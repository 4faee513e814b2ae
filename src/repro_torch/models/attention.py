"""Attention: GQA with RoPE, the flash kernel for causal prefill on the card,
chunked online-softmax and dense masked attention, sliding windows, and
KV-cache decode.

The port of ``repro.models.attention``. Which implementation a block's
attention takes is ``route(device, causal, window, head_dim)``, in one
place:

* ``"flash"``: causal, unwindowed self-attention on a CUDA device, with a
  head width the kernel takes (up to
  ``kernels.flash_attention.MAX_HEAD_DIM``, 256: every config of the repo,
  the reduced ones' 16 included), goes through
  ``kernels.ops.flash_attention``. A sequence that is not a multiple of the
  resolved tile is right-padded with zeros and the output sliced back
  (``flash_prefill``): under the causal mask no real query sees a padded
  key, so the padding changes nothing.
* ``"plain"``: everything else (bidirectional, cross-attention, windowed,
  a head wider than 256, every tensor on the CPU, and every call whose
  output autograd must differentiate), as the JAX package computes it in
  plain JAX: dense masked attention up to ``CHUNK_THRESHOLD`` tokens, the
  chunked online softmax above. Training runs its attention through
  autograd there, as the JAX package's training runs ``chunked_attention``
  under ``jax.grad``; the kernel is forward only in both packages.

``ROUTES`` counts the attention calls of each route
(``reset_route_counts()`` sets them to 0), beside ``ops.LAUNCHES``.
Tensors on the ``meta`` device (the dry run's shape-only trace) take the
card's route; there the flash route is ``kernels.flash_attention.trace``,
an op that computes nothing and whose work the dry run's analyzer counts
as the kernel's. Decode
(one token against the cache, or against a cross-attention's context) is
plain PyTorch on every device, as it is plain JAX in the reference, and
counts no route.

q, k and v reach attention in float32 (``common.dense_apply`` returns
float32), so the kernel takes its float32 route (three split TF32 passes a
product), the float32 scores that ``scores_dtype="float32"`` asks for.
The kernel computes float32 scores whatever ``scores_dtype`` says; the
plain route honours it.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng
from repro_torch.dist import sharding
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ops, tuning
from repro_torch.models import common

_NEG_INF = -1e30
CHUNK_THRESHOLD = 2048       # below this, dense masked attention is cheaper
Q_CHUNK = 1024
KV_CHUNK = 1024

ROUTES = {"flash": 0, "plain": 0}


def reset_route_counts() -> None:
    """Set both route counters to 0."""
    for name in ROUTES:
        ROUTES[name] = 0


def route(device: torch.device, causal: bool, window, head_dim: int,
          needs_grad: bool = False) -> str:
    """``"flash"`` for causal, unwindowed attention on a CUDA (or ``meta``)
    device at a head width the kernel takes (at most
    ``flash_attention.MAX_HEAD_DIM``), else ``"plain"``. ``needs_grad``
    (the call is recorded for a backward pass) takes the plain route: the
    kernel has no backward, as the JAX package's has none."""
    if (torch.device(device).type in ("cuda", "meta") and causal
            and window is None
            and head_dim <= _flash.MAX_HEAD_DIM and not needs_grad):
        return "flash"
    return "plain"


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """The four projections ``wq``, ``wk``, ``wv``, ``wo``."""

    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int, *,
                 dtype=torch.float32, bias: bool = False, device="cuda"):
        super().__init__()
        kw = dict(bias=bias, dtype=dtype, device=device)
        self.wq = common.Dense(d, n_heads * head_dim, **kw)
        self.wk = common.Dense(d, n_kv * head_dim, **kw)
        self.wv = common.Dense(d, n_kv * head_dim, **kw)
        self.wo = common.Dense(n_heads * head_dim, d, **kw)

    def reset(self, key: torch.Tensor) -> None:
        """``attn_init``: q, k, v, o from ``split(key, 4)`` in that order."""
        kq, kk, kv, ko = prng.split(key, 4)
        self.wq.reset(kq)
        self.wk.reset(kk)
        self.wv.reset(kv)
        self.wo.reset(ko)


def qkv_project(p: Attention, x: torch.Tensor, n_heads: int, n_kv: int,
                head_dim: int, positions: torch.Tensor, rope_theta,
                compute_dtype=torch.bfloat16):
    B, S, _ = x.shape
    q = sharding.fit_heads(common.dense_apply(p.wq, x, compute_dtype),
                           n_heads).reshape(B, S, n_heads, head_dim)
    k = sharding.fit_heads(common.dense_apply(p.wk, x, compute_dtype),
                           n_kv).reshape(B, S, n_kv, head_dim)
    v = sharding.fit_heads(common.dense_apply(p.wv, x, compute_dtype),
                           n_kv).reshape(B, S, n_kv, head_dim)
    if rope_theta is not None:
        q = common.apply_rope(q, positions, rope_theta)
        k = common.apply_rope(k, positions, rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# dense masked attention (short sequences / references)
# ---------------------------------------------------------------------------

def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, H, Dh): query head h reads KV head
    ``h // (H // Hkv)``."""
    return k.repeat_interleave(n_heads // k.shape[2], dim=2)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """``einsum`` of operands in their dtypes with the result in
    ``out_dtype``; bf16 operands are summed in float32 (their products are
    exact there) and rounded once, as XLA's preferred element type does."""
    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        return torch.einsum(eq, a.float(), b.float()).to(out_dtype)
    return torch.einsum(eq, a, b).to(out_dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int | None = None,
                    q_offset: int = 0, kv_valid_len=None,
                    scores_dtype=torch.float32) -> torch.Tensor:
    """q: (B, Sq, H, Dh), k/v: (B, Skv, Hkv, Dh). Returns (B, Sq, H, Dh)."""
    B, Sq, H, Dh = q.shape
    Skv = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scores = _einsum("bqhd,bkhd->bhqk", q.to(scores_dtype),
                     k.to(scores_dtype), scores_dtype) / math.sqrt(Dh)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if kv_valid_len is not None:
        mask &= kpos < torch.as_tensor(kv_valid_len, device=q.device)
    scores = torch.where(mask[None, None], scores.float(),
                         torch.tensor(_NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(scores_dtype)
    return _einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v, v.dtype)


# ---------------------------------------------------------------------------
# chunked online-softmax attention (flash-style, plain PyTorch)
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK,
                      scores_dtype=torch.float32) -> torch.Tensor:
    """Streaming attention: never materializes more than (q_chunk x kv_chunk)
    of scores per head. q/k/v as in dense_attention, Sq == Skv == S."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    if S % q_chunk or S % kv_chunk:
        raise ValueError(f"chunked_attention: S={S} not divisible by the "
                         f"chunks ({q_chunk}, {kv_chunk})")
    scale = 1.0 / math.sqrt(Dh)
    rep = H // Hkv
    qh = q.transpose(1, 2)                           # (B, H, S, Dh)
    kh = k.transpose(1, 2)                           # (B, Hkv, S, Dh)
    vh = v.transpose(1, 2)
    neg = torch.tensor(_NEG_INF, device=q.device)
    outs = []
    for q0 in range(0, S, q_chunk):
        q32 = qh[:, :, q0:q0 + q_chunk].float() * scale
        qpos = q0 + torch.arange(q_chunk, device=q.device)
        m = torch.full((B, H, q_chunk), _NEG_INF, device=q.device)
        l = torch.zeros((B, H, q_chunk), device=q.device)
        acc = torch.zeros((B, H, q_chunk, Dh), device=q.device)
        for k0 in range(0, S, kv_chunk):
            kb = kh[:, :, k0:k0 + kv_chunk].repeat_interleave(rep, dim=1)
            vb = vh[:, :, k0:k0 + kv_chunk].repeat_interleave(rep, dim=1)
            s = _einsum("bhqd,bhkd->bhqk", q32.to(scores_dtype),
                        kb.to(scores_dtype), scores_dtype).float()
            kpos = k0 + torch.arange(kv_chunk, device=q.device)
            msk = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                             device=q.device)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                msk &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(msk[None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]).to(scores_dtype)
            corr = torch.exp(m - m_new)
            l = l * corr + p.float().sum(dim=-1)
            acc = acc * corr[..., None] + _einsum("bhqk,bhkd->bhqd", p, vb,
                                                  torch.float32)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=2)                     # (B, H, S, Dh)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# the flash kernel on the card
# ---------------------------------------------------------------------------

def flash_prefill(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention through ``ops.flash_attention`` (one launch on
    CUDA tensors, its plain version on CPU tensors): q (B, S, H, Dh), k and
    v (B, S, Hkv, Dh). S is right-padded with zeros to a multiple of the
    resolved tile's larger block, which the call is then given, and the
    output sliced back to S rows."""
    B, S, H, Dh = q.shape
    if q.device.type == "meta":
        return _flash.trace(q, k, v, True)
    config = tuning.lookup("flash_attention", (B * H, S, Dh),
                           dtype_bytes=tuning.dtype_bytes_of(q),
                           backend=tuning.backend_of(q.device))
    pad = -S % max(config.block)
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    return ops.flash_attention(q, k, v, causal=True, config=config)[:, :S]


#: (batch, heads) dims of q, k, v and the output, for ``local_over``
_BH = ((0, 2),) * 3


def attention(q, k, v, *, causal=True, window=None,
              scores_dtype=torch.float32):
    """Self-attention over one sequence (Sq == Skv), by ``route``. Under
    DTensor it runs on each device's batch and heads
    (``dist.sharding.local_over``)."""
    Dh = q.shape[-1]
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    kind = route(q.device, causal, window, Dh, needs_grad)
    ROUTES[kind] += 1
    fn = functools.partial(_attention, kind=kind, causal=causal,
                           window=window, scores_dtype=scores_dtype)
    return sharding.local_over(fn, (q, k, v), _BH, (0, 2))


def _attention(q, k, v, *, kind, causal, window, scores_dtype):
    if kind == "flash":
        return flash_prefill(q, k, v)
    S = q.shape[1]
    if S <= CHUNK_THRESHOLD or S % Q_CHUNK or S % KV_CHUNK:
        return dense_attention(q, k, v, causal=causal, window=window,
                               scores_dtype=scores_dtype)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             scores_dtype=scores_dtype)


def cross_attention(q, k, v, *, decode: bool = False):
    """Bidirectional attention of q against a context's k and v (another
    length): the plain route, ``dense_attention``. A decode step's call
    (``decode``: its token against the cached context) counts no route, as
    decode's self-attention counts none."""
    if not decode:
        ROUTES["plain"] += 1
    return sharding.local_over(
        functools.partial(dense_attention, causal=False), (q, k, v), _BH,
        (0, 2))


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    return {"k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                             device=device)}


def _slot(pos, L: int, ring: bool) -> int:
    """The cache row ``pos`` goes to, clamped into the cache as
    ``dynamic_update_slice`` clamps its start."""
    pos = int(pos)
    return pos % L if ring else min(max(pos, 0), L - 1)


def cache_update(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                 v_new: torch.Tensor, pos, *, ring: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """Write (B, 1, Hkv, Dh) at position ``pos`` (ring=True wraps: used by
    sliding-window caches whose length is the window size), in place;
    returns the cache."""
    idx = _slot(pos, cache["k"].shape[1], ring)
    cache["k"][:, idx] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, idx] = v_new[:, 0].to(cache["v"].dtype)
    return cache


def decode_attention(q: torch.Tensor, cache: Dict[str, torch.Tensor], pos, *,
                     window: int | None = None) -> torch.Tensor:
    """Single-token attention against the cache. q: (B, 1, H, Dh).

    For ring caches (window), every slot written so far is valid (<= pos) and
    RoPE was already applied at insert time, so ordering inside the ring is
    irrelevant to the softmax; only validity matters. The KV heads are read
    in place (query head h against KV head ``h // (H // Hkv)``), in
    float32.
    """
    fn = functools.partial(_decode_attention, pos=int(pos), window=window)
    return sharding.local_over(fn, (q, cache["k"], cache["v"]), _BH, (0, 2))


def _decode_attention(q, k, v, *, pos, window):
    B, _, H, Dh = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, H // Hkv, Dh)
    k = k.float()
    v = v.float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k) / math.sqrt(Dh)
    slot = torch.arange(L, device=q.device)
    pos = int(pos)
    valid = slot <= pos
    if window is not None:
        # ring: once pos >= L every slot holds an in-window token; before
        # that only slots <= pos have been written.
        valid = valid | (pos >= L)
    s = torch.where(valid, s, torch.tensor(_NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, v)
    return out.reshape(B, 1, H, Dh).to(q.dtype)
