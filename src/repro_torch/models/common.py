"""Shared layer primitives: norms, dense, RoPE, activations, embeddings.

The port of ``repro.models.common``. Each ``*_init``/``*_apply`` pair of
the JAX package becomes a small ``nn.Module`` holding its parameters under
the JAX dict's names (``w``, ``b``, ``scale``, ``bias``, ``table``), with a
``reset(key)`` that draws them from the same key as the ``*_init``, and a
plain function that applies it. Parameters are allocated on ``device``
(the card by default) in ``dtype``; ``device="meta"`` allocates nothing.

``dense_apply`` rounds x and w to the compute dtype and returns the
product in float32, as ``jax.lax.dot_general(...,
preferred_element_type=float32)`` does: on the card one bf16 GEMM with a
float32 output (``torch.mm(..., out_dtype=torch.float32)``, given a
backward pass by ``_F32Out``), on the CPU the bf16-rounded operands upcast
to float32 (their products are exact there).
``bmm_f32`` does the same for a stack of products (the MoE experts).
Tensors on the ``meta`` device (the dry run's shape-only trace,
``launch.dryrun``) take the card's route. A weight that is a DTensor is
used as FSDP uses it, its data-parallel shards gathered
(``dist.sharding.gather_dp``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng
from repro_torch.dist import sharding


def _card_route(t: torch.Tensor) -> bool:
    """True on the card and on ``meta`` tensors, which trace its route."""
    return t.device.type in ("cuda", "meta")


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-d, or a stack of 3-d) of one dtype, summed in float32 into
    a float32 result: on the card one GEMM of that dtype with a float32
    output; elsewhere the operands upcast (products of bf16 values are
    exact in float32)."""
    if _card_route(a):
        mm = torch.mm if a.ndim == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _F32Out(torch.autograd.Function):
    """``torch.mm``/``torch.bmm(x, w, out_dtype=float32)`` of bf16 operands
    on the card, with the backward pass those library calls lack.

    The reference's jaxpr for the gradient of ``dot_general(x, w,
    preferred_element_type=float32)`` of bf16 x and w multiplies the
    float32 cotangent by the other bf16 operand (``preferred_element_type
    =float32``) and converts the result to bf16. XLA on the CPU evaluates
    that mixed product in float32, as the port's CPU path does (autograd
    through the upcast operands). On a TPU at ``Precision.DEFAULT``, which
    the JAX package never overrides, a float32 operand of a matmul is
    rounded to bf16 for one bf16 pass. The card follows the TPU: the
    cotangent rounded to the operands' dtype, then one GEMM of that dtype
    for dx and one for dw, each summed in float32 and rounded to its
    operand's dtype. The two readings differ by that rounding of the
    cotangent (2**-8 of each entry) carried through the product."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g, w.transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_f32(x.transpose(-1, -2), g).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out), both rounded to ``compute_dtype``,
    summed in float32 into a float32 result."""
    x2 = x.reshape(-1, x.shape[-1]).to(compute_dtype)
    wc = sharding.gather_dp(w).to(compute_dtype)
    if compute_dtype == torch.float32:
        y = x2 @ wc
    elif _card_route(x2):
        y = _F32Out.apply(x2, wc)
    else:
        y = x2.float() @ wc.float()
    return y.reshape(*x.shape[:-1], w.shape[1])


def bmm_f32(x: torch.Tensor, w: torch.Tensor,
            compute_dtype: torch.dtype) -> torch.Tensor:
    """The batched ``matmul_f32``: x (e, c, d_in) @ w (e, d_in, d_out),
    ``einsum('ecd,edf->ecf', ..., preferred_element_type=float32)``; on
    the card one bf16 batched GEMM with a float32 output."""
    x, w = x.to(compute_dtype), sharding.gather_dp(w).to(compute_dtype)
    if compute_dtype == torch.float32:
        return torch.bmm(x, w)
    if _card_route(x):
        return _F32Out.apply(x, w)
    return torch.bmm(x.float(), w.float())


class Dense(nn.Module):
    """y = x @ w (+ b): ``w`` (d_in, d_out), ``b`` (d_out,)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype,
                                          device=device))
        self.b = (nn.Parameter(torch.empty(d_out, dtype=dtype, device=device))
                  if bias else None)

    def reset(self, key: torch.Tensor, scale: float | None = None) -> None:
        """``dense_init``: ``normal(key, (d_in, d_out)) * scale`` (1/sqrt(d_in)
        by default) in float32, then cast; a zero bias."""
        d_in, d_out = self.w.shape
        scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
        with torch.no_grad():
            self.w.copy_(prng.normal(key.to(self.w.device), (d_in, d_out))
                         * scale)
            if self.b is not None:
                self.b.zero_()


def dense_apply(p: Dense, x: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x @ w in ``compute_dtype`` with a float32 result, plus the bias in
    float32."""
    y = matmul_f32(x, p.w, compute_dtype)
    if p.b is not None:
        y = y + p.b.float()
    return y


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, dtype=dtype, device=device))

    def reset(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(d, dtype=dtype, device=device))

    def reset(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()


def rmsnorm_apply(p: RMSNorm, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)) * p.scale.float()


def layernorm_apply(p: LayerNorm, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p.scale.float() \
        + p.bias.float()


def norm_init(kind: str, d: int, device="cuda") -> nn.Module:
    """A float32 norm of ``kind`` (layernorm, else rmsnorm), reset."""
    norm = LayerNorm(d, device=device) if kind == "layernorm" \
        else RMSNorm(d, device=device)
    if torch.device(device).type != "meta":
        norm.reset()
    return norm


def norm_apply(kind: str, p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return layernorm_apply(p, x) if kind == "layernorm" \
        else rmsnorm_apply(p, x)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). The two
    halves of Dh rotate together (not interleaved pairs); angles in
    float32; the result in x's dtype."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)               # (Dh/2,)
    angles = positions[..., None].float() * freqs               # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def sinusoidal_positions(seq_len: int, d: int, device="cpu") -> torch.Tensor:
    """(seq_len, d) float32: sin in the even columns, cos in the odd."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    return sinusoidal_at(pos, d)


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal embedding of float32 positions ``pos`` (..., 1):
    (..., d)."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    angle = pos / (10000.0 ** (dim / d))
    out = torch.zeros((*angle.shape[:-1], d), dtype=torch.float32,
                      device=pos.device)
    out[..., 0::2] = torch.sin(angle)
    out[..., 1::2] = torch.cos(angle)
    return out


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# ``jax.nn.gelu`` defaults to its tanh form (approximate=True), so "gelu"
# and "gelu_tanh" are the same function, not torch's default erf form.
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "gelu_tanh": _gelu_tanh,
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# MLP (gated / plain)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``up`` and ``down``, plus ``gate`` when gated."""

    def __init__(self, d: int, d_ff: int, *, gated: bool, dtype=torch.float32,
                 bias: bool = False, device="cuda"):
        super().__init__()
        self.up = Dense(d, d_ff, bias=bias, dtype=dtype, device=device)
        self.down = Dense(d_ff, d, bias=bias, dtype=dtype, device=device)
        self.gate = (Dense(d, d_ff, bias=bias, dtype=dtype, device=device)
                     if gated else None)

    def reset(self, key: torch.Tensor) -> None:
        """``mlp_init``: up from ``ks[0]``, down ``ks[1]``, gate ``ks[2]``
        of ``split(key, 3)``."""
        ks = prng.split(key, 3)
        self.up.reset(ks[0])
        self.down.reset(ks[1])
        if self.gate is not None:
            self.gate.reset(ks[2])


def mlp_apply(p: MLP, x: torch.Tensor, act: str,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    f = ACTIVATIONS[act]
    up = dense_apply(p.up, x, compute_dtype)
    if p.gate is not None:
        h = f(dense_apply(p.gate, x, compute_dtype)) * up
    else:
        h = f(up)
    return dense_apply(p.down, h.to(compute_dtype), compute_dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d, dtype=dtype,
                                              device=device))

    def reset(self, key: torch.Tensor) -> None:
        """``embed_init``: ``normal(key, (vocab, d)) * 0.02``."""
        with torch.no_grad():
            self.table.copy_(prng.normal(key.to(self.table.device),
                                         tuple(self.table.shape)) * 0.02)


def embed_apply(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return sharding.gather_dp(p.table)[tokens.long()]


def unembed_apply(p: Embedding, x: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Tied read-out: logits = x @ table^T, float32."""
    return matmul_f32(x, sharding.gather_dp(p.table).T, compute_dtype)
