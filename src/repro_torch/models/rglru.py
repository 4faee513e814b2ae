"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(Lambda) * sigmoid(r_t))        (c = 8)

The port of ``repro.models.rglru``: ``rglru_init`` becomes the ``RGLRU``
module (``w_in``, ``w_gate_branch``, ``conv_w``, ``gate_r``, ``gate_i``,
``lam``, ``w_out``) with ``reset(key)``, the rest plain functions of it.

The recurrence is a per-channel *linear* scan. The JAX package runs the
sequence with ``lax.associative_scan``; ``associative_scan`` here is the
same recursive odd/even reduction (O(log S) depth, about 2 log2(S)
elementwise passes along dim 1), so the float32 products and sums are
taken in the reference's order. Decode is one elementwise update
(``rglru_step``). The block is x -> [gelu(W_gate x)] * [RG-LRU(conv1d(W_in
x))] -> W_out. Plain PyTorch, as the reference is plain JAX.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng
from repro_torch.core.linalg import sqrt_f32
from repro_torch.dist import sharding
from repro_torch.models import common

_C = 8.0
CONV_K = 4


class RGLRU(nn.Module):
    def __init__(self, d: int, width: int, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w_in = common.Dense(d, width, **kw)
        self.w_gate_branch = common.Dense(d, width, **kw)
        self.conv_w = nn.Parameter(torch.empty(CONV_K, width, **kw))
        self.gate_r = common.Dense(width, width, **kw)
        self.gate_i = common.Dense(width, width, **kw)
        self.lam = nn.Parameter(torch.empty(width, device=device))
        self.w_out = common.Dense(width, d, **kw)

    def reset(self, key: torch.Tensor) -> None:
        """``rglru_init``: ``split(key, 6)``; Lambda from ``uniform(ks[0],
        (W,), 0.9, 0.999)`` through the inverse softplus (a in (0.9,
        0.999) at sigmoid(r) = 0.5), float32; ``gate_i`` from
        ``fold_in(ks[4], 1)``."""
        ks = prng.split(key.to(self.lam.device), 6)
        W = self.lam.shape[0]
        lam_init = prng.uniform(ks[0], (W,), 0.9, 0.999)
        self.w_in.reset(ks[1])
        self.w_gate_branch.reset(ks[2])
        self.gate_r.reset(ks[4])
        self.gate_i.reset(prng.fold_in(ks[4], 1))
        self.w_out.reset(ks[5])
        with torch.no_grad():
            self.lam.copy_(torch.log(torch.exp(-torch.log(lam_init)
                                               / (0.5 * _C)) - 1.0))
            self.conv_w.copy_(prng.normal(ks[3], (CONV_K, W))
                              * (1.0 / math.sqrt(CONV_K)))


def associative_scan(fn: Callable, elems: Tuple[torch.Tensor, ...]
                     ) -> Tuple[torch.Tensor, ...]:
    """``jax.lax.associative_scan(fn, elems, axis=1)``: combine adjacent
    pairs, scan the half-length sequence recursively (the odd outputs),
    combine each with the next even input (the even outputs), interleave."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = fn(tuple(e[:, 0:-1:2] for e in elems),
                 tuple(e[:, 1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:, :-1] for e in odd),
                  tuple(e[:, 2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[:, 2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[:, :1] = e[:, :1]
        r[:, 2::2] = ev
        r[:, 1::2] = od
        out.append(r)
    return tuple(out)


def _causal_conv(w: torch.Tensor, x: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv, kernel CONV_K. x: (B, S, W). Returns (y, new
    state (B, CONV_K-1, W)) for streaming decode."""
    B, S, W = x.shape
    if state is None:
        state = torch.zeros((B, CONV_K - 1, W), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                  # (B, S+K-1, W)
    y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(CONV_K))
    return y, xp[:, -(CONV_K - 1):, :]


def _gates(p: RGLRU, xc: torch.Tensor):
    """log(a_t) and input gate i_t, float32. xc: (..., W). The gate
    products run in ``dense_apply``'s default bf16, as in the reference,
    whatever the model computes in."""
    r = torch.sigmoid(common.dense_apply(p.gate_r, xc))
    i = torch.sigmoid(common.dense_apply(p.gate_i, xc))
    log_a = -_C * F.softplus(p.lam.float()) * r        # (..., W), < 0
    return log_a, i


def _a_b(p: RGLRU, x: torch.Tensor):
    log_a, gate_i = _gates(p, x.float())
    a = torch.exp(log_a)
    b = sqrt_f32(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0)) \
        * gate_i * x.float()
    return a, b


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def rglru_seq(p: RGLRU, x: torch.Tensor, h0: torch.Tensor | None = None,
              compute_dtype=torch.bfloat16):
    """Full-sequence RG-LRU core. x: (B, S, W) (post-conv input).
    Returns (y (B, S, W) float32, final state (B, W))."""
    a, b = _a_b(p, x)
    if h0 is not None:
        b[:, 0, :] += a[:, 0, :] * h0
    # elementwise over (batch, width): under DTensor each device scans its
    # shard (the strided writes do not shard op by op)
    h = sharding.local_over(
        lambda a_, b_: associative_scan(_combine, (a_, b_))[1], (a, b),
        ((0, 2), (0, 2)), (0, 2))
    return h, h[:, -1, :]


def rglru_step(p: RGLRU, x_t: torch.Tensor, h: torch.Tensor):
    """One decode step. x_t: (B, W) post-conv; h: (B, W) -> (y_t, h_new)."""
    a, b = _a_b(p, x_t)
    h_new = a * h + b
    return h_new, h_new


def rglru_block_seq(p: RGLRU, x: torch.Tensor, compute_dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """Full block, training/prefill path (no carried state). x: (B, S, d)."""
    y, _, gate, _ = block_front(p, x, compute_dtype)
    return common.dense_apply(p.w_out, (y * gate).to(compute_dtype),
                              compute_dtype)


def block_front(p: RGLRU, x, compute_dtype):
    """The gate branch, the conv and the scan over a sequence: (y, h_final,
    gate, conv state)."""
    gate = common.ACTIVATIONS["gelu"](
        common.dense_apply(p.w_gate_branch, x, compute_dtype))
    xin = common.dense_apply(p.w_in, x, compute_dtype)
    xc, conv_state = _causal_conv(p.conv_w.float(), xin)
    y, h_final = rglru_seq(p, xc, compute_dtype=compute_dtype)
    return y, h_final, gate, conv_state


def rglru_block_cache_init(batch: int, width: int, dtype=torch.float32,
                           device="cuda") -> Dict[str, torch.Tensor]:
    """The decode state: ``h`` float32, ``conv`` in ``dtype`` (the compute
    dtype, so bf16 under bf16 compute, as in the reference)."""
    return {"h": torch.zeros((batch, width), device=device),
            "conv": torch.zeros((batch, CONV_K - 1, width), dtype=dtype,
                                device=device)}


def rglru_block_step(p: RGLRU, x_t: torch.Tensor, cache,
                     compute_dtype=torch.bfloat16):
    """One decode step of the full block. x_t: (B, 1, d). Writes the new
    state into ``cache`` and returns (out, cache)."""
    gate = common.ACTIVATIONS["gelu"](
        common.dense_apply(p.w_gate_branch, x_t, compute_dtype))
    xin = common.dense_apply(p.w_in, x_t, compute_dtype)
    xc, conv_state = _causal_conv(p.conv_w.float(), xin,
                                  cache["conv"].float())
    y, h_new = rglru_step(p, xc[:, 0, :], cache["h"])
    out = common.dense_apply(p.w_out, (y[:, None, :] * gate).to(compute_dtype),
                             compute_dtype)
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_state)
    return out, cache
