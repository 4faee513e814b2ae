"""SummaryEngine: the paper's step-1 single pass, ``build_summary``.

``build_summary(key, A, B, k, method=..., backend=...)`` returns the
``SketchSummary`` (sketches and exact column norms) that sampling, estimation
and completion consume. Four backends, one randomness contract:

    reference    materialized projection operator, one dense product per
                 matrix (the oracle the other backends are tested against)
    scan         ``block`` rows at a time; each block regenerates its slice
                 of the projection, so the (k, d) operator never exists (the
                 paper's streaming pass)
    rows         arbitrary-order row streaming (``rows_summary``) over rows
                 0..d-1; the reference's exact contraction, bit for bit
    cuda         the hand-written kernels, counterpart of the JAX package's
                 ``pallas`` backend: the fused sketch-and-norms kernel
                 (kernels/sketch_fused) for gaussian, the blocked FWHT
                 (kernels/hadamard) for srht; on CPU tensors they run their
                 plain versions

The contract is that of ``repro.core.summary_engine``:

* ``method='gaussian'``: the projection column of global row ``i`` is
  ``normal(fold_in(key, i), (k,)) / sqrt(k)``;
* ``method='srht'``: signs and sampled Hadamard rows come once from ``key``
  (``srht_plan``); the projection column of row ``i`` is ``signs[i] *
  H[rows, i] / sqrt(k)`` with ``H[r, i] = (-1)^popcount(r & i)``, which is
  what lets SRHT stream row by row.

Precision: ``precision='bf16'`` casts the inputs to bfloat16 while every
sum stays float32; sketches and norms are float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core.sketch import _next_pow2, _sqrt_f32, column_norms, pi_rows
from repro_torch.core.types import SketchSummary

METHODS = ("gaussian", "srht")
BACKENDS = ("reference", "scan", "rows", "cuda")

# Columns per blocked_fwht call in the cuda backend's SRHT pass. The
# transform acts on each column alone, so the pass never holds a padded or
# transformed (dp, n) copy of A or B; on the card the kernel's block mode
# holds one block's (dp, SRHT_COLUMN_BLOCK) float32 intermediate (2.1 GB at
# dp = 65,536) and its float64 norm partials (16 MB).
SRHT_COLUMN_BLOCK = 8192


def _cast(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """None keeps the input dtype; 'f32' and 'bf16' cast."""
    if precision is None:
        return x
    if precision == "f32":
        return x.float()
    if precision == "bf16":
        return x.to(torch.bfloat16)
    raise ValueError(f"unknown precision {precision!r} (use None|'f32'|'bf16')")


def srht_plan(key: torch.Tensor, d: int, k: int):
    """(signs (d,) float32, sampled Hadamard rows (k,) int32, dp): the SRHT
    randomness, drawn as ``core.sketch.srht_sketch`` and
    ``kernels.ops.srht_sketch_kernel`` draw it, so all backends share it."""
    dp = _next_pow2(d)
    if k > dp:
        raise ValueError(
            f"srht needs k <= next_pow2(d): k={k} exceeds the padded "
            f"dimension dp={dp} (d={d}) — no-replacement row sampling "
            f"cannot draw k rows from dp")
    key_sign, key_rows = prng.split(key)
    signs = prng.rademacher(key_sign, (d,), dtype=torch.float32)
    rows = prng.choice(key_rows, dp, (k,))
    return signs, rows, dp


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 entry below 2**32 (SWAR: pairs, nibbles,
    bytes, then one multiply sums the four bytes)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hadamard_cols(sampled_rows: torch.Tensor,
                  row_idx: torch.Tensor) -> torch.Tensor:
    """``H[sampled_rows][:, row_idx]`` (k, t) float32 for the Sylvester
    Hadamard matrix, pointwise: ``H[r, i] = (-1)^popcount(r & i)``."""
    r = sampled_rows.to(torch.int64)[:, None]
    i = row_idx.to(torch.int64)[None, :]
    bit = _popcount((r & i) & 0xFFFFFFFF) & 1
    return (1 - 2 * bit).to(torch.float32)


def srht_rows_from_plan(signs_rows: torch.Tensor, sampled_rows: torch.Tensor,
                        row_idx: torch.Tensor, k: int) -> torch.Tensor:
    """(t, k) SRHT projection columns of global rows ``row_idx``, given
    their signs ``signs_rows`` (t,) and the plan's sampled rows. The one
    place the streamed-SRHT formula lives: reference, scan and rows all call
    it."""
    Hc = hadamard_cols(sampled_rows, row_idx)                   # (k, t)
    return (Hc * signs_rows[None, :]).T / _sqrt_f32(k).to(Hc.device)


def projection_rows(key: torch.Tensor, row_idx: torch.Tensor, k: int, *,
                    method: str = "gaussian", d_total: Optional[int] = None,
                    plan=None) -> torch.Tensor:
    """Columns of the (k, d) sketch operator for the given global row ids:
    (t, k) with ``[t, :] = Pi[:, row_idx[t]]``.

    For srht pass ``d_total`` (the streamed dimension; the plan is drawn
    from ``key``) or ``plan = srht_plan(key, d_total, k)[:2]``, which a
    caller summarizing many chunks draws once. Rows past the signs (pad
    rows, whose data are zero) take the last sign."""
    if method == "gaussian":
        return pi_rows(key, row_idx, k)
    if method == "srht":
        if plan is not None:
            signs, rows = plan[0], plan[1]
        elif d_total is not None:
            signs, rows, _ = srht_plan(key, d_total, k)
        else:
            raise ValueError("method='srht' needs d_total or plan=")
        s = signs[torch.clamp(row_idx.long(), 0, signs.shape[0] - 1)]
        return srht_rows_from_plan(s, rows, row_idx, k)
    raise ValueError(f"unknown sketch method {method!r} (use {METHODS})")


def _sketch_dot(P: torch.Tensor, X: torch.Tensor,
                precision: Optional[str]) -> torch.Tensor:
    """(t, k)^T @ (t, n), accumulated in float32 whatever the input dtype.

    The projection is rounded to X's (possibly reduced) dtype, never the
    data up. bf16 products are exact in float32, so computing in float32
    from the rounded values is bf16-in, f32-accumulate."""
    Xc = _cast(X, precision)
    Pc = _cast(P, precision).to(Xc.dtype)
    return Pc.float().T @ Xc.float()


def _reference_backend(key, A, B, k: int, *, method: str, block: int,
                       precision: Optional[str]) -> SketchSummary:
    """Materialized projection operator + one dense product per matrix."""
    del block
    d = A.shape[0]
    P = projection_rows(key, torch.arange(d, device=key.device), k,
                        method=method, d_total=d)
    Ac, Bc = _cast(A, precision), _cast(B, precision)
    return SketchSummary(
        _sketch_dot(P, Ac, precision), _sketch_dot(P, Bc, precision),
        column_norms(Ac), column_norms(Bc))


def rows_summary(key: torch.Tensor, row_idx: torch.Tensor,
                 A_rows: torch.Tensor, B_rows: torch.Tensor, k: int, *,
                 method: str = "gaussian", d_total: Optional[int] = None,
                 plan=None, precision: Optional[str] = None) -> SketchSummary:
    """Rows arriving as (index, A row, B row) triples, in any order: the
    summary is a sum over rows, so the order does not change it. Partial
    streams combine with ``core.sketch.merge_summaries``. For srht pass
    ``d_total`` or a ``plan`` (see ``projection_rows``). Runs on the rows'
    device."""
    dev = A_rows.device
    P = projection_rows(key.to(dev), row_idx.to(dev), k, method=method,
                        d_total=d_total, plan=plan)
    Ac, Bc = _cast(A_rows, precision), _cast(B_rows, precision)
    return SketchSummary(
        _sketch_dot(P, Ac, precision), _sketch_dot(P, Bc, precision),
        column_norms(Ac), column_norms(Bc))


def _rows_backend(key, A, B, k: int, *, method: str, block: int,
                  precision: Optional[str]) -> SketchSummary:
    """Row-stream semantics over the whole pair (rows 0..d-1)."""
    del block
    d = A.shape[0]
    return rows_summary(key, torch.arange(d, device=A.device), A, B, k,
                        method=method, d_total=d, precision=precision)


def _pad_rows(X: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.nn.functional.pad(X, (0, 0, 0, rows - X.shape[0]))


def _scan_backend(key, A, B, k: int, *, method: str, block: int,
                  precision: Optional[str]) -> SketchSummary:
    """One pass over ``block``-row blocks; each block regenerates its slice
    of the projection from (key, global row ids), so the (k, d) operator
    never exists. The last block is padded with zero rows, whose signs are
    1.0, as in the JAX package's scan."""
    d, n1 = A.shape
    n2 = B.shape[1]
    dev = A.device
    nblk = max(1, math.ceil(d / block))
    if method == "srht":
        signs, srows, _ = srht_plan(key, d, k)
        signs = torch.nn.functional.pad(signs, (0, nblk * block - d),
                                        value=1.0)
    As = torch.zeros((k, n1), dtype=torch.float32, device=dev)
    Bs = torch.zeros((k, n2), dtype=torch.float32, device=dev)
    na2 = torch.zeros((n1,), dtype=torch.float32, device=dev)
    nb2 = torch.zeros((n2,), dtype=torch.float32, device=dev)
    for bi in range(nblk):
        lo, hi = bi * block, (bi + 1) * block
        gids = torch.arange(lo, hi, device=dev)
        if method == "gaussian":
            P_b = pi_rows(key, gids, k)                         # (block, k)
        else:
            P_b = srht_rows_from_plan(signs[lo:hi], srows, gids, k)
        Ac = _cast(_pad_rows(A[lo:hi], block), precision)
        Bc = _cast(_pad_rows(B[lo:hi], block), precision)
        As = As + _sketch_dot(P_b, Ac, precision)
        Bs = Bs + _sketch_dot(P_b, Bc, precision)
        na2 = na2 + torch.sum(Ac.float() ** 2, dim=0)
        nb2 = nb2 + torch.sum(Bc.float() ** 2, dim=0)
    return SketchSummary(As, Bs, torch.sqrt(na2), torch.sqrt(nb2))


def _srht_blocked(X: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
                  dp: int, k: int, precision: Optional[str]):
    """(R H D X / sqrt(dp) * sqrt(dp / k), column norms of X), one
    ``ops.srht_block`` call per SRHT_COLUMN_BLOCK columns. On the card each
    call is one launch of the blocked FWHT's block mode: it writes only the
    k sampled rows of each transformed block, straight into the sketch, and
    takes the norms from its first pass's read of X (its own order of
    sums, float64 beyond a thread's float32); on the CPU the plain
    composition (transform, row gather, rescale, ``column_norms``)."""
    from repro_torch.kernels import ops
    n = X.shape[1]
    dev = X.device
    sketch = torch.empty((k, n), dtype=torch.float32, device=dev)
    norms = torch.empty((n,), dtype=torch.float32, device=dev)
    for c0 in range(0, n, SRHT_COLUMN_BLOCK):
        c1 = min(n, c0 + SRHT_COLUMN_BLOCK)
        ops.srht_block(_cast(X[:, c0:c1], precision), signs, rows, d_pad=dp,
                       sketch=sketch, norms=norms, col0=c0)
    return sketch, norms


def _cuda_backend(key, A, B, k: int, *, method: str, block: int,
                  precision: Optional[str]) -> SketchSummary:
    """The kernels: sketch_fused twice against one materialized (k, d) Pi
    for gaussian; for srht the blocked FWHT over column blocks of A, then
    of B (the JAX ``pallas`` backend's srht branch, without its padded
    (dp, n) copies)."""
    from repro_torch.kernels import ops
    del block
    d = A.shape[0]
    if method == "gaussian":
        P = projection_rows(key, torch.arange(d, device=key.device), k).T
        As, na = ops.sketch_fused(P, A, precision=precision)
        Bs, nb = ops.sketch_fused(P, B, precision=precision)
        return SketchSummary(As, Bs, na, nb)
    signs, rows, dp = srht_plan(key, d, k)
    As, na = _srht_blocked(A, signs, rows, dp, k, precision)
    Bs, nb = _srht_blocked(B, signs, rows, dp, k, precision)
    return SketchSummary(As, Bs, na, nb)


_BACKENDS = {"reference": _reference_backend, "scan": _scan_backend,
             "rows": _rows_backend, "cuda": _cuda_backend}


def build_summary(key: torch.Tensor, A: torch.Tensor, B: torch.Tensor, k: int,
                  *, method: str = "gaussian", backend: str = "reference",
                  block: int = 1024, precision: Optional[str] = None,
                  probes: int = 0, cosketch: int = 0,
                  device="cuda") -> SketchSummary:
    """One-pass summary of (A, B): sketches (k, n) and exact column norms.

    A: (d, n1), B: (d, n2). ``method`` is 'gaussian' or 'srht';
    ``backend`` one of ``BACKENDS``; ``block`` the row-block size of the
    scan backend. ``precision``: None/'f32' | 'bf16'. Key, A and B are
    moved to ``device`` (CUDA by default), where the summary is computed.

    >>> import torch
    >>> from repro_torch import prng
    >>> key = prng.PRNGKey(0)
    >>> A, B = torch.randn(64, 8), torch.randn(64, 6)
    >>> s = build_summary(key, A, B, 16, device="cpu")
    >>> (tuple(s.A_sketch.shape), tuple(s.B_sketch.shape), tuple(s.norm_A.shape))
    ((16, 8), (16, 6), (8,))
    >>> t = build_summary(key, A, B, 16, method="srht", backend="scan",
    ...                   block=32, device="cpu")
    >>> tuple(t.A_sketch.shape)
    (16, 8)
    """
    if method not in METHODS:
        raise ValueError(f"unknown sketch method {method!r} (use {METHODS})")
    if backend == "distributed":
        raise NotImplementedError(
            "backend='distributed' is not ported yet (ROADMAP.md, Queue 1 "
            "item 8)")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown summary backend {backend!r} "
                         f"(use one of {BACKENDS})")
    if probes or cosketch:
        raise NotImplementedError(
            "probe and co-sketch blocks are not ported yet (ROADMAP.md, "
            "Queue 1 item 4: quality gate and refinement)")
    if A.ndim != 2 or B.ndim != 2:
        raise NotImplementedError(
            "batched (L, d, n) summaries are not ported yet (ROADMAP.md, "
            "Queue 1 item 2)")
    if A.shape[0] != B.shape[0]:
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)} "
                         f"disagree on d")
    dev = _device.resolve(device)
    return _BACKENDS[backend](key.to(dev), A.to(dev), B.to(dev), k,
                              method=method, block=block, precision=precision)
