"""SummaryEngine: the paper's step-1 single pass, ``build_summary``.

``build_summary(key, A, B, k, backend=...)`` returns the ``SketchSummary``
(Gaussian sketches and exact column norms) that sampling, estimation and
completion consume. Two backends, one randomness contract:

    reference    materialized projection operator, one dense product per
                 matrix (the oracle the other backend is tested against)
    cuda         the fused sketch-and-norms kernel (kernels/sketch_fused),
                 counterpart of the JAX package's ``pallas`` backend; on CPU
                 tensors it runs the kernel's plain version

The projection column of global row ``i`` is ``normal(fold_in(key, i),
(k,)) / sqrt(k)``, as in ``repro.core.summary_engine``. Precision:
``precision='bf16'`` casts the inputs to bfloat16 while every sum stays
float32; sketches and norms are float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as _device
from repro_torch.core.sketch import column_norms, pi_rows
from repro_torch.core.types import SketchSummary

METHODS = ("gaussian",)
BACKENDS = ("reference", "cuda")
_SRHT_TODO = ("method='srht' is not ported yet (ROADMAP.md, Queue 1 item 2 "
              "and Queue 2 item 3: blocked_fwht)")


def _cast(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """None keeps the input dtype; 'f32' and 'bf16' cast."""
    if precision is None:
        return x
    if precision == "f32":
        return x.float()
    if precision == "bf16":
        return x.to(torch.bfloat16)
    raise ValueError(f"unknown precision {precision!r} (use None|'f32'|'bf16')")


def projection_rows(key: torch.Tensor, row_idx: torch.Tensor, k: int, *,
                    method: str = "gaussian") -> torch.Tensor:
    """Columns of the (k, d) sketch operator for the given global row ids:
    (t, k) with ``[t, :] = Pi[:, row_idx[t]]``."""
    if method == "gaussian":
        return pi_rows(key, row_idx, k)
    if method == "srht":
        raise NotImplementedError(_SRHT_TODO)
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


def _reference_backend(key, A, B, k: int, *,
                       precision: Optional[str]) -> SketchSummary:
    """Materialized projection operator + one dense product per matrix."""
    d = A.shape[0]
    P = projection_rows(key, torch.arange(d, device=key.device), k)
    Ac, Bc = _cast(A, precision), _cast(B, precision)
    return SketchSummary(
        _sketch_dot(P, Ac, precision), _sketch_dot(P, Bc, precision),
        column_norms(Ac), column_norms(Bc))


def _cuda_backend(key, A, B, k: int, *,
                  precision: Optional[str]) -> SketchSummary:
    """The fused kernel, twice, against one materialized (k, d) Pi."""
    from repro_torch.kernels import ops
    d = A.shape[0]
    P = projection_rows(key, torch.arange(d, device=key.device), k).T
    As, na = ops.sketch_fused(P, A, precision=precision)
    Bs, nb = ops.sketch_fused(P, B, precision=precision)
    return SketchSummary(As, Bs, na, nb)


_BACKENDS = {"reference": _reference_backend, "cuda": _cuda_backend}


def build_summary(key: torch.Tensor, A: torch.Tensor, B: torch.Tensor, k: int,
                  *, method: str = "gaussian", backend: str = "reference",
                  precision: Optional[str] = None, probes: int = 0,
                  cosketch: int = 0, device="cuda") -> SketchSummary:
    """One-pass summary of (A, B): sketches (k, n) and exact column norms.

    A: (d, n1), B: (d, n2). ``backend`` is 'reference' or 'cuda'.
    ``precision``: None/'f32' | 'bf16'. Key, A and B are moved to
    ``device`` (CUDA by default), where the summary is computed.

    >>> import torch
    >>> from repro_torch import prng
    >>> key = prng.PRNGKey(0)
    >>> A, B = torch.randn(64, 8), torch.randn(64, 6)
    >>> s = build_summary(key, A, B, 16, device="cpu")
    >>> (tuple(s.A_sketch.shape), tuple(s.B_sketch.shape), tuple(s.norm_A.shape))
    ((16, 8), (16, 6), (8,))
    """
    if method == "srht":
        raise NotImplementedError(_SRHT_TODO)
    if method not in METHODS:
        raise ValueError(f"unknown sketch method {method!r} (use {METHODS})")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown summary backend {backend!r} "
                         f"(use one of {BACKENDS}); 'scan', 'rows' and "
                         f"'distributed' are not ported yet (ROADMAP.md)")
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
                              precision=precision)
