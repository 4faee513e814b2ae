"""EstimationEngine: the paper's steps 2 and 3, ``estimate_product``.

``estimate_product(key, summary, r, method='rescaled_jl', backend=...)``
turns a ``build_summary`` output into rank-r factors of A^T B: it samples
Omega by Eq. (1), estimates the sampled entries by Eq. (2) from the sketches
and the retained column norms, and completes them with WAltMin (Alg 2).

backends (how the Eq. (2) values are computed; everything else is shared):

    reference    ``estimator.rescaled_entries`` in plain PyTorch
    cuda         the sampled-dot gather kernel (kernels/sampled_dot), the
                 counterpart of the JAX package's ``pallas`` backend; on CPU
                 tensors it runs the kernel's plain version

Randomness contract, as in ``repro.core.estimation_engine``: ``key`` is
split once into (sample key, ALS key), the same on every backend.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core import estimator, sampling
from repro_torch.core.types import EstimateResult, SketchSummary
from repro_torch.core.waltmin import waltmin

METHODS = ("rescaled_jl",)
BACKENDS = ("reference", "cuda")


def default_m(n1: int, n2: int, r: int) -> int:
    """The paper's m = Theta(n r log n) sample budget with the constant the
    experiments use (Sec 4: ~10 n r log n)."""
    n = max(n1, n2)
    return int(10 * n * r * math.log(max(n, 2)))


def _cuda_values(summary: SketchSummary, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """Rescaled-JL entries through the gather kernel, which wants row-major
    (n, k) sketches: one transpose each, small next to the O(m k) gather."""
    from repro_torch.kernels import ops
    return ops.sampled_rescaled_dot(
        summary.A_sketch.T.contiguous(), summary.B_sketch.T.contiguous(),
        summary.norm_A, summary.norm_B, rows, cols)


_VALUES = {"reference": estimator.rescaled_entries, "cuda": _cuda_values}


def estimate_product(key: torch.Tensor, summary: SketchSummary, r: int, *,
                     method: str = "rescaled_jl", backend: str = "cuda",
                     m: Optional[int] = None, T: int = 10,
                     use_splits: bool = False,
                     device="cuda") -> EstimateResult:
    """Rank-r factors of A^T B from a one-pass summary (Alg 1 steps 2-3).

    method:  'rescaled_jl' (the paper). The two-pass 'lela_waltmin', the
             sketch-only 'direct_svd' and the refinement 'power' are not
             ported yet.
    backend: 'reference' | 'cuda' (the gather kernel for Eq. 2).
    m:       Omega sample budget; defaults to the paper's ~10 n r log n.
    T:       WAltMin iteration pairs. use_splits: Alg-2 sample splitting.
    device:  where to run; key and summary are moved there.
    """
    if method in ("lela_waltmin", "direct_svd", "power"):
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP.md, Queue 1 "
            f"item 3{' and item 4' if method == 'power' else ''})")
    if method not in METHODS:
        raise ValueError(
            f"unknown estimation method {method!r} (use one of {METHODS})")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown estimation backend {backend!r} (use one of {BACKENDS})")
    if summary.A_sketch.ndim != 2:
        raise NotImplementedError(
            "batched (L, k, n) summaries are not ported yet (ROADMAP.md, "
            "Queue 1 item 3)")
    dev = _device.resolve(device)
    key = key.to(dev)
    summary = SketchSummary(*(None if x is None else x.to(dev)
                              for x in summary))
    if m is None:
        m = default_m(summary.n1, summary.n2, r)
    k_sample, k_als = prng.split(key)
    samples = sampling.sample_entries(k_sample, summary.norm_A,
                                      summary.norm_B, m)
    values = _VALUES[backend](summary, samples.rows, samples.cols)
    factors = waltmin(k_als, samples, values, summary.n1, summary.n2, r, T,
                      norm_A=summary.norm_A, use_splits=use_splits)
    return EstimateResult(factors, samples, values)
