"""EstimationEngine: the paper's steps 2 and 3, ``estimate_product``.

``estimate_product(key, summary, r, method=..., backend=...)`` turns a
``build_summary`` output into rank-r factors of A^T B.

methods (what is estimated):

    rescaled_jl   the paper: Omega sampled by Eq. (1), the sampled entries
                  estimated by Eq. (2) from the sketches and the retained
                  column norms, completed by WAltMin (Alg 2)
    lela_waltmin  the LELA two-pass baseline: the same sample, but exact
                  entries A_i^T B_j gathered from ``exact_pair=(A, B)``,
                  then the same WAltMin
    direct_svd    top-r SVD of A~^T B~, the product of the sketches: no
                  sampling, no completion
    power         Tropp's co-sketch reconstruction (``core/refinement.py``),
                  optionally after sketch-power iterations; needs
                  ``build_summary(..., cosketch=s)``; ``refine=RefineSpec``

backends (how it runs):

    reference    plain PyTorch throughout; direct_svd forms A~^T B~ and
                 takes its dense SVD
    cuda         the counterpart of the JAX package's ``pallas`` backend:
                 rescaled_jl's Eq. (2) values through the sampled-dot gather
                 kernel (kernels/sampled_dot; on CPU tensors its plain
                 version), direct_svd by implicit subspace iteration
                 (``implicit_topr``, the JAX ``jit`` semantics); the methods
                 without a kernel stage run as on ``reference``

Batched mode: a summary whose fields carry a leading (L, ...) axis (from
``build_summary`` on stacked input) is estimated pair by pair, with ``key``
split L ways (or a stack of L keys), and the results are stacked.

``with_error=True`` attaches the ErrorEngine's a-posteriori estimate
(``EstimateResult.error``); it needs a probe-carrying summary.

Randomness contract, as in ``repro.core.estimation_engine``: ``key`` is
split once into (sample key, ALS key), the same on every backend.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core import estimator, refinement, sampling
from repro_torch.core.linalg import svd
from repro_torch.core.refinement import RefineSpec
from repro_torch.core.summary_engine import pair_keys
from repro_torch.core.types import (
    EstimateResult, LowRankFactors, SketchSummary, tree_index, tree_stack)
from repro_torch.core.waltmin import waltmin

METHODS = ("rescaled_jl", "lela_waltmin", "direct_svd", "power")
BACKENDS = ("reference", "cuda")


def default_m(n1: int, n2: int, r: int) -> int:
    """The paper's m = Theta(n r log n) sample budget with the constant the
    experiments use (Sec 4: ~10 n r log n)."""
    n = max(n1, n2)
    return int(10 * n * r * math.log(max(n, 2)))


# ---------------------------------------------------------------------------
# Shared stages
# ---------------------------------------------------------------------------

def _cuda_values(summary: SketchSummary, rows: torch.Tensor,
                 cols: torch.Tensor, tuning=None) -> torch.Tensor:
    """Rescaled-JL entries through the gather kernel, which wants row-major
    (n, k) sketches: one transpose each, small next to the O(m k) gather.
    ``tuning``'s pinned ``sampled_dot`` config, if any, is the launch's."""
    from repro_torch.kernels import ops
    return ops.sampled_rescaled_dot(
        summary.A_sketch.T.contiguous(), summary.B_sketch.T.contiguous(),
        summary.norm_A, summary.norm_B, rows, cols,
        config=None if tuning is None else tuning.config_for("sampled_dot"))


def _reference_values(summary: SketchSummary, rows: torch.Tensor,
                      cols: torch.Tensor, tuning=None) -> torch.Tensor:
    del tuning
    return estimator.rescaled_entries(summary, rows, cols)


_VALUES = {"reference": _reference_values, "cuda": _cuda_values}


def exact_entries(A: torch.Tensor, B: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Exact A_i^T B_j on (rows, cols): LELA's second pass, ``chunk``
    samples at a time, so each step gathers two (d, chunk) blocks."""
    m = rows.shape[0]
    out = torch.empty((m,), dtype=torch.result_type(A, B), device=A.device)
    for lo in range(0, m, chunk):
        r_, c_ = rows[lo:lo + chunk], cols[lo:lo + chunk]
        out[lo:lo + chunk] = torch.sum(A[:, r_] * B[:, c_], dim=0)
    return out


def implicit_topr(matvec, rmatvec, n1: int, n2: int, r: int,
                  key: torch.Tensor, n_iter: int = 12) -> LowRankFactors:
    """Top-r factors of an (n1, n2) operator given only its products with
    a block of vectors (randomized subspace iteration, ``n_iter`` steps
    from a Gaussian start of r + 8 columns; the paper's footnote 6: never
    materialize the operator)."""
    p = min(n2, r + 8)
    Y = matvec(prng.normal(key, (n2, p)))
    for _ in range(n_iter):
        Q = torch.linalg.qr(Y).Q
        Z = torch.linalg.qr(rmatvec(Q)).Q
        Y = matvec(Z)
    Q = torch.linalg.qr(Y).Q
    Bt = rmatvec(Q)                                    # (n2, p)
    Ub, s, Vt = svd(Bt.T)
    return LowRankFactors(Q @ (Ub[:, :r] * s[:r]), Vt[:r].T)


# ---------------------------------------------------------------------------
# The methods: fn(key, summary, r, *, m, T, use_splits, exact_pair, refine,
# backend, tuning) -> EstimateResult
# ---------------------------------------------------------------------------

def _complete(key, summary, r, values_fn, *, m, T, use_splits):
    """Sample Omega, take the values there, complete with WAltMin."""
    k_sample, k_als = prng.split(key)
    samples = sampling.sample_entries(k_sample, summary.norm_A,
                                      summary.norm_B, m)
    values = values_fn(samples.rows, samples.cols)
    factors = waltmin(k_als, samples, values, summary.n1, summary.n2, r, T,
                      norm_A=summary.norm_A, use_splits=use_splits)
    return EstimateResult(factors, samples, values)


def _rescaled_jl(key, summary, r, *, m, T, use_splits, exact_pair, refine,
                 backend, tuning) -> EstimateResult:
    del exact_pair, refine
    values = _VALUES[backend]
    return _complete(key, summary, r,
                     lambda i, j: values(summary, i, j, tuning),
                     m=m, T=T, use_splits=use_splits)


def _lela_waltmin(key, summary, r, *, m, T, use_splits, exact_pair, refine,
                  backend, tuning) -> EstimateResult:
    del refine, backend, tuning
    if exact_pair is None:
        raise ValueError(
            "method='lela_waltmin' is the two-pass baseline: it needs the "
            "original matrices for its exact second pass — pass "
            "exact_pair=(A, B)")
    A, B = exact_pair
    return _complete(key, summary, r, lambda i, j: exact_entries(A, B, i, j),
                     m=m, T=T, use_splits=use_splits)


def _direct_svd(key, summary, r, *, m, T, use_splits, exact_pair, refine,
                backend, tuning) -> EstimateResult:
    del m, T, use_splits, exact_pair, refine, tuning
    As, Bs = summary.A_sketch, summary.B_sketch
    if backend == "reference":
        U, s, Vt = svd(As.T @ Bs)
        factors = LowRankFactors(U[:, :r] * s[:r], Vt[:r].T)
    else:
        factors = implicit_topr(lambda X: As.T @ (Bs @ X),
                                lambda X: Bs.T @ (As @ X),
                                summary.n1, summary.n2, r, key)
    return EstimateResult(factors, None, None)


def _power(key, summary, r, *, m, T, use_splits, exact_pair, refine,
           backend, tuning) -> EstimateResult:
    """Deterministic given the summary: the randomness already lives in the
    retained co-sketch, so the key is unused."""
    del key, m, T, use_splits, exact_pair, backend, tuning
    return EstimateResult(refinement.refine_factors(summary, r, refine),
                          None, None)


_METHODS = {"rescaled_jl": _rescaled_jl, "lela_waltmin": _lela_waltmin,
            "direct_svd": _direct_svd, "power": _power}

# One entry per (method, backend) cell: fn(key, summary, r, *, m, T,
# use_splits, exact_pair, refine, tuning) -> EstimateResult.
_REGISTRY: Dict[Tuple[str, str], Callable] = {
    (method, backend): functools.partial(fn, backend=backend)
    for method, fn in _METHODS.items() for backend in BACKENDS}


def register_estimator(method: str, backend: str):
    """Register ``fn(key, summary, r, *, m, T, use_splits, exact_pair,
    refine, tuning)`` for one (method, backend) cell (a decorator;
    registering an existing cell replaces it)."""
    def _deco(fn):
        _REGISTRY[(method, backend)] = fn
        return fn
    return _deco


def estimators() -> tuple:
    """All registered (method, backend) cells."""
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def estimate_product(key: torch.Tensor, summary: SketchSummary, r: int, *,
                     method: str = "rescaled_jl", backend: str = "cuda",
                     m: Optional[int] = None, T: int = 10,
                     use_splits: bool = False,
                     exact_pair: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                     refine: Optional[RefineSpec] = None,
                     with_error: bool = False, tuning=None,
                     device="cuda") -> EstimateResult:
    """Rank-r factors of A^T B from a one-pass summary (Alg 1 steps 2-3).

    summary: a ``build_summary`` output, (k, n) sketches and exact norms,
             or a stacked (L, k, n) / (L, n) summary for the batched mode
             (``key`` split per pair, or a stack of L keys).
    method:  'rescaled_jl' | 'lela_waltmin' (needs ``exact_pair=(A, B)``,
             stacked (L, d, n) for a batched summary) | 'direct_svd' |
             'power' (needs a co-sketch; takes ``refine=``).
    backend: 'reference' | 'cuda' (the gather kernel for Eq. 2; implicit
             subspace iteration for direct_svd).
    m:       Omega sample budget; defaults to the paper's ~10 n r log n.
             Ignored by direct_svd and power.
    T:       WAltMin iteration pairs. use_splits: Alg-2 sample splitting.
    refine:  ``RefineSpec(iters, method)`` for method='power' (default
             ``RefineSpec()``, the Tropp reconstruction alone).
    with_error: attach ``error_engine.estimate_error`` of the factors;
             needs ``build_summary(..., probes=p)``.
    tuning:  a ``kernels.tuning.TuningSpec``: the cuda backend launches
             the gather kernel with its ``sampled_dot`` config, if pinned.
    device:  where to run; key, summary and exact_pair are moved there.

    >>> from repro_torch import prng
    >>> from repro_torch.core.summary_engine import build_summary
    >>> key = prng.PRNGKey(0)
    >>> A = prng.normal(key, (128, 12))
    >>> B = prng.normal(prng.fold_in(key, 1), (128, 10))
    >>> summary = build_summary(key, A, B, 32, device="cpu")  # step 1
    >>> res = estimate_product(prng.fold_in(key, 2), summary, r=3,
    ...                        m=400, T=2, device="cpu")      # steps 2-3
    >>> (tuple(res.factors.U.shape), tuple(res.factors.V.shape))
    ((12, 3), (10, 3))
    >>> tuple(res.samples.rows.shape)                       # the Omega sample
    (400,)
    """
    if method not in {cell[0] for cell in _REGISTRY}:
        raise ValueError(
            f"unknown estimation method {method!r} (use one of {METHODS})")
    if (method, backend) not in _REGISTRY:
        raise ValueError(
            f"unknown estimation backend {backend!r} for {method!r} (use "
            f"one of {BACKENDS})")
    if refine is not None and method != "power":
        raise ValueError(
            f"refine= only applies to method='power', got method={method!r}")
    if method == "power":
        refine = RefineSpec() if refine is None else refine
        refinement.validate_refine(refine)
        refinement.require_cosketch(summary)
    if method in ("rescaled_jl", "lela_waltmin"):
        # the Eq. (1) sampler is undefined on a zero factor
        sampling.require_nonzero_norms(summary.norm_A, summary.norm_B)
    if with_error and summary.probes is None:
        raise ValueError(
            "with_error=True needs a probe-carrying summary — build it with "
            "build_summary(..., probes=p)")
    dev = _device.resolve(device)
    key = key.to(dev)
    summary = SketchSummary(*(None if x is None else x.to(dev)
                              for x in summary))
    if exact_pair is not None:
        exact_pair = (exact_pair[0].to(dev), exact_pair[1].to(dev))
    if m is None:
        m = default_m(int(summary.A_sketch.shape[-1]),
                      int(summary.B_sketch.shape[-1]), r)
    fn = _REGISTRY[(method, backend)]
    kw = dict(m=m, T=T, use_splits=use_splits, refine=refine, tuning=tuning)

    def _one(kk, s, pair):
        out = fn(kk, s, r, exact_pair=pair, **kw)
        if with_error:
            from repro_torch.core.error_engine import estimate_error
            out = out._replace(error=estimate_error(s, out.factors))
        return out

    if summary.A_sketch.ndim != 3:
        return _one(key, summary, exact_pair)
    L = summary.A_sketch.shape[0]
    keys = pair_keys(key, L)
    return tree_stack([
        _one(keys[i], tree_index(summary, i),
             None if exact_pair is None else
             (exact_pair[0][i], exact_pair[1][i]))
        for i in range(L)])


def estimation_stage(spec, key: torch.Tensor, summary: SketchSummary, r: int,
                     *, exact_pair: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None,
                     refine: Optional[RefineSpec] = None,
                     with_error: bool = False, tuning=None) -> EstimateResult:
    """Steps 2-3 driven by a declarative spec, on the summary's device.

    ``spec`` is any object with the ``EstimationSpec`` fields (method,
    backend, m, T, use_splits); ``core.pipeline`` owns the concrete type.
    ``refine`` rides the plan (``PipelinePlan.refine``), not the spec.
    ``tuning`` pins the gather kernel's config (the ``PipelineEngine``
    passes the one it resolved when it built its cache entry).
    """
    return estimate_product(key, summary, r, method=spec.method,
                            backend=spec.backend, m=spec.m, T=spec.T,
                            use_splits=spec.use_splits, exact_pair=exact_pair,
                            refine=refine, with_error=with_error,
                            tuning=tuning, device=summary.A_sketch.device)
