"""Algorithm 1: SMP-PCA, Streaming Matrix Product PCA, end to end.

A thin preset over the PipelineEngine: ``smppca`` builds the declarative
``pipeline.smppca_plan`` (the step-1 sketch spec and the steps-2/3
estimation spec under the ``split(key, 3)`` layout) and runs it through the
shared engine, whose cache entry for (plan, signature) is built once. The
key derivations are the JAX package's ``smppca``:

    k_sketch, k_sample, _ = split(key, 3)
    summary = build_summary(k_sketch, A, B, k)                 (step 1)
    result  = estimate_product(fold_in(k_sample, 0), summary)  (steps 2-3)

so for the same key it draws the same projection and the same sample as
``repro.core.smppca``.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.core import estimation_engine, pipeline
from repro_torch.core.linalg import spectral_norm, svd
from repro_torch.core.types import LowRankFactors, SketchSummary, SMPPCAResult


def smppca(key: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *, r: int,
           k: int, m: int, T: int = 10, method: str = "gaussian",
           backend: str = "cuda", block: int = 1024,
           est_backend: str = "cuda", precision: str | None = None,
           use_splits: bool = False, device="cuda") -> SMPPCAResult:
    """Single-pass rank-r PCA of A^T B. A: (d, n1), B: (d, n2).

    ``method`` picks the sketch ('gaussian' or 'srht'); ``backend`` runs
    step 1 ('cuda': the fused sketch kernel or the blocked FWHT, 'scan',
    'rows' or 'reference': plain PyTorch; ``block`` is the scan's row
    block); ``est_backend`` computes the Eq. (2) values ('cuda': the gather
    kernel, 'reference'). ``device`` is CUDA unless the caller asks for the
    CPU, where the kernels' plain versions run. Both stages run as one
    cached plan (``pipeline.get_engine()``)."""
    dev = _device.resolve(device)
    plan = pipeline.smppca_plan(
        r=r, k=k, m=m, T=T, method=method, backend=backend, block=block,
        precision=precision, est_backend=est_backend, use_splits=use_splits)
    res = pipeline.get_engine().run(plan, key.to(dev), A.to(dev), B.to(dev))
    return SMPPCAResult(res.estimate.factors, res.summary,
                        res.estimate.samples, res.estimate.values)


def smppca_from_summary(key: torch.Tensor, summary: SketchSummary, *, r: int,
                        m: int, T: int = 10, est_backend: str = "cuda",
                        use_splits: bool = False,
                        device="cuda") -> SMPPCAResult:
    """Steps 2-3 given a one-pass summary; ``key`` is the estimation key."""
    est = estimation_engine.estimate_product(
        key, summary, r, method="rescaled_jl", backend=est_backend, m=m, T=T,
        use_splits=use_splits, device=device)
    return SMPPCAResult(est.factors, summary, est.samples, est.values)


# ---------------------------------------------------------------------------
# Evaluation helpers (small n: they form A^T B densely)
# ---------------------------------------------------------------------------

def spectral_error(A: torch.Tensor, B: torch.Tensor,
                   factors: LowRankFactors) -> torch.Tensor:
    """|| A^T B - U V^T ||_2 / || A^T B ||_2."""
    M = A.T @ B
    return spectral_norm(M - factors.U @ factors.V.T) / spectral_norm(M)


def spectral_error_vs_optimal(A: torch.Tensor, B: torch.Tensor, r: int,
                              factors: LowRankFactors):
    """(algorithm error, optimal rank-r error), both relative spectral norm."""
    M = A.T @ B
    nM = spectral_norm(M)
    U, s, Vt = svd(M)
    Mr = (U[:, :r] * s[:r]) @ Vt[:r]
    return (spectral_norm(M - factors.U @ factors.V.T) / nM,
            spectral_norm(M - Mr) / nM)
