"""Algorithm 1: SMP-PCA, Streaming Matrix Product PCA, end to end.

``smppca`` composes the two engines directly, under the JAX package's
``smppca`` key layout (``repro.core.pipeline.derive_keys('smppca')``):

    k_sketch, k_sample, _ = split(key, 3)
    summary = build_summary(k_sketch, A, B, k)                 (step 1)
    result  = estimate_product(fold_in(k_sample, 0), summary)  (steps 2-3)

so for the same key it draws the same projection and the same sample as
``repro.core.smppca``. There is no compile-once pipeline cache yet.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core import estimation_engine, summary_engine
from repro_torch.core.linalg import svd
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
    CPU, where the kernels' plain versions run."""
    dev = _device.resolve(device)
    key = key.to(dev)
    k_sketch, k_sample, _ = prng.split(key, 3)
    summary = summary_engine.build_summary(
        k_sketch, A, B, k, method=method, backend=backend, block=block,
        precision=precision, device=dev)
    return smppca_from_summary(prng.fold_in(k_sample, 0), summary, r=r, m=m,
                               T=T, est_backend=est_backend,
                               use_splits=use_splits, device=dev)


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
    err = torch.linalg.matrix_norm(M - factors.U @ factors.V.T, ord=2)
    return err / torch.linalg.matrix_norm(M, ord=2)


def spectral_error_vs_optimal(A: torch.Tensor, B: torch.Tensor, r: int,
                              factors: LowRankFactors):
    """(algorithm error, optimal rank-r error), both relative spectral norm."""
    M = A.T @ B
    nM = torch.linalg.matrix_norm(M, ord=2)
    U, s, Vt = svd(M)
    Mr = (U[:, :r] * s[:r]) @ Vt[:r]
    return (torch.linalg.matrix_norm(M - factors.U @ factors.V.T, ord=2) / nM,
            torch.linalg.matrix_norm(M - Mr, ord=2) / nM)
