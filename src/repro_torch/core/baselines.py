"""Baselines the paper compares against (Figs 3(b), 4(b), 4(c); Table 1).

* ``optimal_rank_r``: truncated SVD of the exact product (the "Optimal"
  rows).
* ``sketch_svd``: SVD(A~^T B~), sketch both matrices, then the top-r SVD of
  the product of the sketches (by default without forming it: implicit
  subspace iteration, footnote 6). The straightforward one-pass idea that
  SMP-PCA beats.
* ``product_of_pcas``: A_r^T B_r (the Fig 4(c) failure mode), a rank-r PCA
  of each matrix alone, then their product.

``sketch_svd`` is a thin preset over the PipelineEngine
(``pipeline.sketch_svd_plan``) under the JAX package's ``'sketch_svd'`` key
layout (``k_sketch, k_pow = split(key)``), so for the same key it draws
what ``repro.core.baselines.sketch_svd`` draws. ``optimal_rank_r`` and
``product_of_pcas`` run outside the engine, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core import pipeline
from repro_torch.core.estimation_engine import implicit_topr
from repro_torch.core.linalg import svd
from repro_torch.core.types import LowRankFactors


def optimal_rank_r(A: torch.Tensor, B: torch.Tensor, r: int,
                   device="cuda") -> LowRankFactors:
    """Oracle: exact top-r SVD of the dense product A^T B (n1, n2)."""
    dev = _device.resolve(device)
    U, s, Vt = svd(A.to(dev).T @ B.to(dev))
    return LowRankFactors(U[:, :r] * s[:r], Vt[:r].T)


def sketch_svd(key: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
               r: int, k: int, method: str = "gaussian",
               backend: str = "cuda", est_backend: str = "cuda",
               device="cuda") -> LowRankFactors:
    """SVD(A~^T B~): ``build_summary(k_sketch, A, B, k, method, backend)``,
    then ``estimate_product(k_pow, ..., method='direct_svd',
    backend=est_backend)``, as one cached plan
    (``pipeline.sketch_svd_plan``)."""
    dev = _device.resolve(device)
    plan = pipeline.sketch_svd_plan(r=r, k=k, method=method, backend=backend,
                                    est_backend=est_backend)
    return pipeline.get_engine().run(plan, key.to(dev), A.to(dev),
                                     B.to(dev)).estimate.factors


def product_of_pcas(key: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    r: int, device="cuda") -> LowRankFactors:
    """A_r^T B_r: what two independent streaming-PCA runs give. With A_r =
    U_A S_A V_A^T, A_r^T B_r = V_A S_A (U_A^T U_B) S_B V_B^T."""
    dev = _device.resolve(device)
    A, B = A.to(dev), B.to(dev)
    kA, kB = prng.split(key.to(dev))
    d, n1 = A.shape
    Ar = implicit_topr(lambda X: A @ X, lambda X: A.T @ X, d, n1, r, kA)
    Br = implicit_topr(lambda X: B @ X, lambda X: B.T @ X, d, B.shape[1], r,
                       kB)
    core = Ar.U.T @ Br.U                      # (r, r)
    return LowRankFactors(Ar.V @ core, Br.V)
