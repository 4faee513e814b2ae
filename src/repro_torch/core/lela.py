"""LELA [Bhojanapalli, Jain, Sanghavi, SODA'15]: the two-pass baseline.

Pass 1: the column norms of A and B (``norms_only_summary``). Pass 2: the
exact entries A_i^T B_j on the Omega sampled by Eq. (1). Then the same
WAltMin completion as SMP-PCA. SMP-PCA replaces pass 2 with the rescaled-JL
estimate; comparing the two isolates the cost of sketching (the eta
sigma_r^* term of Thm 3.1).

A thin preset over the PipelineEngine: ``lela`` runs ``pipeline.lela_plan``
(a sketch-free ``norms_only`` first stage and ``method='lela_waltmin'``
estimation fed the original pair as its exact second pass) through the
shared engine. Under the ``'direct'`` key layout the caller's key goes
straight to estimation, so for the same key it draws the same sample as
``repro.core.lela.lela``.
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.core import pipeline
from repro_torch.core.summary_engine import norms_only_summary
from repro_torch.core.types import LowRankFactors

__all__ = ["lela", "norms_only_summary"]


def lela(key: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *, r: int,
         m: int, T: int = 10, use_splits: bool = False,
         device="cuda") -> LowRankFactors:
    """LELA: biased sample, exact entries, WAltMin. A: (d, n1), B: (d,
    n2), moved to ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    plan = pipeline.lela_plan(r=r, m=m, T=T, use_splits=use_splits)
    return pipeline.get_engine().run(plan, key.to(dev), A.to(dev),
                                     B.to(dev)).estimate.factors
