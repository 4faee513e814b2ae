"""Step 2b of SMP-PCA: the rescaled JL estimator (Eq. 2).

    M~(i,j) = ||A_i|| * ||B_j|| * <A~_i, B~_j> / (||A~_i|| * ||B~_j||)

The sketched angle, rescaled by the exact column norms carried from the
single pass. Compact form: D_A (A~^T B~) D_B with D_A = diag(||A_i||/||A~_i||)
and D_B = diag(||B_j||/||B~_j||) (Appendix B).
"""
from __future__ import annotations

import torch

from repro_torch.core.linalg import sqrt_f32
from repro_torch.core.types import SketchSummary

_EPS = 1e-12


def rescaled_entries(summary: SketchSummary, rows: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
    """M~ at (rows, cols), O(m k), in plain PyTorch; ``kernels/sampled_dot``
    is the CUDA kernel for the same values."""
    Ai = summary.A_sketch[:, rows]              # (k, m)
    Bj = summary.B_sketch[:, cols]              # (k, m)
    dots = torch.sum(Ai * Bj, dim=0)            # (m,)
    sa = sqrt_f32(torch.sum(Ai ** 2, dim=0))
    sb = sqrt_f32(torch.sum(Bj ** 2, dim=0))
    scale = (summary.norm_A[rows] * summary.norm_B[cols]) / \
        torch.clamp(sa * sb, min=_EPS)
    return dots * scale


def plain_jl_entries(summary: SketchSummary, rows: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
    """The naive estimator <A~_i, B~_j> the paper improves upon (Fig 2a)."""
    return torch.sum(summary.A_sketch[:, rows] * summary.B_sketch[:, cols],
                     dim=0)


def rescaled_matrix(summary: SketchSummary) -> torch.Tensor:
    """Dense M~ = D_A (A~^T B~) D_B. Small-n tests only."""
    sa = sqrt_f32(torch.sum(summary.A_sketch ** 2, dim=0))
    sb = sqrt_f32(torch.sum(summary.B_sketch ** 2, dim=0))
    da = summary.norm_A / torch.clamp(sa, min=_EPS)
    db = summary.norm_B / torch.clamp(sb, min=_EPS)
    return (summary.A_sketch.T @ summary.B_sketch) * da[:, None] * db[None, :]
