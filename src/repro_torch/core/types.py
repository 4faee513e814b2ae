"""Result types of SMP-PCA, as NamedTuples of tensors.

Field for field the counterparts of ``repro.core.types``: a summary, sample
or set of factors converts between the two packages through
``repro_torch.convert`` without renaming anything.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SketchSummary(NamedTuple):
    """One-pass summary of (A, B), Algorithm 1 step 1.

    A: (d, n1), B: (d, n2); the sketches are ``Pi @ A`` (k, n1) and
    ``Pi @ B`` (k, n2), and the exact column norms are the side information
    the rescaled-JL estimator needs. The probe and co-sketch blocks of the
    JAX summary are carried as fields so that the two types line up; this
    package does not build them yet and leaves them None.
    """

    A_sketch: torch.Tensor        # (k, n1) = Pi @ A
    B_sketch: torch.Tensor        # (k, n2) = Pi @ B
    norm_A: torch.Tensor          # (n1,)  exact column L2 norms of A
    norm_B: torch.Tensor          # (n2,)  exact column L2 norms of B
    probes: Optional[torch.Tensor] = None
    probe_omega: Optional[torch.Tensor] = None
    cosketch_Y: Optional[torch.Tensor] = None
    cosketch_W: Optional[torch.Tensor] = None
    cosketch_omega: Optional[torch.Tensor] = None
    cosketch_psi: Optional[torch.Tensor] = None

    @property
    def k(self) -> int:
        """Sketch size (rows of the sketches)."""
        return self.A_sketch.shape[0]

    @property
    def n1(self) -> int:
        """Columns of A."""
        return self.A_sketch.shape[1]

    @property
    def n2(self) -> int:
        """Columns of B."""
        return self.B_sketch.shape[1]

    @property
    def frob_A(self) -> torch.Tensor:
        """Frobenius norm of A (from the retained column norms)."""
        return torch.sqrt(torch.sum(self.norm_A ** 2))

    @property
    def frob_B(self) -> torch.Tensor:
        """Frobenius norm of B (from the retained column norms)."""
        return torch.sqrt(torch.sum(self.norm_B ** 2))


class SampleSet(NamedTuple):
    """A COO sample of entries of the (n1 x n2) product matrix.

    ``rows``/``cols`` index A's and B's columns (int32, as in the JAX
    package). ``q_hat`` is min(1, q_ij), whose inverse weights the
    completion; ``mask`` marks the valid entries.
    """

    rows: torch.Tensor            # (m,) int32
    cols: torch.Tensor            # (m,) int32
    q_hat: torch.Tensor           # (m,) float32
    mask: torch.Tensor            # (m,) bool

    @property
    def m(self) -> int:
        """Sample budget (length of the COO arrays)."""
        return self.rows.shape[0]


class LowRankFactors(NamedTuple):
    """Rank-r approximation in factored form: M_hat = U @ V^T."""

    U: torch.Tensor               # (n1, r)
    V: torch.Tensor               # (n2, r)

    @property
    def r(self) -> int:
        """Factor rank."""
        return self.U.shape[1]

    def dense(self) -> torch.Tensor:
        """Materialize the (n1, n2) approximation U @ V^T."""
        return self.U @ self.V.T


class EstimateResult(NamedTuple):
    """Steps 2-3 output of ``estimate_product``: the factors, the Omega
    sample and the estimated entries on it."""

    factors: LowRankFactors
    samples: Optional[SampleSet]
    values: Optional[torch.Tensor]   # (m,) estimated entries on Omega


class SMPPCAResult(NamedTuple):
    """Full Algorithm-1 output: factors plus the intermediates."""

    factors: LowRankFactors
    summary: SketchSummary
    samples: SampleSet
    sampled_values: torch.Tensor     # (m,) rescaled-JL estimates on Omega
