"""Result types of SMP-PCA, as NamedTuples of tensors.

Field for field the counterparts of ``repro.core.types``: a summary, sample
or set of factors converts between the two packages through
``repro_torch.convert`` without renaming anything.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.linalg import sqrt_f32


class SketchSummary(NamedTuple):
    """One-pass summary of (A, B), Algorithm 1 step 1.

    A: (d, n1), B: (d, n2); the sketches are ``Pi @ A`` (k, n1) and
    ``Pi @ B`` (k, n2), and the exact column norms are the side information
    the rescaled-JL estimator needs. ``build_summary(..., probes=p)`` adds
    the held-out probe block ``(A^T B) @ Omega`` and its test columns
    (``core/error_engine.py``); ``cosketch=s`` adds Tropp's range and
    co-range pair (Y, W) and their test matrices (``core/refinement.py``).
    Without them those fields are None.
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
        return sqrt_f32(torch.sum(self.norm_A ** 2))

    @property
    def frob_B(self) -> torch.Tensor:
        """Frobenius norm of B (from the retained column norms)."""
        return sqrt_f32(torch.sum(self.norm_B ** 2))

    @property
    def n_probes(self) -> int:
        """Held-out probe count p (0 when no probe block was retained)."""
        return 0 if self.probes is None else self.probes.shape[-1]

    @property
    def n_cosketch(self) -> int:
        """Co-sketch width s (0 when no refinement block was retained)."""
        return 0 if self.cosketch_Y is None else self.cosketch_Y.shape[-1]


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


class ErrorEstimate(NamedTuple):
    """A-posteriori quality estimate of rank-r factors (``error_engine``).

    Each of the p held-out probe columns retained in the summary gives one
    unbiased sample of the squared Frobenius residual ``||A^T B - U
    V^T||_F^2``; the fields are their mean, a normal-approximation
    confidence interval over the p samples, a spectral-norm proxy and the
    residual relative to the estimated ``||A^T B||_F``. Every field is a
    0-d float32 tensor ((L,) for a batched estimate).
    """

    frob_est: torch.Tensor       # sqrt of the unbiased mean squared residual
    frob_sq_est: torch.Tensor    # unbiased estimate of ||A^T B - U V^T||_F^2
    frob_lo: torch.Tensor        # lower confidence bound
    frob_hi: torch.Tensor        # upper confidence bound
    spectral_est: torch.Tensor   # max_j ||R w_j|| / ||w_j||
    rel_est: torch.Tensor        # frob_est / estimated ||A^T B||_F


class EstimateResult(NamedTuple):
    """Steps 2-3 output of ``estimate_product``: the factors, the Omega
    sample and the estimated entries on it (both None for the methods that
    do not sample), and the a-posteriori ``ErrorEstimate`` when asked for
    with ``with_error=True``."""

    factors: LowRankFactors
    samples: Optional[SampleSet]
    values: Optional[torch.Tensor]   # (m,) estimated entries on Omega
    error: Optional[ErrorEstimate] = None


class SMPPCAResult(NamedTuple):
    """Full Algorithm-1 output: factors plus the intermediates."""

    factors: LowRankFactors
    summary: SketchSummary
    samples: SampleSet
    sampled_values: torch.Tensor     # (m,) rescaled-JL estimates on Omega


def tree_index(tree, i: int):
    """The i-th pair of a batched result: each tensor of a (nested)
    NamedTuple indexed along its leading axis; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return type(tree)(*(tree_index(x, i) for x in tree))


def tree_stack(trees):
    """Stack per-pair results of one (nested) NamedTuple type along a new
    leading axis, the batched layout; None fields stay None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(tree_stack(list(xs)) for xs in zip(*trees)))


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples (NamedTuples included)
    in ``jax.tree.leaves``' order: dict keys sorted, None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        children = [tree[key] for key in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        children = list(tree)
    else:
        return [tree]
    return [leaf for child in children for leaf in tree_leaves(child)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in
    ``tree_leaves``' order (the inverse of ``tree_leaves``)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            # sorted keys first, so the leaves come in their flat order
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            items = [build(child) for child in node]
            if isinstance(node, list):
                return items
            return type(node)(*items) if hasattr(node, "_fields") \
                else tuple(items)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
