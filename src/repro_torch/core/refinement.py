"""RefinementEngine: Tropp's co-sketch reconstruction and sketch-power
iterations, without another pass over the data.

* Tropp et al. (1609.00048): the summary may retain a co-sketch, the range
  and co-range pair

      Y = (A^T B) @ Omega_c          (n1, s)   range sketch
      W = Psi_c @ (A^T B)            (l, n2)   co-range sketch, l = 2s + 1

  with Gaussian test matrices ``Omega_c`` (n2, s) and ``Psi_c`` (l, n1)
  drawn from the summary key. Both are sums over the rows of (A, B), so
  they ride the same single pass as the sketches. The reconstruction is
  Tropp's Algorithm 7: ``Q = qr(Y)``, ``X = (Psi_c Q)^+ W``, ``A^T B ~=
  Q X``.
* Sketch-power iterations (Chang & Yang): subspace-iterate the basis
  against the rescaled sketch product ``M~ = D_A (A~^T B~) D_B`` before the
  same reconstruction. ``M~`` is formed densely (n1, n2).

``RefineSpec(iters, method)`` selects the stage: 'tropp' is the (Y, W)
reconstruction alone, 'power' prepends ``iters`` sketch-power iterations.

Randomness contract, that of ``repro.core.refinement``: the test matrices
come from ``fold_in(fold_in(key, "csk!"), 0 | 1)`` (0: Omega_c, 1: Psi_c).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core import estimator
from repro_torch.core.error_engine import dot_f32, row_blocks
from repro_torch.core.linalg import svd
from repro_torch.core.summary_engine import _cast
from repro_torch.core.types import LowRankFactors, SketchSummary

# "csk!": the reserved fold tag of the co-sketch key subtree
_COSKETCH_TAG = 0x63736B21

# sub-indices under the tag fold: Omega_c (range test) / Psi_c (co-range)
_OMEGA_SUB = 0
_PSI_SUB = 1

REFINE_METHODS = ("tropp", "power")


class RefineSpec(NamedTuple):
    """How to rebuild factors from the retained co-sketch block:
    ``method='tropp'``, the (Y, W) reconstruction alone (``iters`` is
    ignored); ``method='power'``, ``iters`` sketch-power iterations against
    the rescaled sketch product first."""

    iters: int = 0
    method: str = "tropp"


def validate_refine(refine: RefineSpec) -> None:
    """Reject a malformed RefineSpec."""
    if not isinstance(refine, RefineSpec):
        raise TypeError(
            f"expected a RefineSpec, got {type(refine).__name__}")
    if refine.method not in REFINE_METHODS:
        raise ValueError(f"unknown refinement method {refine.method!r} "
                         f"(use one of {REFINE_METHODS})")
    if isinstance(refine.iters, bool) or not isinstance(refine.iters, int) \
            or refine.iters < 0:
        raise ValueError(
            f"RefineSpec.iters must be a non-negative int, "
            f"got {refine.iters!r}")


# ---------------------------------------------------------------------------
# The co-sketch block (single-pass accumulation)
# ---------------------------------------------------------------------------

def cosketch_key(key: torch.Tensor) -> torch.Tensor:
    """The reserved co-sketch subtree of the summary key."""
    return prng.fold_in(key, _COSKETCH_TAG)


def cosketch_omega(key: torch.Tensor, n2: int, s: int) -> torch.Tensor:
    """(n2, s) Gaussian range test matrix Omega_c."""
    return prng.normal(prng.fold_in(cosketch_key(key), _OMEGA_SUB), (n2, s))


def cosketch_width(s: int) -> int:
    """Co-range rows l for a width-s range sketch: Tropp's l = 2s + 1,
    which keeps the least-squares solve ``(Psi_c Q) X = W`` overdetermined
    and well conditioned."""
    return 2 * s + 1


def cosketch_psi(key: torch.Tensor, n1: int, s: int) -> torch.Tensor:
    """(l, n1) Gaussian co-range test matrix Psi_c, l = cosketch_width(s)."""
    return prng.normal(prng.fold_in(cosketch_key(key), _PSI_SUB),
                       (cosketch_width(s), n1))


def cosketch_contribution(omega: torch.Tensor, psi: torch.Tensor,
                          A_chunk: torch.Tensor, B_chunk: torch.Tensor,
                          precision: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One row chunk's (dY, dW): ``A_chunk^T (B_chunk @ Omega_c)`` (n1, s)
    and ``(Psi_c @ A_chunk^T) B_chunk`` (l, n2), float32. Each intermediate
    is accumulated in float32 and rounded once to the inputs' dtype before
    its second product, as in the JAX package."""
    Ac, Bc = _cast(A_chunk, precision), _cast(B_chunk, precision)
    Bw = dot_f32(Bc, _cast(omega, precision).to(Bc.dtype))
    dY = dot_f32(Ac.T, Bw.to(Ac.dtype))
    pA = dot_f32(_cast(psi, precision).to(Ac.dtype), Ac.T)
    dW = dot_f32(pA.to(Bc.dtype), Bc)
    return dY, dW


def cosketch_pass(omega: torch.Tensor, psi: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, *, block: int = 1024,
                  precision: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Y, W) over the whole pair, summed over ``block``-row blocks in
    order (the probe pass's block structure)."""
    Y = torch.zeros((A.shape[1], omega.shape[1]), dtype=torch.float32,
                    device=A.device)
    W = torch.zeros((psi.shape[0], B.shape[1]), dtype=torch.float32,
                    device=A.device)
    for Ab, Bb in row_blocks(A, B, block):
        dY, dW = cosketch_contribution(omega, psi, Ab, Bb, precision)
        Y, W = Y + dY, W + dW
    return Y, W


def attach_cosketch(summary: SketchSummary, key: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, s: int, *,
                    block: int = 1024,
                    precision: Optional[str] = None) -> SketchSummary:
    """Retain an s-column co-sketch on a summary: the stage
    ``build_summary(..., cosketch=s)`` runs after any backend.

    >>> from repro_torch import prng
    >>> key = prng.PRNGKey(0)
    >>> A = prng.normal(key, (64, 6))
    >>> B = prng.normal(prng.fold_in(key, 1), (64, 4))
    >>> from repro_torch.core.summary_engine import build_summary
    >>> s = build_summary(key, A, B, 8, cosketch=3, device="cpu")
    >>> (tuple(s.cosketch_Y.shape), tuple(s.cosketch_W.shape))  # l = 2s + 1
    ((6, 3), (7, 4))
    >>> (tuple(s.cosketch_omega.shape), tuple(s.cosketch_psi.shape))
    ((4, 3), (7, 6))
    """
    omega = cosketch_omega(key, B.shape[-1], s)
    psi = cosketch_psi(key, A.shape[-1], s)
    Y, W = cosketch_pass(omega, psi, A, B, block=block, precision=precision)
    return summary._replace(cosketch_Y=Y, cosketch_W=W,
                            cosketch_omega=omega, cosketch_psi=psi)


def merge_cosketch(a: Optional[torch.Tensor],
                   b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Combine two co-sketch blocks (Y with Y, W with W) over disjoint row
    sets: a plain sum. Presence must agree on both operands."""
    if (a is None) != (b is None):
        raise ValueError(
            "cannot merge a cosketch-carrying summary with a cosketch-free "
            "one (build both with the same cosketch=)")
    return None if a is None else a + b


def require_cosketch(summary: SketchSummary) -> None:
    """Reject summaries without the retained (Y, W) pair."""
    if summary.cosketch_Y is None or summary.cosketch_W is None or \
            summary.cosketch_psi is None:
        raise ValueError(
            "summary carries no co-sketch block — build it with "
            "build_summary(..., cosketch=s) to enable sketch-power/Tropp "
            "refinement (estimate_product(method='power') / "
            "rank_curve(refine=...))")


# ---------------------------------------------------------------------------
# Refined factorization
# ---------------------------------------------------------------------------

def refined_svd(summary: SketchSummary, refine: RefineSpec, r_max: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, s, Vt) of the Tropp reconstruction, truncated to ``r_max``:
    ``Q = qr(Y)`` (after ``iters`` QR-orthonormalized sketch-power steps
    ``Q <- qr(M~ M~^T Q)`` for method 'power'), ``X = lstsq(Psi_c Q, W)``,
    then the SVD of X rotated back through Q. All in float32."""
    Y = summary.cosketch_Y.float()
    W = summary.cosketch_W.float()
    psi = summary.cosketch_psi.float()
    Q = torch.linalg.qr(Y).Q
    if refine.method == "power" and refine.iters > 0:
        M = estimator.rescaled_matrix(summary).float()
        for _ in range(refine.iters):
            Q = torch.linalg.qr(M @ (M.T @ Q)).Q
    X = torch.linalg.lstsq(psi @ Q, W).solution          # (q, n2)
    Ub, sv, Vt = svd(X)
    U = Q @ Ub
    return U[:, :r_max], sv[:r_max], Vt[:r_max]


def refine_factors(summary: SketchSummary, r: int,
                   refine: RefineSpec) -> LowRankFactors:
    """Rank-r factors of A^T B from the refined reconstruction.

    >>> import torch
    >>> from repro_torch import prng
    >>> from repro_torch.core.summary_engine import build_summary
    >>> key = prng.PRNGKey(0)
    >>> W0, _ = torch.linalg.qr(prng.normal(key, (256, 10)))
    >>> M = prng.normal(prng.fold_in(key, 1), (10, 8))
    >>> A, B = W0, W0 @ M                       # A^T B == M exactly
    >>> s = build_summary(key, A, B, 32, cosketch=8, device="cpu")
    >>> f = refine_factors(s, 3, RefineSpec(iters=1, method='power'))
    >>> (tuple(f.U.shape), tuple(f.V.shape))
    ((10, 3), (8, 3))
    """
    require_cosketch(summary)
    U, sv, Vt = refined_svd(summary, refine, r)
    return LowRankFactors(U * sv, Vt.T)
