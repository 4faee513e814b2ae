"""ErrorEngine: a-posteriori quality of the factors from held-out probes.

Following Tropp et al., "Practical sketching algorithms for low-rank matrix
approximation" (1609.00048), the summary may retain ``p`` held-out probe
columns

    probes = (A^T B) @ Omega,    Omega (n2, p) standard Gaussian,

summed over the rows in the same single pass (``probes = sum_rows
A_row^T (B_row Omega)``), and use them after estimation:

* ``estimate_error(summary, factors)``: for Gaussian ``w``,
  ``E ||(M - U V^T) w||^2 = ||M - U V^T||_F^2``, so the p probes give an
  unbiased Frobenius-residual estimate with a confidence interval, and a
  spectral-norm proxy ``max_j ||R w_j|| / ||w_j||``;
* ``adaptive_rank(summary, tol, r_max)``: the smallest rank whose estimated
  relative error meets ``tol``, from ONE factorization and ONE probe
  projection (the per-rank error curve is a cumulative sum).

Randomness contract, that of ``repro.core.error_engine``: ``Omega`` is
``normal(fold_in(fold_in(key, "prob"), "e!"), (n2, p))``, a two-level fold
that no per-row ``fold_in(key, i)`` can reach, so every backend and every
block size sees the same probes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import prng
from repro_torch.core import estimator
from repro_torch.core.linalg import svd, sqrt_f32
from repro_torch.core.summary_engine import _cast, _pad_rows
from repro_torch.core.types import ErrorEstimate, LowRankFactors, SketchSummary

# "prob"/"e!": the two-level fold that reserves the probe key subtree
_PROBE_TAG_0 = 0x70726F62
_PROBE_TAG_1 = 0x6521

_EPS = 1e-12

# 97.5% normal quantile: the default two-sided 95% confidence interval
_Z95 = 1.959964


# ---------------------------------------------------------------------------
# The probe block (single-pass accumulation)
# ---------------------------------------------------------------------------

def probe_key(key: torch.Tensor) -> torch.Tensor:
    """The reserved probe subtree of the summary key (two-level fold)."""
    return prng.fold_in(prng.fold_in(key, _PROBE_TAG_0), _PROBE_TAG_1)


def probe_omega(key: torch.Tensor, n2: int, p: int) -> torch.Tensor:
    """(n2, p) standard-Gaussian held-out probes, a pure function of the
    summary key, on the key's device."""
    return prng.normal(probe_key(key), (n2, p))


def dot_f32(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``X @ Y`` accumulated in float32 whatever the input dtype, as
    ``dot_general(..., preferred_element_type=float32)``: products of
    bfloat16 values are exact in float32, so multiplying the upcast values
    is bf16-in, f32-accumulate. On float32 inputs the casts are no-ops."""
    return X.float() @ Y.float()


def probe_contribution(omega: torch.Tensor, A_chunk: torch.Tensor,
                       B_chunk: torch.Tensor,
                       precision: Optional[str] = None) -> torch.Tensor:
    """One row chunk's probe summand ``A_chunk^T (B_chunk @ omega)``, (n1,
    p) float32. The intermediate ``B_chunk @ omega`` is accumulated in
    float32 and rounded once to the inputs' dtype before the second
    product, as in the JAX package."""
    Ac, Bc = _cast(A_chunk, precision), _cast(B_chunk, precision)
    Bw = dot_f32(Bc, _cast(omega, precision).to(Bc.dtype))
    return dot_f32(Ac.T, Bw.to(Ac.dtype))


def row_blocks(A: torch.Tensor, B: torch.Tensor, block: int):
    """(A rows, B rows) ``block`` at a time, the last block padded with
    zero rows: the block structure of the JAX package's ``lax.scan`` over
    a zero-padded pair, without padding all of A and B."""
    for lo in range(0, A.shape[0], block):
        yield (_pad_rows(A[lo:lo + block], block),
               _pad_rows(B[lo:lo + block], block))


def probe_pass(omega: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
               block: int = 1024,
               precision: Optional[str] = None) -> torch.Tensor:
    """(n1, p) probe block over the whole pair, summed over ``block``-row
    blocks in order (the JAX package's scan), so a stream ingested in
    chunks of ``block`` rows adds the same terms in the same order."""
    acc = torch.zeros((A.shape[1], omega.shape[1]), dtype=torch.float32,
                      device=A.device)
    for Ab, Bb in row_blocks(A, B, block):
        acc = acc + probe_contribution(omega, Ab, Bb, precision)
    return acc


def attach_probes(summary: SketchSummary, key: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, p: int, *, block: int = 1024,
                  precision: Optional[str] = None) -> SketchSummary:
    """Retain ``p`` held-out probes on a summary: the stage
    ``build_summary(..., probes=p)`` runs after any backend."""
    omega = probe_omega(key, B.shape[-1], p)
    return summary._replace(
        probes=probe_pass(omega, A, B, block=block, precision=precision),
        probe_omega=omega)


def merge_probes(a: Optional[torch.Tensor],
                 b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Combine two probe blocks over disjoint row sets: a plain sum.
    Presence must agree on both operands."""
    if (a is None) != (b is None):
        raise ValueError("cannot merge a probe-carrying summary with a "
                         "probe-free one (build both with the same probes=)")
    return None if a is None else a + b


# ---------------------------------------------------------------------------
# A-posteriori error estimation
# ---------------------------------------------------------------------------

def _require_probes(summary: SketchSummary) -> None:
    if summary.probes is None or summary.probe_omega is None:
        raise ValueError(
            "summary carries no probe block — build it with "
            "build_summary(..., probes=p) to enable a-posteriori error "
            "estimation")


def estimate_error(summary: SketchSummary, factors: LowRankFactors, *,
                   confidence: float = 0.95) -> ErrorEstimate:
    """Unbiased a-posteriori residual estimate of ``A^T B ~= U V^T``.

    Each probe ``w_j`` gives one unbiased sample ``||probes_j - U (V^T
    w_j)||^2`` of the squared Frobenius residual: the estimate is their
    mean, the interval a normal approximation over the p samples (sample
    std, ddof=1; one probe gives [0, inf)), and the spectral proxy ``max_j
    ||R w_j|| / ||w_j||`` a lower-bound estimator of ``||R||_2``.

    >>> import torch
    >>> from repro_torch import prng
    >>> from repro_torch.core.summary_engine import build_summary
    >>> from repro_torch.core.estimation_engine import estimate_product
    >>> key = prng.PRNGKey(0)
    >>> A = prng.normal(key, (256, 20))
    >>> B = prng.normal(prng.fold_in(key, 1), (256, 16))
    >>> s = build_summary(key, A, B, 64, probes=16, device="cpu")
    >>> tuple(s.probes.shape), tuple(s.probe_omega.shape)   # 16 probes
    ((20, 16), (16, 16))
    >>> res = estimate_product(prng.fold_in(key, 2), s, r=4, m=600, T=3,
    ...                        device="cpu")
    >>> err = estimate_error(s, res.factors)
    >>> true = float(torch.linalg.norm(A.T @ B - res.factors.dense()))
    >>> bool(0.5 * true < float(err.frob_est) < 2.0 * true)
    True
    >>> bool(err.frob_lo <= err.frob_est <= err.frob_hi)
    True
    """
    _require_probes(summary)
    probes, omega = summary.probes, summary.probe_omega
    p = probes.shape[-1]
    resid = probes - factors.U @ (factors.V.T @ omega)         # (n1, p)
    sq = torch.sum(resid.float() ** 2, dim=0)                  # (p,)
    frob_sq = torch.mean(sq)
    z = _Z95 if confidence == 0.95 else float(
        torch.special.ndtri(torch.tensor(0.5 + confidence / 2.0)))
    if p >= 2:
        stderr = torch.std(sq, correction=1) / sqrt_f32(
            torch.tensor(float(p), device=sq.device))
    else:
        stderr = torch.tensor(float("inf"), device=sq.device)
    frob_lo = sqrt_f32(torch.clamp(frob_sq - z * stderr, min=0.0))
    frob_hi = sqrt_f32(frob_sq + z * stderr)
    w_norms = sqrt_f32(torch.sum(omega.float() ** 2, dim=0))
    spectral = torch.max(sqrt_f32(sq) / torch.clamp(w_norms, min=_EPS))
    # ||A^T B||_F from the same probes (unbiased, same argument)
    m_frob = sqrt_f32(torch.mean(torch.sum(probes.float() ** 2, dim=0)))
    frob = sqrt_f32(frob_sq)
    return ErrorEstimate(frob, frob_sq, frob_lo, frob_hi, spectral,
                         frob / torch.clamp(m_frob, min=_EPS))


def rank_curve(summary: SketchSummary, r_max: int,
               refine=None) -> torch.Tensor:
    """Estimated relative Frobenius error of the rank-(i+1) truncation for
    every i < r_max, against the probe block: ONE factorization and ONE
    probe projection for the whole curve. Without ``refine`` the
    factorization is the SVD of the dense rescaled sketch product (n1, n2);
    ``refine`` (a ``refinement.RefineSpec``) takes the Tropp-refined
    reconstruction instead, whose curve is at most the co-sketch width
    long."""
    _require_probes(summary)
    rel, _, _, _ = _rank_curve(summary, r_max, refine=refine)
    return rel


class AdaptiveRankResult(NamedTuple):
    """``adaptive_rank`` output: the chosen rank, its truncated factors, the
    a-posteriori estimate at that rank, and the estimated relative-error
    curve (index i = rank i+1) the search ran over."""

    r: int
    factors: LowRankFactors
    error: ErrorEstimate
    curve: torch.Tensor       # (r_max,) estimated relative Frobenius errors


def _rank_curve(summary: SketchSummary, r_max: int, refine=None):
    """(rel_curve (r_max,), U, s, Vt). With ``c = U^T probes`` and ``Z =
    diag(s) V^T Omega`` the squared residual of the rank-r truncation on
    probe j is ``||probes_j||^2 + sum_{i<r} (Z_ij^2 - 2 c_ij Z_ij)``, a
    cumulative sum over i. Everything in float32."""
    probes = summary.probes.float()
    omega = summary.probe_omega.float()
    if refine is not None:
        from repro_torch.core.refinement import refined_svd
        U, s, Vt = refined_svd(summary, refine, r_max)
    else:
        M = estimator.rescaled_matrix(summary).float()
        U, s, Vt = svd(M)
        U, s, Vt = U[:, :r_max], s[:r_max], Vt[:r_max]
    c = U.T @ probes                                   # (r_max, p)
    Z = s[:, None] * (Vt @ omega)                      # (r_max, p)
    base = torch.sum(probes ** 2, dim=0)               # (p,)
    deltas = Z ** 2 - 2.0 * c * Z
    errsq = torch.clamp(base[None, :] + torch.cumsum(deltas, dim=0), min=0.0)
    m_frob = sqrt_f32(torch.mean(base))
    rel = sqrt_f32(torch.mean(errsq, dim=1)) / torch.clamp(m_frob, min=_EPS)
    return rel, U, s, Vt


def adaptive_rank(summary: SketchSummary, tol: float,
                  r_max: Optional[int] = None,
                  refine=None) -> AdaptiveRankResult:
    """Smallest rank whose estimated relative Frobenius error meets ``tol``
    (``frob_est <= tol * ||A^T B||_F``, both from the probes).

    The search is an exact scan over the curve on the host (probe noise can
    dent its monotonicity near the noise floor); when no rank within
    ``r_max`` meets ``tol`` the result is ``r_max``. ``refine`` gates on
    the Tropp-refined reconstruction (needs a co-sketch; candidate ranks are
    then capped by the co-sketch width).

    >>> import torch
    >>> from repro_torch import prng
    >>> from repro_torch.core.summary_engine import build_summary
    >>> key = prng.PRNGKey(0)
    >>> W, _ = torch.linalg.qr(prng.normal(key, (512, 12)))
    >>> M = (prng.normal(prng.fold_in(key, 1), (12, 10))
    ...      * torch.tensor([10.0, 6.0, 0.1, 0.05, 0.02, 0.01, 0.005, 0.002,
    ...                      0.001, 0.0005])[None, :])
    >>> A, B = W, W @ M              # A^T B == M: rank ~2 + tiny tail
    >>> res = adaptive_rank(build_summary(key, A, B, 128, probes=24,
    ...                                   device="cpu"), tol=0.3, r_max=8)
    >>> (res.r, tuple(res.factors.U.shape), tuple(res.curve.shape))
    (2, (12, 2), (8,))
    >>> bool(res.error.rel_est <= 0.3)       # the chosen rank meets the gate
    True
    >>> bool(res.curve[res.r - 2] > 0.3)     # ... and is the smallest that does
    True
    """
    _require_probes(summary)
    q = min(summary.n1, summary.n2)
    if refine is not None:
        from repro_torch.core.refinement import require_cosketch
        require_cosketch(summary)
        q = min(q, summary.n_cosketch)
    r_max = q if r_max is None else min(r_max, q)
    if r_max < 1:
        raise ValueError(f"r_max must be >= 1, got {r_max}")
    rel, U, s, Vt = _rank_curve(summary, r_max, refine=refine)
    curve = rel.cpu().numpy()
    meets = (curve <= tol).nonzero()[0]
    r = int(meets[0]) + 1 if meets.size else int(curve.shape[0])
    factors = LowRankFactors(U[:, :r] * s[:r], Vt[:r].T)
    return AdaptiveRankResult(r, factors, estimate_error(summary, factors),
                              rel)
