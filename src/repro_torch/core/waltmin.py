"""Step 3 of SMP-PCA: WAltMin, weighted alternating minimization (Alg 2).

Solves  min_{U,V} sum_{(i,j) in Omega} w_ij (e_i^T U V^T e_j - M~(i,j))^2,
w_ij = 1/q_hat_ij, on a COO sample. Per-row r x r normal equations are
summed with ``index_add_`` and solved with a batched ``torch.linalg.solve``.

Sample splitting (Alg 2 line 3): Omega is split into 2T+1 subsets; the t-th
half-iteration only sees subset 2t+1 / 2t+2, by masking.

The JAX package has a jitted ``waltmin`` (a ``lax.scan``) and an eager
``waltmin_reference`` with one body; PyTorch runs eagerly, so here
``waltmin_reference`` is ``waltmin``. On CUDA, ``index_add_`` adds with atomics, whose order changes
from run to run: the factors agree across runs to float32 rounding, not bit
for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core import sampling
from repro_torch.core.linalg import svd, sqrt_f32
from repro_torch.core.types import LowRankFactors, SampleSet

_RIDGE = 1e-8


def _qr(X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(X)[0]


def _sqrt_f32(r: int) -> torch.Tensor:
    return sqrt_f32(torch.tensor(float(r), dtype=torch.float32))


# ---------------------------------------------------------------------------
# COO helpers
# ---------------------------------------------------------------------------

def coo_matmat(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               X: torch.Tensor, n_out: int) -> torch.Tensor:
    """(sparse (n_out, n_in)) @ X  where sparse[r, c] = vals, X: (n_in, p)."""
    contrib = vals[:, None] * X[cols]           # (nnz, p)
    out = torch.zeros((n_out, X.shape[1]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, rows, contrib)


def coo_rmatmat(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                X: torch.Tensor, n_out: int) -> torch.Tensor:
    """(sparse)^T @ X."""
    return coo_matmat(cols, rows, vals, X, n_out)


def coo_topr_svd(key: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, n1: int, n2: int, r: int,
                 n_iter: int = 8
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomized top-r SVD of a sparse (n1, n2) matrix via subspace
    iteration, from COO products only. Returns (U, s, V)."""
    p = min(n2, r + 8)                          # oversampling
    G = prng.normal(key, (n2, p))
    Y = coo_matmat(rows, cols, vals, G, n1)     # (n1, p)
    for _ in range(n_iter):
        Q = _qr(Y)
        Z = _qr(coo_rmatmat(rows, cols, vals, Q, n2))   # (n2, p)
        Y = coo_matmat(rows, cols, vals, Z, n1)
    Q = _qr(Y)                                  # (n1, p)
    Bt = coo_rmatmat(rows, cols, vals, Q, n2)   # (n2, p) = (Q^T S)^T
    Ub, s, Vt = svd(Bt.T)
    return Q @ Ub[:, :r], s[:r], Vt[:r].T


# ---------------------------------------------------------------------------
# WAltMin
# ---------------------------------------------------------------------------

def _trim_rows(U: torch.Tensor, norm_col: torch.Tensor, r: int) -> torch.Tensor:
    """Alg 2 step 6: zero rows whose norm exceeds 8 sqrt(r) ||A_i||/||A||_F,
    then re-orthonormalize. Guards the incoherence Lemma C.2 needs."""
    frob = sqrt_f32(torch.sum(norm_col ** 2))
    thresh = 8.0 * _sqrt_f32(r).to(U.device) * norm_col / \
        torch.clamp(frob, min=1e-12)
    row_norm = torch.linalg.vector_norm(U, dim=1)
    keep = (row_norm <= torch.clamp(thresh, min=1e-12))[:, None]
    return _qr(torch.where(keep, U, 0.0))


def _ls_step(rows_from: torch.Tensor, cols_to: torch.Tensor,
             vals: torch.Tensor, w: torch.Tensor, F: torch.Tensor,
             n_to: int) -> torch.Tensor:
    """One half-iteration: solve for the ``cols_to`` side factor given F.

    For each target index t: G_t = sum w * F_i F_i^T ; b_t = sum w * val *
    F_i, over entries whose source index is i=rows_from and target
    t=cols_to."""
    r = F.shape[1]
    Fi = F[rows_from]                                   # (m, r)
    wv = (w * vals)[:, None] * Fi                       # (m, r)
    wF = w[:, None] * Fi
    outer = wF[:, :, None] * Fi[:, None, :]             # (m, r, r)
    del wF
    G = torch.zeros((n_to, r, r), dtype=F.dtype, device=F.device)
    G.index_add_(0, cols_to, outer)
    del outer
    b = torch.zeros((n_to, r), dtype=F.dtype, device=F.device)
    b.index_add_(0, cols_to, wv)
    # Two-scale Tikhonov, as in the JAX package: a 1e-6-relative per-row term
    # for conditioning plus a 1e-4-relative global floor that damps rows
    # drawing fewer than r samples.
    tr = torch.diagonal(G, dim1=1, dim2=2).sum(-1)[:, None, None]
    lam = 1e-6 * tr / r + 1e-4 * torch.mean(tr) / r + _RIDGE
    G = G + lam * torch.eye(r, dtype=F.dtype, device=F.device)
    return torch.linalg.solve(G, b[..., None])[..., 0]  # (n_to, r)


def waltmin(key: torch.Tensor, samples: SampleSet, values: torch.Tensor,
            n1: int, n2: int, r: int, T: int,
            norm_A: Optional[torch.Tensor] = None,
            use_splits: bool = True) -> LowRankFactors:
    """Algorithm 2. ``values`` are M~ on Omega (or exact entries for LELA).

    norm_A: column norms used by the trim step (uniform when None).
    use_splits=False reuses all samples every iteration (the practical mode
    of the paper's Spark code; splits are for the analysis).
    """
    rows, cols = samples.rows, samples.cols
    w_all = torch.where(samples.mask,
                        1.0 / torch.clamp(samples.q_hat, min=1e-12), 0.0)
    vals = torch.where(samples.mask, values, 0.0)
    if norm_A is None:
        norm_A = torch.ones((n1,), dtype=torch.float32, device=vals.device)

    k_split, k_svd = prng.split(key)
    subset = (sampling.split_omega(k_split, samples, 2 * T + 1)
              if use_splits else None)

    def _wmask(s):
        if not use_splits:
            return w_all
        # splits partition Omega; rescale q_hat by the subset fraction
        return torch.where(subset == s, w_all * (2 * T + 1), 0.0)

    # init: SVD of R_Omega0(M~), trim, orthonormalize
    U0, _, _ = coo_topr_svd(k_svd, rows, cols, _wmask(0) * vals, n1, n2, r)
    U = _trim_rows(U0, norm_A, r)

    # Alternating half-iterations. Orthonormalizing the carried factor
    # between steps removes the scale drift that makes raw ALS diverge in
    # float32; the final V solve restores a consistent scaled pair.
    for t in range(T):
        V = _ls_step(rows, cols, vals, _wmask(2 * t + 1), U, n2)
        U = _qr(_ls_step(cols, rows, vals, _wmask(2 * t + 2), _qr(V), n1))
    V = _ls_step(rows, cols, vals, _wmask(2 * T - 1), U, n2)
    return LowRankFactors(U, V)


def waltmin_reference(key: torch.Tensor, samples: SampleSet,
                      values: torch.Tensor, n1: int, n2: int, r: int, T: int,
                      norm_A: Optional[torch.Tensor] = None,
                      use_splits: bool = True) -> LowRankFactors:
    """Algorithm 2 as written on the page, T iteration pairs dispatched
    eagerly: the JAX package's oracle for its jitted loop. The port's
    ``waltmin`` is already that loop, so this is ``waltmin``."""
    return waltmin(key, samples, values, n1, n2, r, T, norm_A=norm_A,
                   use_splits=use_splits)
