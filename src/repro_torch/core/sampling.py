"""Step 2a of SMP-PCA: biased entrywise sampling of the product matrix.

Eq. (1):  q_ij = m * ( ||A_i||^2/(2 n2 ||A||_F^2) + ||B_j||^2/(2 n1 ||B||_F^2) )

``sample_entries`` draws from the mixture form of Eq. (1): with probability
1/2 (i ~ ||A_i||^2, j uniform), else (i uniform, j ~ ||B_j||^2), by inverse
CDF over the two norm cumsums. The keys and draws are those of
``repro.core.sampling``, so for the same key and norms the port draws the
same indices, up to float32 cumsum ties that may move an inverse-CDF draw
to a neighbouring index.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.types import SampleSet


def q_probabilities(norm_A: torch.Tensor, norm_B: torch.Tensor,
                    m: int) -> torch.Tensor:
    """Dense (n1, n2) matrix of q_hat = min(1, q_ij). Small-n helper."""
    n1, n2 = norm_A.shape[0], norm_B.shape[0]
    fa2 = torch.sum(norm_A ** 2)
    fb2 = torch.sum(norm_B ** 2)
    q = m * (norm_A[:, None] ** 2 / (2 * n2 * fa2)
             + norm_B[None, :] ** 2 / (2 * n1 * fb2))
    return torch.clamp(q, max=1.0)


def q_at(norm_A: torch.Tensor, norm_B: torch.Tensor, m: int,
         rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """q_hat at given (i, j) pairs without materializing (n1, n2)."""
    n1, n2 = norm_A.shape[0], norm_B.shape[0]
    fa2 = torch.sum(norm_A ** 2)
    fb2 = torch.sum(norm_B ** 2)
    q = m * (norm_A[rows] ** 2 / (2 * n2 * fa2)
             + norm_B[cols] ** 2 / (2 * n1 * fb2))
    return torch.clamp(q, max=1.0)


def _cdf(w: torch.Tensor) -> torch.Tensor:
    """Cumulative sum of the weights, summed on the host and returned on
    their device. CUDA's float scan adds in an order that changes from run
    to run, which would move draws at bucket edges between runs of the same
    key; the host sum is one pass over one float per column."""
    return torch.cumsum(w.cpu(), dim=0).to(w.device)


def _categorical_from_weights(key: torch.Tensor, w: torch.Tensor,
                              shape) -> torch.Tensor:
    """Inverse-CDF categorical sampling: O(n) setup + O(m log n) draws.
    Returns int64 indices."""
    cdf = _cdf(w)
    total = cdf[-1]
    u = prng.uniform(key, shape) * total
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, 0, w.shape[0] - 1)


def require_nonzero_norms(norm_A: torch.Tensor, norm_B: torch.Tensor) -> None:
    """Reject an all-zero (or NaN) factor before sampling corrupts silently.

    A zero-norm matrix makes Eq. (1) divide by ``||A||_F^2 = 0``, so it is a
    caller error named here. Zero-norm columns are fine. Reads two scalars
    back to the host (one synchronisation)."""
    fa2, fb2 = torch.stack([torch.sum(norm_A.float() ** 2),
                            torch.sum(norm_B.float() ** 2)]).tolist()
    for name, f2 in (("A", fa2), ("B", fb2)):
        if not f2 > 0.0:
            raise ValueError(
                f"all columns of {name} have zero norm (||{name}||_F = 0, "
                f"or a NaN norm) - the Eq. (1) sampling distribution is "
                f"undefined for a zero factor; nothing to estimate")


def sample_entries(key: torch.Tensor, norm_A: torch.Tensor,
                   norm_B: torch.Tensor, m: int) -> SampleSet:
    """Draw m entries from the Eq. (1) mixture (duplicates allowed). Returns
    a SampleSet with int32 indices, all entries valid, on the norms'
    device. Raises ``ValueError`` on an all-zero A or B."""
    require_nonzero_norms(norm_A, norm_B)
    n1, n2 = norm_A.shape[0], norm_B.shape[0]
    k_branch, k_ra, k_ua, k_rb, k_ub = prng.split(key, 5)

    # branch 0: i ~ ||A_i||^2 / ||A||_F^2, j ~ U[n2]
    rows = _categorical_from_weights(k_ra, norm_A.float() ** 2, (m,))
    cols = prng.randint(k_ua, (m,), 0, n2)
    # branch 1: i ~ U[n1], j ~ ||B_j||^2 / ||B||_F^2
    pick_b = prng.bernoulli(k_branch, 0.5, (m,))
    rows = torch.where(pick_b, prng.randint(k_ub, (m,), 0, n1),
                       rows.to(torch.int32))
    cols = torch.where(
        pick_b,
        _categorical_from_weights(k_rb, norm_B.float() ** 2,
                                  (m,)).to(torch.int32),
        cols)
    q_hat = q_at(norm_A, norm_B, m, rows, cols)
    return SampleSet(rows, cols, q_hat,
                     torch.ones((m,), dtype=torch.bool, device=rows.device))


def sample_entries_binomial(key: torch.Tensor, norm_A: torch.Tensor,
                            norm_B: torch.Tensor, m: int,
                            max_samples: int | None = None) -> SampleSet:
    """The paper's Bernoulli-per-entry model (Alg 1 line 3): entry (i, j)
    is kept with probability q_hat_ij. Dense O(n1 n2), so for small n only.
    Returns a SampleSet padded to ``max_samples`` (default 2m): the kept
    entries first, in row-major order (a stable sort, as ``jnp.argsort``
    is), then unkept ones with ``mask`` False. Raises ``ValueError`` on an
    all-zero A or B."""
    require_nonzero_norms(norm_A, norm_B)
    n2 = norm_B.shape[0]
    cap = int(max_samples or 2 * m)
    q = q_probabilities(norm_A, norm_B, m)
    flat = prng.bernoulli(key, q).reshape(-1)
    sel = torch.argsort(~flat, stable=True)[:cap]
    rows = torch.div(sel, n2, rounding_mode="floor").to(torch.int32)
    cols = (sel % n2).to(torch.int32)
    return SampleSet(rows, cols, q.reshape(-1)[sel], flat[sel])


def split_omega(key: torch.Tensor, samples: SampleSet,
                n_splits: int) -> torch.Tensor:
    """Assign each sampled entry to one of ``n_splits`` subsets (Alg 2
    line 3): (m,) int32 subset ids."""
    return prng.randint(key, (samples.m,), 0, n_splits)
