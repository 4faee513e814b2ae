"""Step 1 of SMP-PCA: the sketches (Gaussian or SRHT) and the column norms.

The Gaussian projection column of data row ``i`` is ``normal(fold_in(key,
i), (k,)) / sqrt(k)``: a pure function of ``(key, i)``, so rows may be
sketched in any order or split across shards and still add up to the same
summary. SRHT (``srht_sketch``, the paper's Spark choice) is ``sqrt(1/k) R
H D X`` with the plain butterfly ``fwht``. The keys and draws are those of
``repro.core.sketch`` (see ``repro_torch.prng``).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.linalg import sqrt_f32
from repro_torch.core.types import SketchSummary


def gaussian_pi(key: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """Dense (k, d) Gaussian JL matrix with entries N(0, 1/k), drawn from
    ``key`` in one piece (``jax.random.normal(key, (k, d)) / sqrt(k)``)."""
    return prng.normal(key, (k, d)) / _sqrt_f32(k)


def pi_rows(key: torch.Tensor, row_idx: torch.Tensor, k: int) -> torch.Tensor:
    """Columns of Pi for the given data-row indices, order independent.

    Returns (len(row_idx), k) float32 with ``[t, :] = Pi[:, row_idx[t]]``,
    on the key's device.
    """
    row_keys = prng.fold_in(key, row_idx)                   # (t, 2)
    return prng.normal(row_keys, (k,)) / _sqrt_f32(k)


def _sqrt_f32(k: float) -> torch.Tensor:
    """sqrt(k) rounded as ``jnp.sqrt(k)`` rounds it: in float32."""
    return sqrt_f32(torch.tensor(float(k), dtype=torch.float32))


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def fwht(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Unnormalized fast Walsh-Hadamard transform along ``axis`` (length a
    power of two), in Sylvester order: butterflies of span 1, 2, 4, ..."""
    x = torch.movedim(x, axis, 0)
    d = x.shape[0]
    if d < 1 or d & (d - 1):
        raise ValueError(
            f"FWHT length must be a power of two, got {d} "
            f"(axis {axis} of shape {tuple(x.shape)})")
    rest = x.shape[1:]
    h = 1
    while h < d:
        x = x.reshape(d // (2 * h), 2, h, *rest)
        a, b = x[:, 0], x[:, 1]
        x = torch.stack([a + b, a - b], dim=1)
        h *= 2
    return torch.movedim(x.reshape(d, *rest), 0, axis)


def srht_sketch(key: torch.Tensor, X: torch.Tensor, k: int) -> torch.Tensor:
    """SRHT sketch ``sqrt(1/k) R H D X`` (R: k sampled rows, H normalized).

    X: (d, n) -> (k, n). d is padded to the next power of two with zero
    rows, which change no column norm or inner product."""
    d = X.shape[0]
    dp = _next_pow2(d)
    key_sign, key_rows = prng.split(key)
    signs = prng.rademacher(key_sign, (d,), dtype=X.dtype)
    Xp = X * signs[:, None]
    if dp != d:
        Xp = torch.nn.functional.pad(Xp, (0, 0, 0, dp - d))
    HX = fwht(Xp, axis=0) / _sqrt_f32(dp).to(X.dtype)
    rows = prng.choice(key_rows, dp, (k,))
    return HX[rows.long()] * _sqrt_f32(dp / k).to(X.dtype)


def column_norms(X: torch.Tensor) -> torch.Tensor:
    """Exact L2 column norms, accumulated in float32."""
    return sqrt_f32(torch.sum(X.float() ** 2, dim=0))


def merge_summaries(a: SketchSummary, b: SketchSummary) -> SketchSummary:
    """Combine summaries of disjoint row shards: the sketches add, the
    squared norms add, and the probe and co-sketch blocks add (both
    operands must carry the same blocks); the shared test matrices are
    carried from ``a`` (both operands must descend from the same key)."""
    from repro_torch.core.error_engine import merge_probes
    from repro_torch.core.refinement import merge_cosketch
    return SketchSummary(
        a.A_sketch + b.A_sketch,
        a.B_sketch + b.B_sketch,
        sqrt_f32(a.norm_A ** 2 + b.norm_A ** 2),
        sqrt_f32(a.norm_B ** 2 + b.norm_B ** 2),
        probes=merge_probes(a.probes, b.probes),
        probe_omega=a.probe_omega,
        cosketch_Y=merge_cosketch(a.cosketch_Y, b.cosketch_Y),
        cosketch_W=merge_cosketch(a.cosketch_W, b.cosketch_W),
        cosketch_omega=a.cosketch_omega,
        cosketch_psi=a.cosketch_psi)


# ---------------------------------------------------------------------------
# One-pass summaries: thin wrappers over the summary engine's backends
# ---------------------------------------------------------------------------

def sketch_summary(key: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   k: int, method: str = "gaussian",
                   device="cuda") -> SketchSummary:
    """The materialized-operator summary: the engine's 'reference'
    backend."""
    from repro_torch.core.summary_engine import build_summary
    return build_summary(key, A, B, k, method=method, backend="reference",
                         device=device)


def sketch_pass(key: torch.Tensor, A: torch.Tensor, B: torch.Tensor, k: int,
                block: int = 1024, device="cuda") -> SketchSummary:
    """The block-streamed single pass (Gaussian): the engine's 'scan'
    backend. Each block regenerates its slice of the projection from (key,
    global row id), so the (k, d) operator never exists."""
    from repro_torch.core.summary_engine import build_summary
    return build_summary(key, A, B, k, backend="scan", block=block,
                         device=device)


def streamed_rows_summary(key: torch.Tensor, row_idx: torch.Tensor,
                          A_rows: torch.Tensor, B_rows: torch.Tensor,
                          k: int) -> SketchSummary:
    """Rows arriving as (index, A row, B row) triples in any order: the
    engine's ``rows_summary`` (Gaussian), on the rows' device."""
    from repro_torch.core.summary_engine import rows_summary
    return rows_summary(key, row_idx, A_rows, B_rows, k)
