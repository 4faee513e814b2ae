"""Step 1 of SMP-PCA: the Gaussian projection and the column norms.

The projection column of data row ``i`` is ``normal(fold_in(key, i), (k,))
/ sqrt(k)``: a pure function of ``(key, i)``, so rows may be sketched in any
order or split across shards and still add up to the same summary. The keys
and draws are those of ``repro.core.sketch`` (see ``repro_torch.prng``).
"""
from __future__ import annotations

import torch

from repro_torch import prng
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


def _sqrt_f32(k: int) -> torch.Tensor:
    """sqrt(k) rounded as ``jnp.sqrt(k)`` rounds it: in float32."""
    return torch.sqrt(torch.tensor(float(k), dtype=torch.float32))


def column_norms(X: torch.Tensor) -> torch.Tensor:
    """Exact L2 column norms, accumulated in float32."""
    return torch.sqrt(torch.sum(X.float() ** 2, dim=0))


def merge_summaries(a: SketchSummary, b: SketchSummary) -> SketchSummary:
    """Combine summaries of disjoint row shards: the sketches add and the
    squared norms add. Summaries with probe or co-sketch blocks are not
    merged here yet (``ROADMAP.md``, Queue 1 item 4)."""
    for s in (a, b):
        if s.probes is not None or s.cosketch_Y is not None:
            raise NotImplementedError(
                "merge_summaries: probe and co-sketch blocks are not ported "
                "yet (ROADMAP.md, Queue 1 item 4)")
    return SketchSummary(
        a.A_sketch + b.A_sketch,
        a.B_sketch + b.B_sketch,
        torch.sqrt(a.norm_A ** 2 + b.norm_A ** 2),
        torch.sqrt(a.norm_B ** 2 + b.norm_B ** 2))

