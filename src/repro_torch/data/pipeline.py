"""Synthetic streaming sources: the port's copy of the JAX package's
``data/pipeline.py::cooccurrence_stream`` (numpy only, so both packages
yield the same arrays for the same seed)."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def cooccurrence_stream(seed: int, d: int, n1: int, n2: int, rank: int,
                        chunk: int) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]]:
    """Yields (row_ids, A_rows, B_rows) chunks in a shuffled (arbitrary)
    order. The underlying A, B are low-rank-plus-noise so A^T B has planted
    structure for SMP-PCA to find."""
    rng = np.random.default_rng(seed)
    UA = rng.normal(size=(d, rank)) / np.sqrt(rank)
    VA = rng.normal(size=(rank, n1))
    UB = 0.5 * UA + 0.5 * rng.normal(size=(d, rank)) / np.sqrt(rank)
    VB = rng.normal(size=(rank, n2))
    A = UA @ VA + 0.1 * rng.normal(size=(d, n1))
    B = UB @ VB + 0.1 * rng.normal(size=(d, n2))
    order = rng.permutation(d)
    for i in range(0, d, chunk):
        rows = order[i:i + chunk]
        yield rows, A[rows].astype(np.float32), B[rows].astype(np.float32)
