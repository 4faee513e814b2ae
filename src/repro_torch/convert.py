"""Carry state between the JAX package and the port, as numpy arrays.

The JAX package's keys, summaries, samples and factors are NamedTuples of
arrays; ``numpy.asarray`` of each field gives what these functions take.
Key data is uint32 (2,) in JAX and int64 (2,) here, holding the same two
32-bit words. Every other field keeps its dtype (int32 indices, float32
values, bool mask), so a round trip through the port is exact.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.types import LowRankFactors, SampleSet, SketchSummary


def key_from_numpy(key_data, device="cpu") -> torch.Tensor:
    """uint32 key data (..., 2) -> the port's int64 key."""
    arr = np.asarray(key_data)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"expected uint32 key data (..., 2), got "
                         f"{arr.dtype} {arr.shape}")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """The port's int64 key -> uint32 key data, as jax.random uses it."""
    return key.cpu().numpy().astype(np.uint32)


def _from_numpy(cls, state, device):
    return cls(*(None if x is None else torch.from_numpy(np.array(x)).to(device)
                 for x in state))


def _to_numpy(cls, state: NamedTuple):
    return cls(*(None if x is None else x.detach().cpu().numpy()
                 for x in state))


def summary_from_numpy(state, device="cpu") -> SketchSummary:
    """A JAX ``SketchSummary`` (fields as numpy arrays or None) -> port."""
    return _from_numpy(SketchSummary, state, device)


def summary_to_numpy(summary: SketchSummary) -> SketchSummary:
    """Port ``SketchSummary`` -> the same NamedTuple holding numpy arrays."""
    return _to_numpy(SketchSummary, summary)


def samples_from_numpy(state, device="cpu") -> SampleSet:
    """A JAX ``SampleSet`` -> port (int32 rows/cols, float32 q_hat, bool)."""
    return _from_numpy(SampleSet, state, device)


def samples_to_numpy(samples: SampleSet) -> SampleSet:
    """Port ``SampleSet`` -> the same NamedTuple holding numpy arrays."""
    return _to_numpy(SampleSet, samples)


def factors_from_numpy(state, device="cpu") -> LowRankFactors:
    """JAX ``LowRankFactors`` -> port."""
    return _from_numpy(LowRankFactors, state, device)


def factors_to_numpy(factors: LowRankFactors) -> LowRankFactors:
    """Port ``LowRankFactors`` -> the same NamedTuple holding numpy arrays."""
    return _to_numpy(LowRankFactors, factors)
