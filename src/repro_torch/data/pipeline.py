"""Deterministic synthetic data: the port of the JAX package's
``data/pipeline.py``.

``SyntheticLM``: ``batch(step)`` is a pure function of (seed, step, host),
drawn with the port's jax-exact keys, so it equals the JAX package's batch
bit for bit. Resuming after a failure at step k takes ``batch(k)``
directly (deterministic skip-ahead), and host sharding folds ``host_id``
into the key. The tokens are a noisy affine walk over the vocabulary
(next = cur * mult + 1 mod V with probability 1 - noise, else uniform), so
a falling training loss is a meaningful signal.

``cooccurrence_stream``: the paper's query x ad / bag-of-words setting, a
stream of (rows, A rows, B rows) chunks in arbitrary order (numpy only, so
both packages yield the same arrays for the same seed).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import prng


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    batch_size: int            # per-host batch
    seq_len: int
    seed: int = 0
    noise: float = 0.1
    mult: int = 3
    n_hosts: int = 1
    host_id: int = 0
    device: str = "cuda"

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """``{"tokens", "labels"}``, (batch_size, seq_len) int32 on
        ``device``: the walk's tokens and the same shifted by one."""
        dev = _device.resolve(self.device)
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(self.seed, device=dev),
                                        step), self.host_id)
        k_start, k_noise, k_rand = prng.split(key, 3)
        B, S, V = self.batch_size, self.seq_len, self.vocab_size
        start = prng.randint(k_start, (B,), 0, V).long()
        flip = prng.bernoulli(k_noise, self.noise, (B, S))
        rand = prng.randint(k_rand, (B, S), 0, V).long()
        toks = torch.empty((B, S + 1), dtype=torch.int64, device=dev)
        toks[:, 0] = cur = start
        for t in range(S):
            cur = torch.where(flip[:, t], rand[:, t],
                              (cur * self.mult + 1) % V)
            toks[:, t + 1] = cur
        toks = toks.to(torch.int32)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}


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
