"""SMP-PCA gradient compression: the paper as a distributed-training feature.

The port of ``repro.optim.grad_compression``. Data-parallel workers w =
1..W each hold a local gradient G_w (n_in x n_out) of a dense layer; the
update needs G = sum_w G_w, the paper's matrix product with

    A := vstack_w(I_{n_in}),   B := vstack_w(G_w),   A^T B = sum_w G_w = G,

whose rows already lie on the workers, as in the paper's Spark setting. One
pass of Algorithm 1 (``summary_engine.identity_product_summary``) sums
``Pi_w`` and ``Pi_w G_w`` and the squared column norms of the G_w over the
workers: k (n_in + n_out) + n_out floats on the wire instead of n_in n_out.
Every worker then runs the same-keyed sampling, Eq. 2 values and WAltMin
and applies the same rank-r gradient; error feedback (the residual added to
the next step's gradient) restores what rank r drops.

Gradients are nested dicts, lists and tuples of tensors, walked in
``jax.tree.flatten``'s order (dict keys sorted), so that leaf i's key
``fold_in(key, i)`` is the JAX package's. A ``torch.distributed`` process
group takes the place of the mesh axis: with ``group=`` the input
gradients are each worker's own, the compressed ones the same global
reconstruction on every worker, and the leaves that are not compressed
are averaged (``all_reduce`` over the group, divided by its size).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.core.smppca import smppca_from_summary
from repro_torch.core.summary_engine import identity_product_summary
from repro_torch.core.types import tree_leaves, tree_unflatten


class CompressionConfig(NamedTuple):
    rank: int = 8
    sketch_k: int = 128
    sample_factor: int = 8      # m = factor * (n1 + n2) * rank
    min_dim: int = 64           # compress 2-D leaves with min(dims) >= this
    als_iters: int = 4


class CompressionState(NamedTuple):
    err: Any                    # residual tree (0-d zeros where not compressed)
    step: torch.Tensor          # () int32


MIN_DIM = 64


def _compressible(leaf: torch.Tensor) -> bool:
    """2-D dense-layer grads, or stacked (L, n1, n2) layer groups."""
    return leaf.ndim in (2, 3) and min(leaf.shape[-2:]) >= MIN_DIM


def init_state(grads_like) -> CompressionState:
    """Zero residuals shaped like the compressible leaves (float32 on each
    leaf's device), 0-d zeros elsewhere; step 0."""
    err = tree_unflatten(grads_like, [
        torch.zeros(g.shape if _compressible(g) else (),
                    dtype=torch.float32, device=g.device)
        for g in tree_leaves(grads_like)])
    return CompressionState(err, torch.zeros((), dtype=torch.int32))


def _m_for(n1: int, n2: int, cfg: CompressionConfig) -> int:
    return int(cfg.sample_factor * (n1 + n2) * cfg.rank)


def compress_leaf(key: torch.Tensor, G: torch.Tensor, cfg: CompressionConfig,
                  group=None, n_workers: int = 1) -> torch.Tensor:
    """The rank-r SMP-PCA reconstruction of one gradient matrix, on G's
    device. With ``group`` G is this worker's summand and the one-pass
    summary is summed over the group. A stacked (L, n1, n2) layer group
    compresses each layer under ``split(key, L)``."""
    if G.ndim == 3:
        keys = prng.split(key.to(G.device), G.shape[0])
        return torch.stack([compress_leaf(keys[i], G[i], cfg, group=group,
                                          n_workers=n_workers)
                            for i in range(G.shape[0])])
    n1, n2 = G.shape
    key = key.to(G.device)
    summary = identity_product_summary(
        key, G.float(), cfg.sketch_k, group=group, n_workers=n_workers,
        device=G.device)
    res = smppca_from_summary(
        prng.fold_in(key, 1), summary, r=cfg.rank, m=_m_for(n1, n2, cfg),
        T=cfg.als_iters, device=G.device)
    return res.factors.U @ res.factors.V.T


def compress_grads(key: torch.Tensor, grads, state: CompressionState,
                   cfg: CompressionConfig = CompressionConfig(),
                   group=None, n_workers: int = 1):
    """Compress every eligible leaf: ``(new_grads, new_state, stats)``.

    Leaf i is compressed under ``fold_in(key, i)`` after its residual is
    added. With ``group`` the compressed gradients are the mean over the
    workers (the global reconstruction divided by ``n_workers``) and the
    other leaves are averaged over the group. ``stats`` holds
    ``n_compressed`` and ``comm_fraction``, the bytes sent over the bytes of
    the uncompressed gradients."""
    flat = tree_leaves(grads)
    eflat = tree_leaves(state.err)
    out, err_new = [], []
    n_comp = 0
    saved_bytes = total_bytes = 0.0
    for i, (g, e) in enumerate(zip(flat, eflat)):
        total_bytes += g.numel() * 4
        if _compressible(g):
            g_in = g.float() + e
            ghat = compress_leaf(prng.fold_in(key.to(g.device), i), g_in, cfg,
                                 group=group, n_workers=n_workers)
            if group is not None:
                ghat = ghat / n_workers     # the mean-reduction convention
            out.append(ghat.to(g.dtype))
            err_new.append(g_in - ghat)
            n_comp += 1
            n1, n2 = g.shape[-2:]
            n_layers = g.shape[0] if g.ndim == 3 else 1
            saved_bytes += g.numel() * 4 - \
                4 * n_layers * (cfg.sketch_k * (n1 + n2) + n2)
        else:
            if group is not None:
                g = g.clone()
                dist.all_reduce(g, group=group)
                g = g / dist.get_world_size(group)
            out.append(g)
            err_new.append(torch.zeros((), dtype=torch.float32,
                                       device=g.device))
    stats = {"n_compressed": n_comp,
             "comm_fraction": 1.0 - saved_bytes / max(total_bytes, 1.0)}
    return (tree_unflatten(grads, out),
            CompressionState(tree_unflatten(grads, err_new), state.step + 1),
            stats)
