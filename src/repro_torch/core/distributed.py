"""Distributed one-pass summary: the Spark treeAggregate as all-reduces over
a ``torch.distributed`` process group.

The port of ``repro.core.distributed``. The streamed dimension d (the rows
of A and B) is sharded over the ranks of a group. Each rank sketches its
row shard with its slice of the global projection (the column of global row
``i`` is a function of ``(key, i)`` alone, so the terms are those of the
single-process pass), then all-reduces sum the sketches and the squared
column norms: sketch contributions form a commutative monoid, and Spark's
shuffle tree becomes one collective (gloo on CPU tensors, NCCL on the
card).

Groups take the place of the JAX package's mesh axes. ``group`` is one
process group (a flat all-reduce) or an ``(outer, inner)`` pair, as
``dist.multihost.host_groups`` builds it, for the hierarchical reduce: the
large blocks (sketches, probe block, co-sketch pair) are all-reduced over
``inner`` (the ranks of one host) and then over ``outer`` (one rank of each
host), while the squared norms take one all-reduce over all ranks, the
flat path's collective, so they stay bit-identical between the two paths.
A pair must span the default group.

The shard layout is the JAX package's: ``shard_rows = ceil(d / world)``,
the global shard index runs row-major over the hierarchy (``shard_index``),
and the trailing shard is padded with zero rows, which add exact zeros to
every accumulator; ``shard_range(d, world, index)`` gives a shard's rows.
The local pass is ``summary_engine.chunk_contribution``, the one body of
the ``scan`` backend and of the stream: on the card, projection rows and
one ``ops.sketch_fused`` launch per matrix. For SRHT the rows come from the
plan of the real d, as in the reference.

Every rank computes the same result: the all-reduce hands each rank the
same sums, and steps 2 and 3 run replicated from the same key.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core import error_engine, refinement
from repro_torch.core.linalg import sqrt_f32
from repro_torch.core.streaming import (
    StreamingSummarizer, StreamState, _check_row_bounds, _count, merge_states)
from repro_torch.core.summary_engine import (
    METHODS, build_summary, chunk_contribution, srht_plan)
from repro_torch.core.types import LowRankFactors, SketchSummary


def _levels(group) -> tuple:
    """The reduction hierarchy, outer level first: ``(group,)`` or
    ``(outer, inner)``."""
    levels = tuple(group) if isinstance(group, (tuple, list)) else (group,)
    if len(levels) not in (1, 2) or any(g is None for g in levels):
        raise ValueError(f"group must be a process group or an (outer, "
                         f"inner) pair of them, got {group!r}")
    if len(levels) == 2 and \
            math.prod(dist.get_world_size(g) for g in levels) != \
            dist.get_world_size():
        raise ValueError("an (outer, inner) pair must span the default "
                         "group (dist.multihost.host_groups builds one)")
    return levels


def world_size(group) -> int:
    """Number of shards: the ranks of ``group`` (of both levels of a
    pair)."""
    return math.prod(dist.get_world_size(g) for g in _levels(group))


def shard_index(group) -> int:
    """This rank's global shard position, row-major over the hierarchy
    (outer level first), as ``PartitionSpec((outer, inner))`` lays rows
    out in the JAX package."""
    idx = 0
    for g in _levels(group):
        idx = idx * dist.get_world_size(g) + dist.get_rank(g)
    return idx


def shard_range(d: int, world: int, index: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of shard ``index`` of ``world`` over d rows:
    ``ceil(d / world)`` rows each, the trailing shards short (or empty)."""
    if world < 1 or not 0 <= index < world:
        raise ValueError(f"shard {index} outside {world} shards")
    rows = -(-d // world)
    lo = min(index * rows, d)
    return lo, min(lo + rows, d)


def _block_psum(x: torch.Tensor, levels: tuple) -> torch.Tensor:
    """All-reduce a large block in place: the innermost level first, then
    each outer level (the flat sum reassociated)."""
    for g in reversed(levels):
        dist.all_reduce(x, group=g)
    return x


def _scalar_psum(x: torch.Tensor, levels: tuple) -> torch.Tensor:
    """All-reduce the squared norms in place in one collective over all the
    ranks, as the flat path does, so that both paths give the same bits."""
    dist.all_reduce(x, group=levels[0] if len(levels) == 1 else None)
    return x


def _own_rows(X: torch.Tensor, rows: int, lo: int, hi: int,
              local: bool = False) -> torch.Tensor:
    """This rank's rows ``[lo, hi)`` (X itself when ``local``, else a view
    of the whole X), zero-padded to ``rows``; no copy when none is
    padded."""
    X = X if local else X[lo:hi]
    if X.shape[0] != hi - lo:
        raise ValueError(f"this rank's shard holds rows [{lo}, {hi}), got "
                         f"{X.shape[0]} rows")
    if X.shape[0] == rows:
        return X
    return torch.nn.functional.pad(X, (0, 0, 0, rows - X.shape[0]))


def distributed_sketch_summary(group, key: torch.Tensor, A: torch.Tensor,
                               B: torch.Tensor, k: int,
                               method: str = "gaussian",
                               precision: Optional[str] = None, *,
                               d: Optional[int] = None,
                               device="cuda") -> SketchSummary:
    """One-pass summary with the rows of A and B sharded over ``group``.

    A and B are the whole (d, n) pair on every rank, of which each rank
    reads its own shard (a view), or, with ``d`` given, this rank's rows
    ``shard_range(d, world_size(group), shard_index(group))`` alone. Each
    rank forms the projection columns of its own global rows from the
    (key, global row id) contract; the SRHT plan is drawn from ``key`` and
    the real d, the same on every rank. A ragged d pads the trailing shard
    with zero rows, so the summary is bit for bit that of an input padded
    by hand. ``group`` is one process group or an ``(outer, inner)`` pair
    (module docstring). Runs on ``device``, which must be the group's:
    CUDA with NCCL, the CPU with gloo."""
    if method not in METHODS:
        raise ValueError(f"unknown sketch method {method!r} (use {METHODS})")
    levels = _levels(group)
    world, idx = world_size(group), shard_index(group)
    dev = _device.resolve(device)
    key, A, B = key.to(dev), A.to(dev), B.to(dev)
    local = d is not None
    d = A.shape[0] if d is None else int(d)
    rows = -(-d // world)
    lo, hi = shard_range(d, world, idx)
    plan = srht_plan(key, d, k)[:2] if method == "srht" else None
    gids = torch.arange(idx * rows, (idx + 1) * rows, device=dev)
    dA, dB, na2, nb2 = chunk_contribution(
        key, plan, _own_rows(A, rows, lo, hi, local),
        _own_rows(B, rows, lo, hi, local), gids, k=k, method=method,
        precision=precision)
    As, Bs = _block_psum(dA, levels), _block_psum(dB, levels)
    na2, nb2 = _scalar_psum(na2, levels), _scalar_psum(nb2, levels)
    return SketchSummary(As, Bs, sqrt_f32(na2), sqrt_f32(nb2))


def distributed_streaming_update(group, summarizer: StreamingSummarizer,
                                 state: StreamState, A_slab: torch.Tensor,
                                 B_slab: torch.Tensor, row_offset: int = 0
                                 ) -> StreamState:
    """Absorb a slab of rows, sharded over ``group``, into a ``StreamState``
    that every rank holds alike.

    The slab's global rows are ``row_offset .. row_offset + slab_d``, A_slab
    and B_slab the whole slab on every rank (each rank reads its shard, a
    view). Each rank computes its
    shard's contribution (sketches, squared norms, and the probe block and
    co-sketch pair where the state carries them), the all-reduces sum them
    (the merge of the per-rank partial states), and the sum is merged into
    ``state`` as a delta that arrives "now": its data time is the state's
    clock, so ``merge_states`` settles the state's pending decay and adds
    the new rows at weight 1 (decay commutes with the sum). A ragged slab
    pads the trailing shard with zero rows; ``rows_seen`` and ``row_high``
    count the real rows."""
    levels = _levels(group)
    world, idx = world_size(group), shard_index(group)
    dev = state.A_acc.device
    slab_d = A_slab.shape[0]
    if slab_d == 0:
        return state
    row_offset = int(row_offset)
    _check_row_bounds(state, row_offset, row_offset + slab_d - 1)
    rows = -(-slab_d // world)
    lo, hi = shard_range(slab_d, world, idx)
    A_loc = _own_rows(A_slab.to(dev), rows, lo, hi)
    B_loc = _own_rows(B_slab.to(dev), rows, lo, hi)
    gids = torch.arange(row_offset + idx * rows,
                        row_offset + (idx + 1) * rows, device=dev)
    plan = None if state.signs is None else (state.signs, state.srows)
    prec = summarizer.precision
    dA, dB, dna2, dnb2 = chunk_contribution(
        state.key, plan, A_loc, B_loc, gids, k=summarizer.k,
        method=summarizer.method, precision=prec)
    dprobe = dY = dW = None
    if state.omega is not None:
        # the probe block is linear in the rows too: the same reduce
        dprobe = _block_psum(error_engine.probe_contribution(
            state.omega, A_loc, B_loc, prec), levels)
    if state.cosketch_omega is not None:
        dY, dW = refinement.cosketch_contribution(
            state.cosketch_omega, state.cosketch_psi, A_loc, B_loc, prec)
        dY, dW = _block_psum(dY, levels), _block_psum(dW, levels)
    delta = StreamState(
        key=None, A_acc=_block_psum(dA, levels), B_acc=_block_psum(dB, levels),
        na2=_scalar_psum(dna2, levels), nb2=_scalar_psum(dnb2, levels),
        rows_seen=_count(slab_d), row_high=_count(row_offset + slab_d),
        d_total=state.d_total, signs=state.signs, srows=state.srows,
        omega=state.omega, probe_acc=dprobe, decay_rate=state.decay_rate,
        t_state=state.t_state, t_data=state.t_state,
        cosketch_omega=state.cosketch_omega,
        cosketch_psi=state.cosketch_psi, cosketch_Y=dY, cosketch_W=dW)
    return merge_states(state, delta)


def distributed_streaming_summary(group, key: torch.Tensor, A: torch.Tensor,
                                  B: torch.Tensor, k: int,
                                  method: str = "gaussian",
                                  precision: Optional[str] = None,
                                  slab: Optional[int] = None,
                                  probes: int = 0, cosketch: int = 0, *,
                                  device="cuda") -> SketchSummary:
    """A whole streaming pass over the row-sharded pair: ``slab``-row slabs
    (rounded down to a multiple of the shard count, at least one row a
    shard), each through ``distributed_streaming_update``, then
    ``finalize``. With ``slab=None`` the pair is one slab. ``probes`` keeps
    the held-out probe block, ``cosketch`` the co-sketch pair. A and B are
    the whole pair on every rank; runs on ``device``."""
    d = A.shape[0]
    world = world_size(group)
    summ = StreamingSummarizer(k, method=method, precision=precision,
                               probes=probes, cosketch=cosketch,
                               device=device)
    state = summ.init(key, (d, A.shape[1], B.shape[1]))
    slab = d if slab is None else int(slab)
    slab = max(world, slab - slab % world)
    for off in range(0, d, slab):
        state = distributed_streaming_update(
            group, summ, state, A[off:off + slab], B[off:off + slab],
            row_offset=off)
    return summ.finalize(state)


def distributed_smppca(group, key: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, *, r: int, k: int, m: int,
                       T: int = 10, method: str = "gaussian",
                       device="cuda") -> LowRankFactors:
    """The whole pipeline over ``group``: ``split(key)``, the all-reduced
    pass (``build_summary(backend='distributed')``), then steps 2 and 3
    replicated on every rank from the same key (they are small next to
    the pass), so every rank returns the same factors up to the card's
    WAltMin atomics. A and B are the whole pair on every rank."""
    from repro_torch.core.smppca import smppca_from_summary
    dev = _device.resolve(device)
    k1, k2 = prng.split(key.to(dev))
    summary = build_summary(k1, A, B, k, method=method, backend="distributed",
                            group=group, device=dev)
    return smppca_from_summary(k2, summary, r=r, m=m, T=T,
                               device=dev).factors
