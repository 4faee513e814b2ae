"""StreamingSummarizer: mergeable one-pass summaries over row chunks.

The port of ``repro.core.streaming``. The step-1 summary of (A, B) is a sum
over rows, so it can be built while the rows arrive, in chunks, on several
workers, and merged: the four-phase contract of a mergeable sketch (Tropp
et al., "Practical sketching algorithms for low-rank matrix
approximation"):

    init(key, shapes)                       -> StreamState   (empty monoid id)
    update(state, A_chunk, B_chunk, off)    -> StreamState   (absorb rows)
    merge(s1, s2)                           -> StreamState   (associative +)
    finalize(state)                         -> SketchSummary (sqrt the norms)

Every accumulator (the sketches, the *squared* column norms, the optional
held-out probe block ``(A^T B) @ Omega`` and the optional co-sketch pair
``(A^T B) @ Omega_c``, ``Psi_c @ (A^T B)``) is linear in the rows, so
``StreamState`` is a commutative monoid under ``merge``. The projection
column of global row ``i`` is a pure function of ``(key, i)`` (Gaussian
``fold_in``; SRHT through the popcount Hadamard identity from one
``srht_plan``), so a chunk's contribution depends only on its rows' ids.

Exactness grades, as in the JAX package:

* sequential ingestion at a fixed chunk size ``c`` (rows 0..d-1 in order) is
  **bit-identical** to ``build_summary(backend='scan', block=c)``: both add
  ``summary_engine.chunk_contribution`` of the same chunks in the same
  order (on the card, two ``sketch_fused`` launches a chunk). The scan pads
  its last block with zero rows and the stream does not. On the card the
  sketches and norms stay bit-identical with a ragged last chunk too
  (``sketch_fused`` sums in stages and chains of stages fixed from a call's
  first row, where zero rows add exact zeros; ``chip_smoke.py`` checks d = 50,000 at c = 1,024, 4,096 and
  16,384). The probe and co-sketch blocks are cuBLAS products, whose sums
  may follow the chunk's length, and on the CPU BLAS blocks every product
  by it: there the identity needs c to divide d, as the JAX package's
  tests take it;
* merge is **bit-commutative**;
* reassociating merges (other chunk sizes, shuffled arrival) agrees to
  float tolerance.

Drifting streams: ``StreamingSummarizer(decay=gamma)`` ages earlier mass by
``gamma`` per logical tick. ``decay_state`` only advances an integer clock;
the scalar multiply is settled lazily at the next update, merge or
finalize, so ``decay(merge(s1, s2)) == merge(decay(s1), decay(s2))`` bit for
bit. ``WindowedSummarizer(k, n_buckets=b)`` keeps a ring of ``b`` per-epoch
states under ``window_bucket_key(key, epoch)``; ``slide`` retires the oldest
epoch in O(1).

The wire layer (``compress_state``, ``wire_pack``, ...) writes a settled
state as the JAX package does, byte for byte, so an image crosses between
the two packages.

The port is eager: a ``StreamState`` is an immutable NamedTuple of tensors,
and every operation returns a new one. Its accumulators, key, SRHT plan and
test matrices live on the device of ``init``; its 0-d fields (the counters
``rows_seen``, ``row_high``, ``d_total`` and the decay clock) live on the
CPU, so the host loop reads them (bounds checks, ring slots, manifests)
without waiting for the card.

>>> import torch
>>> from repro_torch import prng
>>> key = prng.PRNGKey(0)
>>> A, B = torch.randn(64, 6), torch.randn(64, 4)
>>> summ = StreamingSummarizer(k=8, device="cpu")
>>> state = summ.init(key, (64, 6, 4))
>>> state = summ.update(state, A[:32], B[:32], 0)     # rows arrive in chunks
>>> state = summ.update(state, A[32:], B[32:], 32)
>>> s = summ.finalize(state)
>>> (tuple(s.A_sketch.shape), tuple(s.B_sketch.shape), int(state.rows_seen))
((8, 6), (8, 4), 64)
>>> from repro_torch.core.summary_engine import build_summary
>>> ref = build_summary(key, A, B, 8, device="cpu")
>>> bool(torch.allclose(s.A_sketch, ref.A_sketch, atol=1e-5))
True
"""
from __future__ import annotations

import collections
import json
import struct
from typing import Iterable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core import error_engine, refinement
from repro_torch.core.linalg import sqrt_f32
from repro_torch.core.summary_engine import (
    METHODS, chunk_contribution, srht_plan)
from repro_torch.core.types import SketchSummary


def _count(value) -> torch.Tensor:
    """A 0-d int32 counter on the CPU."""
    return torch.tensor(int(value), dtype=torch.int32)


class StreamState(NamedTuple):
    """Partial one-pass summary: the mergeable accumulator.

    Field for field ``repro.core.streaming.StreamState``. Norms are carried
    *squared* (``na2``/``nb2``) so ``merge`` is a plain sum on every field;
    the square root happens once, in ``finalize``. ``signs``/``srows`` hold
    the SRHT plan (None for gaussian); ``key`` is carried so a restored
    checkpoint keeps absorbing rows with the same randomness. The 0-d
    fields are CPU tensors (module docstring).
    """

    key: Optional[torch.Tensor]    # base key, on the state's device
    A_acc: torch.Tensor            # (k, n1) running Pi @ A
    B_acc: torch.Tensor            # (k, n2) running Pi @ B
    na2: torch.Tensor              # (n1,) running squared column norms of A
    nb2: torch.Tensor              # (n2,) running squared column norms of B
    rows_seen: torch.Tensor        # () int32 total rows absorbed
    row_high: torch.Tensor         # () int32 1 + the largest absorbed global
                                   #    row id (0 when empty): where a resumed
                                   #    contiguous cursor starts
    d_total: torch.Tensor          # () int32 global streamed dimension
    signs: Optional[torch.Tensor]  # (d,) SRHT signs, else None
    srows: Optional[torch.Tensor]  # (k,) SRHT sampled Hadamard rows, else None
    omega: Optional[torch.Tensor] = None      # (n2, p) held-out probes
    probe_acc: Optional[torch.Tensor] = None  # (n1, p) running (A^T B) @ omega
    decay_rate: Optional[torch.Tensor] = None  # () f32 retention per tick,
                                               #    None without decay
    t_state: Optional[torch.Tensor] = None    # () int32 logical now
    t_data: Optional[torch.Tensor] = None     # () int32 time the accumulators
                                              #    are aged to (<= t_state)
    cosketch_omega: Optional[torch.Tensor] = None  # (n2, s) range test
    cosketch_psi: Optional[torch.Tensor] = None    # (l, n1) co-range test
    cosketch_Y: Optional[torch.Tensor] = None      # (n1, s) running Y
    cosketch_W: Optional[torch.Tensor] = None      # (l, n2) running W

    @property
    def k(self) -> int:
        """Sketch size."""
        return self.A_acc.shape[0]

    @property
    def n_probes(self) -> int:
        """Held-out probe count p (0 when no probe block is carried)."""
        return 0 if self.probe_acc is None else self.probe_acc.shape[-1]

    @property
    def n_cosketch(self) -> int:
        """Co-sketch width s (0 when no refinement block is carried)."""
        return 0 if self.cosketch_Y is None else self.cosketch_Y.shape[-1]

    @property
    def decayed(self) -> bool:
        """Whether this state carries the exponential-decay clock."""
        return self.decay_rate is not None


def _check_mergeable(s1: StreamState, s2: StreamState) -> None:
    """Shape-level compatibility guard."""
    if s1.A_acc.shape != s2.A_acc.shape or s1.B_acc.shape != s2.B_acc.shape:
        raise ValueError(
            f"cannot merge stream states of different shapes: "
            f"{tuple(s1.A_acc.shape)}/{tuple(s1.B_acc.shape)} vs "
            f"{tuple(s2.A_acc.shape)}/{tuple(s2.B_acc.shape)}")
    if (s1.signs is None) != (s2.signs is None):
        raise ValueError("cannot merge gaussian and srht stream states")
    if (s1.probe_acc is None) != (s2.probe_acc is None):
        raise ValueError("cannot merge a probe-carrying stream state with a "
                         "probe-free one (init both with the same probes=)")
    if (s1.cosketch_Y is None) != (s2.cosketch_Y is None):
        raise ValueError(
            "cannot merge a cosketch-carrying stream state with a "
            "cosketch-free one (init both with the same cosketch=)")
    if (s1.decay_rate is None) != (s2.decay_rate is None):
        raise ValueError(
            "cannot merge a decayed stream state with an undecayed one "
            "(init both with the same decay=)")
    if s1.decay_rate is not None and \
            float(s1.decay_rate) != float(s2.decay_rate):
        raise ValueError(
            f"cannot merge stream states with different decay rates: "
            f"{float(s1.decay_rate)} vs {float(s2.decay_rate)}")


def _check_row_bounds(state: StreamState, lo: int, hi: int) -> None:
    """Reject global row ids outside [0, d_total): they would otherwise
    corrupt the summary silently (SRHT clamps into the sign vector;
    gaussian folds in a wrong index)."""
    d = int(state.d_total)
    if lo < 0 or hi >= d:
        raise ValueError(
            f"global row ids [{lo}, {hi}] fall outside the declared "
            f"streamed dimension d_total={d} from init()")


def _scale_blocks(state: StreamState, factor) -> StreamState:
    """Multiply every linear accumulator block (sketches, squared norms,
    the probe block and the co-sketch pair) by one scalar: decay
    settlement is exactly this."""
    return state._replace(
        A_acc=state.A_acc * factor,
        B_acc=state.B_acc * factor,
        na2=state.na2 * factor,
        nb2=state.nb2 * factor,
        probe_acc=(None if state.probe_acc is None
                   else state.probe_acc * factor),
        cosketch_Y=(None if state.cosketch_Y is None
                    else state.cosketch_Y * factor),
        cosketch_W=(None if state.cosketch_W is None
                    else state.cosketch_W * factor))


def _settle_state(state: StreamState) -> StreamState:
    """Apply pending decay: age the accumulators from ``t_data`` up to
    ``t_state`` (one scalar multiply per block; a no-op without decay or
    when nothing is pending). The factor ``decay_rate ** (t_state -
    t_data)`` is a float32 base to an int32 power, as in the JAX package."""
    if state.decay_rate is None or int(state.t_state) == int(state.t_data):
        return state
    factor = state.decay_rate ** (state.t_state - state.t_data)
    return _scale_blocks(state, factor)._replace(t_data=state.t_state)


def decay_state(state: StreamState, dt: int = 1) -> StreamState:
    """Advance the state's logical clock by ``dt`` ticks (the decay op).

    Each tick multiplies all *previously absorbed* mass by the state's
    ``decay_rate``, lazily: only the integer timestamp moves here, and the
    scalar multiply settles at the next update, merge alignment or
    finalize. So ``decay_state(merge_states(s1, s2), dt)`` is bitwise
    ``merge_states(decay_state(s1, dt), decay_state(s2, dt))``. The
    identity on an undecayed state. ``dt`` is a non-negative integer.
    """
    dt = int(dt)
    if dt < 0:
        raise ValueError(
            f"decay_state needs a non-negative tick count, got dt={dt}")
    if dt == 0 or state.decay_rate is None:
        return state
    return state._replace(t_state=state.t_state + dt)


def _align_states(s1: StreamState, s2: StreamState
                  ) -> Tuple[StreamState, StreamState]:
    """Age both decayed operands to the later ``t_data`` so ``merge`` can
    be a plain sum. Symmetric in (s1, s2), the basis of bitwise merge
    commutativity; the side already at the common timestamp is untouched."""
    td = torch.maximum(s1.t_data, s2.t_data)

    def _age(s: StreamState) -> StreamState:
        if int(s.t_data) == int(td):
            return s._replace(t_data=td)
        return _scale_blocks(s, s.decay_rate ** (td - s.t_data)
                             )._replace(t_data=td)

    return _age(s1), _age(s2)


def _plus(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    return None if a is None else a + b


def merge_states(s1: StreamState, s2: StreamState) -> StreamState:
    """Combine summaries of disjoint row sets (the monoid operation).

    A plain sum on every accumulator: commutative bit for bit, associative
    to float reassociation. The key and plan are taken from ``s1`` (both
    operands descend from the same ``init``). Decayed states are first
    aligned to a common data timestamp; the merged clock is the later of
    the two, so merging never rewinds time and pending decay stays pending.
    """
    _check_mergeable(s1, s2)
    extra = {}
    if s1.decay_rate is not None:
        s1, s2 = _align_states(s1, s2)
        extra = dict(t_state=torch.maximum(s1.t_state, s2.t_state),
                     t_data=s1.t_data)
    return s1._replace(
        A_acc=s1.A_acc + s2.A_acc,
        B_acc=s1.B_acc + s2.B_acc,
        na2=s1.na2 + s2.na2,
        nb2=s1.nb2 + s2.nb2,
        rows_seen=s1.rows_seen + s2.rows_seen,
        row_high=torch.maximum(s1.row_high, s2.row_high),
        probe_acc=_plus(s1.probe_acc, s2.probe_acc),
        cosketch_Y=_plus(s1.cosketch_Y, s2.cosketch_Y),
        cosketch_W=_plus(s1.cosketch_W, s2.cosketch_W),
        **extra)


def tree_merge(states: Sequence[StreamState]) -> StreamState:
    """Log-depth pairwise reduction of partial states (any reduction tree
    is equivalent by associativity; this one is fixed, so equal inputs
    merge bit-identically)."""
    states = list(states)
    if not states:
        raise ValueError("tree_merge needs at least one state")
    while len(states) > 1:
        nxt = [merge_states(states[i], states[i + 1])
               for i in range(0, len(states) - 1, 2)]
        if len(states) % 2:
            nxt.append(states[-1])
        states = nxt
    return states[0]


def finalize_state(state: StreamState) -> SketchSummary:
    """StreamState -> the step-1 ``SketchSummary`` (square root of the
    squared norms; the probe and co-sketch blocks and their test matrices
    ride along). Pending decay is settled first, so the summary describes
    the *decayed* product as of ``t_state``."""
    state = _settle_state(state)
    return SketchSummary(state.A_acc, state.B_acc,
                         sqrt_f32(state.na2), sqrt_f32(state.nb2),
                         probes=state.probe_acc, probe_omega=state.omega,
                         cosketch_Y=state.cosketch_Y,
                         cosketch_W=state.cosketch_W,
                         cosketch_omega=state.cosketch_omega,
                         cosketch_psi=state.cosketch_psi)


def _on(x, dev: torch.device) -> torch.Tensor:
    """A chunk (tensor or numpy array) as a tensor on ``dev``."""
    return torch.as_tensor(x).to(dev)


class _Staging:
    """One slot of ``ingest``'s copy ring: pinned host buffers for an A and
    a B chunk, and the event of the last copy out of them."""

    def __init__(self):
        self.bufs = [None, None]
        self.done: Optional[torch.cuda.Event] = None

    def stage(self, chunks, dev: torch.device, copy: torch.cuda.Stream):
        """Copy host chunks into the pinned buffers, then to ``dev`` on the
        copy stream; returns the device chunks and the copy's event."""
        if self.done is not None:
            self.done.synchronize()   # the last copy out of the buffers
        out = []
        for i, x in enumerate(chunks):
            host = torch.as_tensor(x)
            buf = self.bufs[i]
            if buf is None or buf.dtype != host.dtype or \
                    buf.numel() < host.numel():
                buf = self.bufs[i] = torch.empty(host.numel(),
                                                 dtype=host.dtype,
                                                 pin_memory=True)
            pinned = buf[:host.numel()].view(host.shape)
            pinned.copy_(host)
            with torch.cuda.stream(copy):
                out.append(pinned.to(dev, non_blocking=True))
        self.done = torch.cuda.Event()
        self.done.record(copy)
        return out[0], out[1], self.done


class StreamingSummarizer:
    """Chunked, mergeable front end to the summary engine's single pass.

    Configure once (sketch size, method, precision, blocks, decay, device);
    then drive any number of independent streams through ``init ->
    update* -> merge* -> finalize``. All randomness comes from the ``init``
    key through the (key, global row index) contract, so the result does
    not depend on chunking or merge order and matches the one-shot
    ``build_summary``. States live on ``device`` ("cuda" by default, which
    raises without a card); chunks are moved there.

    >>> import torch
    >>> from repro_torch import prng
    >>> summ = StreamingSummarizer(k=4, method="srht", device="cpu")
    >>> key = prng.PRNGKey(7)
    >>> A, B = torch.randn(32, 5), torch.randn(32, 3)
    >>> left = summ.init(key, (32, 5, 3))        # two independent workers ...
    >>> right = summ.init(key, (32, 5, 3))
    >>> left = summ.update(left, A[:16], B[:16], 0)
    >>> right = summ.update(right, A[16:], B[16:], 16)
    >>> s = summ.finalize(summ.merge(left, right))   # ... merged
    >>> tuple(s.B_sketch.shape)
    (4, 3)
    """

    def __init__(self, k: int, *, method: str = "gaussian",
                 precision: Optional[str] = None, probes: int = 0,
                 cosketch: int = 0, decay: float = 1.0, device="cuda"):
        if method not in METHODS:
            raise ValueError(
                f"unknown sketch method {method!r} (use {METHODS})")
        if isinstance(decay, bool) or not isinstance(decay, (int, float)) \
                or not 0.0 < float(decay) <= 1.0:
            raise ValueError(
                f"decay must be a retention factor in (0, 1], got {decay!r}")
        self.k = k
        self.method = method
        self.precision = precision
        self.probes = probes
        self.cosketch = cosketch
        self.decay = float(decay)
        self.device = device

    # -- contract ----------------------------------------------------------

    def init(self, key: torch.Tensor,
             shapes: Tuple[int, int, int]) -> StreamState:
        """Empty state for a (d, n1, n2) stream under ``key``, on the
        summarizer's device.

        ``d`` is the *global* streamed dimension: every update checks its
        row ids against it, and SRHT draws its sign and sample plan from
        (key, d) here, the one O(d) step; every update is O(chunk).
        """
        dev = _device.resolve(self.device)
        key = key.to(dev)
        d, n1, n2 = shapes
        if self.method == "srht":
            signs, srows, _ = srht_plan(key, d, self.k)
        else:
            signs = srows = None
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                           device=dev)
        omega = probe_acc = None
        if self.probes:
            omega = error_engine.probe_omega(key, n2, self.probes)
            probe_acc = zeros(n1, self.probes)
        c_omega = c_psi = c_Y = c_W = None
        if self.cosketch:
            c_omega = refinement.cosketch_omega(key, n2, self.cosketch)
            c_psi = refinement.cosketch_psi(key, n1, self.cosketch)
            c_Y = zeros(n1, self.cosketch)
            c_W = zeros(refinement.cosketch_width(self.cosketch), n2)
        decay_rate = t_state = t_data = None
        if self.decay < 1.0:
            decay_rate = torch.tensor(self.decay, dtype=torch.float32)
            t_state = t_data = _count(0)
        return StreamState(
            key=key, A_acc=zeros(self.k, n1), B_acc=zeros(self.k, n2),
            na2=zeros(n1), nb2=zeros(n2), rows_seen=_count(0),
            row_high=_count(0), d_total=_count(d), signs=signs, srows=srows,
            omega=omega, probe_acc=probe_acc, decay_rate=decay_rate,
            t_state=t_state, t_data=t_data, cosketch_omega=c_omega,
            cosketch_psi=c_psi, cosketch_Y=c_Y, cosketch_W=c_W)

    def update(self, state: StreamState, A_chunk, B_chunk,
               row_offset) -> StreamState:
        """Absorb a contiguous chunk of rows starting at global
        ``row_offset``.

        Chunks may arrive in any order, as long as each global row is
        absorbed once overall (the summary is a sum over rows). A zero-row
        chunk is the monoid identity. The bounds check reads only host
        counters, so an update on the card queues its work without waiting.
        """
        t = A_chunk.shape[0]
        if B_chunk.shape[0] != t:
            raise ValueError(f"chunk row counts differ: "
                             f"{tuple(A_chunk.shape)} vs "
                             f"{tuple(B_chunk.shape)}")
        if t == 0:
            return state
        off = int(row_offset)
        _check_row_bounds(state, off, off + t - 1)
        gids = torch.arange(off, off + t, device=state.A_acc.device)
        return self._absorb(state, A_chunk, B_chunk, gids, t, off + t)

    def update_rows(self, state: StreamState, row_ids, A_rows,
                    B_rows) -> StreamState:
        """Absorb rows with explicit global ids (arrival in any order, the
        paper's shuffled co-occurrence stream). An empty id array is a
        no-op."""
        t = A_rows.shape[0]
        ids = torch.as_tensor(row_ids)
        if B_rows.shape[0] != t or ids.shape[0] != t:
            raise ValueError(
                f"row ids / chunk row counts differ: ids {tuple(ids.shape)}, "
                f"A {tuple(A_rows.shape)}, B {tuple(B_rows.shape)}")
        if t == 0:
            return state
        # one device-to-host copy for both bounds
        lo, hi = (int(v) for v in torch.stack([ids.min(), ids.max()]).tolist())
        _check_row_bounds(state, lo, hi)
        return self._absorb(state, A_rows, B_rows,
                            ids.to(state.A_acc.device), t, hi + 1)

    def merge(self, s1: StreamState, s2: StreamState) -> StreamState:
        """Alias of ``merge_states``."""
        return merge_states(s1, s2)

    def advance(self, state: StreamState, dt: int = 1) -> StreamState:
        """Alias of ``decay_state`` (the identity without decay)."""
        return decay_state(state, dt)

    def finalize(self, state: StreamState) -> SketchSummary:
        """Alias of ``finalize_state``."""
        return finalize_state(state)

    # -- conveniences ------------------------------------------------------

    def summarize_chunks(self, key: torch.Tensor,
                         shapes: Tuple[int, int, int],
                         chunks: Iterable[Tuple[torch.Tensor, torch.Tensor]]
                         ) -> SketchSummary:
        """One-call sequential ingestion: ``(A_chunk, B_chunk)`` pairs in
        row order -> finalized summary."""
        state = self.init(key, shapes)
        off = 0
        for A_chunk, B_chunk in chunks:
            state = self.update(state, A_chunk, B_chunk, off)
            off += A_chunk.shape[0]
        return self.finalize(state)

    def ingest(self, state: StreamState,
               chunks: Iterable[Tuple[torch.Tensor, torch.Tensor]], *,
               row_offset: Optional[int] = None,
               prefetch: int = 2) -> StreamState:
        """Sequential ingestion of ``(A_chunk, B_chunk)`` pairs in row order,
        with host-to-device copies ahead of the compute on the card.

        On the card, host chunks (numpy arrays or CPU tensors, pageable or
        not) go through a ring of ``prefetch + 1`` pinned staging buffers
        per matrix and are copied to the card with ``non_blocking`` on a
        side stream, up to ``prefetch`` chunks ahead of the update that runs
        on the current stream. Events order the two streams: an update
        waits on its chunk's copy, a staging buffer is refilled only after
        the copy out of it has finished, and each staged chunk is
        ``record_stream``-ed on the compute stream so the caching allocator
        does not hand its memory out while the update still reads it. Each
        update is queued before the next chunk is staged, so the host's
        copy into pinned memory overlaps the card's work. Chunks already on
        the card are used as they are. ``prefetch=0`` is the serial
        baseline: copy, update, synchronize.

        Staging only moves bytes, so ``ingest`` is bit-identical to the
        ``update`` loop at the same chunk boundaries. On the CPU it is that
        loop. Chunks start at ``row_offset`` (default: the state's
        ``row_high``, the resume-contiguously convention).
        """
        if isinstance(prefetch, bool) or not isinstance(prefetch, int) \
                or prefetch < 0:
            raise ValueError(
                f"prefetch must be a non-negative chunk count, "
                f"got {prefetch!r}")
        off = int(state.row_high) if row_offset is None else int(row_offset)
        dev = state.A_acc.device
        if dev.type != "cuda":
            for A_chunk, B_chunk in chunks:
                state = self.update(state, A_chunk, B_chunk, off)
                off += A_chunk.shape[0]
            return state
        compute = torch.cuda.current_stream(dev)
        copy = torch.cuda.Stream(dev)
        ring = [_Staging() for _ in range(prefetch + 1)]
        it = iter(chunks)
        staged: collections.deque = collections.deque()
        n_staged = 0

        def _stage_next() -> None:
            nonlocal n_staged
            pair = next(it, None)
            if pair is None:
                return
            if all(torch.is_tensor(x) and x.device == dev for x in pair):
                staged.append((pair[0], pair[1], None))
            else:
                staged.append(ring[n_staged % len(ring)].stage(pair, dev,
                                                               copy))
            n_staged += 1

        for _ in range(prefetch + 1):          # prime the ring
            _stage_next()
        while staged:
            A_chunk, B_chunk, copied = staged.popleft()
            if copied is not None:
                compute.wait_event(copied)
                A_chunk.record_stream(compute)
                B_chunk.record_stream(compute)
            state = self.update(state, A_chunk, B_chunk, off)
            off += A_chunk.shape[0]
            del A_chunk, B_chunk
            if not prefetch:
                compute.synchronize()
            _stage_next()
        return state

    def _absorb(self, state, A_chunk, B_chunk, gids, t, hi1) -> StreamState:
        if A_chunk.shape[0] != B_chunk.shape[0]:
            raise ValueError(f"chunk row counts differ: "
                             f"{tuple(A_chunk.shape)} vs "
                             f"{tuple(B_chunk.shape)}")
        dev = state.A_acc.device
        A_chunk, B_chunk = _on(A_chunk, dev), _on(B_chunk, dev)
        # settle pending decay before absorbing: new rows enter at weight 1
        # (they arrive "now"), old mass is scaled down
        state = _settle_state(state)
        plan = None if state.signs is None else (state.signs, state.srows)
        dA, dB, dna2, dnb2 = chunk_contribution(
            state.key, plan, A_chunk, B_chunk, gids, k=self.k,
            method=self.method, precision=self.precision)
        probe_acc = state.probe_acc
        if state.omega is not None:
            probe_acc = probe_acc + error_engine.probe_contribution(
                state.omega, A_chunk, B_chunk, self.precision)
        c_Y, c_W = state.cosketch_Y, state.cosketch_W
        if state.cosketch_omega is not None:
            dY, dW = refinement.cosketch_contribution(
                state.cosketch_omega, state.cosketch_psi, A_chunk, B_chunk,
                self.precision)
            c_Y, c_W = c_Y + dY, c_W + dW
        return state._replace(
            A_acc=state.A_acc + dA, B_acc=state.B_acc + dB,
            na2=state.na2 + dna2, nb2=state.nb2 + dnb2,
            rows_seen=state.rows_seen + t,
            row_high=torch.maximum(state.row_high, _count(hi1)),
            probe_acc=probe_acc, cosketch_Y=c_Y, cosketch_W=c_W)


# -- wire format: a compressed StreamState for checkpoints and transfer -------

#: sketch-block precisions a WireSpec may name, cheapest last
WIRE_DTYPES = ("f32", "bf16", "int8")


class WireSpec(NamedTuple):
    """On-the-wire precision of a compressed ``StreamState``: the storage
    dtype of the sketch-shaped blocks (the two sketches and the co-sketch
    pair). The squared norms and the probe block always stay float32: the
    norms are the rescaled estimator's advantage, and the exact probe block
    is what measures the cost of quantization (``wire_error``).

    >>> WireSpec("bf16").bits
    16
    >>> WireSpec() == WireSpec("f32")   # default: lossless
    True
    """

    sketch: str = "f32"

    @property
    def bits(self) -> int:
        """Storage bits per sketch-block value."""
        return {"f32": 32, "bf16": 16, "int8": 8}[self.sketch]


class CompressedState(NamedTuple):
    """Tensors-only wire image of a *settled* ``StreamState``, field for
    field ``repro.core.streaming.CompressedState``.

    Everything derivable from ``key`` is dropped (the probe test matrix,
    the co-sketch pair, the SRHT plan) and rebuilt by ``decompress_state``.
    ``srht`` is a 0/1 scalar naming which plan to rebuild. Pending decay is
    settled by ``compress_state``, so only ``t_state`` travels. ``*_scale``
    are the per-slice symmetric dequantization scales (int8 only). 0-d
    fields are CPU tensors, as in ``StreamState``.
    """

    key: torch.Tensor
    A_blk: torch.Tensor                     # (k, n1) sketch, spec dtype
    B_blk: torch.Tensor                     # (k, n2) sketch, spec dtype
    na2: torch.Tensor                       # (n1,) f32, never quantized
    nb2: torch.Tensor                       # (n2,) f32, never quantized
    rows_seen: torch.Tensor
    row_high: torch.Tensor
    d_total: torch.Tensor
    srht: torch.Tensor                      # () int32: 1 = rebuild SRHT plan
    A_scale: Optional[torch.Tensor] = None  # (k, 1) int8 dequant scales
    B_scale: Optional[torch.Tensor] = None  # (k, 1)
    probe_acc: Optional[torch.Tensor] = None  # (n1, p) f32, never quantized
    decay_rate: Optional[torch.Tensor] = None
    t_state: Optional[torch.Tensor] = None
    cosketch_Y: Optional[torch.Tensor] = None  # (n1, s) spec dtype
    cosketch_W: Optional[torch.Tensor] = None  # (l, n2) spec dtype
    Y_scale: Optional[torch.Tensor] = None     # (1, s) int8 dequant scales
    W_scale: Optional[torch.Tensor] = None     # (l, 1)


def _as_wire_spec(spec: Union[WireSpec, str]) -> WireSpec:
    spec = WireSpec(spec) if isinstance(spec, str) else spec
    if not isinstance(spec, WireSpec) or spec.sketch not in WIRE_DTYPES:
        raise ValueError(
            f"wire spec must name a sketch dtype in {WIRE_DTYPES}, "
            f"got {spec!r}")
    return spec


def _quant_block(x: torch.Tensor, spec: WireSpec, axis: int):
    """(stored block, dequantization scale or None) for one sketch-shaped
    block. int8 is symmetric per slice along ``axis`` (scale = max|x| /
    127, kept as a dimension, clamped away from zero so all-zero slices
    stay exact zeros), rounding half to even as ``jnp.round`` does."""
    if spec.sketch == "f32":
        return x, None
    if spec.sketch == "bf16":
        return x.to(torch.bfloat16), None
    scale = torch.clamp(x.abs().amax(dim=axis, keepdim=True),
                        min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_block(blk: torch.Tensor,
                   scale: Optional[torch.Tensor]) -> torch.Tensor:
    if blk.dtype == torch.int8:
        return blk.float() * scale
    return blk.float()


def compress_state(state: StreamState,
                   spec: Union[WireSpec, str] = WireSpec()
                   ) -> CompressedState:
    """StreamState -> its wire image under ``spec``.

    Settles pending decay first (the wire carries one timestamp), then
    stores the sketch-shaped blocks at the spec's precision and everything
    else float32. With the default f32 spec, ``decompress_state`` returns
    a state bit-identical to the settled input, structure included.
    """
    spec = _as_wire_spec(spec)
    if state.key is None:
        raise ValueError(
            "compress_state needs the state's base key: the wire format "
            "regenerates the probe/co-sketch test matrices and the SRHT "
            "plan from it instead of shipping them")
    state = _settle_state(state)
    A_blk, A_scale = _quant_block(state.A_acc, spec, 1)
    B_blk, B_scale = _quant_block(state.B_acc, spec, 1)
    c_Y = c_W = Y_s = W_s = None
    if state.cosketch_Y is not None:
        c_Y, Y_s = _quant_block(state.cosketch_Y, spec, 0)
        c_W, W_s = _quant_block(state.cosketch_W, spec, 1)
    return CompressedState(
        key=state.key, A_blk=A_blk, B_blk=B_blk,
        na2=state.na2, nb2=state.nb2,
        rows_seen=state.rows_seen, row_high=state.row_high,
        d_total=state.d_total,
        srht=_count(0 if state.signs is None else 1),
        A_scale=A_scale, B_scale=B_scale,
        probe_acc=state.probe_acc,
        decay_rate=state.decay_rate, t_state=state.t_state,
        cosketch_Y=c_Y, cosketch_W=c_W, Y_scale=Y_s, W_scale=W_s)


def decompress_state(comp: CompressedState) -> StreamState:
    """Wire image -> a full ``StreamState`` ready to keep absorbing rows.

    Rebuilds every key-derived field (probe omega, co-sketch test pair,
    SRHT plan) from ``comp.key``, bit-identical to the originals by the
    (key, index) randomness contract, and dequantizes the sketch blocks.
    """
    k, n1 = comp.A_blk.shape
    n2 = comp.B_blk.shape[1]
    if int(comp.srht):
        signs, srows, _ = srht_plan(comp.key, int(comp.d_total), k)
    else:
        signs = srows = None
    omega = None
    if comp.probe_acc is not None:
        omega = error_engine.probe_omega(comp.key, n2,
                                         comp.probe_acc.shape[1])
    c_omega = c_psi = c_Y = c_W = None
    if comp.cosketch_Y is not None:
        s = comp.cosketch_Y.shape[1]
        c_omega = refinement.cosketch_omega(comp.key, n2, s)
        c_psi = refinement.cosketch_psi(comp.key, n1, s)
        c_Y = _dequant_block(comp.cosketch_Y, comp.Y_scale)
        c_W = _dequant_block(comp.cosketch_W, comp.W_scale)
    return StreamState(
        key=comp.key,
        A_acc=_dequant_block(comp.A_blk, comp.A_scale),
        B_acc=_dequant_block(comp.B_blk, comp.B_scale),
        na2=comp.na2, nb2=comp.nb2,
        rows_seen=comp.rows_seen, row_high=comp.row_high,
        d_total=comp.d_total, signs=signs, srows=srows,
        omega=omega, probe_acc=comp.probe_acc,
        decay_rate=comp.decay_rate,
        t_state=comp.t_state, t_data=comp.t_state,
        cosketch_omega=c_omega, cosketch_psi=c_psi,
        cosketch_Y=c_Y, cosketch_W=c_W)


def _wire_dtype(name: str, leaf: torch.Tensor) -> Tuple[str, int]:
    """(the JAX package's dtype string, bytes a value) of a wire field:
    the key travels as uint32 key data, bfloat16 by that name."""
    if name == "key":
        return "uint32", 4
    if leaf.dtype == torch.bfloat16:
        return "bfloat16", 2
    return str(np.dtype(str(leaf.dtype).split(".")[-1])), leaf.element_size()


def _wire_array(name: str, leaf: torch.Tensor) -> np.ndarray:
    """A wire field as host bytes: key data as uint32 words, bfloat16 as its
    uint16 bit patterns."""
    from repro_torch import convert
    if name == "key":
        return convert.key_to_numpy(leaf)
    return convert.tensor_to_bits(leaf)


def wire_bytes(comp: CompressedState) -> int:
    """Payload bytes of a wire image (the pack header, a few dozen bytes of
    field names, is excluded); the JAX package's count for the same
    image."""
    return sum(leaf.numel() * _wire_dtype(name, leaf)[1]
               for name, leaf in zip(comp._fields, comp) if leaf is not None)


def wire_pack(comp: CompressedState) -> bytes:
    """Serialize a wire image to self-describing bytes: a 4-byte
    little-endian header length, a JSON header listing each present field
    in ``CompressedState`` order (name, dtype string, shape), then the raw
    little-endian payloads. Byte for byte the JAX package's image of the
    same state."""
    header, payload = [], []
    for name, leaf in zip(comp._fields, comp):
        if leaf is None:
            continue
        arr = _wire_array(name, leaf)
        header.append({"field": name, "dtype": _wire_dtype(name, leaf)[0],
                       "shape": list(arr.shape)})
        payload.append(arr.tobytes())
    head = json.dumps(header).encode("utf-8")
    return struct.pack("<I", len(head)) + head + b"".join(payload)


def wire_unpack(data: bytes, device="cuda") -> CompressedState:
    """Inverse of ``wire_pack`` (also of the JAX package's): the image's
    fields as tensors on ``device``, 0-d fields on the CPU, the key as the
    port's key."""
    from repro_torch import convert
    dev = _device.resolve(device)
    (hlen,) = struct.unpack_from("<I", data, 0)
    header = json.loads(data[4:4 + hlen].decode("utf-8"))
    off = 4 + hlen
    kw = {}
    for field in header:
        bf16 = field["dtype"] == "bfloat16"
        dt = np.dtype(np.uint16 if bf16 else field["dtype"])
        count = int(np.prod(field["shape"], dtype=np.int64))
        arr = np.frombuffer(data, dtype=dt, count=count, offset=off)
        arr = arr.reshape(field["shape"])
        off += dt.itemsize * count
        if field["field"] == "key":
            kw["key"] = convert.key_from_numpy(arr, dev)
            continue
        t = convert.bits_to_tensor(arr, bf16=bf16)
        kw[field["field"]] = t if t.ndim == 0 else t.to(dev)
    return CompressedState(**kw)


def _sketch_probe(s: StreamState, w: torch.Tensor) -> torch.Tensor:
    """``A_acc^T (B_acc w)``, the sketch's estimate of ``(A^T B) w``,
    without forming n1 x n2."""
    return s.A_acc.T @ (s.B_acc @ w)


def wire_error(state: StreamState, spec: Union[WireSpec, str]) -> float:
    """Probe-measured relative error a round trip through ``spec`` adds.

    The probe block ``b_j = (A^T B) w_j`` is exact side information riding
    the state, so the cost of quantization is measured without forming the
    n1 x n2 product: sketch-estimate each probe from the original and the
    decompressed state, and return

        sqrt(mean_j ||dev_j||^2 / ||w_j||^2) / ||M||_F_est,

    with ``||M||_F_est`` the ErrorEngine's Frobenius estimate from the
    exact probe block. f32 round trips are bit-identical (error 0.0).
    """
    if state.omega is None:
        raise ValueError(
            "wire_error needs the held-out probe block (init the stream "
            "with probes>0) — it is the exact reference quantization "
            "error is measured against")
    spec = _as_wire_spec(spec)
    settled = _settle_state(state)
    rt = decompress_state(compress_state(settled, spec))
    w = settled.omega
    dev = _sketch_probe(rt, w) - _sketch_probe(settled, w)
    wn2 = torch.sum(w.float() ** 2, dim=0)
    frob_dev = sqrt_f32(torch.mean(torch.sum(dev ** 2, dim=0) / wn2))
    frob_m = sqrt_f32(torch.mean(
        torch.sum(settled.probe_acc ** 2, dim=0) / wn2))
    return float(frob_dev / torch.clamp(frob_m, min=1e-30))


def choose_wire_spec(state: StreamState, tol: float,
                     specs: Sequence[Union[WireSpec, str]] =
                     ("int8", "bf16", "f32")) -> Tuple[WireSpec, float]:
    """The probe-measured compression gate: the first spec of ``specs``
    (fewest wire bytes first) whose ``wire_error`` is within ``tol``, with
    the measured error. f32 is lossless (error 0.0), so when no candidate
    meets ``tol`` the gate falls back to f32."""
    if isinstance(tol, bool) or not isinstance(tol, (int, float)) \
            or not float(tol) > 0.0:
        raise ValueError(
            f"gate tolerance must be a positive relative error, got {tol!r}")
    for spec in specs:
        spec = _as_wire_spec(spec)
        err = 0.0 if spec.sketch == "f32" else wire_error(state, spec)
        if err <= float(tol):
            return spec, err
    return WireSpec("f32"), 0.0   # lossless meets any tolerance


# -- sliding window over epochs ----------------------------------------------

_WINDOW_TAG = 0x77647721  # ascii "wdw!": the reserved fold tag of bucket keys


def window_bucket_key(key: torch.Tensor, epoch) -> torch.Tensor:
    """Projection key of the window bucket holding ``epoch``: the window
    tag folded in first, then the epoch, so bucket keys never collide with
    row, tenant or probe folds of the same base key."""
    epoch = int(epoch)
    if epoch < 0:
        raise ValueError(f"window epoch must be non-negative, got {epoch}")
    return prng.fold_in(prng.fold_in(key, _WINDOW_TAG), epoch)


class WindowState(NamedTuple):
    """Sliding-window summary: a ring of per-epoch partial ``StreamState``s.

    ``buckets[e % n_buckets]`` holds epoch ``e``'s rows; ``head`` (a 0-d
    int32 CPU tensor) is the newest live epoch, so the window covers epochs
    ``head - n_buckets + 1 .. head`` (a fresh window starts at ``head =
    n_buckets - 1`` over empty past epochs).
    """

    key: torch.Tensor                   # base key (bucket keys fold from it)
    buckets: Tuple[StreamState, ...]    # ring; slot e % n_buckets: epoch e
    head: torch.Tensor                  # () int32 newest live epoch

    @property
    def n_buckets(self) -> int:
        """Ring size (the window length in epochs)."""
        return len(self.buckets)


class WindowedSummarizer:
    """Sliding-window front end: the summary of the last ``n_buckets``
    epochs.

    A ring of ``n_buckets`` partial ``StreamState``s, one per epoch, each
    under its own ``window_bucket_key``; the window summary is the merge of
    the live buckets, and ``slide`` retires the oldest epoch in O(1) by
    re-initializing one ring slot. Updates land in the head epoch with
    *bucket-local* row ids (each epoch is its own 0..d-1 row space). Every
    bucket shares the *base* key's probe and co-sketch test matrices: their
    blocks sum across buckets only against common test matrices.

    >>> import torch
    >>> from repro_torch import prng
    >>> win = WindowedSummarizer(k=4, n_buckets=2, device="cpu")
    >>> w = win.init(prng.PRNGKey(0), (8, 3, 2))
    >>> w = win.update(w, torch.randn(8, 3), torch.randn(8, 2), 0)
    >>> w = win.slide(w)             # next epoch opens, oldest expires
    >>> int(win.merged(w).rows_seen)   # still inside the window
    8
    >>> w = win.slide(w)             # the epoch holding those rows expires
    >>> bool(torch.all(win.finalize(w).A_sketch == 0))
    True
    """

    def __init__(self, k: int, n_buckets: int, *,
                 method: str = "gaussian",
                 precision: Optional[str] = None, probes: int = 0,
                 cosketch: int = 0, device="cuda"):
        if isinstance(n_buckets, bool) or not isinstance(n_buckets, int) \
                or n_buckets < 1:
            raise ValueError(
                f"n_buckets must be a positive int (the window length in "
                f"epochs), got {n_buckets!r}")
        self.n_buckets = n_buckets
        self._inner = StreamingSummarizer(
            k, method=method, precision=precision, probes=probes,
            cosketch=cosketch, device=device)

    @property
    def k(self) -> int:
        """Sketch size of every bucket."""
        return self._inner.k

    @property
    def method(self) -> str:
        """Sketch method of every bucket."""
        return self._inner.method

    @property
    def probes(self) -> int:
        """Held-out probe count carried by every bucket."""
        return self._inner.probes

    @property
    def cosketch(self) -> int:
        """Co-sketch width carried by every bucket."""
        return self._inner.cosketch

    def _fresh_bucket(self, key, shapes, epoch, omega,
                      cpair=None) -> StreamState:
        bucket = self._inner.init(window_bucket_key(key, epoch), shapes)
        if omega is not None:
            bucket = bucket._replace(omega=omega)
        if cpair is not None:
            bucket = bucket._replace(cosketch_omega=cpair[0],
                                     cosketch_psi=cpair[1])
        return bucket

    def init(self, key: torch.Tensor,
             shapes: Tuple[int, int, int]) -> WindowState:
        """Empty window for a (d, n1, n2) stream: ``head = n_buckets - 1``
        over empty epochs ``0 .. n_buckets - 1`` (``d`` is the per-epoch
        row space)."""
        key = key.to(_device.resolve(self._inner.device))
        omega = cpair = None
        if self._inner.probes:
            omega = error_engine.probe_omega(key, shapes[2],
                                             self._inner.probes)
        if self._inner.cosketch:
            cpair = (refinement.cosketch_omega(key, shapes[2],
                                               self._inner.cosketch),
                     refinement.cosketch_psi(key, shapes[1],
                                             self._inner.cosketch))
        buckets = tuple(self._fresh_bucket(key, shapes, e, omega, cpair)
                        for e in range(self.n_buckets))
        return WindowState(key=key, buckets=buckets,
                           head=_count(self.n_buckets - 1))

    def _check_ring(self, wstate: WindowState) -> None:
        if len(wstate.buckets) != self.n_buckets:
            raise ValueError(
                f"window state carries {len(wstate.buckets)} buckets but "
                f"this summarizer expects n_buckets={self.n_buckets}")

    def _head_slot(self, wstate: WindowState) -> int:
        self._check_ring(wstate)
        return int(wstate.head) % self.n_buckets

    def _with_head_bucket(self, wstate, bucket) -> WindowState:
        buckets = list(wstate.buckets)
        buckets[int(wstate.head) % self.n_buckets] = bucket
        return wstate._replace(buckets=tuple(buckets))

    def update(self, wstate: WindowState, A_chunk, B_chunk,
               row_offset) -> WindowState:
        """Absorb a contiguous chunk into the head epoch (bucket-local
        ``row_offset``)."""
        slot = self._head_slot(wstate)
        return self._with_head_bucket(wstate, self._inner.update(
            wstate.buckets[slot], A_chunk, B_chunk, row_offset))

    def update_rows(self, wstate: WindowState, row_ids, A_rows,
                    B_rows) -> WindowState:
        """Absorb rows with explicit bucket-local ids into the head epoch."""
        slot = self._head_slot(wstate)
        return self._with_head_bucket(wstate, self._inner.update_rows(
            wstate.buckets[slot], row_ids, A_rows, B_rows))

    def ingest(self, wstate: WindowState,
               chunks: Iterable[Tuple[torch.Tensor, torch.Tensor]], *,
               row_offset: Optional[int] = None,
               prefetch: int = 2) -> WindowState:
        """``StreamingSummarizer.ingest`` into the head bucket (same copy
        ring, same bit-identity, bucket-local row ids)."""
        slot = self._head_slot(wstate)
        return self._with_head_bucket(wstate, self._inner.ingest(
            wstate.buckets[slot], chunks, row_offset=row_offset,
            prefetch=prefetch))

    def slide(self, wstate: WindowState, n: int = 1) -> WindowState:
        """Advance the window by ``n`` epochs, O(1) each: the expiring slot
        is re-initialized under the *new* epoch's bucket key, nothing else
        is touched."""
        self._check_ring(wstate)
        if isinstance(n, bool) or not isinstance(n, int) or n < 1:
            raise ValueError(
                f"slide needs a positive epoch count, got {n!r}")
        ref = wstate.buckets[0]
        shapes = (int(ref.d_total), ref.A_acc.shape[1], ref.B_acc.shape[1])
        cpair = (None if ref.cosketch_omega is None
                 else (ref.cosketch_omega, ref.cosketch_psi))
        head = int(wstate.head)
        buckets = list(wstate.buckets)
        for _ in range(n):
            head += 1
            buckets[head % self.n_buckets] = self._fresh_bucket(
                wstate.key, shapes, head, ref.omega, cpair)
        return wstate._replace(buckets=tuple(buckets), head=_count(head))

    def merged(self, wstate: WindowState) -> StreamState:
        """The window as one ``StreamState``: live buckets merged in
        ascending epoch order (a fixed merge tree, so a window rebuilt
        from the same buckets merges bit-identically)."""
        self._check_ring(wstate)
        head = int(wstate.head)
        return tree_merge([wstate.buckets[e % self.n_buckets]
                           for e in range(head - self.n_buckets + 1,
                                          head + 1)])

    def finalize(self, wstate: WindowState) -> SketchSummary:
        """Finalize the merged window into a step-1 ``SketchSummary``."""
        return finalize_state(self.merged(wstate))
