"""Continuously batched serving loop: the scheduler/dispatcher split.

The port of ``repro.serve.scheduler``. The paper's sketch -> estimate ->
error recipe is a small fixed-shape computation a service runs many times,
and the ``PipelineEngine`` makes every warm request one cache lookup plus
the stages. This module puts a front end on that warm path:

* ``Scheduler``: host-side queueing only (no tensor work): an admission
  queue with **continuous batching** (a request joins its shape bucket's
  open batch the moment it arrives; the batch dispatches when full or when
  its most urgent member's deadline forces it), earliest-deadline-first
  ordering, and bounded queues with **backpressure and load shedding**
  (reject with a reason when depth or wait limits are exceeded).
* ``Dispatcher``: runs one ready batch as one batched ``PipelineEngine``
  call (``torch.stack`` the keys, A and B; run the plan; slice each
  request's result out with ``types.tree_index``) and resolves the
  requests' futures.
* ``ServingLoop``: the two behind a clock. ``submit`` admits a request and
  returns a ``ServeFuture`` at once; ``poll`` sheds expired requests and
  dispatches every ready batch; ``drain`` force-dispatches everything
  queued (the synchronous ``SketchService.flush`` path); ``start``/``stop``
  run ``poll`` on a background thread.

**Tenants**: a request submitted under ``tenant=`` has its key folded
through ``pipeline.tenant_key`` at admission, before batching, so tenants
share one warm cache while two tenants submitting the same key get
different sketches. Tenancy never enters the batch signature.

Everything is deterministic under an injected ``clock`` (tests drive a
virtual clock; production uses ``time.monotonic``):

>>> import torch
>>> from repro_torch import prng
>>> from repro_torch.core import pipeline
>>> key = prng.PRNGKey(0)
>>> A, B = torch.randn(64, 6), torch.randn(64, 4)
>>> plan = pipeline.PipelinePlan(
...     sketch=pipeline.SketchSpec(k=8, backend="scan", block=32),
...     estimation=pipeline.EstimationSpec(m=64, T=2),
...     rank=pipeline.RankPolicy(r=2), key_layout="service")
>>> now = [0.0]
>>> loop = ServingLoop(config=LoopConfig(max_batch=2), clock=lambda: now[0])
>>> f1 = loop.submit(key, A, B, work=PipelineWork(plan))
>>> f2 = loop.submit(prng.fold_in(key, 7), A, B, work=PipelineWork(plan),
...                  tenant="acme")
>>> loop.poll()                    # batch full (2/2): one batched call
1
>>> f1.done and f2.done
True
>>> tuple(f1.result(timeout=60).estimate.factors.U.shape)
(6, 2)
>>> loop.stats.occupancy           # continuous batching: 2 requests a call
2.0
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import pipeline
from repro_torch.core.pipeline import PipelineResult
from repro_torch.core.types import (
    ErrorEstimate, LowRankFactors, SketchSummary, tree_index)
from repro_torch.kernels.tuning import TuningSpec

#: Load-shed reasons (``Rejected.reason`` / ``LoopStats.shed`` keys).
SHED_QUEUE_FULL = "queue_full"        # admission: depth limit exceeded
SHED_WAIT_EXCEEDED = "wait_exceeded"  # scheduling: waited past max_wait

#: Dispatch triggers (``LoopStats.dispatched`` keys).
DISPATCH_FULL = "full"                # batch reached max_batch
DISPATCH_DEADLINE = "deadline"        # most urgent member's budget forced it
DISPATCH_DRAIN = "drain"              # explicit drain()/flush


class Rejected(RuntimeError):
    """A request the service refused (admission) or shed (scheduling).

    ``reason`` is one of the SHED_* constants; the message carries the
    limit that was exceeded so callers can apply backpressure upstream.
    """

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class SummaryWork(NamedTuple):
    """Step-1-only work: the request resolves to a ``SketchSummary``.

    ``tuning`` optionally pins kernel configs (a ``TuningSpec``) as
    ``PipelinePlan.tuning`` does for full-pipeline work; it is part of the
    work value, hence of the batch signature and the cache key.
    """

    spec: pipeline.SketchSpec
    tuning: Optional[TuningSpec] = None


class PipelineWork(NamedTuple):
    """Full-pipeline work: the request resolves to a ``PipelineResult``."""

    plan: pipeline.PipelinePlan


class LoopConfig(NamedTuple):
    """Scheduling policy knobs (all limits optional; None = unbounded).

    * ``max_batch``: dispatch a bucket's open batch the moment it holds
      this many requests (None: only deadlines or ``drain`` dispatch).
    * ``max_queue``: admission bound on total queued requests; past it
      ``submit`` raises ``Rejected(SHED_QUEUE_FULL)`` (backpressure).
    * ``max_wait``: requests queued longer than this are shed at the next
      ``poll`` with ``Rejected(SHED_WAIT_EXCEEDED)``.
    * ``default_deadline``: deadline budget (seconds from arrival) for
      requests submitted without one; None = no deadline.
    * ``dispatch_margin``: dispatch a partial batch this many seconds
      before its most urgent deadline (headroom for service time).
    * ``pad``: ``'none'`` dispatches batches at their exact size (every new
      size is a new cache signature); ``'pow2'`` right-pads each batch to
      the next power of two by repeating its last request, then drops the
      padding: per-request results are the same (each pair of a batch is
      computed alone), and variable-occupancy traffic builds at most
      log2(max_batch)+1 entries per bucket.
    """

    max_batch: Optional[int] = None
    max_queue: Optional[int] = None
    max_wait: Optional[float] = None
    default_deadline: Optional[float] = None
    dispatch_margin: float = 0.0
    pad: str = "none"


@dataclasses.dataclass
class LoopStats:
    """Observable serving counters (the traffic run's raw cells)."""

    admitted: int = 0             # requests accepted into the queue
    completed: int = 0            # requests resolved with a result
    dispatches: int = 0           # batched engine calls
    batched_requests: int = 0     # requests across all dispatches
    shed: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)        # reason -> count
    dispatched: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)        # trigger -> count

    @property
    def occupancy(self) -> float:
        """Mean requests per dispatch (what continuous batching buys)."""
        return self.batched_requests / self.dispatches if self.dispatches \
            else 0.0

    @property
    def shed_total(self) -> int:
        """Requests refused or shed, over every reason."""
        return sum(self.shed.values())


class ServeFuture:
    """Handle for one in-flight request.

    ``done`` flips when the dispatcher resolves or the scheduler sheds the
    request; ``result()`` returns the work's value (``SketchSummary`` or
    ``PipelineResult``) or raises ``Rejected`` if the request was shed, and
    the dispatch's exception if the engine raised. ``result(timeout=...)``
    blocks, so futures work alike whether the loop is polled inline or
    pumped by the background thread.
    """

    def __init__(self, seq: int):
        self.seq = seq
        self.dispatch_seq: Optional[int] = None   # which dispatch served it
        self.completed_at: Optional[float] = None
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        """True once resolved (with a result, a shed or an error)."""
        return self._event.is_set()

    @property
    def shed_reason(self) -> Optional[str]:
        """The SHED_* reason if the request was shed, else None."""
        return self._error.reason if isinstance(self._error, Rejected) \
            else None

    def result(self, timeout: Optional[float] = None):
        """The served value; raises ``Rejected`` for shed requests."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.seq} still pending")
        if self._error is not None:
            raise self._error
        return self._value

    def _resolve(self, value, dispatch_seq: int, now: float) -> None:
        self._value = value
        self.dispatch_seq = dispatch_seq
        self.completed_at = now
        self._event.set()

    def _fail(self, exc: BaseException, now: float) -> None:
        self._error = exc
        self.completed_at = now
        self._event.set()


@dataclasses.dataclass
class _Request:
    """One admitted request: payload and scheduling state."""

    seq: int
    key: torch.Tensor             # tenant fold already applied
    A: torch.Tensor
    B: torch.Tensor
    work: Union[SummaryWork, PipelineWork]
    arrival: float
    deadline: Optional[float]     # absolute clock time, None = none
    future: ServeFuture

    @property
    def urgency(self) -> float:
        """EDF sort key (requests without a deadline sort last)."""
        return math.inf if self.deadline is None else self.deadline


class _Batch(NamedTuple):
    """A dispatch-ready group of same-signature requests."""

    requests: List[_Request]
    trigger: str                  # DISPATCH_FULL / _DEADLINE / _DRAIN

    @property
    def urgency(self) -> Tuple[float, int]:
        """Inter-batch EDF order: most urgent member, then oldest seq."""
        return (min(r.urgency for r in self.requests),
                min(r.seq for r in self.requests))


def _signature(req: _Request) -> tuple:
    """Batch bucket key: the work spec and the shape, dtype and device of
    A, B and the key, so that stacking never promotes or moves a request's
    tensors. Tenancy is deliberately absent."""
    return (req.work,) + tuple((tuple(x.shape), x.dtype, x.device)
                               for x in (req.A, req.B, req.key))


class Scheduler:
    """Admission, continuous batching and EDF ordering (queueing only).

    Requests live in per-signature buckets; each bucket is its open batch:
    a request joins it on arrival and leaves when the batch dispatches
    (full, deadline-forced or drained) or when it is shed. No tensor work
    happens here; the dispatcher owns the device.
    """

    def __init__(self, config: LoopConfig):
        if config.max_batch is not None and config.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {config.max_batch}")
        if config.max_queue is not None and config.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {config.max_queue}")
        self.config = config
        self._buckets: "collections.OrderedDict[tuple, List[_Request]]" = \
            collections.OrderedDict()
        self._depth = 0

    @property
    def depth(self) -> int:
        """Total queued (not yet dispatched or shed) requests."""
        return self._depth

    def admit(self, req: _Request) -> None:
        """Queue a request into its bucket's open batch, or raise
        ``Rejected(SHED_QUEUE_FULL)`` when the depth bound is hit."""
        cfg = self.config
        if cfg.max_queue is not None and self._depth >= cfg.max_queue:
            raise Rejected(
                SHED_QUEUE_FULL,
                f"queue depth limit reached ({self._depth} >= "
                f"{cfg.max_queue} queued requests)")
        self._buckets.setdefault(_signature(req), []).append(req)
        self._depth += 1

    def shed_expired(self, now: float) -> List[_Request]:
        """Remove (and return) every request that has waited past
        ``max_wait``."""
        cfg = self.config
        if cfg.max_wait is None:
            return []
        expired: List[_Request] = []
        for sig in list(self._buckets):
            keep = []
            for req in self._buckets[sig]:
                if now - req.arrival > cfg.max_wait:
                    expired.append(req)
                else:
                    keep.append(req)
            self._prune(sig, keep)
        self._depth -= len(expired)
        return expired

    def ready(self, now: float) -> List[_Batch]:
        """Pop every dispatch-ready batch, most urgent first.

        A bucket's open batch is ready when it is full (``max_batch``
        members, repeatedly, so a backlog drains in ``max_batch``-sized
        dispatches) or when its most urgent member's deadline forces it
        (``deadline - now <= dispatch_margin``), however few requests it
        holds. Members leave earliest-deadline-first, and batches are
        returned EDF-ordered across buckets, so a late-deadline pile-up in
        one bucket cannot starve an earlier deadline in another.
        """
        cfg = self.config
        batches: List[_Batch] = []
        for sig in list(self._buckets):
            pending = sorted(self._buckets[sig], key=lambda r:
                             (r.urgency, r.seq))
            while cfg.max_batch is not None and \
                    len(pending) >= cfg.max_batch:
                batches.append(_Batch(pending[:cfg.max_batch],
                                      DISPATCH_FULL))
                pending = pending[cfg.max_batch:]
            if pending and pending[0].deadline is not None and \
                    pending[0].deadline - now <= cfg.dispatch_margin:
                batches.append(_Batch(pending, DISPATCH_DEADLINE))
                pending = []
            self._prune(sig, pending)
        self._depth -= sum(len(b.requests) for b in batches)
        batches.sort(key=lambda b: b.urgency)
        return batches

    def force_all(self) -> List[_Batch]:
        """Pop everything as one whole-bucket batch per signature (the
        ``drain``/flush path: batch sizes ignore ``max_batch``, so a manual
        flush stays one dispatch per shape bucket)."""
        batches = [_Batch(reqs, DISPATCH_DRAIN)
                   for reqs in self._buckets.values() if reqs]
        self._buckets.clear()
        self._depth = 0
        batches.sort(key=lambda b: b.urgency)
        return batches

    def _prune(self, sig: tuple, keep: List[_Request]) -> None:
        if keep:
            self._buckets[sig] = keep
        else:
            self._buckets.pop(sig, None)


class Dispatcher:
    """Runs one ready batch as one batched PipelineEngine call.

    Stacks the batch's keys, A and B for the engine's batched mode, runs
    the work's plan (or summary spec) through the shared cache, slices the
    batched result back out per request and resolves the futures. The
    engine computes each pair of a stack alone, so a request's result does
    not depend on its batch-mates. ``pad='pow2'`` repeats the last request
    up to the next power of two before stacking (and drops the padded
    lanes), bounding the batch-size signatures under variable occupancy;
    repeated lanes cannot move a quality gate, which takes a max over the
    batch. A future resolves once its result is computed, so
    ``completed_at`` includes the service time."""

    def __init__(self, engine: pipeline.PipelineEngine, pad: str = "none"):
        if pad not in ("none", "pow2"):
            raise ValueError(f"pad must be 'none' or 'pow2', got {pad!r}")
        self.engine = engine
        self.pad = pad

    def _padded(self, reqs: List[_Request]) -> List[_Request]:
        if self.pad == "none":
            return reqs
        width = 1 << (len(reqs) - 1).bit_length()
        return reqs + [reqs[-1]] * (width - len(reqs))

    def dispatch(self, batch: _Batch, dispatch_seq: int,
                 clock: Callable[[], float]) -> None:
        """Run the batch and resolve every member's future, stamped with
        ``clock()`` once the results are computed (on the card the
        dispatcher waits for its stream first)."""
        reqs = batch.requests
        lanes = self._padded(reqs)
        keys = torch.stack([r.key for r in lanes])
        A = torch.stack([r.A for r in lanes])
        B = torch.stack([r.B for r in lanes])
        work = reqs[0].work
        if isinstance(work, SummaryWork):
            out = self.engine.summarize(work.spec, keys, A, B, work.tuning)
        else:
            out = self.engine.run(work.plan, keys, A, B)
        if A.device.type == "cuda":
            torch.cuda.current_stream(A.device).synchronize()
        now = clock()
        for i, req in enumerate(reqs):
            req.future._resolve(tree_index(out, i), dispatch_seq, now)


class ServingLoop:
    """The serving stack: clock, Scheduler, Dispatcher and stats.

    ``submit`` is non-blocking admission (returns a ``ServeFuture`` or
    raises ``Rejected``, the backpressure signal); ``poll`` advances the
    loop one step (shed expired, dispatch ready); ``drain`` force-flushes
    everything queued. ``start``/``stop`` run ``poll`` on a daemon thread:
    admission and futures are thread-safe, and dispatches run outside the
    queue lock so slow device work never blocks admission. A dispatch that
    raises fails its batch's futures with the error; ``poll`` and
    ``drain`` then raise it too (the background pump keeps running).
    """

    def __init__(self, *, engine: Optional[pipeline.PipelineEngine] = None,
                 config: LoopConfig = LoopConfig(),
                 clock: Callable[[], float] = time.monotonic):
        self.engine = engine if engine is not None else pipeline.get_engine()
        self.config = config
        self.clock = clock
        self.scheduler = Scheduler(config)
        self.dispatcher = Dispatcher(self.engine, pad=config.pad)
        self.stats = LoopStats()
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def depth(self) -> int:
        """Currently queued requests (the backpressure observable)."""
        with self._lock:
            return self.scheduler.depth

    # -- admission ---------------------------------------------------------

    def submit(self, key: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
               work: Union[SummaryWork, PipelineWork],
               tenant: Optional[Union[int, str]] = None,
               deadline: Optional[float] = None) -> ServeFuture:
        """Admit one request; returns its future at once.

        ``tenant`` namespaces the request key through
        ``pipeline.tenant_key`` before batching (None leaves the key as
        it is). ``deadline`` is the request's budget in seconds from
        arrival (None uses ``config.default_deadline``); the scheduler
        force-dispatches a partial batch rather than let it lapse. Raises
        ``Rejected(SHED_QUEUE_FULL)`` when the queue bound is hit.
        """
        now = self.clock()
        if tenant is not None:
            key = pipeline.tenant_key(key, tenant)
        if deadline is None:
            deadline = self.config.default_deadline
        seq = next(self._seq)
        req = _Request(
            seq=seq, key=key, A=A, B=B, work=work, arrival=now,
            deadline=None if deadline is None else now + deadline,
            future=ServeFuture(seq))
        with self._lock:
            try:
                self.scheduler.admit(req)
            except Rejected as exc:
                self.stats.shed[exc.reason] += 1
                req.future._fail(exc, now)
                raise
            self.stats.admitted += 1
        return req.future

    # -- the loop body -----------------------------------------------------

    def poll(self) -> int:
        """One scheduling step: shed expired requests, then dispatch every
        ready batch (EDF order). Returns the number of dispatches."""
        now = self.clock()
        with self._lock:
            expired = self.scheduler.shed_expired(now)
            for _ in expired:
                self.stats.shed[SHED_WAIT_EXCEEDED] += 1
            batches = self.scheduler.ready(now)
        for req in expired:
            req.future._fail(Rejected(
                SHED_WAIT_EXCEEDED,
                f"request {req.seq} waited past max_wait="
                f"{self.config.max_wait}s"), now)
        return self._dispatch_batches(batches)

    def drain(self) -> int:
        """Force-dispatch everything queued, one dispatch per shape bucket
        regardless of batch-size limits (the synchronous flush path).
        Returns the number of dispatches."""
        with self._lock:
            batches = self.scheduler.force_all()
        return self._dispatch_batches(batches)

    def _dispatch_batches(self, batches: List[_Batch]) -> int:
        failure = None
        for batch in batches:
            with self._lock:
                self.stats.dispatches += 1
                dispatch_seq = self.stats.dispatches
                self.stats.batched_requests += len(batch.requests)
                self.stats.dispatched[batch.trigger] += 1
            try:
                self.dispatcher.dispatch(batch, dispatch_seq, self.clock)
            except Exception as exc:      # the batch's callers get the error
                now = self.clock()
                for req in batch.requests:
                    if not req.future.done:
                        req.future._fail(exc, now)
                failure = failure or exc
                continue
            with self._lock:
                self.stats.completed += len(batch.requests)
        if failure is not None:
            raise failure
        return len(batches)

    # -- background pump ---------------------------------------------------

    def start(self, interval: float = 1e-3) -> None:
        """Pump ``poll`` on a daemon thread every ``interval`` seconds:
        callers just ``submit`` and wait on futures. A failed dispatch has
        already failed its futures, so the pump goes on."""
        if self._thread is not None:
            raise RuntimeError("serving loop already started")
        self._stop.clear()

        def pump():
            while not self._stop.is_set():
                try:
                    self.poll()
                except Exception:         # noqa: BLE001 - futures hold it
                    pass
                self._stop.wait(interval)

        self._thread = threading.Thread(target=pump, daemon=True,
                                        name="serving-loop")
        self._thread.start()

    def stop(self, *, drain: bool = True, timeout: Optional[float] = None
             ) -> None:
        """Stop the background pump (then drain what is queued, unless
        ``drain=False``). Raises ``TimeoutError`` if the pump thread has
        not ended within ``timeout`` seconds."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("the serving loop's thread did not stop")
        self._thread = None
        if drain:
            self.drain()


class ServedEstimate(NamedTuple):
    """One served request: the step-1 summary, the step-2/3 factors, and
    (for probe-carrying services with ``with_error`` or a gated rank) the
    a-posteriori error estimate the gate read."""

    summary: SketchSummary
    factors: LowRankFactors
    error: Optional[ErrorEstimate] = None


def as_served(result: PipelineResult) -> ServedEstimate:
    """Repackage a per-request ``PipelineResult`` as the
    ``ServedEstimate`` the SketchService API serves."""
    return ServedEstimate(result.summary, result.estimate.factors,
                          error=result.estimate.error)
