"""Batched serving engines.

The port of ``repro.serve.engine``:

``Engine``        LM serving: preallocated KV caches, prefill, then a
                  decode loop, greedy or temperature sampling, under
                  ``torch.inference_mode()`` on the model's device.
``SketchService`` sketch serving: a synchronous front end over the
                  continuously batched ``serve.scheduler.ServingLoop``.
                  ``submit``/``flush`` batch requests per shape bucket,
                  each bucket one batched call through the
                  ``core.pipeline.PipelineEngine`` cache, while the loop
                  underneath adds admission control, deadlines, load
                  shedding and tenant key namespacing for asynchronous
                  callers. ``flush()`` returns each request's summary;
                  ``flush_factors(r)`` the top-r factors of each A^T B.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core import pipeline, streaming
from repro_torch.core.streaming import (
    StreamingSummarizer, StreamState, WindowedSummarizer, WindowState)
from repro_torch.core.types import SketchSummary
from repro_torch.models.factory import Model
from repro_torch.serve.scheduler import (
    PipelineWork, ServedEstimate, ServeFuture, ServingLoop, SummaryWork,
    as_served)

__all__ = ["Engine", "ServeConfig", "SketchService", "ServedEstimate"]


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 -> greedy
    seed: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Generates with a ``Model`` and its parameters (``Model.init_params``
    or ``convert.lm_params_from_numpy``) on the model's device.

    ``timings`` holds the last ``generate``'s host-clock seconds of the
    prefill and of the decode loop (each ending in a synchronize on a CUDA
    device) and its decode steps."""

    def __init__(self, model: Model, params, cfg: ServeConfig = ServeConfig()):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.timings: Dict[str, float] = {}

    def _sample(self, key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        """Greedy ``argmax``, or ``jax.random.categorical(key, logits / T)``:
        the argmax of the logits over T plus gumbel noise under key."""
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        noise = prng.gumbel(key, tuple(logits.shape))
        return torch.argmax(noise + logits / self.cfg.temperature,
                            dim=-1).to(torch.int32)

    def generate(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """batch['tokens']: (B, P) prompts (+ stub-frontend aux inputs).
        Returns the (B, P + max_new_tokens) int32 token matrix. The first
        token is sampled under ``PRNGKey(seed)``, token t + 1 under that key
        folded with 0, ..., t in turn; decode step t sits at position P + t."""
        dev = self.model.device
        batch = {name: t.to(dev) for name, t in batch.items()}
        tokens = batch["tokens"]
        B, P = tokens.shape
        n_new = self.cfg.max_new_tokens
        with torch.inference_mode():
            caches = self.model.init_cache(B, P + n_new)
            t0 = time.perf_counter()
            logits, caches = self.model.prefill(self.params, batch, caches)
            key = prng.PRNGKey(self.cfg.seed, device=dev)
            cur = self._sample(key, logits[:, -1, :])[:, None]
            _sync(dev)
            t1 = time.perf_counter()
            out = [tokens.to(torch.int32)]
            for t in range(n_new - 1):
                out.append(cur)
                logits, caches = self.model.decode_step(self.params, caches,
                                                        cur, P + t)
                key = prng.fold_in(key, t)
                cur = self._sample(key, logits[:, -1, :])[:, None]
            out.append(cur)
            result = torch.cat(out, dim=1)
            _sync(dev)
        self.timings = {"prefill_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1,
                        "decode_steps": n_new - 1}
        return result


@dataclasses.dataclass
class _StreamSession:
    """One live accumulator: its summarizer, state and append cursor.

    ``summarizer``/``state`` are a ``StreamingSummarizer`` driving a
    ``StreamState`` (vanilla or decayed) or a ``WindowedSummarizer``
    driving a ``WindowState``; both expose the same update/finalize
    surface, so the session methods branch on the variant only in
    ``advance_stream`` (decay tick or window slide)."""

    key: torch.Tensor
    summarizer: Union[StreamingSummarizer, WindowedSummarizer]
    state: Union[StreamState, WindowState]
    next_row: int
    rows_seen: int


class SketchService:
    """Micro-batching front end for one-pass summary requests.

    Many callers each need the step-1 summary (or the factors) of their own
    (A, B) pair: per-layer gradients, per-tenant co-occurrence shards.
    ``SketchService`` queues requests and flushes them through a
    ``ServingLoop``: the scheduler buckets them by shape and each bucket
    runs as one batched call of a cached ``PipelineEngine`` entry, with
    per-request keys, so results equal each request served alone, and a
    warm bucket (repeat shapes) builds nothing. ``submit(..., tenant=)``
    namespaces a request's randomness (``pipeline.tenant_key``) without
    splitting the cache; asynchronous callers wanting continuous batching,
    deadlines and shedding drive ``service.loop`` directly.

    Two request styles share the service:

    * **one-shot**: ``submit(key, A, B)`` whole pairs, then ``flush()`` /
      ``flush_factors(r)``, one batched call per shape bucket;
    * **stream sessions**: ``open_stream(key, d, n1, n2)`` then
      ``append(sid, A_chunk, B_chunk)`` row chunks over time; ``query(sid)``
      reads the live summary at any point and ``stream_factors(sid, r)``
      runs the estimation ``flush_factors`` runs, with the same per-request
      key derivation: a pair appended in chunks of the service's ``block``
      rows and queried equals the pair submitted whole.

    Requests and sessions run on ``device`` ("cuda" by default, which
    raises without a card); submitted pairs are moved there, while request
    keys stay on the host, where the tenant fold and the key fan-out are a
    few integer operations.

    >>> import torch
    >>> from repro_torch import prng
    >>> key = prng.PRNGKey(0)
    >>> A, B = torch.randn(64, 6), torch.randn(64, 4)
    >>> svc = SketchService(k=8, backend="scan", block=32, device="cpu")
    >>> t0 = svc.submit(key, A, B)                 # one-shot request
    >>> tuple(svc.flush()[t0].A_sketch.shape)
    (8, 6)
    >>> sid = svc.open_stream(key, 64, 6, 4)       # stream session
    >>> svc.append(sid, A[:32], B[:32])
    32
    >>> svc.append(sid, A[32:], B[32:])
    64
    >>> tuple(svc.query(sid).A_sketch.shape)       # live summary
    (8, 6)
    >>> est = svc.stream_factors(sid, r=2, m=64, T=2)
    >>> tuple(est.factors.U.shape)
    (6, 2)
    """

    def __init__(self, k: int = 128, *, method: str = "gaussian",
                 backend: str = "scan", block: int = 1024,
                 precision: Optional[str] = None, probes: int = 0,
                 cosketch: int = 0, tuning=None,
                 engine: Optional[pipeline.PipelineEngine] = None,
                 loop: Optional[ServingLoop] = None, device="cuda"):
        self.k = k
        self.method = method
        self.backend = backend
        self.block = block
        self.precision = precision
        self.probes = probes
        self.cosketch = cosketch      # refinement co-sketch width (0 = off)
        self.tuning = tuning          # Optional[kernels.tuning.TuningSpec]
        self.device = _device.resolve(device)
        if loop is not None and engine is not None and \
                loop.engine is not engine:
            raise ValueError(
                "pass engine= OR loop=, not a loop pinned to a different "
                "engine: the service dispatches through loop.engine")
        self.loop = loop if loop is not None else ServingLoop(engine=engine)
        self.engine = self.loop.engine
        self._queue: List[Tuple[int, torch.Tensor, torch.Tensor,
                                torch.Tensor, Optional[Union[int, str]],
                                Optional[float]]] = []
        self._next_ticket = 0
        self._streams: Dict[int, _StreamSession] = {}
        self._next_stream = 0

    def submit(self, key: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
               tenant: Optional[Union[int, str]] = None,
               deadline: Optional[float] = None) -> int:
        """Queue one (A, B) pair under its own key; returns a ticket.

        ``tenant`` namespaces the request's randomness under a tenant id
        (``pipeline.tenant_key``; None keeps the key as it is).
        ``deadline`` is the request's budget in seconds, honoured when the
        ``ServingLoop`` is polled asynchronously (a synchronous ``flush``
        dispatches everything). Raises ``ValueError`` on non-2-D inputs or
        mismatched row dimensions.
        """
        if A.ndim != 2 or B.ndim != 2:
            raise ValueError(
                f"submit expects 2-D (d, n) matrices, got A with shape "
                f"{tuple(A.shape)} and B with shape {tuple(B.shape)}")
        if A.shape[0] != B.shape[0]:
            raise ValueError(
                f"A and B must share the streamed row dimension d, got "
                f"A with shape {tuple(A.shape)} vs B with shape "
                f"{tuple(B.shape)}")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._queue.append((ticket, key.cpu(), A.to(self.device),
                            B.to(self.device), tenant, deadline))
        return ticket

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _enqueue(self, work) -> Dict[int, ServeFuture]:
        """Hand the queued requests to the serving loop under one work spec
        (flush decides summary-only or full pipeline at flush time)."""
        futures = {}
        for ticket, key, A, B, tenant, deadline in self._queue:
            futures[ticket] = self.loop.submit(
                key, A, B, work=work, tenant=tenant, deadline=deadline)
        self._queue = []
        return futures

    def _sketch_spec(self) -> pipeline.SketchSpec:
        """The service's step-1 configuration as a plan stage."""
        return pipeline.SketchSpec(
            method=self.method, backend=self.backend, k=self.k,
            block=self.block, precision=self.precision, probes=self.probes,
            cosketch=self.cosketch)

    def flush(self) -> Dict[int, SketchSummary]:
        """One cached batched summary call per bucket; drains the queue. An
        empty queue returns ``{}`` without touching the engine."""
        if not self._queue:
            return {}
        futures = self._enqueue(SummaryWork(self._sketch_spec(),
                                            tuning=self.tuning))
        self.loop.drain()
        return {ticket: f.result()
                for ticket, f in futures.items()}

    def flush_factors(self, r=None, *, tol: Optional[float] = None,
                      r_max: Optional[int] = None, m: Optional[int] = None,
                      T: int = 6, est_method: str = "rescaled_jl",
                      est_backend: str = "cuda", use_splits: bool = False,
                      with_error: bool = False,
                      refine=None) -> Dict[int, ServedEstimate]:
        """The sketch -> estimate pipeline: per shape bucket one batched
        call of a cached entry (summary, estimation and the optional error
        estimate), and each request gets the top-r factors of its A^T B
        (and its summary).

        Rank selection is fixed (``r=<int>``) or quality-gated: ``r='auto'``
        with ``tol=<relative Frobenius error>`` reads each bucket's
        per-rank error curve once to fast-forward the doubling schedule
        past ranks that fail for some request (capped at ``r_max``), then
        gates on the served factors' a-posteriori estimate, so every
        request's ``ServedEstimate.error`` meets ``tol`` whenever a rank
        within the cap can. Gated (and ``with_error=True``) serving needs a
        probe-carrying service (``SketchService(probes=p)``).

        Each request's estimation key is ``fold_in(request key, 1)``, so
        results are reproducible per request and independent of the
        bucket's other requests. ``est_method='lela_waltmin'`` stacks the
        queued pairs as the exact second pass; ``est_method='power'`` with
        ``refine=RefineSpec(...)`` serves refined reconstructions (needs
        ``SketchService(cosketch=s)``).
        """
        gated = self._check_gate(r, tol, with_error)
        if not self._queue:
            return {}
        plan = self._plan(r=r if not gated else None, tol=tol, r_max=r_max,
                          m=m, T=T, est_method=est_method,
                          est_backend=est_backend, use_splits=use_splits,
                          with_error=with_error, gated=gated, refine=refine)
        futures = self._enqueue(PipelineWork(plan))
        self.loop.drain()
        return {ticket: as_served(f.result())
                for ticket, f in futures.items()}

    def _check_gate(self, r, tol, with_error) -> bool:
        """Validate a rank-selection request; True when quality-gated
        (``r='auto'``, or tol-driven): one rulebook for flush_factors and
        stream_factors."""
        gated = (r == "auto" or (r is None and tol is not None))
        if gated and tol is None:
            raise ValueError("r='auto' needs tol= (the relative-error gate)")
        if not gated and (isinstance(r, bool) or not isinstance(r, int)):
            raise ValueError(f"r must be an int or 'auto', got {r!r}")
        if (gated or with_error) and self.probes <= 0:
            raise ValueError(
                "quality-gated/with_error serving needs a probe-carrying "
                "service: construct SketchService(probes=p)")
        return gated

    def _plan(self, *, r, tol, r_max, m, T, est_method, est_backend,
              use_splits, with_error, gated,
              refine=None) -> pipeline.PipelinePlan:
        """One flush or stream request as a plan (the cache key). Gate-only
        knobs are left out on the fixed-rank path so that equivalent
        requests share cache entries."""
        rank = (pipeline.RankPolicy(r=None, tol=tol, r_max=r_max) if gated
                else pipeline.RankPolicy(r=r))
        return pipeline.PipelinePlan(
            sketch=self._sketch_spec(),
            estimation=pipeline.EstimationSpec(
                method=est_method, backend=est_backend, m=m, T=T,
                use_splits=use_splits),
            rank=rank, key_layout="service", with_error=with_error,
            tuning=self.tuning, refine=refine)

    # -- stream sessions ---------------------------------------------------

    def open_stream(self, key: torch.Tensor, d: int, n1: int, n2: int, *,
                    state: Optional[Union[StreamState, WindowState]] = None,
                    decay: float = 1.0,
                    window: Optional[int] = None) -> int:
        """Open an accumulator session for a (d, n1, n2) stream; returns
        its id.

        The session takes the service's ``k``, ``method``, ``precision``,
        ``probes`` and ``cosketch``. Pass ``state`` (for example from
        ``ckpt.checkpoint.restore_stream_state``) to resume a checkpointed
        pass: it must match the session's shapes and carry the same key
        (the sketch randomness lives in the state; another key would break
        the parity between ``stream_factors`` and ``flush_factors``).

        Drifting streams: ``decay=gamma`` opens an exponentially decayed
        session (``advance_stream`` ticks its clock); ``window=b`` a sliding
        window of ``b`` epochs (``advance_stream`` slides it; ``d`` is then
        the per-epoch row space and the cursor restarts each epoch). The
        two are exclusive. To resume a windowed session pass a
        ``WindowState`` from ``restore_window_state``.
        """
        if decay != 1.0 and window is not None:
            raise ValueError(
                f"pass decay= OR window=, not both (got decay={decay}, "
                f"window={window}): a session forgets by exponential decay "
                f"or by sliding window, not both at once")
        key = key.to(self.device)
        if window is not None:
            return self._open_window_stream(key, d, n1, n2,
                                            n_buckets=window, state=state)
        summ = StreamingSummarizer(self.k, method=self.method,
                                   precision=self.precision,
                                   probes=self.probes,
                                   cosketch=self.cosketch, decay=decay,
                                   device=self.device)
        if state is None:
            state = summ.init(key, (d, n1, n2))
        elif isinstance(state, WindowState):
            raise ValueError(
                "resumed state is a WindowState but the session was opened "
                "without window=: pass window=<n_buckets> to resume a "
                "windowed session")
        else:
            self._check_resumed(state, key, d, n1, n2, decay)
        sid = self._next_stream
        self._next_stream += 1
        self._streams[sid] = _StreamSession(
            key=key, summarizer=summ, state=state,
            next_row=int(state.row_high), rows_seen=int(state.rows_seen))
        return sid

    def _check_resumed(self, state: StreamState, key, d, n1, n2,
                       decay) -> None:
        shapes = (tuple(state.A_acc.shape), tuple(state.B_acc.shape),
                  int(state.d_total))
        want = ((self.k, n1), (self.k, n2), d)
        if shapes != want:
            raise ValueError(
                f"resumed state does not match this session: state has "
                f"(A_acc, B_acc, d_total) = {shapes}, session needs {want}")
        if state.n_probes != self.probes:
            raise ValueError(
                f"resumed state carries {state.n_probes} probe columns but "
                f"the service is configured with probes={self.probes}: "
                f"probe blocks cannot be grown or dropped mid-pass")
        if state.n_cosketch != self.cosketch:
            raise ValueError(
                f"resumed state carries a co-sketch block of width "
                f"{state.n_cosketch} but the service is configured with "
                f"cosketch={self.cosketch}: co-sketch blocks cannot be "
                f"grown or dropped mid-pass")
        if state.key is not None and not torch.equal(state.key.cpu(),
                                                     key.cpu()):
            raise ValueError(
                "resumed state carries a different base key than the "
                "session key: sketch and estimation randomness would "
                "disagree; pass the key the pass was started with")
        if (self.method == "srht") != (state.signs is not None):
            raise ValueError(
                f"resumed state method does not match the service's "
                f"method={self.method!r}")
        if state.decayed != (decay < 1.0):
            raise ValueError(
                f"resumed state {'carries' if state.decayed else 'has no'} "
                f"decay clock but the session was opened with "
                f"decay={decay}: a pass cannot change its decay policy "
                f"mid-stream")
        if state.decayed and float(state.decay_rate) != float(decay):
            raise ValueError(
                f"resumed state was decayed at rate "
                f"{float(state.decay_rate)} but the session was opened "
                f"with decay={decay}")

    def _open_window_stream(self, key, d, n1, n2, *, n_buckets, state) -> int:
        summ = WindowedSummarizer(self.k, n_buckets, method=self.method,
                                  precision=self.precision,
                                  probes=self.probes,
                                  cosketch=self.cosketch, device=self.device)
        if state is None:
            state = summ.init(key, (d, n1, n2))
        else:
            if not isinstance(state, WindowState):
                raise ValueError(
                    f"resuming a windowed session needs a WindowState from "
                    f"restore_window_state, got {type(state).__name__}")
            if len(state.buckets) != n_buckets:
                raise ValueError(
                    f"resumed window carries {len(state.buckets)} buckets "
                    f"but the session was opened with window={n_buckets}: "
                    f"window rings cannot be resized on resume")
            ref = state.buckets[0]
            shapes = (tuple(ref.A_acc.shape), tuple(ref.B_acc.shape),
                      int(ref.d_total))
            want = ((self.k, n1), (self.k, n2), d)
            if shapes != want:
                raise ValueError(
                    f"resumed window does not match this session: buckets "
                    f"have (A_acc, B_acc, d_total) = {shapes}, session "
                    f"needs {want}")
            if ref.n_probes != self.probes:
                raise ValueError(
                    f"resumed window carries {ref.n_probes} probe columns "
                    f"but the service is configured with probes="
                    f"{self.probes}")
            if ref.n_cosketch != self.cosketch:
                raise ValueError(
                    f"resumed window carries a co-sketch block of width "
                    f"{ref.n_cosketch} but the service is configured with "
                    f"cosketch={self.cosketch}")
            if not torch.equal(state.key.cpu(), key.cpu()):
                raise ValueError(
                    "resumed window carries a different base key than the "
                    "session key: bucket keys fold from the base key, so "
                    "the randomness would disagree; pass the key the "
                    "window was started with")
        sid = self._next_stream
        self._next_stream += 1
        slot = int(state.head) % n_buckets
        self._streams[sid] = _StreamSession(
            key=key, summarizer=summ, state=state,
            next_row=int(state.buckets[slot].row_high),
            rows_seen=sum(int(b.rows_seen) for b in state.buckets))
        return sid

    def advance_stream(self, stream_id: int, dt: int = 1) -> None:
        """Tick a drifting session's time axis by ``dt``.

        Decayed sessions advance their clock (each tick multiplies earlier
        mass by the session's ``decay``, settled lazily); windowed sessions
        slide ``dt`` epochs (the oldest buckets expire and the append cursor
        restarts at 0). Raises ``ValueError`` on a vanilla session and
        ``KeyError`` naming the id when the stream is unknown or closed.
        """
        sess = self._session(stream_id)
        if isinstance(sess.summarizer, WindowedSummarizer):
            sess.state = sess.summarizer.slide(sess.state, dt)
            sess.next_row = 0
        elif sess.summarizer.decay < 1.0:
            sess.state = sess.summarizer.advance(sess.state, dt)
        else:
            raise ValueError(
                f"stream {stream_id} has no time axis: open it with "
                f"decay= or window= to advance/slide it")

    def _session(self, stream_id: int) -> _StreamSession:
        """The live session for an id, or a ``KeyError`` naming it."""
        try:
            return self._streams[stream_id]
        except KeyError:
            raise KeyError(
                f"unknown or closed stream id {stream_id!r} (open streams: "
                f"{sorted(self._streams)})") from None

    def append(self, stream_id: int, A_chunk: torch.Tensor,
               B_chunk: torch.Tensor, row_offset: Optional[int] = None) -> int:
        """Absorb one row chunk into the live accumulator.

        ``row_offset`` defaults to the session's cursor (contiguous
        ingestion); pass it for out-of-order arrival. Returns the rows
        absorbed so far (a host-side count: appending never waits on the
        device). Raises ``KeyError`` naming the id when the stream is
        unknown or closed.
        """
        sess = self._session(stream_id)
        off = sess.next_row if row_offset is None else row_offset
        sess.state = sess.summarizer.update(sess.state, A_chunk, B_chunk, off)
        sess.next_row = max(sess.next_row, off + A_chunk.shape[0])
        sess.rows_seen += A_chunk.shape[0]
        return sess.rows_seen

    def append_async(self, stream_id: int, chunks, *,
                     prefetch: int = 2) -> int:
        """Absorb an iterator of ``(A_chunk, B_chunk)`` pairs through
        ``StreamingSummarizer.ingest``: on the card up to ``prefetch``
        upcoming host chunks are copied ahead on a side stream while the
        update for the current chunk runs. Equal bit for bit to the
        ``append`` loop at the same chunk boundaries. Chunks are contiguous
        from the session cursor (windowed sessions ingest into the head
        epoch). Returns the rows absorbed so far."""
        sess = self._session(stream_id)
        rows = 0

        def _counted():
            nonlocal rows
            for A_chunk, B_chunk in chunks:
                rows += A_chunk.shape[0]
                yield A_chunk, B_chunk

        sess.state = sess.summarizer.ingest(
            sess.state, _counted(), row_offset=sess.next_row,
            prefetch=prefetch)
        sess.next_row += rows
        sess.rows_seen += rows
        return sess.rows_seen

    def query(self, stream_id: int) -> SketchSummary:
        """Finalized summary of the live accumulator (the session keeps
        absorbing chunks afterwards)."""
        sess = self._session(stream_id)
        return sess.summarizer.finalize(sess.state)

    def export_stream(self, stream_id: int, *, wire=None,
                      tol: Optional[float] = None):
        """The live accumulator as a compressed wire image.

        ``wire`` names a ``streaming.WireSpec`` precision (default lossless
        f32); ``tol`` instead runs the probe-measured gate
        (``streaming.choose_wire_spec``; needs ``SketchService(probes=p)``).
        A windowed session exports its merged window under the session's
        base key, from which the far side rebuilds the shared probe and
        co-sketch matrices. ``streaming.wire_pack`` of the image gives the
        bytes.
        """
        sess = self._session(stream_id)
        state = sess.state
        if isinstance(sess.summarizer, WindowedSummarizer):
            state = sess.summarizer.merged(state)._replace(key=sess.key)
        if tol is not None:
            spec, _ = streaming.choose_wire_spec(state, tol)
        else:
            spec = "f32" if wire is None else wire
        return streaming.compress_state(state, spec)

    def stream_factors(self, stream_id: int, r=None, *,
                       tol: Optional[float] = None,
                       r_max: Optional[int] = None,
                       m: Optional[int] = None, T: int = 6,
                       est_method: str = "rescaled_jl",
                       est_backend: str = "cuda",
                       use_splits: bool = False,
                       with_error: bool = False,
                       refine=None) -> ServedEstimate:
        """``flush_factors`` against the live accumulator: finalize the
        session's state and run the same cached estimation path
        (``PipelineEngine.run_from_summary``) with the same per-request key
        derivation (``fold_in(session key, 1)``). ``r='auto'`` with
        ``tol=`` gates the rank as ``flush_factors`` does. Raises
        ``KeyError`` naming the id when the stream is unknown or closed."""
        sess = self._session(stream_id)
        gated = self._check_gate(r, tol, with_error)
        plan = self._plan(r=r if not gated else None, tol=tol, r_max=r_max,
                          m=m, T=T, est_method=est_method,
                          est_backend=est_backend, use_splits=use_splits,
                          with_error=with_error, gated=gated, refine=refine)
        summary = sess.summarizer.finalize(sess.state)
        est = self.engine.run_from_summary(plan, sess.key, summary)
        return ServedEstimate(summary, est.factors, error=est.error)

    def close_stream(self, stream_id: int) -> Union[StreamState, WindowState]:
        """Tear down a session; returns its final state (checkpointable).
        Raises ``KeyError`` naming the id when the stream is unknown or
        already closed."""
        self._session(stream_id)
        return self._streams.pop(stream_id).state
