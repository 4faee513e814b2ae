"""The port's serving stack on the CPU: the continuous-batching contract of
``serve.scheduler`` (the twins of tests/serve/test_scheduler.py), the
``SketchService`` request guards and cache sharing (the twins of
tests/serve/test_service.py), a batch against its requests served alone,
threads sharing one loop, and ``run_traffic`` at a small size.

Everything host-side runs under a virtual clock (``clock=lambda: now[0]``)
so deadline forcing, wait-time shedding and EDF ordering are
deterministic; the dispatch tests use tiny shapes so each cache entry is
built once and the warm-path assertions read real ``PipelineEngine``
counters. Every thread a test starts is stopped in a ``finally``, and
every wait has a timeout.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import pipeline, summary_engine
from repro_torch.core.pipeline import PipelineEngine
from repro_torch.serve.engine import SketchService
from repro_torch.serve.scheduler import (
    DISPATCH_DEADLINE, DISPATCH_DRAIN, DISPATCH_FULL, SHED_QUEUE_FULL,
    SHED_WAIT_EXCEEDED, LoopConfig, PipelineWork, Rejected, ServingLoop,
    SummaryWork)
from repro_torch.serve.traffic import TrafficConfig, run_traffic

SPEC = pipeline.SketchSpec(k=8, backend="scan", block=32)
PLAN = pipeline.PipelinePlan(
    sketch=SPEC,
    estimation=pipeline.EstimationSpec(m=64, T=2),
    rank=pipeline.RankPolicy(r=2), key_layout="service")
# Seconds a test waits on a future or a thread before failing.
WAIT_S = 120.0


def gaussian_pair(seed, d=64, n1=6, n2=5):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((d, n1)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((d, n2)).astype(np.float32)))


@pytest.fixture()
def key():
    return prng.PRNGKey(0)


def _loop(now, **kw):
    return ServingLoop(engine=PipelineEngine(),
                       config=LoopConfig(**kw), clock=lambda: now[0])


def _service(**kw):
    return SketchService(k=8, backend="scan", block=32, device="cpu", **kw)


# ---------------------------------------------------------------------------
# The scheduler (tests/serve/test_scheduler.py)
# ---------------------------------------------------------------------------

def test_full_batch_dispatches_on_poll(key):
    """A bucket's open batch dispatches the moment it holds max_batch
    requests: continuous batching, no flush call anywhere."""
    now = [0.0]
    loop = _loop(now, max_batch=2)
    A, B = gaussian_pair(0)
    f1 = loop.submit(key, A, B, work=SummaryWork(SPEC))
    assert loop.poll() == 0                        # 1/2: stays open
    f2 = loop.submit(prng.fold_in(key, 1), A, B, work=SummaryWork(SPEC))
    assert loop.poll() == 1                        # 2/2: ONE batched call
    assert f1.done and f2.done
    assert tuple(f1.result(timeout=WAIT_S).A_sketch.shape) == (8, 6)
    assert loop.stats.occupancy == 2.0
    assert loop.stats.dispatched[DISPATCH_FULL] == 1


def test_deadline_forces_partial_batch(key):
    """A lone request cannot wait forever for batch-mates: when its budget
    runs out the scheduler dispatches the partial batch."""
    now = [0.0]
    loop = _loop(now, max_batch=4, dispatch_margin=0.1)
    A, B = gaussian_pair(0)
    f = loop.submit(key, A, B, work=SummaryWork(SPEC), deadline=1.0)
    assert loop.poll() == 0                        # budget remains: hold
    now[0] = 0.85
    assert loop.poll() == 0                        # 1.0 - 0.85 > margin
    now[0] = 0.95
    assert loop.poll() == 1                        # forced, 1/4 occupancy
    assert f.done and f.shed_reason is None
    assert loop.stats.dispatched[DISPATCH_DEADLINE] == 1
    assert loop.stats.batched_requests == 1


def test_shed_on_full_queue(key):
    """Admission past max_queue raises Rejected(SHED_QUEUE_FULL) and
    queues nothing."""
    now = [0.0]
    loop = _loop(now, max_queue=2)
    A, B = gaussian_pair(0)
    loop.submit(key, A, B, work=SummaryWork(SPEC))
    loop.submit(prng.fold_in(key, 1), A, B, work=SummaryWork(SPEC))
    with pytest.raises(Rejected, match="depth limit") as exc:
        loop.submit(prng.fold_in(key, 2), A, B, work=SummaryWork(SPEC))
    assert exc.value.reason == SHED_QUEUE_FULL
    assert loop.depth == 2
    assert loop.stats.shed[SHED_QUEUE_FULL] == 1
    assert loop.stats.admitted == 2


def test_wait_time_shed(key):
    """Requests queued past max_wait are shed at the next poll: the future
    resolves with the shed reason and result() raises Rejected."""
    now = [0.0]
    loop = _loop(now, max_wait=0.5)
    A, B = gaussian_pair(0)
    f = loop.submit(key, A, B, work=SummaryWork(SPEC))
    now[0] = 0.6
    assert loop.poll() == 0                        # shed, not dispatched
    assert f.done and f.shed_reason == SHED_WAIT_EXCEEDED
    with pytest.raises(Rejected, match="max_wait"):
        f.result(timeout=WAIT_S)
    assert loop.depth == 0
    assert loop.stats.shed[SHED_WAIT_EXCEEDED] == 1


def test_no_priority_inversion_across_buckets(key):
    """Several ready batches dispatch earliest-deadline first: a
    late-deadline pile-up in one bucket cannot starve another."""
    now = [0.0]
    loop = _loop(now, max_batch=4, dispatch_margin=0.0)
    A1, B1 = gaussian_pair(0)
    A2, B2 = gaussian_pair(9, n1=4, n2=3)
    late = loop.submit(key, A1, B1, work=SummaryWork(SPEC), deadline=10.0)
    early = loop.submit(key, A2, B2, work=SummaryWork(SPEC), deadline=1.0)
    now[0] = 10.0                                  # both deadlines due
    assert loop.poll() == 2
    assert early.dispatch_seq < late.dispatch_seq


def test_edf_within_an_overfull_bucket(key):
    """An overfull bucket serves its most urgent members in the first
    (full) batch; the late-deadline straggler waits for its own budget."""
    now = [0.0]
    loop = _loop(now, max_batch=2)
    A, B = gaussian_pair(0)
    f_late = loop.submit(key, A, B, work=SummaryWork(SPEC), deadline=9.0)
    f_mid = loop.submit(prng.fold_in(key, 1), A, B,
                        work=SummaryWork(SPEC), deadline=5.0)
    f_soon = loop.submit(prng.fold_in(key, 2), A, B,
                         work=SummaryWork(SPEC), deadline=1.0)
    assert loop.poll() == 1                        # full batch: soon + mid
    assert f_soon.done and f_mid.done and not f_late.done
    assert f_soon.dispatch_seq == f_mid.dispatch_seq
    now[0] = 9.0
    assert loop.poll() == 1                        # straggler's own deadline
    assert f_late.done
    assert loop.stats.dispatched == {DISPATCH_FULL: 1, DISPATCH_DEADLINE: 1}


def test_tenant_isolation_same_key_bit_different(key):
    """Two tenants submitting the SAME key batch together (tenancy is not in
    the batch signature) yet get different sketches; tenant=None is the
    un-namespaced summary, bit for bit."""
    now = [0.0]
    loop = _loop(now)
    A, B = gaussian_pair(0)
    f_acme = loop.submit(key, A, B, work=SummaryWork(SPEC), tenant="acme")
    f_glob = loop.submit(key, A, B, work=SummaryWork(SPEC), tenant="globex")
    f_none = loop.submit(key, A, B, work=SummaryWork(SPEC))
    assert loop.drain() == 1                       # mixed tenants, ONE batch
    s_acme, s_glob, s_none = (f.result(timeout=WAIT_S)
                              for f in (f_acme, f_glob, f_none))
    assert not torch.equal(s_acme.A_sketch, s_glob.A_sketch)
    assert not torch.equal(s_acme.A_sketch, s_none.A_sketch)
    baseline = summary_engine.build_summary(key, A, B, 8, backend="scan",
                                            block=32, device="cpu")
    assert torch.equal(s_none.A_sketch, baseline.A_sketch)
    manual = summary_engine.build_summary(
        pipeline.tenant_key(key, "acme"), A, B, 8, backend="scan", block=32,
        device="cpu")
    assert torch.equal(s_acme.A_sketch, manual.A_sketch)


def test_warm_cache_mixed_shape_traffic_zero_retraces(key):
    """After one cold pass per (shape bucket, batch width), mixed-shape
    traffic is cache hits only: no new build, occupancy > 1. pad='pow2'
    maps variable batch sizes onto the already-warm widths."""
    now = [0.0]
    loop = _loop(now, max_batch=2, pad="pow2", dispatch_margin=0.0)
    engine = loop.engine
    pairs = [gaussian_pair(0), gaussian_pair(9, n1=4, n2=3)]
    for i, (A, B) in enumerate(pairs):             # cold: widths 1 and 2
        loop.submit(prng.fold_in(key, i), A, B,
                    work=SummaryWork(SPEC), deadline=0.0)
        loop.poll()                                # width 1 (deadline)
        loop.submit(prng.fold_in(key, i + 2), A, B, work=SummaryWork(SPEC))
        loop.submit(prng.fold_in(key, i + 4), A, B, work=SummaryWork(SPEC))
        loop.poll()                                # width 2 (full)
    traces_cold = engine.stats.traces
    dispatches_cold = loop.stats.dispatches
    for rep in range(3):                           # steady state
        fs = []
        for i, (A, B) in enumerate(pairs):
            fs.append(loop.submit(prng.fold_in(key, 10 + rep * 4 + i), A, B,
                                  work=SummaryWork(SPEC)))
            fs.append(loop.submit(prng.fold_in(key, 20 + rep * 4 + i), A, B,
                                  work=SummaryWork(SPEC)))
        loop.poll()
        f = loop.submit(prng.fold_in(key, 30 + rep), pairs[0][0],
                        pairs[0][1], work=SummaryWork(SPEC), deadline=0.0)
        loop.poll()
        assert all(x.done for x in fs) and f.done
    assert engine.stats.traces == traces_cold      # no new build, warm
    assert loop.stats.dispatches > dispatches_cold
    assert loop.stats.occupancy > 1.0


def test_pow2_padding_is_bit_exact_and_bounds_traces(key):
    """A padded partial batch returns the same per-request results as an
    unpadded loop, bit for bit, and shares the padded width's entry (no new
    build when a full batch of that width arrives later)."""
    A, B = gaussian_pair(0)
    keys = [prng.fold_in(key, i) for i in range(7)]

    def run(pad):
        now = [0.0]
        loop = _loop(now, max_batch=4, pad=pad)
        fs = [loop.submit(k, A, B, work=SummaryWork(SPEC)) for k in keys[:3]]
        loop.drain()                               # batch of 3
        return loop, [f.result(timeout=WAIT_S) for f in fs]

    loop_p, padded = run("pow2")
    loop_n, plain = run("none")
    for sp, sn in zip(padded, plain):
        assert torch.equal(sp.A_sketch, sn.A_sketch)
    traces = loop_p.engine.stats.traces
    fs = [loop_p.submit(k, A, B, work=SummaryWork(SPEC)) for k in keys[:4]]
    assert loop_p.poll() == 1
    assert loop_p.engine.stats.traces == traces
    assert all(f.done for f in fs)


def test_drain_dispatches_whole_buckets(key):
    """drain() (the flush path) ignores max_batch: one call per shape
    bucket."""
    now = [0.0]
    loop = _loop(now, max_batch=2)
    A, B = gaussian_pair(0)
    fs = [loop.submit(prng.fold_in(key, i), A, B,
                      work=SummaryWork(SPEC), deadline=100.0 + i)
          for i in range(5)]
    assert loop.poll() == 2                        # 2 full batches pop
    assert loop.drain() == 1                       # the other 3 as ONE batch
    assert all(f.done for f in fs)
    assert loop.stats.dispatched[DISPATCH_DRAIN] == 1
    assert loop.stats.batched_requests == 5


def test_background_pump_resolves_futures(key):
    """start()/stop(): callers just submit and wait on futures; batching,
    deadline forcing and dispatch all happen on the loop's thread."""
    loop = ServingLoop(engine=PipelineEngine(),
                       config=LoopConfig(max_batch=2, default_deadline=0.05))
    A, B = gaussian_pair(0)
    loop.start(interval=1e-3)
    try:
        fs = [loop.submit(prng.fold_in(key, i), A, B,
                          work=PipelineWork(PLAN)) for i in range(3)]
        outs = [f.result(timeout=WAIT_S) for f in fs]
    finally:
        loop.stop(timeout=WAIT_S)
    assert all(tuple(o.estimate.factors.U.shape) == (6, 2) for o in outs)
    assert loop.stats.completed == 3
    assert loop.stats.dispatches == 2              # a full batch + straggler


def test_loop_config_validation():
    with pytest.raises(ValueError, match="max_batch"):
        ServingLoop(engine=PipelineEngine(), config=LoopConfig(max_batch=0))
    with pytest.raises(ValueError, match="max_queue"):
        ServingLoop(engine=PipelineEngine(), config=LoopConfig(max_queue=0))
    with pytest.raises(ValueError, match="pad"):
        ServingLoop(engine=PipelineEngine(), config=LoopConfig(pad="pow3"))


def test_failed_dispatch_fails_its_futures(key):
    """An engine error reaches the batch's callers through their futures
    (and the caller of drain), never leaving a future pending."""
    now = [0.0]
    loop = _loop(now)
    A, B = gaussian_pair(0)
    bad = pipeline.PipelinePlan(sketch=SPEC, rank=pipeline.RankPolicy(r=2),
                                key_layout="nope")
    f = loop.submit(key, A, B, work=PipelineWork(bad))
    with pytest.raises(ValueError, match="layout"):
        loop.drain()
    assert f.done and f.shed_reason is None
    with pytest.raises(ValueError, match="layout"):
        f.result(timeout=WAIT_S)
    assert loop.stats.completed == 0


# ---------------------------------------------------------------------------
# A batch against its requests served alone; threads sharing one loop
# ---------------------------------------------------------------------------

def test_batch_equals_requests_served_alone(key):
    """A bucket of three requests (full pipeline, one batched call) gives
    each request what it gets alone, bit for bit on the CPU (each pair of
    a batch runs the single-pair operations)."""
    now = [0.0]
    loop = _loop(now)
    pairs = [gaussian_pair(20 + i) for i in range(3)]
    keys = [prng.fold_in(key, i) for i in range(3)]
    fs = [loop.submit(k, A, B, work=PipelineWork(PLAN))
          for k, (A, B) in zip(keys, pairs)]
    assert loop.drain() == 1
    alone = PipelineEngine()
    for f, k, (A, B) in zip(fs, keys, pairs):
        got = f.result(timeout=WAIT_S)
        want = alone.run(PLAN, k, A, B)
        for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
            assert torch.equal(getattr(got.summary, name),
                               getattr(want.summary, name)), name
        assert torch.equal(got.estimate.factors.U, want.estimate.factors.U)
        assert torch.equal(got.estimate.factors.V, want.estimate.factors.V)


def test_threads_share_one_loop_and_engine(key):
    """Sixteen threads submit to one pumped loop (switch interval cut to
    1 us): every request is admitted, served once and counted once, and the
    engine's counters add up."""
    loop = ServingLoop(engine=PipelineEngine(),
                       config=LoopConfig(max_batch=4, default_deadline=0.01,
                                         pad="pow2"))
    A, B = gaussian_pair(0, d=32, n1=3, n2=2)
    futures, lock = [], threading.Lock()
    spec = pipeline.SketchSpec(k=4, backend="scan", block=32)

    def client(c):
        for i in range(4):
            f = loop.submit(prng.fold_in(key, 100 * c + i), A, B,
                            work=SummaryWork(spec))
            with lock:
                futures.append(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    loop.start(interval=1e-4)
    threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT_S)
        assert not any(th.is_alive() for th in threads)
        for f in futures:
            f.result(timeout=WAIT_S)
    finally:
        loop.stop(timeout=WAIT_S)
        sys.setswitchinterval(old)
    assert len(futures) == 64
    assert loop.stats.admitted == loop.stats.completed == 64
    assert loop.stats.batched_requests == 64
    stats = loop.engine.stats
    assert stats.hits + stats.misses == loop.stats.dispatches
    assert stats.misses == stats.traces == len(loop.engine)


# ---------------------------------------------------------------------------
# SketchService (tests/serve/test_service.py)
# ---------------------------------------------------------------------------

def test_submit_rejects_non_2d_inputs(key):
    svc = _service()
    A, B = gaussian_pair(0)
    with pytest.raises(ValueError, match=r"2-D.*\(64, 6, 1\)"):
        svc.submit(key, A[..., None], B)           # 3-D A
    with pytest.raises(ValueError, match="2-D"):
        svc.submit(key, A, B[:, 0])                # 1-D B
    assert svc.pending == 0


def test_submit_rejects_mismatched_row_dimension(key):
    svc = _service()
    A, B = gaussian_pair(0)
    with pytest.raises(ValueError,
                       match=r"row dimension.*\(64, 6\).*\(32, 5\)"):
        svc.submit(key, A, B[:32])
    assert svc.pending == 0
    assert isinstance(svc.submit(key, A, B), int)


def test_stream_factors_shares_warm_executables(key):
    """Two sessions with the same shapes and arguments share one
    from-summary entry: the second stream_factors call builds nothing."""
    eng = PipelineEngine()
    svc = _service(engine=eng)
    A, B = gaussian_pair(0)
    sid = svc.open_stream(key, 64, 6, 5)
    svc.append(sid, A, B)
    first = svc.stream_factors(sid, r=2, m=100, T=2)
    traces0 = eng.stats.traces
    sid2 = svc.open_stream(prng.fold_in(key, 1), 64, 6, 5)
    svc.append(sid2, A, B)
    second = svc.stream_factors(sid2, r=2, m=100, T=2)
    assert eng.stats.traces == traces0
    assert eng.stats.hits >= 1
    assert first.factors.U.shape == second.factors.U.shape
    assert not torch.equal(first.factors.U, second.factors.U)


def test_flush_and_flush_factors_share_summary_randomness(key):
    """flush() (summary-only entry) and flush_factors() (full entry) agree
    bit for bit on the summary of the same request."""
    eng = PipelineEngine()
    svc = _service(engine=eng)
    A, B = gaussian_pair(0)
    t0 = svc.submit(key, A, B)
    summary = svc.flush()[t0]
    t1 = svc.submit(key, A, B)
    served = svc.flush_factors(r=2, m=100, T=2)[t1]
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        assert torch.equal(getattr(summary, name),
                           getattr(served.summary, name)), name


def test_unknown_stream_id_raises_keyerror_with_id(key):
    """Every stream entry point names the offending id in a KeyError, for
    unknown AND already-closed streams."""
    svc = _service()
    A, B = gaussian_pair(0)
    for call in (lambda: svc.append("nope", A, B),
                 lambda: svc.stream_factors("nope", r=2, m=100, T=2),
                 lambda: svc.close_stream("nope")):
        with pytest.raises(KeyError, match="'nope'"):
            call()
    sid = svc.open_stream(key, 64, 6, 5)
    svc.append(sid, A, B)
    svc.close_stream(sid)
    with pytest.raises(KeyError, match=str(sid)):
        svc.append(sid, A, B)
    with pytest.raises(KeyError, match=str(sid)):
        svc.stream_factors(sid, r=2, m=100, T=2)
    with pytest.raises(KeyError, match=str(sid)):
        svc.close_stream(sid)


def test_empty_flush_returns_empty_without_dispatch(key):
    """flush()/flush_factors() with nothing queued return {} and never
    touch the engine."""
    eng = PipelineEngine()
    svc = _service(engine=eng)
    assert svc.flush() == {}
    assert svc.flush_factors(r=2, m=100, T=2) == {}
    assert eng.stats.traces == 0
    assert eng.stats.hits == 0 and eng.stats.misses == 0
    assert svc.loop.stats.dispatches == 0
    with pytest.raises(ValueError):
        svc.flush_factors(r="auto")                # auto rank needs tol


def test_default_engine_is_shared_across_services(key):
    """Unpinned services share the process-default engine; a service built
    on a loop pinned to another engine is refused."""
    a = _service()
    b = _service()
    assert a.engine is b.engine is pipeline.get_engine()
    c = _service(engine=PipelineEngine(max_entries=4))
    assert c.engine is not a.engine
    with pytest.raises(ValueError, match="engine= OR loop="):
        _service(engine=PipelineEngine(), loop=ServingLoop())


def test_service_default_device_is_cuda(monkeypatch):
    """The service runs on the card unless asked for the CPU, and refuses
    a default CUDA device without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SketchService(k=8)


# ---------------------------------------------------------------------------
# run_traffic at a small size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", [
    dict(name="mixed_tenants", shapes=((96, 6, 5), (128, 4, 4)),
         tenants=("acme", 7, None)),
    dict(name="overload_shed", shapes=((96, 6, 5),), rate_x=4.0,
         max_queue=2),
])
def test_run_traffic_small(cell):
    """Warm-up builds every entry, the steady state builds none, and every
    request is either served or shed with a reason (no clock is read by the
    assertions)."""
    cfg = TrafficConfig(n_requests=12, k=8, block=32, r=2, m=60, T=1,
                        max_batch=2, target_occupancy=2.0,
                        pairs_per_shape=2, **cell)
    rec = run_traffic(cfg, device="cpu")
    assert rec["device"] == "cpu"
    assert rec["traces_warmup"] == 2 * len(cfg.shapes)   # widths 1 and 2
    assert rec["traces_steady"] == 0
    assert rec["completed"] + sum(rec["shed"].values()) == cfg.n_requests
    assert set(rec["shed"]) <= {SHED_QUEUE_FULL, SHED_WAIT_EXCEEDED}
    assert rec["dispatches"] >= 1
