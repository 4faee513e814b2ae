"""The port's PipelineEngine against the JAX package: plans, validation, the
cache (hits, builds, LRU eviction, the quality gate's dispatch counts; the
port's twins of tests/core/test_pipeline.py), the key layouts and tenant
folds bit for bit, and ``PipelineEngine.run`` of each preset, a refined
plan and a gated plan against the JAX package's.

Inputs are made with numpy from a seed. Every jax call runs under the
classic key tree (``jax.threefry_partitionable(False)``) on a fresh JAX
``PipelineEngine``; the JAX results are computed once per module.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jax_pipeline
from repro.core import refinement as jax_refinement
from repro_torch import convert, prng
from repro_torch.core import (
    error_engine, estimation_engine, pipeline, summary_engine)
from repro_torch.core.pipeline import (
    EstimationSpec, PipelineEngine, PipelinePlan, RankPolicy, SketchSpec)
from repro_torch.core.refinement import RefineSpec
from repro_torch.kernels import tuning
from repro_torch.serve.engine import SketchService

# U V^T of the two packages, relative Frobenius: without sampling (float32
# QR, SVD and products by other routines) within 1e-4; with a WAltMin
# completion of a sample within 1e-3 (the same samples up to a rare
# inverse-CDF tie), the tolerances of tests/test_torch_baselines.py.
UVT_RTOL = 1e-4
UVT_RTOL_COMPLETION = 1e-3
# A summary's fields: each column within 1e-5 of its largest entry
# (float32 sums over d rows in another order).
BLOCK_RTOL = 1e-5
# Share of Omega samples that may differ between the packages (an
# inverse-CDF tie moved by an ulp of the float32 CDF).
SAMPLE_SHARE = 1e-3
# The gate's known spectrum (tests/core/test_pipeline.py).
GATE_SPECTRUM = [16.0, 12.0, 8.0, 6.0, 4.0, 3.0, 0.05, 0.02]


def gaussian_pair(seed, d=64, n1=6, n2=5):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((d, n1)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((d, n2)).astype(np.float32)))


def known_spectrum_pair(seed, d, n1, n2, spectrum):
    """tests/conftest.py::known_spectrum_pair with numpy draws: A = W with
    orthonormal columns, B = W M, so A^T B = M has the given spectrum."""
    rng = np.random.default_rng(seed)
    s = np.asarray(spectrum, np.float64)
    q = s.shape[0]
    W = np.linalg.qr(rng.standard_normal((d, n1)))[0]
    U0 = np.linalg.qr(rng.standard_normal((n1, q)))[0]
    V0 = np.linalg.qr(rng.standard_normal((n2, q)))[0]
    M = (U0 * s) @ V0.T
    return (torch.from_numpy(W.astype(np.float32)),
            torch.from_numpy((W @ M).astype(np.float32)))


def service(k=8, probes=0, engine=None):
    return SketchService(k=k, backend="scan", block=32, probes=probes,
                         engine=engine, device="cpu")


def submit_bucketed(svc, key, shapes):
    """One request per (d, n) shape; same-shape entries share a bucket."""
    tickets = []
    for i, (d, n) in enumerate(shapes):
        kk = prng.fold_in(key, i)
        A, B = gaussian_pair(100 + i, d, n, n)
        tickets.append(svc.submit(kk, A, B))
    return tickets


def dense(factors):
    U, V = (np.asarray(x) for x in factors)
    return U @ V.T


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def close_to_column_max(got, want, rtol=BLOCK_RTOL):
    """Each column within ``rtol`` of its largest entry (a vector of norms:
    each entry within ``rtol`` of itself)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want) if want.ndim == 1 else \
        np.abs(want).max(axis=-2, keepdims=True)
    assert np.all(np.abs(got - want) <= rtol * scale), \
        float((np.abs(got - want) / scale).max())


@pytest.fixture()
def key():
    return prng.PRNGKey(0)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def test_plans_are_hashable_and_value_keyed():
    p1 = pipeline.smppca_plan(r=2, k=16, m=200, T=2)
    p2 = pipeline.smppca_plan(r=2, k=16, m=200, T=2)
    p3 = pipeline.smppca_plan(r=2, k=16, m=200, T=3)
    assert hash(p1) == hash(p2) and p1 == p2
    assert p1 != p3
    assert len({p1, p2, p3}) == 2


def test_plan_validation_errors(key):
    eng = PipelineEngine()
    A, B = gaussian_pair(0, d=32, n1=4, n2=3)
    bad = [
        (PipelinePlan(key_layout="nope", rank=RankPolicy(r=2)), "layout"),
        (PipelinePlan(sketch=SketchSpec(method="nope"),
                      rank=RankPolicy(r=2)), "sketch method"),
        (PipelinePlan(sketch=SketchSpec(backend="nope"),
                      rank=RankPolicy(r=2)), "summary backend"),
        (PipelinePlan(sketch=SketchSpec(backend="distributed"),
                      rank=RankPolicy(r=2)), "distributed"),
        (PipelinePlan(estimation=EstimationSpec(method="nope"),
                      rank=RankPolicy(r=2)), "estimation method"),
        (PipelinePlan(estimation=EstimationSpec(backend="nope"),
                      rank=RankPolicy(r=2)), "estimation backend"),
        (PipelinePlan(estimation=EstimationSpec(backend="pallas"),
                      rank=RankPolicy(r=2)), "estimation backend"),
        (PipelinePlan(rank=RankPolicy(r=None, tol=None)), "tol"),
        (PipelinePlan(rank=RankPolicy(r=None, tol=0.5)), "probe"),
        (PipelinePlan(rank=RankPolicy(r=2.5)), "int"),
        (PipelinePlan(rank=RankPolicy(r=2), with_error=True), "probes"),
        (PipelinePlan(estimation=EstimationSpec(method="power"),
                      rank=RankPolicy(r=2)), "cosketch"),
        (PipelinePlan(rank=RankPolicy(r=2), refine=RefineSpec()),
         "refine only applies"),
        (PipelinePlan(rank=RankPolicy(r=2), tuning="fast"), "TuningSpec"),
        (PipelinePlan(rank=RankPolicy(r=2), wire="bf16"), "WireSpec"),
    ]
    for plan, match in bad:
        with pytest.raises(ValueError, match=match):
            eng.run(plan, key, A, B)
    with pytest.raises(TypeError, match="PipelinePlan"):
        eng.run("not a plan", key, A, B)
    with pytest.raises(ValueError, match="max_entries"):
        PipelineEngine(max_entries=0)
    assert eng.stats.traces == 0 and len(eng) == 0


def test_batched_non_service_layout_raises(key):
    """A key stack with a layout other than 'service' is refused, as in the
    JAX package; a batched call needs a stack of keys."""
    eng = PipelineEngine()
    A, B = gaussian_pair(0, d=32, n1=4, n2=3)
    keys = prng.split(key, 2)
    plan = pipeline.smppca_plan(r=2, k=8, m=50, T=1)
    with pytest.raises(NotImplementedError, match="service"):
        eng.run(plan, keys, torch.stack([A, A]), torch.stack([B, B]))
    with pytest.raises(ValueError, match="stack of keys"):
        pipeline.derive_keys("service", key, batched=True)


# ---------------------------------------------------------------------------
# Plan-path parity with the stage-by-stage composition
# ---------------------------------------------------------------------------

def test_run_matches_stagewise_composition_bitwise(key):
    """engine.run(smppca preset) == build_summary + estimate_product with
    smppca's key fan-out, bit for bit."""
    A, B = gaussian_pair(1, d=96, n1=10, n2=8)
    eng = PipelineEngine()
    res = eng.run(pipeline.smppca_plan(r=2, k=16, m=200, T=2), key, A, B)
    k_sketch, k_sample, _ = prng.split(key, 3)
    summary = summary_engine.build_summary(k_sketch, A, B, 16, device="cpu")
    manual = estimation_engine.estimate_product(
        prng.fold_in(k_sample, 0), summary, 2, m=200, T=2, device="cpu")
    assert torch.equal(res.estimate.factors.U, manual.factors.U)
    assert torch.equal(res.estimate.factors.V, manual.factors.V)
    assert torch.equal(res.summary.A_sketch, summary.A_sketch)


def test_run_from_summary_matches_estimate_product_bitwise(key):
    """The from-summary path (stream_factors' spine) derives the service
    fold_in(key, 1) estimation key and matches estimate_product."""
    A, B = gaussian_pair(1, d=96, n1=10, n2=8)
    summary = summary_engine.build_summary(key, A, B, 16, device="cpu")
    eng = PipelineEngine()
    plan = PipelinePlan(sketch=SketchSpec(k=16, backend="scan"),
                        estimation=EstimationSpec(m=200, T=2),
                        rank=RankPolicy(r=2), key_layout="service")
    est = eng.run_from_summary(plan, key, summary)
    manual = estimation_engine.estimate_product(
        prng.fold_in(key, 1), summary, 2, m=200, T=2, device="cpu")
    assert torch.equal(est.factors.U, manual.factors.U)


def test_summarize_matches_build_summary_bitwise(key):
    A, B = gaussian_pair(2, d=64, n1=6, n2=5)
    eng = PipelineEngine()
    spec = SketchSpec(method="srht", backend="scan", k=8, block=32)
    got = eng.summarize(spec, key, A, B)
    want = summary_engine.build_summary(key, A, B, 8, method="srht",
                                        backend="scan", block=32,
                                        device="cpu")
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# ---------------------------------------------------------------------------
# The cache: warm hits, no builds, one batched call per bucket
# ---------------------------------------------------------------------------

def test_warm_flush_factors_one_fused_dispatch_zero_retraces(key):
    """A repeated-shape warm flush_factors makes one call per shape bucket
    and builds nothing."""
    eng = PipelineEngine()
    svc = service(engine=eng)
    shapes = [(64, 6), (96, 5), (64, 6)]          # two buckets, one repeated
    t_cold = submit_bucketed(svc, key, shapes)
    cold = svc.flush_factors(r=2, m=100, T=2)
    traces0 = eng.stats.traces
    assert traces0 == 2                           # one build per shape bucket
    assert eng.stats.est_dispatches == 2          # ... and one call each
    assert eng.stats.curve_dispatches == 0

    t_warm = submit_bucketed(svc, key, shapes)    # same keys, same shapes
    warm = svc.flush_factors(r=2, m=100, T=2)
    assert eng.stats.traces == traces0            # no new build
    assert eng.stats.est_dispatches == 4
    assert eng.stats.hits == 2
    for tc, tw in zip(t_cold, t_warm):            # warm == cold, bit for bit
        assert torch.equal(cold[tc].factors.U, warm[tw].factors.U)


def test_distinct_plans_never_share_entries(key):
    """Plans differing in any field get their own entries (and differing
    shapes their own signatures under one plan)."""
    eng = PipelineEngine()
    svc = service(engine=eng)
    submit_bucketed(svc, key, [(64, 6)])
    svc.flush_factors(r=2, m=100, T=2)
    submit_bucketed(svc, key, [(64, 6)])
    svc.flush_factors(r=3, m=100, T=2)            # different rank -> new entry
    submit_bucketed(svc, key, [(64, 6)])
    svc.flush_factors(r=2, m=100, T=3)            # different T -> new entry
    assert eng.stats.misses == 3 and eng.stats.hits == 0
    assert len(eng) == 3
    submit_bucketed(svc, key, [(48, 6)])          # same plan, new shape
    svc.flush_factors(r=2, m=100, T=2)
    assert eng.stats.misses == 4 and len(eng) == 4


def test_signature_separates_dtype_and_device_type(key):
    """The signature is shape, dtype AND device type: a float64 call builds
    its own entry, a repeat of either hits."""
    eng = PipelineEngine()
    A, B = gaussian_pair(3, d=64, n1=6, n2=5)
    plan = pipeline.smppca_plan(r=2, k=8, m=80, T=1)
    eng.run(plan, key, A, B)
    eng.run(plan, key, A.double(), B.double())
    eng.run(plan, key, A, B)
    assert (eng.stats.misses, eng.stats.hits) == (2, 1)
    sig = pipeline._signature(key, A, B)
    assert all(leaf[2] == "cpu" for leaf in sig)
    assert pipeline._signature(None, A) == (None, ((64, 6), "torch.float32",
                                                   "cpu"))


def test_cache_eviction_at_lru_bound(key):
    """Past max_entries the least-recently-used entry is dropped and
    rebuilt on next use."""
    eng = PipelineEngine(max_entries=2)
    svc = service(engine=eng)

    def flush_shape(d):
        submit_bucketed(svc, key, [(d, 6)])
        svc.flush_factors(r=2, m=100, T=2)

    flush_shape(32)
    flush_shape(48)
    assert eng.stats.evictions == 0 and len(eng) == 2
    flush_shape(64)                               # evicts the (32, 6) entry
    assert eng.stats.evictions == 1 and len(eng) == 2
    traces0 = eng.stats.traces
    flush_shape(48)                               # still cached: no build
    assert eng.stats.traces == traces0 and eng.stats.hits == 1
    flush_shape(32)                               # evicted: built again
    assert eng.stats.traces == traces0 + 1
    assert eng.stats.evictions == 2


def test_engine_clear_drops_executables(key):
    eng = PipelineEngine()
    svc = service(engine=eng)
    submit_bucketed(svc, key, [(64, 6)])
    svc.flush_factors(r=2, m=100, T=2)
    assert len(eng) == 1
    eng.clear()
    assert len(eng) == 0
    submit_bucketed(svc, key, [(64, 6)])
    svc.flush_factors(r=2, m=100, T=2)
    assert eng.stats.traces == 2                  # cleared -> built again


def test_warm_call_resolves_no_config(key, monkeypatch):
    """A build resolves every launch config (tuning.lookup) once; a warm
    call of the same entry resolves none, on the kernel backends too."""
    calls = []
    real = tuning.lookup

    def counting(*args, **kw):
        calls.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(tuning, "lookup", counting)
    A, B = gaussian_pair(4, d=64, n1=6, n2=5)
    eng = PipelineEngine()
    for method in ("gaussian", "srht"):
        plan = pipeline.smppca_plan(r=2, k=8, m=80, T=1, method=method,
                                    backend="cuda", est_backend="cuda")
        calls.clear()
        cold = eng.run(plan, key, A, B)
        assert set(calls) == {"sketch_fused" if method == "gaussian"
                              else "blocked_fwht", "sampled_dot"}
        calls.clear()
        warm = eng.run(plan, key, A, B)
        assert calls == []
        assert torch.equal(cold.estimate.factors.U, warm.estimate.factors.U)
    pinned = tuning.TuningSpec((tuning.DEFAULTS["sketch_fused"],
                                tuning.DEFAULTS["sampled_dot"]))
    calls.clear()
    eng.run(pipeline.smppca_plan(r=2, k=8, m=80, T=1, backend="cuda")
            ._replace(tuning=pinned), key, A, B)
    assert calls == []                            # pinned: nothing to look up


def test_cache_holds_no_tensor_of_a_call(key):
    """An entry binds shapes and configs, never the call's tensors: once the
    caller drops A, B and the result, nothing keeps them alive."""
    eng = PipelineEngine()
    A, B = gaussian_pair(5, d=64, n1=6, n2=5)
    res = eng.run(pipeline.smppca_plan(r=2, k=8, m=80, T=1), key, A, B)
    refs = [weakref.ref(x) for x in (A, B, res.summary.A_sketch,
                                     res.estimate.factors.U)]
    del A, B, res
    gc.collect()
    assert len(eng) == 1
    assert all(r() is None for r in refs)


# ---------------------------------------------------------------------------
# The quality gate: one curve read, one estimation call per bucket
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gate_pair():
    return known_spectrum_pair(0, 384, 14, 12, GATE_SPECTRUM)


def test_gated_flush_single_estimation_dispatch(key, gate_pair):
    """A gated flush is one curve call and ONE estimation call per bucket,
    however many ranks the doubling schedule passes, and a warm gated flush
    builds nothing."""
    A, B = gate_pair
    eng = PipelineEngine()
    svc = service(k=512, probes=24, engine=eng)
    svc.submit(key, A, B)
    svc.submit(prng.fold_in(key, 7), A, B)
    out = svc.flush_factors(r="auto", tol=0.2, m=1500, T=4,
                            est_method="direct_svd")
    assert eng.stats.curve_dispatches == 1
    assert eng.stats.est_dispatches == 1
    assert all(v.factors.r >= 8 for v in out.values())   # it did escalate
    traces0 = eng.stats.traces
    svc.submit(key, A, B)
    svc.submit(prng.fold_in(key, 7), A, B)
    svc.flush_factors(r="auto", tol=0.2, m=1500, T=4, est_method="direct_svd")
    assert eng.stats.traces == traces0
    assert (eng.stats.curve_dispatches, eng.stats.est_dispatches) == (2, 2)


def test_gated_served_estimate_is_authoritative(key, gate_pair):
    """The curve only fast-forwards the schedule; the SERVED factors'
    estimate has the final word. With a starved completion (small m, T=1)
    the SVD-truncation curve passes rank 4 but the WAltMin factors miss tol
    there, so the gate escalates to the cap, and reports the miss there.
    (m=200: on this numpy pair m=300 already meets tol at the cap, where
    the JAX test's pair still misses it.)"""
    A, B = gate_pair
    eng = PipelineEngine()
    svc = service(k=512, probes=24, engine=eng)
    t = svc.submit(key, A, B)
    out = svc.flush_factors(r="auto", tol=0.3, r_max=8, m=200, T=1)[t]
    assert out.factors.r == 8
    assert eng.stats.curve_dispatches == 1
    assert eng.stats.est_dispatches == 2          # one escalation round
    assert float(out.error.rel_est) > 0.3         # honest at the cap


def test_gated_curve_executable_shared_across_tolerances(key, gate_pair):
    """tol is read on the host: gated flushes differing only in tol share
    one curve entry, and only a rank not served before builds an
    estimation entry."""
    A, B = gate_pair
    eng = PipelineEngine()
    svc = service(k=512, probes=24, engine=eng)
    svc.submit(key, A, B)
    r1 = next(iter(svc.flush_factors(r="auto", tol=0.2, m=1500, T=4,
                                     est_method="direct_svd").values()))
    assert eng.stats.traces == 2                  # one curve + one estimation
    svc.submit(key, A, B)
    r2 = next(iter(svc.flush_factors(r="auto", tol=0.3, m=1500, T=4,
                                     est_method="direct_svd").values()))
    assert (r1.factors.r, r2.factors.r) == (8, 4)
    assert eng.stats.traces == 3                  # curve shared; new rank only
    assert eng.stats.curve_dispatches == 2 and eng.stats.misses == 3
    svc.submit(key, A, B)
    svc.flush_factors(r="auto", tol=0.3, m=1500, T=4, est_method="direct_svd")
    assert eng.stats.traces == 3                  # fully warm


def test_gated_rank_curve_matches_adaptive_rank_sweep(key):
    """The gate's curve is the adaptive_rank sweep: the same single-SVD
    relative error curve, read through the public rank_curve."""
    A, B = known_spectrum_pair(1, 256, 12, 10, [8.0, 4.0, 2.0, 1.0, 0.5,
                                                0.1, 0.05, 0.02, 0.01, 0.005])
    summary = summary_engine.build_summary(key, A, B, 64, probes=16,
                                           device="cpu")
    curve = error_engine.rank_curve(summary, 8)
    res = error_engine.adaptive_rank(summary, tol=0.3, r_max=8)
    assert torch.equal(curve, res.curve)
    eng = PipelineEngine()
    plan = PipelinePlan(sketch=SketchSpec(k=64, probes=16),
                        estimation=EstimationSpec(method="direct_svd"),
                        rank=RankPolicy(r=None, tol=0.3, r_max=8))
    gated = eng.run_from_summary(plan, key, summary)
    assert eng._pick_rank(curve, 0.3) <= gated.factors.r


def test_rank_curve_requires_probes(key):
    A, B = gaussian_pair(6, d=64, n1=6, n2=5)
    with pytest.raises(ValueError, match="probe"):
        error_engine.rank_curve(
            summary_engine.build_summary(key, A, B, 8, device="cpu"), 4)


def test_pipeline_refine_joins_cache_key(key):
    """Two plans differing only in RefineSpec build separately; repeat
    traffic under a pinned refinement builds nothing (the twin of
    tests/core/test_refinement.py::test_pipeline_refine_joins_cache_key)."""
    A, B = gaussian_pair(7, d=128, n1=11, n2=7)
    eng = PipelineEngine()

    def mk(spec):
        return PipelinePlan(sketch=SketchSpec(k=16, cosketch=4),
                            estimation=EstimationSpec(method="power"),
                            rank=RankPolicy(r=2), refine=spec)
    r0 = eng.run(mk(RefineSpec(0, "tropp")), key, A, B)
    assert eng.stats.misses == 1
    eng.run(mk(RefineSpec(2, "power")), key, A, B)
    assert eng.stats.misses == 2
    eng.run(mk(RefineSpec(0, "tropp")), key, A, B)
    assert (eng.stats.hits, eng.stats.traces) == (1, 2)
    assert r0.estimate.factors.U.shape == (11, 2)


# ---------------------------------------------------------------------------
# Keys and tenants, bit for bit against the JAX package
# ---------------------------------------------------------------------------

def _jax_keys(layout, key_np, **kw):
    with jax.threefry_partitionable(False):
        return tuple(np.asarray(k) for k in jax_pipeline.derive_keys(
            layout, jnp.asarray(key_np), **kw))


def _port_keys(layout, key_np, **kw):
    return tuple(convert.key_to_numpy(k) for k in pipeline.derive_keys(
        layout, convert.key_from_numpy(key_np), **kw))


@pytest.mark.parametrize("layout", pipeline.LAYOUTS)
@pytest.mark.parametrize("tenant", [None, "acme", 7])
def test_derive_keys_match_jax(layout, tenant):
    key_np = np.asarray([0, 42], np.uint32)
    got = _port_keys(layout, key_np, tenant=tenant)
    want = _jax_keys(layout, key_np, tenant=tenant)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tenant", [None, "globex", 2 ** 31 - 1])
def test_batched_service_keys_match_jax(tenant):
    with jax.threefry_partitionable(False):
        stack = np.asarray(jax.random.split(jax.random.PRNGKey(3), 4))
    got = _port_keys("service", stack, batched=True, tenant=tenant)
    want = _jax_keys("service", stack, batched=True, tenant=tenant)
    for g, w in zip(got, want):
        assert g.shape == (4, 2)
        np.testing.assert_array_equal(g, w)


def test_tenant_id_and_key_match_jax():
    for tenant in ("acme", "globex", "", "ünïcode", 0, 7, 2 ** 31 - 1):
        assert pipeline.tenant_id(tenant) == jax_pipeline.tenant_id(tenant)
    key_np = np.asarray([5, 9], np.uint32)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax_pipeline.tenant_key(jnp.asarray(key_np), "acme"))
    got = convert.key_to_numpy(pipeline.tenant_key(
        convert.key_from_numpy(key_np), "acme"))
    np.testing.assert_array_equal(got, want)
    for bad, err in ((True, TypeError), (1.5, TypeError),
                     (-1, ValueError), (2 ** 31, ValueError)):
        with pytest.raises(err):
            pipeline.tenant_id(bad)


# ---------------------------------------------------------------------------
# PipelineEngine.run against the JAX package's
# ---------------------------------------------------------------------------

def _np_pair(seed, d, n1, n2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, n1)).astype(np.float32),
            rng.standard_normal((d, n2)).astype(np.float32))


def _corr_pair(seed, d=300, n=20, corr=0.3):
    """tests/conftest.py::planted_pair (decay 1) with numpy draws."""
    rng = np.random.default_rng(seed)
    D = (1.0 / np.arange(1.0, n + 1.0)).astype(np.float32)
    A = rng.standard_normal((d, n)).astype(np.float32) * D
    B = A + corr * rng.standard_normal((d, n)).astype(np.float32) * D
    return A, B


def _slow_pair(seed):
    i = np.arange(10, dtype=np.float64)
    A, B = known_spectrum_pair(seed, 384, 14, 12, 1.0 / np.sqrt(1.0 + i))
    return A.numpy(), B.numpy()


def _parity_cases():
    """(name, JAX plan, port plan, pair maker): each preset, a refined
    power plan and a gated plan."""
    corr = lambda: _corr_pair(11)                       # noqa: E731
    return [
        ("smppca", jax_pipeline.smppca_plan(r=3, k=32, m=600, T=3),
         pipeline.smppca_plan(r=3, k=32, m=600, T=3), corr),
        ("smppca_srht_scan",
         jax_pipeline.smppca_plan(r=3, k=32, m=600, T=3, method="srht",
                                  backend="scan", block=128),
         pipeline.smppca_plan(r=3, k=32, m=600, T=3, method="srht",
                              backend="scan", block=128), corr),
        ("lela", jax_pipeline.lela_plan(r=3, m=600, T=3),
         pipeline.lela_plan(r=3, m=600, T=3), corr),
        ("sketch_svd", jax_pipeline.sketch_svd_plan(r=3, k=32),
         pipeline.sketch_svd_plan(r=3, k=32), corr),
        ("power_refined",
         jax_pipeline.PipelinePlan(
             sketch=jax_pipeline.SketchSpec(k=32, cosketch=6),
             estimation=jax_pipeline.EstimationSpec(method="power",
                                                    backend="jit"),
             rank=jax_pipeline.RankPolicy(r=3),
             refine=jax_refinement.RefineSpec(1, "power")),
         PipelinePlan(sketch=SketchSpec(k=32, cosketch=6),
                      estimation=EstimationSpec(method="power"),
                      rank=RankPolicy(r=3), refine=RefineSpec(1, "power")),
         lambda: _np_pair(12, 128, 11, 7)),
        ("gated",
         jax_pipeline.PipelinePlan(
             sketch=jax_pipeline.SketchSpec(k=64, probes=16),
             estimation=jax_pipeline.EstimationSpec(method="direct_svd",
                                                    backend="jit"),
             rank=jax_pipeline.RankPolicy(r=None, tol=0.5, r_max=10),
             key_layout="smppca"),
         PipelinePlan(sketch=SketchSpec(k=64, probes=16),
                      estimation=EstimationSpec(method="direct_svd"),
                      rank=RankPolicy(r=None, tol=0.5, r_max=10),
                      key_layout="smppca"),
         lambda: _slow_pair(13)),
    ]


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    with jax.threefry_partitionable(False):
        for name, jplan, _, make in _parity_cases():
            A, B = make()
            res = jax_pipeline.PipelineEngine().run(
                jplan, jax.random.PRNGKey(5), jnp.asarray(A), jnp.asarray(B))
            out[name] = jax.tree.map(np.asarray, res)
    return out


@pytest.mark.parametrize("case", [c[0] for c in _parity_cases()])
def test_engine_run_matches_jax(jax_runs, case):
    _, _, plan, make = next(c for c in _parity_cases() if c[0] == case)
    A, B = make()
    res = PipelineEngine().run(plan, prng.PRNGKey(5), torch.from_numpy(A),
                               torch.from_numpy(B))
    want = jax_runs[case]
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B", "probes",
                 "cosketch_Y"):
        w = getattr(want.summary, name)
        if w is None:
            continue
        g = getattr(res.summary, name).numpy()
        assert g.shape == w.shape, name
        if w.size:
            close_to_column_max(g, w)
    assert res.estimate.factors.r == want.estimate.factors.U.shape[-1]
    sampled = want.estimate.samples is not None
    if sampled:
        share = np.mean(res.estimate.samples.rows.numpy()
                        == want.estimate.samples.rows)
        assert share >= 1 - SAMPLE_SHARE
    tol = UVT_RTOL_COMPLETION if sampled else UVT_RTOL
    err = rel(dense(res.estimate.factors), dense(want.estimate.factors))
    assert err < tol, err
    if case == "gated":
        assert res.estimate.error is not None
        np.testing.assert_allclose(float(res.estimate.error.rel_est),
                                   float(want.estimate.error.rel_est),
                                   rtol=1e-4)
