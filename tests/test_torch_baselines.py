"""The rest of the port's estimation engine against the JAX package: the
methods 'lela_waltmin' and 'direct_svd', ``lela``, the baselines
(``optimal_rank_r``, ``sketch_svd``, ``product_of_pcas``), the batched
mode of both engines, ``norms_only_summary`` and the Bernoulli-per-entry
sampler.

Inputs are made with numpy from a seed: Gaussian pairs, the planted pair
and the known-spectrum pairs of ``tests/conftest.py`` re-made with numpy
draws. ``lela`` and ``sketch_svd`` of the JAX package run through a fresh
``PipelineEngine`` (no executable cached under another key-tree mode).
Every jax call runs under the classic key tree
(``jax.threefry_partitionable(False)``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jax_baselines
from repro.core import estimation_engine as jax_estimation
from repro.core import pipeline
from repro.core import refinement as jax_refinement
from repro.core import sampling as jax_sampling
from repro.core import summary_engine as jax_summary
from repro_torch import convert, prng
from repro_torch.core import (
    baselines, estimation_engine, sampling, summary_engine)
from repro_torch.core.refinement import RefineSpec
from repro_torch.core.types import tree_index

jax_smppca = importlib.import_module("repro.core.smppca")
# the packages export the functions lela and smppca under the names of
# their modules, so the modules are taken from the import system
lela = importlib.import_module("repro_torch.core.lela")
smppca = importlib.import_module("repro_torch.core.smppca")

# Dense U V^T, relative Frobenius error: the methods without sampling
# (float32 QR, SVD and products by other routines) within 1e-4; those that
# complete a sample with WAltMin within 1e-3, the tolerance of
# tests/test_torch_estimation.py::test_estimate_product_matches_jax (the
# same samples up to a rare inverse-CDF tie, float32 sums in other orders).
UVT_RTOL = 1e-4
UVT_RTOL_COMPLETION = 1e-3
# A batched estimate against the looped single calls on the same device:
# the same operations on the same inputs, but the CPU's threaded LAPACK
# (QR, least squares, SVD) does not always repeat its last bits (1.4e-7
# seen between two calls), so 1e-5 relative.
LOOPED_RTOL = 1e-5
# Share of entries whose Bernoulli draw may flip: q_hat computed by both
# packages in float32 can differ by an ulp, which flips a draw whose
# uniform lies between the two (tests/test_torch_estimation.py allows the
# same share of inverse-CDF draws to move).
FLIP_SHARE = 1e-3
# Per-field tolerances of a summary: each column within 1e-5 of its largest
# entry (float32 sums over d rows in another order).
BLOCK_RTOL = 1e-5


def gaussian_pair(seed, d=200, n1=20, n2=16, L=None):
    rng = np.random.default_rng(seed)
    lead = () if L is None else (L,)
    return (rng.standard_normal(lead + (d, n1)).astype(np.float32),
            rng.standard_normal(lead + (d, n2)).astype(np.float32))


def planted_pair(seed, d=400, n=40, corr=0.3):
    """tests/conftest.py::planted_pair (decay 1) with numpy draws."""
    rng = np.random.default_rng(seed)
    D = (1.0 / np.arange(1.0, n + 1.0)).astype(np.float32)
    A = rng.standard_normal((d, n)).astype(np.float32) * D
    B = A + corr * rng.standard_normal((d, n)).astype(np.float32) * D
    return A, B


def known_spectrum_pair(seed, kind, d=384, n1=14, n2=12, q=10):
    """tests/conftest.py::known_spectrum_pair with numpy draws."""
    rng = np.random.default_rng(seed)
    i = np.arange(q, dtype=np.float64)
    s = {"fast": 2.0 ** -i, "slow": 1.0 / np.sqrt(1.0 + i),
         "rank_deficient": np.where(i < q // 2, 2.0 ** -i, 0.0)}[kind]
    W = np.linalg.qr(rng.standard_normal((d, n1)))[0]
    U0 = np.linalg.qr(rng.standard_normal((n1, q)))[0]
    V0 = np.linalg.qr(rng.standard_normal((n2, q)))[0]
    return W.astype(np.float32), (W @ ((U0 * s) @ V0.T)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def jax_build(key, A, B, k, **kw):
    with jax.threefry_partitionable(False):
        return jax_summary.build_summary(key, jnp.asarray(A),
                                         jnp.asarray(B), k, **kw)


def to_port(jax_state):
    return convert.summary_from_numpy(
        [None if x is None else np.asarray(x) for x in jax_state])


def jax_index(factors, i):
    return tuple(np.asarray(x)[i] for x in factors)


def dense(factors):
    U, V = (np.asarray(x) for x in factors)
    return U @ np.swapaxes(V, -1, -2)


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def close_to_column_max(got, want, rtol=BLOCK_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=-2, keepdims=True)
    assert np.all(np.abs(got - want) <= rtol * scale), \
        float((np.abs(got - want) / scale).max())


# ---------------------------------------------------------------------------
# The Bernoulli-per-entry sampler
# ---------------------------------------------------------------------------

def test_bernoulli_takes_a_tensor_of_probabilities():
    """jax.random.bernoulli(key, p) with an array p: shape from p, bits
    exact (the uniforms are, and p is the same float32)."""
    p = np.random.default_rng(0).uniform(0, 1, (7, 9)).astype(np.float32)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(4),
                                               jnp.asarray(p)))
    got = prng.bernoulli(prng.PRNGKey(4), t(p))
    assert got.dtype == torch.bool and tuple(got.shape) == (7, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    # a float p and a shape, as before
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(4), 0.3,
                                               (50,)))
    np.testing.assert_array_equal(
        prng.bernoulli(prng.PRNGKey(4), 0.3, (50,)).numpy(), want)


@pytest.mark.parametrize("m,max_samples", [(2000, None), (500, 700),
                                           (3000, 100)])
def test_sample_entries_binomial_matches_jax(m, max_samples):
    """Same key and norms: the kept entries agree up to FLIP_SHARE of the
    n1 n2 draws; where they agree, rows, cols and mask agree bit for bit
    (the stable selection keeps row-major order) and q_hat to 1e-6."""
    rng = np.random.default_rng(1)
    na = rng.uniform(0.1, 2.0, 200).astype(np.float32)
    nb = rng.uniform(0.1, 2.0, 150).astype(np.float32)
    with jax.threefry_partitionable(False):
        want = jax_sampling.sample_entries_binomial(
            jax.random.PRNGKey(5), jnp.asarray(na), jnp.asarray(nb), m,
            max_samples=max_samples)
    got = sampling.sample_entries_binomial(prng.PRNGKey(5), t(na), t(nb), m,
                                           max_samples=max_samples)
    cap = max_samples or 2 * m
    assert got.rows.dtype == got.cols.dtype == torch.int32
    assert got.mask.dtype == torch.bool and got.m == cap

    def kept(s):
        r, c, k = (np.asarray(x) for x in (s.rows, s.cols, s.mask))
        return set(zip(r[k].tolist(), c[k].tolist()))

    flips = len(kept(got) ^ kept(want))
    assert flips <= FLIP_SHARE * 200 * 150, flips
    if flips == 0:
        for name in ("rows", "cols", "mask"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        np.testing.assert_allclose(got.q_hat.numpy(), np.asarray(want.q_hat),
                                   rtol=1e-6)


def test_sample_entries_binomial_rejects_a_zero_factor():
    with pytest.raises(ValueError, match="zero norm"):
        sampling.sample_entries_binomial(prng.PRNGKey(0), torch.zeros(3),
                                         torch.ones(4), 5)


# ---------------------------------------------------------------------------
# Shared stages
# ---------------------------------------------------------------------------

def test_norms_only_summary_matches_jax():
    A, B = gaussian_pair(2)
    want = jax_summary.norms_only_summary(jnp.asarray(A), jnp.asarray(B))
    got = summary_engine.norms_only_summary(t(A), t(B))
    assert tuple(got.A_sketch.shape) == (0, 20) and got.k == 0
    assert tuple(got.B_sketch.shape) == (0, 16)
    assert got.probes is None and got.cosketch_Y is None
    np.testing.assert_allclose(got.norm_A.numpy(), np.asarray(want.norm_A),
                               rtol=1e-6)
    np.testing.assert_allclose(got.norm_B.numpy(), np.asarray(want.norm_B),
                               rtol=1e-6)


@pytest.mark.parametrize("m,chunk", [(0, 2048), (1000, 2048), (1000, 64)])
def test_exact_entries_matches_jax(m, chunk):
    A, B = gaussian_pair(3)
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 20, m).astype(np.int32)
    cols = rng.integers(0, 16, m).astype(np.int32)
    want = np.asarray(jax_estimation.exact_entries(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(rows), jnp.asarray(cols),
        chunk=chunk))
    got = estimation_engine.exact_entries(t(A), t(B), t(rows), t(cols),
                                          chunk=chunk)
    assert tuple(got.shape) == (m,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(A.T @ B).max())


@pytest.mark.parametrize("r", [1, 4])
def test_implicit_topr_matches_jax(r):
    """The same Gaussian start from the key; QR signs may differ, U V^T
    does not."""
    A, B = planted_pair(5)
    M = A.T @ B
    with jax.threefry_partitionable(False):
        want = jax_estimation.implicit_topr(
            lambda X: jnp.asarray(M) @ X, lambda X: jnp.asarray(M).T @ X,
            40, 40, r, jax.random.PRNGKey(6))
    Mt = t(M)
    got = estimation_engine.implicit_topr(lambda X: Mt @ X,
                                          lambda X: Mt.T @ X, 40, 40, r,
                                          prng.PRNGKey(6))
    assert tuple(got.U.shape) == (40, r)
    assert rel(dense(got), dense(want)) < UVT_RTOL


# ---------------------------------------------------------------------------
# The methods
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planted_summary():
    A, B = planted_pair(0)
    with jax.threefry_partitionable(False):
        js = jax_build(jax.random.PRNGKey(0), A, B, 64, probes=8,
                       cosketch=6)
    return A, B, js


@pytest.mark.parametrize("backend,jax_backend", [("reference", "reference"),
                                                 ("cuda", "jit")])
def test_direct_svd_matches_jax(planted_summary, backend, jax_backend):
    """'reference' takes the dense SVD of A~^T B~, 'cuda' implicit
    subspace iteration from the key (the JAX jit and pallas cells)."""
    _, _, js = planted_summary
    with jax.threefry_partitionable(False):
        want = jax_estimation.estimate_product(
            jax.random.PRNGKey(3), js, 4, method="direct_svd",
            backend=jax_backend)
    got = estimation_engine.estimate_product(
        prng.PRNGKey(3), to_port(js), 4, method="direct_svd",
        backend=backend, device="cpu")
    assert got.samples is None and got.values is None
    assert rel(dense(got.factors), dense(want.factors)) < UVT_RTOL


@pytest.mark.parametrize("use_splits,m", [(False, 2000), (True, 8000)])
@pytest.mark.parametrize("backend", estimation_engine.BACKENDS)
def test_lela_waltmin_matches_jax(planted_summary, backend, use_splits, m):
    """With Alg-2 sample splitting each half-step sees m / (2T + 1)
    samples: at m = 2000 that is ~220 for 40 x 3 unknowns, where even the
    JAX package's own 'reference' and 'jit' cells differ by 2.8e-4, so the
    split case takes m = 8000."""
    A, B, js = planted_summary
    with jax.threefry_partitionable(False):
        want = jax_estimation.estimate_product(
            jax.random.PRNGKey(4), js, 3, method="lela_waltmin", m=m,
            T=4, use_splits=use_splits,
            exact_pair=(jnp.asarray(A), jnp.asarray(B)))
    got = estimation_engine.estimate_product(
        prng.PRNGKey(4), to_port(js), 3, method="lela_waltmin", m=m, T=4,
        use_splits=use_splits, exact_pair=(t(A), t(B)), backend=backend,
        device="cpu")
    same = got.samples.rows.numpy() == np.asarray(want.samples.rows)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(got.values.numpy()[same],
                               np.asarray(want.values)[same], rtol=0,
                               atol=1e-5 * np.abs(A.T @ B).max())
    assert rel(dense(got.factors), dense(want.factors)) < UVT_RTOL_COMPLETION


def test_lela_matches_jax():
    """lela under the 'direct' key layout: the caller's key goes straight
    to estimation of a norms-only summary."""
    A, B = planted_pair(1)
    with jax.threefry_partitionable(False):
        want = pipeline.PipelineEngine().run(
            pipeline.lela_plan(r=3, m=2000, T=5), jax.random.PRNGKey(7),
            jnp.asarray(A), jnp.asarray(B)).estimate.factors
    got = lela.lela(prng.PRNGKey(7), t(A), t(B), r=3, m=2000, T=5,
                    device="cpu")
    assert rel(dense(got), dense(want)) < UVT_RTOL_COMPLETION


@pytest.mark.parametrize("method", ["gaussian", "srht"])
def test_sketch_svd_matches_jax(method):
    """The 'sketch_svd' key layout: split(key) into the sketch and the
    implicit SVD's keys."""
    A, B = planted_pair(2)
    with jax.threefry_partitionable(False):
        want = pipeline.PipelineEngine().run(
            pipeline.sketch_svd_plan(r=4, k=64, method=method),
            jax.random.PRNGKey(8), jnp.asarray(A),
            jnp.asarray(B)).estimate.factors
    for backend in ("reference", "cuda"):
        got = baselines.sketch_svd(prng.PRNGKey(8), t(A), t(B), r=4, k=64,
                                   method=method, backend=backend,
                                   device="cpu")
        assert rel(dense(got), dense(want)) < UVT_RTOL


def test_product_of_pcas_matches_jax():
    A, B = planted_pair(3)
    with jax.threefry_partitionable(False):
        want = jax_baselines.product_of_pcas(jax.random.PRNGKey(9),
                                             jnp.asarray(A), jnp.asarray(B),
                                             4)
    got = baselines.product_of_pcas(prng.PRNGKey(9), t(A), t(B), 4,
                                    device="cpu")
    assert tuple(got.U.shape) == (40, 4) and tuple(got.V.shape) == (40, 4)
    assert rel(dense(got), dense(want)) < UVT_RTOL


@pytest.mark.parametrize("r", [1, 5])
def test_optimal_rank_r_matches_jax(r):
    A, B = planted_pair(4)
    want = jax_baselines.optimal_rank_r(jnp.asarray(A), jnp.asarray(B), r)
    got = baselines.optimal_rank_r(t(A), t(B), r, device="cpu")
    assert rel(dense(got), dense(want)) < UVT_RTOL


@pytest.mark.parametrize("kind", ["fast", "slow", "rank_deficient"])
def test_spectral_errors_on_known_spectra_match_jax(kind):
    """ROADMAP's acceptance for LELA and SVD(A~^T B~): their spectral
    errors on the known-spectrum fixtures agree with the JAX package's, and
    each stays above the optimal rank-r error."""
    A, B = known_spectrum_pair(0, kind)
    r, m = 3, 1500
    with jax.threefry_partitionable(False):
        engine = pipeline.PipelineEngine()
        key = jax.random.PRNGKey(1)
        jA, jB = jnp.asarray(A), jnp.asarray(B)
        want = {
            "lela": engine.run(pipeline.lela_plan(r=r, m=m, T=6), key, jA,
                               jB).estimate.factors,
            "sketch_svd": engine.run(pipeline.sketch_svd_plan(r=r, k=48),
                                     key, jA, jB).estimate.factors}
        want = {name: float(jax_smppca.spectral_error(jA, jB, f))
                for name, f in want.items()}
    got = {"lela": lela.lela(prng.PRNGKey(1), t(A), t(B), r=r, m=m, T=6,
                             device="cpu"),
           "sketch_svd": baselines.sketch_svd(prng.PRNGKey(1), t(A), t(B),
                                              r=r, k=48, device="cpu")}
    _, opt = smppca.spectral_error_vs_optimal(t(A), t(B), r, got["lela"])
    for name, f in got.items():
        err = float(smppca.spectral_error(t(A), t(B), f))
        np.testing.assert_allclose(err, want[name], rtol=1e-3, err_msg=name)
        assert err >= float(opt) * (1 - 1e-4), (name, err, float(opt))


# ---------------------------------------------------------------------------
# The batched mode
# ---------------------------------------------------------------------------

L = 3


@pytest.fixture(scope="module")
def batched_pairs():
    A, B = gaussian_pair(6, L=L)
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(2)
        stack = jax.random.split(jax.random.PRNGKey(3), L)
        want = {"split": jax_build(jkey, A, B, 16, probes=4, cosketch=3),
                "stack": jax_build(stack, A, B, 16, probes=4, cosketch=3)}
    keys = {"split": prng.PRNGKey(2),
            "stack": convert.key_from_numpy(np.asarray(stack))}
    return A, B, keys, want


@pytest.mark.parametrize("key_kind", ["split", "stack"])
@pytest.mark.parametrize("backend", summary_engine.BACKENDS)
def test_batched_summary_matches_jax(batched_pairs, backend, key_kind):
    """Stacked (L, d, n) input, with one key split L ways or a stack of L
    keys, probes and co-sketch included: every field against the JAX
    package's vmapped summary."""
    A, B, keys, want = batched_pairs
    got = summary_engine.build_summary(keys[key_kind], t(A), t(B), 16,
                                       backend=backend, probes=4, cosketch=3,
                                       device="cpu")
    want = want[key_kind]
    for name, g, w in zip(got._fields, got, want):
        assert tuple(g.shape) == w.shape, name
        if name in ("probe_omega", "cosketch_omega", "cosketch_psi"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
        elif name.startswith("norm"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
        else:
            close_to_column_max(g.numpy(), w)


def test_batched_summary_is_the_looped_one(batched_pairs):
    """Each pair of a batched summary is the single summary of that pair
    under its own key, bit for bit."""
    A, B, keys, _ = batched_pairs
    got = summary_engine.build_summary(keys["split"], t(A), t(B), 16,
                                       probes=4, cosketch=3, device="cpu")
    pair_keys = prng.split(keys["split"], L)
    for i in range(L):
        one = summary_engine.build_summary(pair_keys[i], t(A[i]), t(B[i]),
                                           16, probes=4, cosketch=3,
                                           device="cpu")
        for name, g, w in zip(one._fields, tree_index(got, i), one):
            assert torch.equal(g, w), name


_BATCH_METHODS = {
    "rescaled_jl": (dict(m=300, T=3), UVT_RTOL_COMPLETION),
    "lela_waltmin": (dict(m=300, T=3), UVT_RTOL_COMPLETION),
    "direct_svd": ({}, UVT_RTOL),
    "power": (dict(refine=(1, "power")), UVT_RTOL)}


@pytest.mark.parametrize("method", list(_BATCH_METHODS))
def test_batched_estimate_matches_jax(batched_pairs, method):
    """A batched (L, k, n) summary estimated with split(key, L), with an
    ErrorEstimate per pair: against the JAX package's vmapped estimate,
    and each pair against the port's single estimate of that pair."""
    A, B, keys, want_summaries = batched_pairs
    js = want_summaries["split"]
    kw, tol = _BATCH_METHODS[method]
    jkw, tkw = dict(kw), dict(kw)
    if "refine" in kw:
        jkw["refine"] = jax_refinement.RefineSpec(*kw["refine"])
        tkw["refine"] = RefineSpec(*kw["refine"])
    if method == "lela_waltmin":
        jkw["exact_pair"] = (jnp.asarray(A), jnp.asarray(B))
        tkw["exact_pair"] = (t(A), t(B))
    with jax.threefry_partitionable(False):
        want = jax_estimation.estimate_product(
            jax.random.PRNGKey(5), js, 2, method=method, backend="pallas",
            with_error=True, **jkw)
    ts = to_port(js)
    got = estimation_engine.estimate_product(
        prng.PRNGKey(5), ts, 2, method=method, with_error=True,
        device="cpu", **tkw)
    assert tuple(got.factors.U.shape) == (L, 20, 2)
    assert tuple(got.error.rel_est.shape) == (L,)
    for i in range(L):
        assert rel(dense(tree_index(got.factors, i)),
                   dense(jax_index(want.factors, i))) < tol
    np.testing.assert_allclose(got.error.rel_est.numpy(),
                               np.asarray(want.error.rel_est),
                               rtol=10 * tol)
    keys = prng.split(prng.PRNGKey(5), L)
    for i in range(L):
        pair_kw = dict(tkw)
        if method == "lela_waltmin":
            pair_kw["exact_pair"] = (t(A[i]), t(B[i]))
        one = estimation_engine.estimate_product(
            keys[i], tree_index(ts, i), 2, method=method, with_error=True,
            device="cpu", **pair_kw)
        # the same computation on the same inputs; the CPU's threaded
        # LAPACK (QR, least squares, SVD) need not repeat its last bits
        assert rel(dense(tree_index(got.factors, i)),
                   dense(one.factors)) < LOOPED_RTOL
        np.testing.assert_allclose(float(tree_index(got.error, i).rel_est),
                                   float(one.error.rel_est),
                                   rtol=LOOPED_RTOL)


def test_batched_estimate_takes_a_key_stack(batched_pairs):
    A, B, keys, want_summaries = batched_pairs
    js = want_summaries["stack"]
    with jax.threefry_partitionable(False):
        stack = jax.random.split(jax.random.PRNGKey(6), L)
        want = jax_estimation.estimate_product(stack, js, 2, m=300, T=3,
                                               backend="pallas")
    got = estimation_engine.estimate_product(
        convert.key_from_numpy(np.asarray(stack)), to_port(js), 2, m=300,
        T=3, device="cpu")
    assert tuple(got.samples.rows.shape) == (L, 300)
    for i in range(L):
        assert rel(dense(tree_index(got.factors, i)),
                   dense(jax_index(want.factors, i))) < UVT_RTOL_COMPLETION
