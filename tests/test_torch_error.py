"""The port's ErrorEngine against the JAX package: the probe block, the
a-posteriori ``ErrorEstimate``, the rank curve and ``adaptive_rank``.

Inputs are made with numpy from a seed: the known-spectrum pairs of
``tests/conftest.py::known_spectrum_pair`` (A^T B == M with a set
spectrum), re-made with numpy draws, and plain Gaussian pairs. Where a test
holds a function rather than the summary it reads, both packages get the
same summary (``repro_torch.convert``). Every jax call runs under the
classic key tree (``jax.threefry_partitionable(False)``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import error_engine as jax_error
from repro.core import estimation_engine as jax_estimation
from repro.core import sketch as jax_sketch
from repro.core import summary_engine as jax_summary
from repro.core.refinement import RefineSpec as JaxRefineSpec
from repro_torch import convert, prng
from repro_torch.core import error_engine, estimation_engine, summary_engine
from repro_torch.core.refinement import RefineSpec
from repro_torch.core.sketch import merge_summaries

# The probe block: float32 sums over d rows in another order, and test
# columns that differ from jax's by an ulp where log1p rounds differently:
# each column within 1e-5 of its own largest entry.
BLOCK_RTOL = 1e-5
# ErrorEstimate fields and the rank curve: float32 reductions of the same
# quantities in another order, 1e-4 relative. The curve is the square root
# of a cumulative sum of terms as large as the probes' energy, so its
# square carries float32 rounding of that energy: where the curve falls
# below ~1e-3 (fast and rank-deficient spectra refined past their tail)
# both packages' squares may differ by up to CURVE_SQ_ATOL, ten float32
# ulps of 1, which is far more than 1e-4 of so small a value.
EST_RTOL = 1e-4
CURVE_SQ_ATOL = 1e-6
# An estimated residual at float32 rounding level of A^T B (rank-r factors
# of a rank-r product) is rounding noise in both packages: such values agree
# within 1e-5 of the estimated ||A^T B||_F.
RESID_FLOOR = 1e-5
# Dense U V^T of the chosen factors, relative Frobenius error.
UVT_RTOL = 1e-4


def spectrum_values(kind, q=10):
    """tests/conftest.py::spectrum_values."""
    i = np.arange(q, dtype=np.float64)
    if kind == "fast":
        s = 2.0 ** -i
    elif kind == "slow":
        s = 1.0 / np.sqrt(1.0 + i)
    else:                                   # rank_deficient
        s = np.where(i < q // 2, 2.0 ** -i, 0.0)
    return s.astype(np.float32)


def known_spectrum_pair(seed, kind, d=384, n1=14, n2=12):
    """tests/conftest.py::known_spectrum_pair with numpy draws: A = W with
    orthonormal columns, B = W @ M, M = U0 diag(s) V0^T."""
    rng = np.random.default_rng(seed)
    s = spectrum_values(kind)
    W = np.linalg.qr(rng.standard_normal((d, n1)))[0]
    U0 = np.linalg.qr(rng.standard_normal((n1, s.size)))[0]
    V0 = np.linalg.qr(rng.standard_normal((n2, s.size)))[0]
    M = (U0 * s) @ V0.T
    return W.astype(np.float32), (W @ M).astype(np.float32)


def gaussian_pair(seed, d=300, n1=20, n2=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, n1)).astype(np.float32),
            rng.standard_normal((d, n2)).astype(np.float32))


def jax_build(seed, A, B, k, **kw):
    with jax.threefry_partitionable(False):
        return jax_summary.build_summary(jax.random.PRNGKey(seed),
                                         jnp.asarray(A), jnp.asarray(B), k,
                                         **kw)


def to_port(jax_state):
    return convert.summary_from_numpy(
        [None if x is None else np.asarray(x) for x in jax_state])


def close_to_column_max(got, want, rtol=BLOCK_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=0, keepdims=True)
    assert np.all(np.abs(got - want) <= rtol * scale), \
        float((np.abs(got - want) / scale).max())


def dense(factors):
    return np.asarray(factors.U) @ np.asarray(factors.V).T


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def assert_curve_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    ok = ((np.abs(got - want) <= EST_RTOL * np.abs(want))
          | (np.abs(got ** 2 - want ** 2) <= CURVE_SQ_ATOL))
    assert ok.all(), (got, want)


def assert_estimate_close(got, want, rtol=EST_RTOL):
    """Each field within ``rtol``; a residual at float32 rounding level of
    the product (factors that reconstruct it exactly) within RESID_FLOOR of
    the estimated ||A^T B||_F, the squared one within its square."""
    m_frob = float(want.frob_est) / max(float(want.rel_est), 1e-30)
    floors = dict(frob_sq_est=(RESID_FLOOR * m_frob) ** 2,
                  rel_est=RESID_FLOOR)
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(
            float(g), float(w), rtol=rtol,
            atol=floors.get(name, RESID_FLOOR * m_frob), err_msg=name)


# ---------------------------------------------------------------------------
# The probe block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_probe_key_and_omega_match_jax(seed):
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(seed)
        want_key = np.asarray(jax_error.probe_key(jkey))
        want = np.asarray(jax_error.probe_omega(jkey, 37, 6))
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        convert.key_to_numpy(error_engine.probe_key(key)), want_key)
    got = error_engine.probe_omega(key, 37, 6)
    assert got.dtype == torch.float32 and tuple(got.shape) == (37, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_probe_summaries():
    A, B = gaussian_pair(1)
    return A, B, {method: jax_build(3, A, B, 16, method=method, probes=5)
                  for method in ("gaussian", "srht")}


@pytest.mark.parametrize("method", ["gaussian", "srht"])
@pytest.mark.parametrize("backend", summary_engine.BACKENDS)
def test_probe_block_matches_jax(jax_probe_summaries, backend, method):
    """build_summary(probes=p) on every port backend against the JAX
    reference backend: the attach runs after the backend, so the probe
    block does not depend on it."""
    A, B, want = jax_probe_summaries
    got = summary_engine.build_summary(
        prng.PRNGKey(3), torch.from_numpy(A), torch.from_numpy(B), 16,
        method=method, backend=backend, probes=5, device="cpu")
    want = want[method]
    assert got.n_probes == 5 and got.n_cosketch == 0
    assert got.cosketch_Y is None and got.cosketch_W is None
    np.testing.assert_allclose(got.probe_omega.numpy(),
                               np.asarray(want.probe_omega), rtol=0,
                               atol=1e-6)
    close_to_column_max(got.probes.numpy(), want.probes)
    close_to_column_max(got.A_sketch.numpy(), want.A_sketch)


@pytest.mark.parametrize("precision,dtype", [(None, torch.float32),
                                             ("bf16", torch.float32),
                                             (None, torch.bfloat16)])
@pytest.mark.parametrize("block", [64, 1024])
def test_probe_pass_matches_jax(precision, dtype, block):
    """The block scan with the same test columns, in float32 and with bf16
    inputs: the intermediate B @ Omega is accumulated in float32 and
    rounded once to bf16 before the second product, in both packages. d =
    300 is not a multiple of 64, so the last block is zero-padded."""
    A, B = gaussian_pair(2)
    omega = np.random.default_rng(3).standard_normal((16, 4)).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jax_error.probe_pass(
        jnp.asarray(omega), jnp.asarray(A).astype(jdt),
        jnp.asarray(B).astype(jdt), block=block, precision=precision))
    got = error_engine.probe_pass(
        torch.from_numpy(omega), torch.from_numpy(A).to(dtype),
        torch.from_numpy(B).to(dtype), block=block, precision=precision)
    assert got.dtype == torch.float32
    close_to_column_max(got.numpy(), want)


def test_merged_probe_summaries_match_jax():
    """Two row shards summarized apart and merged: the probe blocks add;
    against the JAX package's merge of the same shards."""
    A, B = gaussian_pair(4)
    parts = [(A[:120], B[:120]), (A[120:], B[120:])]
    with jax.threefry_partitionable(False):
        want = jax_sketch.merge_summaries(*(jax_build(5, a, b, 16, probes=3)
                                            for a, b in parts))
    got = merge_summaries(*(summary_engine.build_summary(
        prng.PRNGKey(5), torch.from_numpy(a), torch.from_numpy(b), 16,
        probes=3, device="cpu") for a, b in parts))
    close_to_column_max(got.probes.numpy(), want.probes)
    np.testing.assert_allclose(got.probe_omega.numpy(),
                               np.asarray(want.probe_omega), atol=1e-6)


def test_merge_rejects_a_probe_presence_mismatch():
    A, B = (torch.from_numpy(x) for x in gaussian_pair(4, d=40))
    key = prng.PRNGKey(0)
    bare = summary_engine.build_summary(key, A, B, 8, device="cpu")
    probed = summary_engine.build_summary(key, A, B, 8, probes=2,
                                          device="cpu")
    for a, b in ((bare, probed), (probed, bare)):
        with pytest.raises(ValueError, match="probe"):
            merge_summaries(a, b)


# ---------------------------------------------------------------------------
# ErrorEstimate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_estimate():
    """A probe-carrying JAX summary of a slow-spectrum pair and the JAX
    rescaled-JL factors of it."""
    A, B = known_spectrum_pair(0, "slow")
    js = jax_build(0, A, B, 48, probes=24, cosketch=10)
    with jax.threefry_partitionable(False):
        res = jax_estimation.estimate_product(jax.random.PRNGKey(1), js, 3,
                                              m=600, T=4, with_error=True)
    return js, res


@pytest.mark.parametrize("confidence", [0.95, 0.8])
def test_estimate_error_matches_jax(jax_estimate, confidence):
    js, res = jax_estimate
    with jax.threefry_partitionable(False):
        want = jax_error.estimate_error(js, res.factors,
                                        confidence=confidence)
    got = error_engine.estimate_error(
        to_port(js), convert.factors_from_numpy(
            [np.asarray(x) for x in res.factors]), confidence=confidence)
    assert all(x.dtype == torch.float32 and x.ndim == 0 for x in got)
    assert float(got.frob_lo) <= float(got.frob_est) <= float(got.frob_hi)
    assert_estimate_close(got, want)


def test_estimate_error_one_probe_has_an_open_interval():
    A, B = gaussian_pair(6)
    js = jax_build(1, A, B, 16, probes=1)
    with jax.threefry_partitionable(False):
        jres = jax_estimation.estimate_product(jax.random.PRNGKey(2), js, 2,
                                               m=300, T=2)
        want = jax_error.estimate_error(js, jres.factors)
    got = error_engine.estimate_error(
        to_port(js), convert.factors_from_numpy(
            [np.asarray(x) for x in jres.factors]))
    assert float(want.frob_hi) == float(got.frob_hi) == float("inf")
    assert float(got.frob_lo) == float(want.frob_lo) == 0.0
    for name in ("frob_est", "frob_sq_est", "spectral_est", "rel_est"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=EST_RTOL)


@pytest.mark.parametrize("backend", estimation_engine.BACKENDS)
def test_estimate_product_with_error_matches_jax(jax_estimate, backend):
    """with_error=True on the port's estimate of the same summary and key:
    its estimate against the JAX package's, and against estimate_error of
    its own factors."""
    js, res = jax_estimate
    got = estimation_engine.estimate_product(
        prng.PRNGKey(1), to_port(js), 3, m=600, T=4, backend=backend,
        with_error=True, device="cpu")
    assert rel(dense(got.factors), dense(res.factors)) < 1e-3
    # factors within 1e-3 give estimates within about as much
    assert_estimate_close(got.error, res.error, rtol=1e-3)
    assert_estimate_close(got.error, error_engine.estimate_error(
        to_port(js), got.factors))


def test_error_estimate_converts_both_ways_exactly(jax_estimate):
    _, res = jax_estimate
    as_numpy = [np.asarray(x) for x in res.error]
    est = convert.error_from_numpy(as_numpy)
    assert all(x.dtype == torch.float32 and x.ndim == 0 for x in est)
    for x, y in zip(convert.error_to_numpy(est), as_numpy):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_summary_with_and_without_blocks_converts_both_ways(jax_estimate):
    js, _ = jax_estimate
    bare = jax_build(0, *gaussian_pair(1), 8)
    for state in (js, bare):
        as_numpy = [None if x is None else np.asarray(x) for x in state]
        back = convert.summary_to_numpy(convert.summary_from_numpy(as_numpy))
        for x, y in zip(back, as_numpy):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


def test_error_guards_raise():
    A, B = (torch.from_numpy(x) for x in gaussian_pair(4, d=40))
    key = prng.PRNGKey(0)
    bare = summary_engine.build_summary(key, A, B, 8, device="cpu")
    with pytest.raises(ValueError, match="probe"):
        estimation_engine.estimate_product(key, bare, 2, m=50, T=1,
                                           with_error=True, device="cpu")
    with pytest.raises(ValueError, match="probe"):
        error_engine.adaptive_rank(bare, tol=0.5)
    with pytest.raises(ValueError, match="probe"):
        error_engine.rank_curve(bare, 3)
    probed = summary_engine.build_summary(key, A, B, 8, probes=3,
                                          device="cpu")
    with pytest.raises(ValueError, match="co-sketch"):
        error_engine.adaptive_rank(probed, tol=0.5, refine=RefineSpec())
    with pytest.raises(ValueError, match="r_max"):
        error_engine.adaptive_rank(probed, tol=0.5, r_max=0)


# ---------------------------------------------------------------------------
# The rank curve and the gate
# ---------------------------------------------------------------------------

_REFINES = {None: (None, None),
            "tropp": (RefineSpec(0, "tropp"), JaxRefineSpec(0, "tropp")),
            "power1": (RefineSpec(1, "power"), JaxRefineSpec(1, "power"))}
# A sketch-power step multiplies the basis by M~ M~^T, whose rank is that
# of A^T B: on the fast spectrum its last directions are 6e5 times weaker
# than its first, on the rank-deficient one they are zero, so float32
# rounding alone picks them and the JAX package's own result is not
# determined there. Power refinement is held on the slow spectrum, where it
# is well conditioned (and in tests/test_torch_refinement.py on Gaussian
# pairs).
_CASES = [(kind, refine) for kind in ("fast", "slow", "rank_deficient")
          for refine in _REFINES if refine != "power1" or kind == "slow"]


@functools.lru_cache(maxsize=None)
def spectrum_summary(kind):
    A, B = known_spectrum_pair(0, kind)
    return jax_build(0, A, B, 48, probes=24, cosketch=10)


@pytest.mark.parametrize("kind,refine", _CASES)
def test_rank_curve_matches_jax(kind, refine):
    js = spectrum_summary(kind)
    spec, jspec = _REFINES[refine]
    with jax.threefry_partitionable(False):
        want = np.asarray(jax_error.rank_curve(js, 12, refine=jspec))
    got = error_engine.rank_curve(to_port(js), 12, refine=spec)
    assert got.dtype == torch.float32
    assert_curve_close(got.numpy(), want)


@pytest.mark.parametrize("tol", [0.1, 0.3])
@pytest.mark.parametrize("kind,refine", _CASES)
def test_adaptive_rank_matches_jax(kind, refine, tol):
    """The chosen rank exactly; its curve and ErrorEstimate within
    EST_RTOL; the truncated factors' U V^T within UVT_RTOL."""
    js = spectrum_summary(kind)
    spec, jspec = _REFINES[refine]
    with jax.threefry_partitionable(False):
        want = jax_error.adaptive_rank(js, tol=tol, refine=jspec)
    got = error_engine.adaptive_rank(to_port(js), tol=tol, refine=spec)
    assert isinstance(got.r, int) and got.r == want.r
    assert_curve_close(got.curve.numpy(), want.curve)
    assert rel(dense(got.factors), dense(want.factors)) < UVT_RTOL
    assert_estimate_close(got.error, want.error)


def test_adaptive_rank_passes_at_lower_rank_slow_spectrum():
    """tests/core/test_refinement.py's acceptance pin, held in the port on
    the port's own summary of the numpy slow-spectrum pair: at tol 0.3 the
    Tropp-refined gate passes at a strictly smaller rank than the
    unrefined one, power refinement is never worse, and each gate picks
    the rank the JAX package picks on the same inputs."""
    A, B = known_spectrum_pair(0, "slow")
    js = jax_build(0, A, B, 48, probes=24, cosketch=10)
    ts = summary_engine.build_summary(
        prng.PRNGKey(0), torch.from_numpy(A), torch.from_numpy(B), 48,
        probes=24, cosketch=10, device="cpu")
    picks = {}
    for name, (spec, jspec) in _REFINES.items():
        with jax.threefry_partitionable(False):
            want = jax_error.adaptive_rank(js, tol=0.3, refine=jspec)
        picks[name] = error_engine.adaptive_rank(ts, tol=0.3, refine=spec).r
        assert picks[name] == want.r, (name, picks[name], want.r)
    assert picks["tropp"] < picks[None], picks
    assert picks["power1"] <= picks[None], picks


def test_adaptive_rank_without_r_max_is_capped():
    """r_max defaults to min(n1, n2), and to the co-sketch width when
    refined."""
    A, B = known_spectrum_pair(1, "fast")
    ts = summary_engine.build_summary(
        prng.PRNGKey(2), torch.from_numpy(A), torch.from_numpy(B), 48,
        probes=8, cosketch=4, device="cpu")
    assert error_engine.adaptive_rank(ts, tol=0.0).curve.shape == (12,)
    assert error_engine.adaptive_rank(
        ts, tol=0.0, refine=RefineSpec()).curve.shape == (4,)
    assert error_engine.rank_curve(ts, 7, refine=RefineSpec()).shape == (4,)
