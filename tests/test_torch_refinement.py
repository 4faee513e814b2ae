"""The port's RefinementEngine against the JAX package: the co-sketch block
(Y, W) and its test matrices, Tropp's reconstruction with and without
sketch-power iterations, and ``estimate_product(method='power')``.

Inputs are made with numpy from a seed (Gaussian pairs and the
slow-spectrum pair of ``tests/conftest.py::known_spectrum_pair``). Every
jax call runs under the classic key tree
(``jax.threefry_partitionable(False)``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimation_engine as jax_estimation
from repro.core import refinement as jax_refinement
from repro.core import sketch as jax_sketch
from repro.core import summary_engine as jax_summary
from repro_torch import convert, prng
from repro_torch.core import estimation_engine, refinement, summary_engine
from repro_torch.core.refinement import RefineSpec
from repro_torch.core.sketch import merge_summaries

# (Y, W): float32 sums over d rows in another order, and test matrices that
# differ from jax's by an ulp where log1p rounds differently: each column
# within 1e-5 of its own largest entry.
BLOCK_RTOL = 1e-5
# Refined factors from the same co-sketch: QR, least squares and SVD in
# float32 by other LAPACK routines; the dense U V^T within 1e-4 relative
# Frobenius.
UVT_RTOL = 1e-4

SPECS = [RefineSpec(0, "tropp"), RefineSpec(0, "power"),
         RefineSpec(1, "power"), RefineSpec(2, "power")]


def gaussian_pair(seed, d=300, n1=20, n2=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, n1)).astype(np.float32),
            rng.standard_normal((d, n2)).astype(np.float32))


def slow_spectrum_pair(seed, d=384, n1=14, n2=12, q=10):
    """tests/conftest.py::known_spectrum_pair, 'slow' profile, with numpy
    draws: A^T B = U0 diag(1/sqrt(1 + i)) V0^T."""
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(1.0 + np.arange(q))
    W = np.linalg.qr(rng.standard_normal((d, n1)))[0]
    U0 = np.linalg.qr(rng.standard_normal((n1, q)))[0]
    V0 = np.linalg.qr(rng.standard_normal((n2, q)))[0]
    return W.astype(np.float32), (W @ ((U0 * s) @ V0.T)).astype(np.float32)


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


def rel_dense(got, want):
    g = np.asarray(got.U) @ np.asarray(got.V).T
    w = np.asarray(want.U) @ np.asarray(want.V).T
    return np.linalg.norm(g - w) / np.linalg.norm(w)


# ---------------------------------------------------------------------------
# The co-sketch block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11])
def test_cosketch_keys_and_test_matrices_match_jax(seed):
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(seed)
        want_key = np.asarray(jax_refinement.cosketch_key(jkey))
        want_omega = np.asarray(jax_refinement.cosketch_omega(jkey, 23, 4))
        want_psi = np.asarray(jax_refinement.cosketch_psi(jkey, 19, 4))
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        convert.key_to_numpy(refinement.cosketch_key(key)), want_key)
    assert refinement.cosketch_width(4) == jax_refinement.cosketch_width(4)
    omega = refinement.cosketch_omega(key, 23, 4)
    psi = refinement.cosketch_psi(key, 19, 4)
    assert tuple(omega.shape) == (23, 4) and tuple(psi.shape) == (9, 19)
    np.testing.assert_allclose(omega.numpy(), want_omega, rtol=0, atol=1e-6)
    np.testing.assert_allclose(psi.numpy(), want_psi, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_cosketch_summary():
    A, B = gaussian_pair(1)
    return A, B, jax_build(2, A, B, 16, probes=4, cosketch=5)


@pytest.mark.parametrize("backend", summary_engine.BACKENDS)
def test_cosketch_block_matches_jax(jax_cosketch_summary, backend):
    """build_summary(cosketch=s) on every port backend against the JAX
    reference backend (the attach does not depend on the backend)."""
    A, B, want = jax_cosketch_summary
    got = summary_engine.build_summary(
        prng.PRNGKey(2), torch.from_numpy(A), torch.from_numpy(B), 16,
        backend=backend, probes=4, cosketch=5, device="cpu")
    assert got.n_cosketch == 5 and got.n_probes == 4
    assert tuple(got.cosketch_W.shape) == (11, 16)
    for name in ("cosketch_omega", "cosketch_psi"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-6)
    close_to_column_max(got.cosketch_Y.numpy(), want.cosketch_Y)
    close_to_column_max(got.cosketch_W.numpy(), want.cosketch_W)
    close_to_column_max(got.probes.numpy(), want.probes)


@pytest.mark.parametrize("precision,dtype", [(None, torch.float32),
                                             ("bf16", torch.float32),
                                             (None, torch.bfloat16)])
@pytest.mark.parametrize("block", [64, 1024])
def test_cosketch_pass_matches_jax(precision, dtype, block):
    """The block scan with the same test matrices: the intermediates B @
    Omega_c and Psi_c @ A^T are accumulated in float32 and rounded once to
    the inputs' dtype (bf16 here) before the second products."""
    A, B = gaussian_pair(3)
    rng = np.random.default_rng(4)
    omega = rng.standard_normal((16, 3)).astype(np.float32)
    psi = rng.standard_normal((7, 20)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    wY, wW = jax_refinement.cosketch_pass(
        jnp.asarray(omega), jnp.asarray(psi), jnp.asarray(A).astype(jdt),
        jnp.asarray(B).astype(jdt), block=block, precision=precision)
    Y, W = refinement.cosketch_pass(
        torch.from_numpy(omega), torch.from_numpy(psi),
        torch.from_numpy(A).to(dtype), torch.from_numpy(B).to(dtype),
        block=block, precision=precision)
    assert Y.dtype == W.dtype == torch.float32
    close_to_column_max(Y.numpy(), wY)
    close_to_column_max(W.numpy(), wW)


def test_merged_cosketch_summaries_match_jax():
    A, B = gaussian_pair(5)
    parts = [(A[:100], B[:100]), (A[100:], B[100:])]
    with jax.threefry_partitionable(False):
        want = jax_sketch.merge_summaries(*(
            jax_build(6, a, b, 16, cosketch=3) for a, b in parts))
    got = merge_summaries(*(summary_engine.build_summary(
        prng.PRNGKey(6), torch.from_numpy(a), torch.from_numpy(b), 16,
        cosketch=3, device="cpu") for a, b in parts))
    assert got.probes is None
    close_to_column_max(got.cosketch_Y.numpy(), want.cosketch_Y)
    close_to_column_max(got.cosketch_W.numpy(), want.cosketch_W)


def test_merge_rejects_a_cosketch_presence_mismatch():
    A, B = (torch.from_numpy(x) for x in gaussian_pair(5, d=40))
    key = prng.PRNGKey(0)
    bare = summary_engine.build_summary(key, A, B, 8, device="cpu")
    with_cs = summary_engine.build_summary(key, A, B, 8, cosketch=2,
                                           device="cpu")
    for a, b in ((bare, with_cs), (with_cs, bare)):
        with pytest.raises(ValueError, match="cosketch"):
            merge_summaries(a, b)


# ---------------------------------------------------------------------------
# Refined factors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad,exc", [
    (("tropp", 0), TypeError),               # not a RefineSpec
    (RefineSpec(0, "lanczos"), ValueError),
    (RefineSpec(-1, "power"), ValueError),
    (RefineSpec(True, "power"), ValueError),
    (RefineSpec(1.0, "power"), ValueError)])
def test_validate_refine_rejects_what_jax_rejects(bad, exc):
    jbad = bad if not isinstance(bad, RefineSpec) else \
        jax_refinement.RefineSpec(*bad)
    with pytest.raises(exc):
        jax_refinement.validate_refine(jbad)
    with pytest.raises(exc):
        refinement.validate_refine(bad)
    refinement.validate_refine(RefineSpec(3, "power"))


@pytest.fixture(scope="module")
def jax_refine_summaries():
    out = {"gaussian": jax_build(7, *gaussian_pair(7), 32, cosketch=8),
           "slow": jax_build(0, *slow_spectrum_pair(0), 48, cosketch=10)}
    return out


@pytest.mark.parametrize("r", [1, 3, 8])
@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("pair", ["gaussian", "slow"])
def test_refine_factors_matches_jax(jax_refine_summaries, pair, spec, r):
    js = jax_refine_summaries[pair]
    with jax.threefry_partitionable(False):
        want = jax_refinement.refine_factors(
            js, r, jax_refinement.RefineSpec(*spec))
    got = refinement.refine_factors(to_port(js), r, spec)
    assert tuple(got.U.shape) == tuple(want.U.shape)
    assert tuple(got.V.shape) == tuple(want.V.shape)
    assert rel_dense(got, want) < UVT_RTOL


def test_refined_svd_matches_jax(jax_refine_summaries):
    """The singular values themselves, and the truncation to r_max."""
    js = jax_refine_summaries["slow"]
    for spec in SPECS:
        with jax.threefry_partitionable(False):
            _, want, _ = jax_refinement.refined_svd(
                js, jax_refinement.RefineSpec(*spec), 6)
        U, s, Vt = refinement.refined_svd(to_port(js), spec, 6)
        assert tuple(U.shape) == (14, 6) and tuple(Vt.shape) == (6, 12)
        np.testing.assert_allclose(s.numpy(), np.asarray(want), rtol=1e-4)


@pytest.mark.parametrize("spec", [None] + SPECS, ids=str)
@pytest.mark.parametrize("backend", estimation_engine.BACKENDS)
def test_estimate_product_power_matches_jax(jax_refine_summaries, backend,
                                            spec):
    """method='power' on both port backends against the JAX package's
    'reference' and 'pallas' cells; refine=None is RefineSpec()."""
    js = jax_refine_summaries["gaussian"]
    jax_backend = "reference" if backend == "reference" else "pallas"
    with jax.threefry_partitionable(False):
        want = jax_estimation.estimate_product(
            jax.random.PRNGKey(1), js, 4, method="power", backend=jax_backend,
            refine=None if spec is None else jax_refinement.RefineSpec(*spec))
    got = estimation_engine.estimate_product(
        prng.PRNGKey(1), to_port(js), 4, method="power", backend=backend,
        refine=spec, device="cpu")
    assert got.samples is None and got.values is None and got.error is None
    assert rel_dense(got.factors, want.factors) < UVT_RTOL


def test_refinement_needs_a_cosketch():
    A, B = (torch.from_numpy(x) for x in gaussian_pair(5, d=40))
    bare = summary_engine.build_summary(prng.PRNGKey(0), A, B, 8,
                                        device="cpu")
    with pytest.raises(ValueError, match="co-sketch"):
        refinement.refine_factors(bare, 2, RefineSpec())
    with pytest.raises(ValueError, match="co-sketch"):
        refinement.require_cosketch(bare)
