"""Steps 2 and 3 of the port against the JAX package: the sampled-dot
kernel's plain version, Eq. (1) sampling, Eq. (2) values and WAltMin.

Inputs are made with numpy from a seed. The JAX sampled-dot kernel runs in
interpret mode (one grid step per sample, so m stays small). Every jax call
runs under the classic key tree (``jax.threefry_partitionable(False)``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimation_engine as jax_estimation
from repro.core import estimator as jax_estimator
from repro.core import sampling as jax_sampling
from repro.core import summary_engine as jax_summary
from repro.kernels import ops as jax_ops
from repro_torch import convert, prng
from repro_torch.core import estimation_engine, estimator, sampling, waltmin
from repro_torch.core.types import SampleSet
from repro_torch.kernels import ops, sampled_dot

jax_waltmin = importlib.import_module("repro.core.waltmin")

# Eq. (2) values are bounded by ||A_i|| ||B_j||; float32 dot products of k
# terms in another order agree to 1e-5 of that scale.
VALUE_RTOL = 1e-5
# WAltMin on identical samples and values: float32 QR, solves and sums in
# other orders; U V^T agrees to 1e-4 in relative Frobenius norm.
UVT_RTOL = 1e-4


def _summary(seed=0, d=400, n1=30, n2=20, k=32):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, n1)).astype(np.float32)
    B = rng.standard_normal((d, n2)).astype(np.float32)
    with jax.threefry_partitionable(False):
        js = jax_summary.build_summary(jax.random.PRNGKey(seed),
                                       jnp.asarray(A), jnp.asarray(B), k)
    return js, convert.summary_from_numpy(
        [None if x is None else np.asarray(x) for x in js])


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("case", ["random", "empty", "duplicates",
                                  "more_than_entries"])
def test_sampled_dot_plain_matches_jax_kernel(case):
    rng = np.random.default_rng(1)
    n1, n2, k = 9, 7, 24
    As = rng.standard_normal((n1, k)).astype(np.float32)
    Bs = rng.standard_normal((n2, k)).astype(np.float32)
    na = rng.uniform(0.5, 2.0, n1).astype(np.float32)
    nb = rng.uniform(0.5, 2.0, n2).astype(np.float32)
    m = {"random": 40, "empty": 0, "duplicates": 30,
         "more_than_entries": n1 * n2 + 11}[case]
    rows = rng.integers(0, n1, m).astype(np.int32)
    cols = rng.integers(0, n2, m).astype(np.int32)
    if case == "duplicates":
        rows[10:20], cols[10:20] = rows[0], cols[0]
    want = np.asarray(jax_ops.sampled_rescaled_dot(
        jnp.asarray(As), jnp.asarray(Bs), jnp.asarray(na), jnp.asarray(nb),
        jnp.asarray(rows), jnp.asarray(cols)))
    got = ops.sampled_rescaled_dot(*(torch.from_numpy(x) for x in
                                     (As, Bs, na, nb, rows, cols))).numpy()
    assert got.shape == (m,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=VALUE_RTOL * float((na.max() * nb.max())))
    if case == "duplicates":
        assert np.all(got[10:20] == got[0])


def test_sampled_dot_bf16_gather():
    """precision='bf16' rounds the sketch rows, then sums in float32: the
    plain version on bf16-rounded inputs is the JAX kernel's result."""
    rng = np.random.default_rng(2)
    As = rng.standard_normal((5, 16)).astype(np.float32)
    Bs = rng.standard_normal((4, 16)).astype(np.float32)
    na, nb = np.ones(5, np.float32), np.ones(4, np.float32)
    rows = np.array([0, 4, 2], np.int32)
    cols = np.array([3, 0, 1], np.int32)
    want = np.asarray(jax_ops.sampled_rescaled_dot(
        *(jnp.asarray(x) for x in (As, Bs, na, nb, rows, cols)),
        precision="bf16"))
    got = ops.sampled_rescaled_dot(*(torch.from_numpy(x) for x in
                                     (As, Bs, na, nb, rows, cols)),
                                   precision="bf16").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_RTOL)


@pytest.mark.parametrize("k,itemsize,n2,want", [
    (512, 4, 100_000, 8192),     # the slice: 16 MiB of float32 rows
    (512, 2, 100_000, 16_384),   # bf16 rows: twice as many
    (100, 4, 100_000, 32_768),   # k not a multiple of 32
    (33, 2, 10 ** 6, 131_072),
    (512, 4, 1000, 1024),        # n2 below a block: one block
    (512, 4, 8192, 8192),
    (512, 4, 1, 1),
    (0, 4, 50, 64),
    (1 << 23, 4, 100, 1),        # a row larger than the budget
])
def test_sampled_dot_column_block(k, itemsize, n2, want):
    """The bucketing's column block: the largest power of two of rows of
    Bs within L2_BLOCK_BYTES, capped by what n2 needs, at least 1; and the
    bucket count that sizes the kernel's scratch."""
    cblock = sampled_dot.column_block(k, itemsize, n2)
    assert cblock == want
    assert cblock & (cblock - 1) == 0
    assert cblock * max(k, 1) * itemsize <= max(sampled_dot.L2_BLOCK_BYTES,
                                                max(k, 1) * itemsize)
    assert sampled_dot.buckets(7, n2, cblock) == 7 * -(-n2 // cblock)


@pytest.mark.parametrize("m", [1, 5000])
def test_sample_entries_matches_jax(m):
    """Indices bit for bit. The inverse-CDF draws search float32 cumsums
    that torch and XLA add in different orders, so a draw landing within
    an ulp of a bucket edge may move to the neighbouring index; at most
    0.1% of the draws may do so. q_hat follows the indices."""
    js, ts = _summary()
    with jax.threefry_partitionable(False):
        want = jax_sampling.sample_entries(jax.random.PRNGKey(9), js.norm_A,
                                           js.norm_B, m)
    got = sampling.sample_entries(prng.PRNGKey(9), ts.norm_A, ts.norm_B, m)
    assert got.rows.dtype == got.cols.dtype == torch.int32
    same = ((got.rows.numpy() == np.asarray(want.rows))
            & (got.cols.numpy() == np.asarray(want.cols)))
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(got.q_hat.numpy()[same],
                               np.asarray(want.q_hat)[same], rtol=1e-6)
    assert bool(got.mask.all())


def test_split_omega_and_q_helpers_match_jax():
    js, ts = _summary()
    with jax.threefry_partitionable(False):
        jsamp = jax_sampling.sample_entries(jax.random.PRNGKey(1), js.norm_A,
                                            js.norm_B, 300)
        want_split = np.asarray(jax_sampling.split_omega(
            jax.random.PRNGKey(2), jsamp, 21))
        want_q = np.asarray(jax_sampling.q_probabilities(js.norm_A, js.norm_B,
                                                         300))
    tsamp = convert.samples_from_numpy([np.asarray(x) for x in jsamp])
    got_split = sampling.split_omega(prng.PRNGKey(2), tsamp, 21).numpy()
    np.testing.assert_array_equal(got_split, want_split)
    np.testing.assert_allclose(
        sampling.q_probabilities(ts.norm_A, ts.norm_B, 300).numpy(), want_q,
        rtol=1e-6)
    np.testing.assert_allclose(
        sampling.q_at(ts.norm_A, ts.norm_B, 300, tsamp.rows,
                      tsamp.cols).numpy(), np.asarray(jsamp.q_hat), rtol=1e-6)


def test_zero_factor_is_rejected():
    with pytest.raises(ValueError, match="zero norm"):
        sampling.sample_entries(prng.PRNGKey(0), torch.zeros(4),
                                torch.ones(3), 10)


def test_rescaled_entries_match_jax():
    js, ts = _summary()
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 30, 500).astype(np.int32)
    cols = rng.integers(0, 20, 500).astype(np.int32)
    want = np.asarray(jax_estimator.rescaled_entries(js, jnp.asarray(rows),
                                                     jnp.asarray(cols)))
    got = estimator.rescaled_entries(ts, torch.from_numpy(rows),
                                     torch.from_numpy(cols)).numpy()
    scale = float(js.norm_A.max() * js.norm_B.max())
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_RTOL * scale)
    # the same values through the kernel wrapper (plain version on CPU)
    kern = estimation_engine._cuda_values(ts, torch.from_numpy(rows),
                                          torch.from_numpy(cols)).numpy()
    np.testing.assert_allclose(kern, want, rtol=0, atol=VALUE_RTOL * scale)
    np.testing.assert_allclose(
        estimator.plain_jl_entries(ts, torch.from_numpy(rows),
                                   torch.from_numpy(cols)).numpy(),
        np.asarray(jax_estimator.plain_jl_entries(js, jnp.asarray(rows),
                                                  jnp.asarray(cols))),
        rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        estimator.rescaled_matrix(ts).numpy(),
        np.asarray(jax_estimator.rescaled_matrix(js)),
        rtol=0, atol=VALUE_RTOL * scale)


@pytest.mark.parametrize("use_splits", [False, True])
def test_waltmin_on_jax_samples_matches_jax(use_splits):
    """Same samples and values in, U V^T out (factor signs may differ
    between QR implementations; U V^T does not depend on them)."""
    js, ts = _summary(d=500, n1=40, n2=30)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(4)
        jsamp = jax_sampling.sample_entries(key, js.norm_A, js.norm_B, 4000)
        jvals = jax_estimator.rescaled_entries(js, jsamp.rows, jsamp.cols)
        jf = jax_waltmin.waltmin(key, jsamp, jvals, 40, 30, 3, 4,
                                 norm_A=js.norm_A, use_splits=use_splits)
    tf = waltmin.waltmin(
        prng.PRNGKey(4),
        convert.samples_from_numpy([np.asarray(x) for x in jsamp]),
        torch.from_numpy(np.array(jvals)), 40, 30, 3, 4,
        norm_A=ts.norm_A, use_splits=use_splits)
    want = np.asarray(jf.U @ jf.V.T)
    assert _rel((tf.U @ tf.V.T).numpy(), want) < UVT_RTOL


def test_coo_topr_svd_singular_values_match_jax():
    rng = np.random.default_rng(5)
    M = rng.standard_normal((30, 20)).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(30), np.arange(20), indexing="ij")
    rows, cols = ii.reshape(-1).astype(np.int32), jj.reshape(-1).astype(np.int32)
    with jax.threefry_partitionable(False):
        _, want_s, _ = jax_waltmin.coo_topr_svd(
            jax.random.PRNGKey(0), jnp.asarray(rows), jnp.asarray(cols),
            jnp.asarray(M.reshape(-1)), 30, 20, 4)
    _, s, _ = waltmin.coo_topr_svd(
        prng.PRNGKey(0), torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(M.reshape(-1)), 30, 20, 4)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-5)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_estimate_product_matches_jax(backend):
    js, ts = _summary(d=500, n1=40, n2=30, k=64)
    m = jax_estimation.default_m(40, 30, 3)
    assert estimation_engine.default_m(40, 30, 3) == m
    assert estimation_engine.default_m(100_000, 100_000, 5) == 57_564_627
    with jax.threefry_partitionable(False):
        want = jax_estimation.estimate_product(jax.random.PRNGKey(8), js, 3,
                                               m=m, T=5, backend="pallas")
    got = estimation_engine.estimate_product(prng.PRNGKey(8), ts, 3, m=m,
                                             T=5, backend=backend,
                                             device="cpu")
    assert (got.samples.rows.numpy() == np.asarray(want.samples.rows)).mean() \
        >= 0.999
    wf = want.factors
    assert _rel((got.factors.U @ got.factors.V.T).numpy(),
                np.asarray(wf.U @ wf.V.T)) < 1e-3


def test_unported_methods_raise():
    _, ts = _summary()
    for method in ("lela_waltmin", "direct_svd", "power"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            estimation_engine.estimate_product(prng.PRNGKey(0), ts, 2,
                                               method=method, device="cpu")


def test_samples_convert_both_ways_exactly():
    js, _ = _summary()
    with jax.threefry_partitionable(False):
        jsamp = jax_sampling.sample_entries(jax.random.PRNGKey(1), js.norm_A,
                                            js.norm_B, 64)
    as_numpy = [np.asarray(x) for x in jsamp]
    samp = convert.samples_from_numpy(as_numpy)
    assert isinstance(samp, SampleSet) and samp.rows.dtype == torch.int32
    for x, y in zip(convert.samples_to_numpy(samp), as_numpy):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
