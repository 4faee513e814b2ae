"""The SRHT step-1 path of the port against the JAX package: the plan, the
pointwise Hadamard columns, the butterfly, the blocked FWHT kernel's plain
version, ``build_summary(method='srht')`` on every port backend (and the
Gaussian ``scan`` and ``rows`` backends), and ``smppca(method='srht')``.

Inputs are made with numpy from a seed and handed to both packages. The JAX
Pallas kernel runs as the JAX suite runs it on the CPU (interpret mode,
through ``repro.kernels.ops``). Every jax call runs under the classic key
tree (``jax.threefry_partitionable(False)``), with a fresh PipelineEngine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline
from repro.core import sketch as jax_sketch
from repro.core import summary_engine as jax_summary
from repro.kernels import hadamard as jax_hadamard
from repro.kernels import ops as jax_ops
from repro_torch import prng
from repro_torch.core import sketch, summary_engine
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.smppca import smppca, spectral_error_vs_optimal
from repro_torch.kernels import hadamard, ops, tuning

# The JAX suite's own tolerances: the blocked FWHT against its butterfly
# (tests/kernels/test_kernels.py::test_blocked_fwht_sweep), and every
# summary backend against the reference
# (tests/core/test_summary_engine.py::test_backend_parity_vs_reference).
FWHT_RTOL = 1e-4
SUMMARY_RTOL, SUMMARY_ATOL_SCALE = 2e-4, 1e-5
# U V^T of port and JAX on the same key: identical keys and samples (up to
# a rare inverse-CDF tie), float32 sums in other orders (as in
# tests/test_torch_smppca.py).
SLICE_RTOL = 1e-3


def _key(seed):
    with jax.threefry_partitionable(False):
        return jax.random.PRNGKey(seed)


def _pair(seed, d=300, n1=24, n2=18):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, n1)).astype(np.float32),
            rng.standard_normal((d, n2)).astype(np.float32))


def _summary_close(got, want):
    for g, w in zip(got[:4], want[:4]):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=SUMMARY_RTOL,
            atol=SUMMARY_ATOL_SCALE * max(np.abs(w).max(), 1.0))


# ---------------------------------------------------------------------------
# The plan and the pointwise Hadamard columns: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,k", [(300, 32), (2000, 512), (50_000, 512),
                                 (64, 64)])
def test_srht_plan_bit_exact(d, k):
    with jax.threefry_partitionable(False):
        signs, rows, dp = jax_summary.srht_plan(_key(d), d, k)
        signs, rows = np.asarray(signs), np.asarray(rows)
    got_signs, got_rows, got_dp = summary_engine.srht_plan(prng.PRNGKey(d),
                                                           d, k)
    assert got_dp == dp
    assert got_signs.dtype == torch.float32 and got_rows.dtype == torch.int32
    np.testing.assert_array_equal(got_signs.numpy(), signs)
    np.testing.assert_array_equal(got_rows.numpy(), rows)


def test_srht_plan_rejects_k_above_dp():
    with pytest.raises(ValueError, match="k <= next_pow2"):
        summary_engine.srht_plan(prng.PRNGKey(0), 300, 513)


def test_hadamard_cols_bit_exact():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2 ** 31 - 1, 40).astype(np.int32)
    idx = np.concatenate([np.arange(70), rng.integers(0, 2 ** 31 - 1, 30)]
                         ).astype(np.int32)
    want = np.asarray(jax_summary.hadamard_cols(jnp.asarray(rows),
                                                jnp.asarray(idx)))
    got = summary_engine.hadamard_cols(torch.from_numpy(rows),
                                       torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    H = hadamard.hadamard_matrix(64).numpy()
    np.testing.assert_array_equal(
        summary_engine.hadamard_cols(torch.arange(64), torch.arange(64)
                                     ).numpy(), H)


@pytest.mark.parametrize("n", [1, 2, 64])
def test_hadamard_matrix_matches_jax(n):
    np.testing.assert_array_equal(hadamard.hadamard_matrix(n).numpy(),
                                  np.asarray(jax_hadamard.hadamard_matrix(n)))
    with pytest.raises(ValueError, match="power of two"):
        hadamard.hadamard_matrix(n + 3 if n > 1 else 3)


def test_projection_rows_srht_bit_exact_with_pad_rows():
    """Rows past d (the scan's pad rows) take the last sign, as in JAX;
    d_total= and plan= give the same columns."""
    d, k = 300, 32
    idx = np.array([0, 1, 5, 299, 300, 319], np.int32)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax_summary.projection_rows(
            _key(4), jnp.asarray(idx), k, method="srht", d_total=d))
    key = prng.PRNGKey(4)
    got = summary_engine.projection_rows(key, torch.from_numpy(idx), k,
                                         method="srht", d_total=d)
    np.testing.assert_array_equal(got.numpy(), want)
    plan = summary_engine.srht_plan(key, d, k)[:2]
    np.testing.assert_array_equal(
        summary_engine.projection_rows(key, torch.from_numpy(idx), k,
                                       method="srht", plan=plan).numpy(),
        want)
    with pytest.raises(ValueError, match="d_total or plan"):
        summary_engine.projection_rows(key, torch.from_numpy(idx), k,
                                       method="srht")


# ---------------------------------------------------------------------------
# The butterfly and the kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((64, 5), 0), ((3, 128), 1),
                                        ((1, 4), 0), ((256,), 0)])
def test_fwht_matches_jax(shape, axis):
    """Both are the same float32 butterflies in the same order: bit for
    bit."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_sketch.fwht(jnp.asarray(x), axis=axis))
    got = sketch.fwht(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fwht_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        sketch.fwht(torch.zeros(6, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,b,n", [(128, 128, 64), (256, 64, 100),
                                   (512, 128, 256), (1024, 32, 96)])
def test_blocked_fwht_plain_matches_jax_kernel(d, b, n, dtype):
    """The wrapper on CPU tensors (the kernel's plain version) against the
    Pallas kernel in interpret mode, over the JAX suite's sweep; rtol 1e-4
    and atol 1e-4 of the largest entry, the JAX suite's tolerances."""
    rng = np.random.default_rng(d + b + n)
    X = rng.standard_normal((d, n)).astype(np.float32)
    signs = np.where(rng.random(d) < 0.5, -1.0, 1.0).astype(np.float32)
    Xt = torch.from_numpy(X).to(dtype)
    Xj = jnp.asarray(Xt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(jax_ops.blocked_fwht(Xj, jnp.asarray(signs), b=b))
    before = dict(ops.LAUNCHES)
    got = ops.blocked_fwht(Xt, torch.from_numpy(signs))
    assert ops.LAUNCHES == before          # the plain version counts nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == (d, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWHT_RTOL,
                               atol=FWHT_RTOL * np.abs(want).max())


def test_blocked_fwht_d_pad_reads_zero_rows():
    """``d_pad`` is the transform of the input padded with zero rows, a
    column slice of a wider matrix included (bit for bit: the same adds)."""
    rng = np.random.default_rng(2)
    wide = torch.from_numpy(rng.standard_normal((300, 40)).astype(np.float32))
    X = wide[:, 3:30]
    signs = torch.from_numpy(np.where(rng.random(300) < 0.5, -1.0, 1.0)
                             .astype(np.float32))
    padded = torch.nn.functional.pad(X, (0, 0, 0, 212))
    want = ops.blocked_fwht(padded, torch.nn.functional.pad(signs, (0, 212),
                                                            value=1.0))
    got = ops.blocked_fwht(X, signs, d_pad=512)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="power of two"):
        ops.blocked_fwht(X, signs)
    with pytest.raises(ValueError, match="d_pad"):
        ops.blocked_fwht(X, signs, d_pad=256)
    with pytest.raises(ValueError, match="disagree"):
        ops.blocked_fwht(X, signs[:10], d_pad=512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,d_pad,n,k,col0", [
    (300, 512, 40, 32, 0),     # two passes, padded
    (200, 256, 33, 256, 5),    # one pass, every row sampled, a column offset
    (1, 1, 3, 1, 0),           # a transform of length 1
    (777, 1024, 17, 64, 2),    # ragged n, into a wider sketch
    (0, 1, 4, 1, 0),           # no input row: zeros
])
def test_srht_block_plain_is_the_composition(d, d_pad, n, k, col0, dtype):
    """``ops.srht_block`` on CPU tensors (the block mode's plain version)
    writes what ``_srht_blocked`` computed before the block mode existed:
    the full transform's sampled rows divided by sqrt(dp), times sqrt(dp /
    k), and ``column_norms``, bit for bit; columns outside the block stay
    untouched, and it counts no launch."""
    rng = np.random.default_rng(d + n + k)
    X = torch.from_numpy(rng.standard_normal((d, n)).astype(np.float32)
                         ).to(dtype)
    signs = torch.from_numpy(np.where(rng.random(d) < 0.5, -1.0, 1.0)
                             .astype(np.float32))
    rows = torch.from_numpy(rng.permutation(d_pad)[:k].astype(np.int32))
    sketch = torch.full((k, col0 + n + 3), 7.0)
    norms = torch.full((col0 + n + 3,), 7.0)
    before = dict(ops.LAUNCHES)
    got_s, got_n = ops.srht_block(X, signs, rows, d_pad=d_pad, sketch=sketch,
                                  norms=norms, col0=col0)
    assert ops.LAUNCHES == before
    HX = ops.blocked_fwht(X, signs, d_pad=d_pad)
    want_s = (HX[rows.long()] / sketch_mod._sqrt_f32(d_pad)) \
        * sketch_mod._sqrt_f32(d_pad / k)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_n, sketch_mod.column_norms(X))
    assert torch.equal(sketch[:, col0:col0 + n], want_s)
    outside = torch.cat([sketch[:, :col0], sketch[:, col0 + n:]], dim=1)
    assert bool((outside == 7.0).all())
    assert bool((norms[:col0] == 7.0).all() and (norms[col0 + n:] == 7.0).all())
    alone = ops.srht_block(X, signs, rows, d_pad=d_pad)
    assert torch.equal(alone[0], want_s) and torch.equal(alone[1], got_n)


def test_srht_block_rejects_bad_shapes():
    X, signs = torch.zeros(300, 4), torch.ones(300)
    rows = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        ops.srht_block(X, signs, rows, d_pad=384)
    with pytest.raises(ValueError, match="disagree"):
        ops.srht_block(X, signs[:10], rows, d_pad=512)
    with pytest.raises(ValueError, match="k="):
        ops.srht_block(X, signs, rows[:0], d_pad=512)
    with pytest.raises(ValueError, match="cannot take"):
        ops.srht_block(X, signs, rows, d_pad=512, sketch=torch.zeros(8, 3),
                       norms=torch.zeros(4))


@pytest.mark.parametrize("d_pad", [1, 2, 256, 512, 65_536, 131_072, 2 ** 25])
def test_radices_are_the_sources_split(d_pad):
    """``hadamard.radices`` (which sizes the block mode's scratch) cuts a
    transform as ``tuning._fwht_radix`` models it: the same number of
    passes and first radix, radices that multiply to d_pad, each at most
    256, larger first."""
    logs = hadamard.radices(d_pad)
    passes, radix = tuning._fwht_radix(d_pad, 1 << hadamard.MAX_LOG_RADIX)
    assert (len(logs), 1 << logs[0]) == (passes, radix)
    assert sum(logs) == d_pad.bit_length() - 1
    assert all(0 <= x <= hadamard.MAX_LOG_RADIX for x in logs)
    assert logs == sorted(logs, reverse=True)


def _cluster_smem(d, size, k, L1=256, lo=32, C=8, S=3, w1=8):
    """The cluster form's shared memory a CTA at d_pad = 65,536, as the
    source lays it out: the TMA ring, the live blocks of z, the mbarriers,
    the norms' sums, the row table's counts and one int a sampled row."""
    live = -(-d // L1)
    small = 16 * S + 8 * C + 8 * w1 * C + 4 * (3 * lo + 2)
    return S * L1 * C * size + live * lo * C * 4 + small + 4 * k


@pytest.mark.parametrize("dtype,size", [(torch.float32, 4),
                                        (torch.bfloat16, 2)])
def test_block_plan_takes_the_cluster_form_at_the_slice_shape(dtype, size):
    """d = 50,000 padded to 65,536 with k = 512, the SRHT pass's call shape:
    the cluster form, 8 columns a cluster of 8 CTAs, each holding the
    strip's 196 live blocks of 256 rows (200,704 bytes) and its ring."""
    plan = hadamard.block_plan(50_000, 65_536, dtype, 512)
    assert plan == hadamard.BlockPlan("cluster", 8, 8,
                                      _cluster_smem(50_000, size, 512))
    assert plan.smem == {4: 228_344, 2: 216_056}[size]
    assert plan.smem <= hadamard.SMEM_MAX == 232_448


@pytest.mark.parametrize("dtype,size", [(torch.float32, 4),
                                        (torch.bfloat16, 2)])
@pytest.mark.parametrize("k", [1, 512, 2048])
def test_block_plan_capacity_edge(dtype, size, k):
    """The largest d whose strip fits a CTA's 227 KB takes the cluster
    form, and one 256-row block more takes the two-pass form."""
    edge = max(d for d in range(256, 65_537, 256)
               if _cluster_smem(d, size, k) <= hadamard.SMEM_MAX)
    assert hadamard.block_plan(edge, 65_536, dtype, k).form == "cluster"
    for d in (edge + 1, edge + 256):
        assert hadamard.block_plan(d, 65_536, dtype, k).form == "two_pass"
    assert edge == {(4, 1): 51_712, (4, 512): 51_200, (4, 2048): 49_664,
                    (2, 1): 54_784, (2, 512): 54_272,
                    (2, 2048): 52_736}[size, k]


@pytest.mark.parametrize("d,d_pad,k", [
    (70_000, 131_072, 512),   # three passes
    (50_000, 131_072, 64),    # d_pad past 65,536
    (200, 256, 16),           # one pass
    (256, 256, 256),
    (1, 1, 1),
    (50_000, 65_536, 65_536),  # a row table that does not fit
])
def test_block_plan_keeps_the_two_pass_form(d, d_pad, k):
    """Shapes outside the cluster form's: more or fewer than two passes,
    or a CTA that cannot hold the strip and its table."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = hadamard.block_plan(d, d_pad, dtype, k)
        assert plan.form == "two_pass" and (plan.cols, plan.ctas) == (32, 1)


@pytest.mark.parametrize("d,d_pad", [(300, 512), (777, 1024), (2000, 4096),
                                     (20_000, 32_768)])
def test_block_plan_small_two_pass_shapes_take_the_cluster_form(d, d_pad):
    """Every d_pad of two passes (512 .. 65,536) takes the cluster form
    where its strip fits."""
    assert hadamard.block_plan(d, d_pad, torch.float32, 64).form == "cluster"


def test_srht_sketch_and_kernel_composition_match_jax():
    """``core.sketch.srht_sketch`` and ``ops.srht_sketch_kernel`` against
    their JAX counterparts at d = 777 (padded to 1024): same keys, same
    butterfly adds; the FWHT tolerance."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((777, 20)).astype(np.float32)
    with jax.threefry_partitionable(False):
        want_kernel = np.asarray(jax_ops.srht_sketch_kernel(
            _key(5), jnp.asarray(X), 64))
        want_ref = np.asarray(jax_sketch.srht_sketch(_key(5), jnp.asarray(X),
                                                     64))
    for got, want in (
            (ops.srht_sketch_kernel(prng.PRNGKey(5), torch.from_numpy(X), 64),
             want_kernel),
            (sketch.srht_sketch(prng.PRNGKey(5), torch.from_numpy(X), 64),
             want_ref)):
        assert tuple(got.shape) == (64, 20)
        np.testing.assert_allclose(got.numpy(), want, rtol=FWHT_RTOL,
                                   atol=FWHT_RTOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# build_summary on every port backend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_summaries():
    """JAX's reference and pallas summaries of one pair, both methods."""
    A, B = _pair(7)
    out = {}
    with jax.threefry_partitionable(False):
        for method in ("gaussian", "srht"):
            for backend in ("reference", "pallas"):
                s = jax_summary.build_summary(_key(0), jnp.asarray(A),
                                              jnp.asarray(B), 32,
                                              method=method, backend=backend)
                out[method, backend] = [np.asarray(x) for x in s[:4]]
    return A, B, out


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
@pytest.mark.parametrize("backend", summary_engine.BACKENDS)
@pytest.mark.parametrize("method", ["gaussian", "srht"])
def test_build_summary_matches_jax(jax_summaries, method, backend,
                                   jax_backend):
    """Every port backend against JAX's reference and pallas backends at d
    = 300 (SRHT pads to 512; the scan's last block is ragged), with the JAX
    suite's backend-parity tolerances."""
    A, B, want = jax_summaries
    got = summary_engine.build_summary(
        prng.PRNGKey(0), torch.from_numpy(A), torch.from_numpy(B), 32,
        method=method, backend=backend, block=128, device="cpu")
    _summary_close(got, want[method, jax_backend])


@pytest.mark.parametrize("method", ["gaussian", "srht"])
def test_rows_backend_is_the_reference_bit_for_bit(method):
    A, B = (torch.from_numpy(x) for x in _pair(8))
    key = prng.PRNGKey(1)
    ref = summary_engine.build_summary(key, A, B, 32, method=method,
                                       device="cpu")
    rows = summary_engine.build_summary(key, A, B, 32, method=method,
                                        backend="rows", device="cpu")
    for x, y in zip(rows[:4], ref[:4]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("method", ["gaussian", "srht"])
def test_rows_summary_any_order_and_merge(method):
    """Shuffled rows, and two shards merged, give the whole pair's summary
    (float32 sums in another order: the backend-parity tolerances); the
    same as JAX's ``rows_summary`` on the same shuffled rows."""
    A, B = _pair(9)
    d, k = A.shape[0], 16
    perm = np.random.default_rng(0).permutation(d)
    key = prng.PRNGKey(2)
    plan = summary_engine.srht_plan(key, d, k)[:2] if method == "srht" \
        else None
    whole = summary_engine.build_summary(key, torch.from_numpy(A),
                                         torch.from_numpy(B), k,
                                         method=method, device="cpu")
    shuffled = summary_engine.rows_summary(
        key, torch.from_numpy(perm), torch.from_numpy(A[perm]),
        torch.from_numpy(B[perm]), k, method=method, plan=plan)
    _summary_close(shuffled, whole)
    halves = [summary_engine.rows_summary(
        key, torch.from_numpy(perm[s]), torch.from_numpy(A[perm[s]]),
        torch.from_numpy(B[perm[s]]), k, method=method, d_total=d)
        for s in (slice(0, 111), slice(111, d))]
    _summary_close(sketch.merge_summaries(*halves), whole)
    with jax.threefry_partitionable(False):
        want = jax_summary.rows_summary(
            _key(2), jnp.asarray(perm), jnp.asarray(A[perm]),
            jnp.asarray(B[perm]), k, method=method, d_total=d)
    _summary_close(shuffled, want)


def test_sketch_wrappers_match_jax():
    """``sketch_summary``, ``sketch_pass`` and ``streamed_rows_summary``
    against their JAX namesakes."""
    A, B = _pair(10, d=200, n1=7, n2=5)
    idx = np.random.default_rng(1).permutation(200)
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    with jax.threefry_partitionable(False):
        want = [jax_sketch.sketch_summary(_key(3), jnp.asarray(A),
                                          jnp.asarray(B), 16, method="srht"),
                jax_sketch.sketch_pass(_key(3), jnp.asarray(A),
                                       jnp.asarray(B), 16, block=64),
                jax_sketch.streamed_rows_summary(
                    _key(3), jnp.asarray(idx), jnp.asarray(A[idx]),
                    jnp.asarray(B[idx]), 16)]
    key = prng.PRNGKey(3)
    got = [sketch.sketch_summary(key, At, Bt, 16, method="srht",
                                 device="cpu"),
           sketch.sketch_pass(key, At, Bt, 16, block=64, device="cpu"),
           sketch.streamed_rows_summary(key, torch.from_numpy(idx),
                                        At[idx], Bt[idx], 16)]
    for g, w in zip(got, want):
        _summary_close(g, w)


def test_cuda_backend_column_blocks_do_not_change_the_summary(monkeypatch):
    """The cuda backend's SRHT pass transforms column blocks; the transform
    acts on each column alone, so the block width changes no sketch entry
    (bit for bit) and the norms only by float32 summation order."""
    A, B = (torch.from_numpy(x) for x in _pair(11, n1=50, n2=9))
    key = prng.PRNGKey(6)
    whole = summary_engine.build_summary(key, A, B, 32, method="srht",
                                         backend="cuda", device="cpu")
    monkeypatch.setattr(summary_engine, "SRHT_COLUMN_BLOCK", 7)
    blocked = summary_engine.build_summary(key, A, B, 32, method="srht",
                                           backend="cuda", device="cpu")
    for x, y in zip(blocked[:2], whole[:2]):
        assert torch.equal(x, y)
    for x, y in zip(blocked[2:4], whole[2:4]):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# smppca(method='srht') against the JAX pipeline
# ---------------------------------------------------------------------------

D, N, K, R, T = 2000, 200, 512, 5, 8
M = int(10 * N * R * np.log(N))


@pytest.fixture(scope="module")
def srht_runs():
    rng = np.random.default_rng(0)
    D_ = (1.0 / np.arange(1.0, N + 1.0)).astype(np.float32)
    A = rng.standard_normal((D, N)).astype(np.float32) * D_
    B = A + 0.3 * rng.standard_normal((D, N)).astype(np.float32) * D_
    with jax.threefry_partitionable(False):
        plan = pipeline.smppca_plan(r=R, k=K, m=M, T=T, method="srht",
                                    backend="pallas", est_backend="jit")
        jres = pipeline.PipelineEngine().run(plan, jax.random.PRNGKey(0),
                                             jnp.asarray(A), jnp.asarray(B))
        jax_uvt = (np.asarray(jres.estimate.factors.U)
                   @ np.asarray(jres.estimate.factors.V).T)
        jax_rows = np.asarray(jres.estimate.samples.rows)
    port = smppca(prng.PRNGKey(0), torch.from_numpy(A), torch.from_numpy(B),
                  r=R, k=K, m=M, T=T, method="srht", device="cpu")
    return A, B, jax_uvt, jax_rows, port


def test_srht_smppca_matches_jax(srht_runs):
    A, B, jax_uvt, jax_rows, port = srht_runs
    assert (port.samples.rows.numpy() == jax_rows).mean() >= 0.999
    got = (port.factors.U @ port.factors.V.T).numpy()
    assert np.linalg.norm(got - jax_uvt) / np.linalg.norm(jax_uvt) \
        < SLICE_RTOL
    assert port.summary.A_sketch.shape == (K, N)


def test_srht_smppca_recovers_correlated_product(srht_runs):
    """The JAX suite's bound (tests/core/test_waltmin_smppca.py), met by
    the SRHT path at the same size."""
    A, B, _, _, port = srht_runs
    err, opt = spectral_error_vs_optimal(torch.from_numpy(A),
                                         torch.from_numpy(B), R, port.factors)
    assert float(err) < 3.0 * float(opt) + 0.05, (float(err), float(opt))


def test_srht_smppca_scan_backend_matches_cuda_backend(srht_runs):
    """step 1 on the scan backend (block 512) gives the cuda backend's
    factors (the same plan; float32 sums in another order)."""
    A, B, _, _, port = srht_runs
    scan = smppca(prng.PRNGKey(0), torch.from_numpy(A), torch.from_numpy(B),
                  r=R, k=K, m=M, T=T, method="srht", backend="scan",
                  block=512, device="cpu")
    want = port.factors.U @ port.factors.V.T
    got = scan.factors.U @ scan.factors.V.T
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        < SLICE_RTOL
