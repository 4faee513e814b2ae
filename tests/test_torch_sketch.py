"""Step 1 of the port against the JAX package: the projection, the fused
sketch kernel's plain version and ``build_summary``.

Inputs are made with numpy from a seed and handed to both packages. The JAX
Pallas kernel runs as the JAX suite runs it on the CPU (interpret mode,
through ``repro.kernels.ops``). Every jax call runs under the classic key
tree (``jax.threefry_partitionable(False)``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import summary_engine as jax_summary
from repro.kernels import ops as jax_ops
from repro_torch import convert, prng
from repro_torch.core import sketch, summary_engine
from repro_torch.kernels import ops

# Float32 tolerances. The projection differs from jax only where log1p
# rounds its last bit differently (an ulp of a normal draw, 1e-6 absolute).
# Sketches are float32 sums over d rows in another order: 1e-5 relative to
# the largest entry; norms (sums of positive terms) 1e-5 relative.
PROJ_ATOL = 1e-6
SKETCH_RTOL = 1e-5


def _close_to_max(got, want, rtol=SKETCH_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("k", [8, 33])
def test_projection_rows_match_jax(k):
    rows = np.array([0, 1, 5, 17, 1000, 2 ** 31 - 1])
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(7)
        want = np.asarray(jax_summary.projection_rows(key, jnp.asarray(rows),
                                                      k))
    got = summary_engine.projection_rows(prng.PRNGKey(7),
                                         torch.from_numpy(rows), k)
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PROJ_ATOL)


def test_gaussian_pi_matches_jax():
    from repro.core.sketch import gaussian_pi
    with jax.threefry_partitionable(False):
        want = np.asarray(gaussian_pi(jax.random.PRNGKey(1), 16, 40))
    got = sketch.gaussian_pi(prng.PRNGKey(1), 16, 40).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PROJ_ATOL)


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("k,d,n", [(33, 517, 259),
                                   (8, 7, 3), (64, 1500, 300)])
def test_sketch_fused_plain_matches_jax_kernel(k, d, n, precision):
    """The wrapper on CPU tensors (the kernel's plain version) against the
    Pallas kernel in interpret mode, on ragged and aligned shapes."""
    rng = np.random.default_rng(k * d + n)
    Pi = rng.standard_normal((k, d)).astype(np.float32)
    A = rng.standard_normal((d, n)).astype(np.float32)
    want_out, want_norm = jax_ops.sketch_fused(jnp.asarray(Pi), jnp.asarray(A),
                                               precision=precision)
    before = dict(ops.LAUNCHES)
    out, norm = ops.sketch_fused(torch.from_numpy(Pi), torch.from_numpy(A),
                                 precision=precision)
    assert ops.LAUNCHES == before          # the plain version counts nothing
    assert out.dtype == norm.dtype == torch.float32
    assert tuple(out.shape) == (k, n) and tuple(norm.shape) == (n,)
    _close_to_max(out.numpy(), want_out)
    np.testing.assert_allclose(norm.numpy(), np.asarray(want_norm),
                               rtol=SKETCH_RTOL)


def test_sketch_fused_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="disagree on d"):
        ops.sketch_fused(torch.zeros(4, 10), torch.zeros(11, 3))
    with pytest.raises(ValueError, match="precision"):
        ops.sketch_fused(torch.zeros(4, 10), torch.zeros(10, 3),
                         precision="fp8")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_build_summary_matches_jax_pallas(backend, precision):
    rng = np.random.default_rng(3)
    d, n1, n2, k = 600, 40, 25, 32
    A = rng.standard_normal((d, n1)).astype(np.float32)
    B = rng.standard_normal((d, n2)).astype(np.float32)
    with jax.threefry_partitionable(False):
        want = jax_summary.build_summary(
            jax.random.PRNGKey(5), jnp.asarray(A), jnp.asarray(B), k,
            backend="pallas", precision=precision)
    got = summary_engine.build_summary(
        prng.PRNGKey(5), torch.from_numpy(A), torch.from_numpy(B), k,
        backend=backend, precision=precision, device="cpu")
    # bf16 rounds the projection to 8 bits: an ulp of difference in a
    # normal draw can round to a neighbouring bf16 value, a 2**-8 relative
    # step on that entry, so the bf16 sketch tolerance is 1e-3.
    rtol = SKETCH_RTOL if precision is None else 1e-3
    for got_x, want_x in zip(got[:2], want[:2]):
        _close_to_max(got_x.numpy(), want_x, rtol)
    for got_x, want_x in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                                   rtol=SKETCH_RTOL)
    assert all(x is None for x in got[4:])


def test_summary_backends_agree_and_merge():
    """reference and cuda backends agree on CPU; summaries of two row
    shards merge to the summary of the whole (same global row ids)."""
    rng = np.random.default_rng(4)
    A = torch.from_numpy(rng.standard_normal((300, 12)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((300, 9)).astype(np.float32))
    key = prng.PRNGKey(2)
    ref = summary_engine.build_summary(key, A, B, 16, device="cpu")
    fused = summary_engine.build_summary(key, A, B, 16, backend="cuda",
                                         device="cpu")
    for x, y in zip(ref[:4], fused[:4]):
        _close_to_max(x.numpy(), y.numpy())
    P = summary_engine.projection_rows(key, torch.arange(300), 16)
    half = [sketch.SketchSummary(P[s].T @ A[s], P[s].T @ B[s],
                                 sketch.column_norms(A[s]),
                                 sketch.column_norms(B[s]))
            for s in (slice(0, 130), slice(130, 300))]
    merged = sketch.merge_summaries(*half)
    for x, y in zip(merged[:4], ref[:4]):
        _close_to_max(x.numpy(), y.numpy())


def test_unported_summary_options_raise():
    A, B = torch.zeros(8, 3), torch.zeros(8, 2)
    key = prng.PRNGKey(0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        summary_engine.build_summary(key, A, B, 4, method="srht",
                                     device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        summary_engine.build_summary(key, A, B, 4, probes=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        summary_engine.build_summary(key, A, B, 4, cosketch=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        summary_engine.build_summary(key, A[None], B[None], 4, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        summary_engine.build_summary(key, A, B, 4, backend="scan",
                                     device="cpu")


def test_summary_converts_both_ways_exactly():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((50, 6)).astype(np.float32)
    B = rng.standard_normal((50, 4)).astype(np.float32)
    with jax.threefry_partitionable(False):
        js = jax_summary.build_summary(jax.random.PRNGKey(0), jnp.asarray(A),
                                       jnp.asarray(B), 8)
    as_numpy = [None if x is None else np.asarray(x) for x in js]
    back = convert.summary_to_numpy(convert.summary_from_numpy(as_numpy))
    for x, y in zip(back, as_numpy):
        if y is None:
            assert x is None
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
