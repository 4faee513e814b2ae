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


def test_build_summary_norms_are_jax_roots_bit_for_bit():
    """On the CPU ``torch.sqrt`` of float32 is an ulp off on some inputs;
    the port's roots (``core.linalg.sqrt_f32``) are ``jnp.sqrt``'s. Each
    column holds two entries, so its squared norm is one rounded sum in
    both packages, and every column's is one that ``torch.sqrt``
    misrounds: the norms equal the JAX package's bit for bit."""
    rng = np.random.default_rng(7)
    a = rng.uniform(1, 10, (2, 4096)).astype(np.float32)
    sq = a[0] * a[0] + a[1] * a[1]
    bad = np.flatnonzero(torch.sqrt(torch.from_numpy(sq)).numpy()
                         != np.sqrt(sq))
    assert len(bad) >= 16
    A = np.zeros((64, len(bad)), np.float32)
    A[3], A[40] = a[0, bad], a[1, bad]
    B = A[:, ::-1].copy()
    with jax.threefry_partitionable(False):
        want = jax_summary.build_summary(jax.random.PRNGKey(5),
                                         jnp.asarray(A), jnp.asarray(B), 16)
    got = summary_engine.build_summary(
        prng.PRNGKey(5), torch.from_numpy(A), torch.from_numpy(B), 16,
        device="cpu")
    for got_x, want_x in zip(got[2:4], want[2:4]):
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    naive = torch.sqrt(torch.from_numpy(sq[bad])).numpy()
    assert (naive != np.asarray(want[2])).all()


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
    """The distributed backend without its process group is a ValueError
    (the backend itself is tests/test_torch_distributed.py's). Merging
    summaries of which only one carries a probe or co-sketch block is a
    ValueError, as in the JAX package; so are an unknown method or backend
    and mismatched shapes."""
    A, B = torch.randn(8, 3), torch.randn(8, 2)
    key = prng.PRNGKey(0)
    with pytest.raises(ValueError, match="group"):
        summary_engine.build_summary(key, A, B, 4, backend="distributed",
                                     device="cpu")
    bare = summary_engine.build_summary(key, A, B, 4, device="cpu")
    for blocks, what in ((dict(probes=2), "probe"),
                         (dict(cosketch=2), "cosketch")):
        full = summary_engine.build_summary(key, A, B, 4, device="cpu",
                                            **blocks)
        for a, b in ((bare, full), (full, bare)):
            with pytest.raises(ValueError, match=what):
                sketch.merge_summaries(a, b)
    with pytest.raises(ValueError, match="backend"):
        summary_engine.build_summary(key, A, B, 4, backend="pallas",
                                     device="cpu")
    with pytest.raises(ValueError, match="method"):
        summary_engine.build_summary(key, A, B, 4, method="countsketch",
                                     device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        summary_engine.build_summary(key, A[None], B[None].repeat(2, 1, 1),
                                     4, device="cpu")


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


# The tolerance of the tensor-core sketch_fused.cu, decided on the CPU by
# emulating what the kernel feeds its TF32 MMAs. A TF32 value keeps the top
# 19 bits of a float32: the kernel rounds an operand x to nearest TF32
# (``big``), and the MMA reads only the top 19 bits of ``small = x - big``.
_TF32_MASK = np.uint32(0xFFFFE000)


def _tf32_nearest(x):
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & _TF32_MASK).view(np.float32)


def _tf32_truncated(x):
    return (x.astype(np.float32).view(np.uint32) & _TF32_MASK).view(np.float32)


def _planted_operands(k, d, n, seed=0):
    """Pi (k, d) and A (d, n) float32 from a numpy seed, A's columns scaled
    1/i as in the planted pair, so each column has its own scale."""
    rng = np.random.default_rng(seed)
    Pi = rng.standard_normal((k, d)).astype(np.float32)
    A = (rng.standard_normal((d, n)) / np.arange(1, n + 1)).astype(np.float32)
    return Pi, A


def _column_err(got, want):
    """Each column's largest error over that column's largest entry."""
    return float((np.abs(got - want).max(0) / np.abs(want).max(0)).max())


def test_split_tf32_meets_the_sketch_tolerance_and_one_pass_does_not():
    """At the slice's d = 50,000, the three-pass split (small*big, big*small,
    big*big) stays within 1e-5 of each column's largest entry of the float64
    product; one TF32 pass is off by more than the kernel's 1e-4. Sums in
    float64, so that only the rounding of the operands is measured."""
    Pi, A = _planted_operands(64, 50_000, 64)
    exact = Pi.astype(np.float64) @ A.astype(np.float64)
    Pb, Ab = _tf32_nearest(Pi), _tf32_nearest(A)
    Ps, As = _tf32_truncated(Pi - Pb), _tf32_truncated(A - Ab)
    f64 = lambda x: x.astype(np.float64)  # noqa: E731
    three = f64(Ps) @ f64(Ab) + f64(Pb) @ f64(As) + f64(Pb) @ f64(Ab)
    one = f64(Pb) @ f64(Ab)
    assert _column_err(three, exact) <= 1e-5
    assert _column_err(one, exact) > 1e-4


def _round_toward_zero(x64):
    f = x64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _accumulate(Pi, A, steps_per_fresh):
    """Three-pass products of each k8 step added into a float32 accumulator
    that rounds toward zero, as an MMA adds; every ``steps_per_fresh`` k8
    steps the fragment is added to a float32 sum with round to nearest
    (None: the accumulator is the sum)."""
    Pb, Ab = _tf32_nearest(Pi), _tf32_nearest(A)
    Ps, As = _tf32_truncated(Pi - Pb), _tf32_truncated(A - Ab)
    total = np.zeros((Pi.shape[0], A.shape[1]), np.float32)
    frag = np.zeros_like(total)
    for step, d0 in enumerate(range(0, Pi.shape[1], 8), start=1):
        cols = slice(d0, d0 + 8)
        for a, b in ((Ps, Ab), (Pb, As), (Pb, Ab)):
            prod = a[:, cols].astype(np.float64) @ b[cols].astype(np.float64)
            frag = _round_toward_zero(frag.astype(np.float64) + prod)
        if steps_per_fresh and step % steps_per_fresh == 0:
            total, frag = total + frag, np.zeros_like(frag)
    return total + frag


def test_two_level_accumulation_bounds_the_mma_truncation():
    """An accumulator that rounds toward zero at each MMA drifts toward zero
    over d = 50,000 by more than 1e-4 of a column's largest entry; a fresh
    fragment per 64 rows of d (one stage of sketch_fused.cu), added with
    round to nearest, keeps the sum within 1e-5."""
    Pi, A = _planted_operands(16, 50_000, 16, seed=1)
    exact = Pi.astype(np.float64) @ A.astype(np.float64)
    assert _column_err(_accumulate(Pi, A, None), exact) > 1e-4
    assert _column_err(_accumulate(Pi, A, 8), exact) <= 1e-5


# The float32 instance on wgmma (sketch_fused.cu since the TF32 wgmma
# design) splits the other way: a raw float32 value is its own big part,
# which the tensor core truncates to TF32 as it reads it, and small = x -
# trunc(x) is truncated again; the three passes are A small x Pi big, A big
# x Pi big and A big x Pi small, and a chain of F32_CHAIN_STAGES stages of
# F32_BK rows goes into one fresh accumulator.


def _truncating_split(x):
    """(big, small) as the tensor core reads them: trunc(x) and
    trunc(x - trunc(x)), the difference exact in float32."""
    big = _tf32_truncated(x)
    return big, _tf32_truncated(x - big)


def _chain_k8_steps():
    """k8 steps a chain of sketch_fused.cu's float32 instance covers."""
    import pathlib
    import re
    text = (pathlib.Path(__file__).resolve().parents[1]
            / "src/repro_torch/kernels/csrc/sketch_fused.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    return const("F32_CHAIN_STAGES") * const("F32_BK") // 8


@pytest.mark.parametrize("passes", [3, 1])
def test_truncating_split_meets_the_sketch_tolerance_only_in_three_passes(
        passes):
    """At the slice's d = 50,000, the truncating split's three passes stay
    within 1e-5 of each column's largest entry of the float64 product (5.5e-7
    on this pair); one TF32 pass is off by more than the kernel's 1e-4
    (1.1e-3). Sums in float64: only the operands' rounding is measured."""
    Pi, A = _planted_operands(64, 50_000, 64)
    exact = Pi.astype(np.float64) @ A.astype(np.float64)
    (Pb, Ps), (Ab, As) = _truncating_split(Pi), _truncating_split(A)
    f64 = lambda x: x.astype(np.float64)  # noqa: E731
    got = f64(Pb) @ f64(Ab)
    if passes == 3:
        got = f64(Pb) @ f64(As) + got + f64(Ps) @ f64(Ab)
        assert _column_err(got, exact) <= 1e-5
    else:
        assert _column_err(got, exact) > 1e-4


def _accumulate_truncating(Pi, A, steps_per_fresh):
    """The float32 instance's sum: the three passes of each k8 step, in its
    order, added into a float32 accumulator that rounds toward zero, as a
    wgmma adds; every ``steps_per_fresh`` k8 steps the accumulator is added
    to a float32 sum with round to nearest (None: the accumulator is the
    sum)."""
    (Pb, Ps), (Ab, As) = _truncating_split(Pi), _truncating_split(A)
    total = np.zeros((Pi.shape[0], A.shape[1]), np.float32)
    frag = np.zeros_like(total)
    for step, d0 in enumerate(range(0, Pi.shape[1], 8), start=1):
        cols = slice(d0, d0 + 8)
        for a, b in ((Pb, As), (Pb, Ab), (Ps, Ab)):
            prod = a[:, cols].astype(np.float64) @ b[cols].astype(np.float64)
            frag = _round_toward_zero(frag.astype(np.float64) + prod)
        if steps_per_fresh and step % steps_per_fresh == 0:
            total, frag = total + frag, np.zeros_like(frag)
    return total + frag


@pytest.mark.parametrize("chained", [True, False])
def test_truncating_split_needs_the_chains(chained):
    """The truncating split summed as the float32 instance sums it, at
    d = 50,000: chains of the kernel's length (8 stages of 32 rows, 32 k8
    steps) into a fresh accumulator keep every column within 1e-5 of its
    largest entry (3.6e-6 on this pair), under the card's 1e-4; one
    accumulator over all of d drifts past 1e-4 (6.8e-4)."""
    Pi, A = _planted_operands(16, 50_000, 16, seed=1)
    exact = Pi.astype(np.float64) @ A.astype(np.float64)
    if chained:
        assert _chain_k8_steps() == 32
        err = _column_err(_accumulate_truncating(Pi, A, _chain_k8_steps()),
                          exact)
        assert err <= 1e-5
    else:
        assert _column_err(_accumulate_truncating(Pi, A, None), exact) > 1e-4


def test_pi_small_plain_is_the_truncating_split():
    """The float32 prologue's plain version gives Pi - trunc(Pi): exact, so
    that trunc(Pi) + small == Pi, and equal to the emulation's."""
    from repro_torch.kernels import sketch_fused
    rng = np.random.default_rng(4)
    Pi = rng.standard_normal((33, 517)).astype(np.float32)
    Pi[0, :4] = (0.0, -0.0, 1e-30, -3.5)
    small = sketch_fused.pi_small_plain(torch.from_numpy(Pi)).numpy()
    np.testing.assert_array_equal(small, Pi - _tf32_truncated(Pi))
    np.testing.assert_array_equal(_tf32_truncated(Pi) + small, Pi)


@pytest.mark.parametrize("dtype,cols,copied", [
    (torch.float32, 8, False), (torch.float32, 4, False),
    (torch.float32, 6, True), (torch.float32, 1, True),
    (torch.bfloat16, 8, False), (torch.bfloat16, 12, True)])
def test_tma_rows_pads_rows_to_16_bytes(dtype, cols, copied):
    """TMA reads rows at pitches of 16 bytes: ``_tma_rows`` keeps such a
    tensor and copies any other, zero-padded, counting the copy."""
    from repro_torch.kernels import sketch_fused
    x = torch.arange(3 * cols, dtype=torch.float32).reshape(3, cols).to(dtype)
    before = sketch_fused.ALIGNED_COPIES
    got = sketch_fused._tma_rows(x)
    assert sketch_fused.ALIGNED_COPIES == before + copied
    assert (got is x) == (not copied)
    assert got.shape[1] * got.element_size() % 16 == 0
    assert torch.equal(got[:, :cols], x) and not got[:, cols:].any()


def test_probe_edits_apply_to_the_kernel_source():
    """tools/sketch_fused_probe.py builds its variants by editing
    sketch_fused.cu's text; each edit must still find what it replaces."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "sketch_fused_probe", root / "tools" / "sketch_fused_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    text = (root / "src/repro_torch/kernels/csrc/sketch_fused.cu").read_text()
    for variant in (probe.one_level, probe.no_copies, probe.no_mma,
                    probe.along_k, probe.n4, probe.k4n2, probe.stages3,
                    probe.no_small):
        edited = variant(text)
        assert edited != text
    assert "wgmma_tf32_n128(part" not in probe.no_mma(text)
    assert "wgmma_m64n128k16(part" not in probe.no_mma(text)
    assert "fresh = step + 1 == n_steps;" in probe.one_level(text)
    assert probe.ISSUE not in probe.no_copies(text)
    assert "step >= F32_STAGES" in probe.no_copies(text)
    # the earlier float32 design the probe and chip_smoke.py time in turns
    with open(probe.MMA_SYNC_SOURCE) as f:
        yardstick = f.read()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in yardstick
    assert 'extern "C" int sketch_fused_f32(const float* Pi, const float* A,' \
        ' float* out,' in yardstick
