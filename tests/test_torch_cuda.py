"""The port's CUDA kernels on the card: each against its plain version, the
launch counters, and the slice on the card against the slice on the CPU.

These tests need a CUDA card and skip without one; on a machine with a card
run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared tests/conftest.py imports jax, which a
machine set up for the port need not have.)
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core.smppca import smppca
from repro_torch.kernels import (flash_attention, hadamard, ops, sketch_fused,
                                 tuning)

pytestmark = pytest.mark.cuda

# float32 sums over d in another order (sketch_fused: three split TF32
# passes on the tensor cores, chains into fresh accumulators, float32
# class): sketch entries within 1e-5 of
# the largest entry at these d, norms 1e-5 relative; Eq. 2 values within
# 1e-5 of their nA * nB scale.
RTOL = 1e-5
# Flash kernel against its plain version: the JAX suite's tolerances for
# its kernel against its oracle (tests/kernels/test_flash_attention.py).
FLASH_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d,n", [(512, 2048, 1024), (33, 517, 259),
                                   (1, 1, 1), (130, 16, 129)])
def test_sketch_fused_kernel_matches_plain(card, k, d, n, dtype):
    gen = torch.Generator(device=card).manual_seed(k + d + n)
    Pi = torch.randn(k, d, generator=gen, device=card).to(dtype)
    A = torch.randn(d, n, generator=gen, device=card).to(dtype)
    before = ops.LAUNCHES["sketch_fused"]
    out, norm = ops.sketch_fused(Pi, A)
    assert ops.LAUNCHES["sketch_fused"] == before + 1
    ref, ref_norm2 = ops.KERNELS["sketch_fused"].plain(Pi, A)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=RTOL * float(ref.abs().max()))
    torch.testing.assert_close(norm ** 2, ref_norm2, rtol=RTOL, atol=0)


def _sketch_against_plain(Pi, A, per_column=False):
    """ops.sketch_fused (one launch) against the plain version on the same
    inputs: entries within RTOL of the largest entry (of each column's
    largest entry with ``per_column``), squared norms within RTOL."""
    before = ops.LAUNCHES["sketch_fused"]
    out, norm = ops.sketch_fused(Pi, A)
    assert ops.LAUNCHES["sketch_fused"] == before + 1
    ref, ref_norm2 = ops.KERNELS["sketch_fused"].plain(Pi, A)
    scale = ref.abs().amax(dim=0 if per_column else None)
    assert bool(((out - ref).abs() <= RTOL * scale).all())
    torch.testing.assert_close(norm ** 2, ref_norm2, rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d,n", [
    (64, 1001, 203),    # d and n odd: both inputs copied for TMA
    (96, 1002, 206),    # d and n even, not multiples of 4 or 8
    (200, 100, 256),    # read in place; d not a multiple of a stage
    (128, 20, 264),     # d shorter than one stage
    (512, 64, 40_000),  # 1,252 tiles: more than one per persistent CTA
])
def test_sketch_fused_kernel_edges(card, k, d, n, dtype):
    gen = torch.Generator(device=card).manual_seed(k * d + n)
    Pi = torch.randn(k, d, generator=gen, device=card).to(dtype)
    A = torch.randn(d, n, generator=gen, device=card).to(dtype)
    _sketch_against_plain(Pi, A)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sketch_fused_kernel_unaligned_pointers(card, dtype):
    """Rows whose lengths are multiples of 16 bytes, but whose storage
    starts one element past a 16-byte boundary: copied for TMA."""
    gen = torch.Generator(device=card).manual_seed(3)
    k, d, n = 130, 512, 384
    flat = torch.randn(k * d + d * n + 2, generator=gen, device=card).to(dtype)
    Pi = flat[1:1 + k * d].view(k, d)
    A = flat[2 + k * d:].view(d, n)
    assert Pi.is_contiguous() and A.is_contiguous()
    assert Pi.data_ptr() % 16 and A.data_ptr() % 16
    _sketch_against_plain(Pi, A)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sketch_fused_kernel_columns_at_d_20000(card, dtype):
    """Long sums on the tensor cores: at d = 20,000, with the planted
    pair's columns scaled 1/i, each column within RTOL of its own largest
    entry (chip_smoke.py holds d = 50,000 to 1e-4 the same way)."""
    gen = torch.Generator(device=card).manual_seed(20)
    k, d, n = 256, 20_000, 1024
    Pi = torch.randn(k, d, generator=gen, device=card)
    scale = 1.0 / torch.arange(1, n + 1, device=card, dtype=torch.float32)
    A = torch.randn(d, n, generator=gen, device=card) * scale
    _sketch_against_plain(Pi.to(dtype), A.to(dtype), per_column=True)


@pytest.mark.parametrize("k", [1, 130, 384, 512, 640, 1024])
def test_sketch_fused_bf16_clusters_along_k(card, k):
    """The bf16 instance's clusters of min(ceil(k / 128), 4) CTAs (1, 2,
    3 and 4), each CTA's share of an A tile multicast into all of them and
    a stage refilled once every CTA released it; 640 and 1,024 have more
    row blocks than one cluster holds. n = 40,000: 313 column tiles, more
    units than the card holds clusters."""
    gen = torch.Generator(device=card).manual_seed(k)
    d, n = 1000, 40_000
    Pi = torch.randn(k, d, generator=gen, device=card).to(torch.bfloat16)
    A = torch.randn(d, n, generator=gen, device=card).to(torch.bfloat16)
    _sketch_against_plain(Pi, A)


@pytest.mark.parametrize("k", [64, 128, 512, 640])
def test_sketch_fused_f32_clusters(card, k):
    """The float32 instance's clusters of two neighbouring column tiles,
    each CTA's half of Pi's rows multicast into both, at one to five row
    blocks of Pi (64 and 128: one; 640: a partial one, the tile's rows past
    k zero-filled). n = 40,000: 313 column tiles, an odd count (the last
    cluster's second tile lies past n) and more units than the card holds
    clusters; d = 1,000 ends in a ragged stage."""
    gen = torch.Generator(device=card).manual_seed(k + 1)
    d, n = 1000, 40_000
    Pi = torch.randn(k, d, generator=gen, device=card)
    A = torch.randn(d, n, generator=gen, device=card)
    _sketch_against_plain(Pi, A)


def test_sketch_fused_f32_repeats_bit_for_bit(card):
    """No atomics and fixed orders: two float32 calls on the same inputs
    are equal bit for bit."""
    gen = torch.Generator(device=card).manual_seed(6)
    Pi = torch.randn(512, 3000, generator=gen, device=card)
    A = torch.randn(3000, 5000, generator=gen, device=card)
    out1, norm1 = ops.sketch_fused(Pi, A, squared=True)
    out2, norm2 = ops.sketch_fused(Pi, A, squared=True)
    assert torch.equal(out1, out2) and torch.equal(norm1, norm2)


@pytest.mark.parametrize("k,d,n,offset,copies", [
    (512, 2048, 1024, False, 0),   # TMA reads both in place
    (64, 1001, 203, False, 2),     # rows of Pi and A not multiples of 4
    (96, 1002, 206, False, 2),
    (256, 3001, 515, False, 2),
    (130, 16, 129, False, 1),      # only A's rows
    (130, 512, 384, True, 2),      # bases one element past 16 bytes
])
def test_sketch_fused_f32_aligned_copies_are_counted(card, k, d, n, offset,
                                                     copies):
    """The float32 wrapper copies, zero-padded, an input whose base or row
    pitch TMA cannot read, and counts each copy in ALIGNED_COPIES."""
    gen = torch.Generator(device=card).manual_seed(k + d + n + 1)
    if offset:
        flat = torch.randn(k * d + d * n + 2, generator=gen, device=card)
        Pi = flat[1:1 + k * d].view(k, d)
        A = flat[2 + k * d:].view(d, n)
    else:
        Pi = torch.randn(k, d, generator=gen, device=card)
        A = torch.randn(d, n, generator=gen, device=card)
    before = sketch_fused.ALIGNED_COPIES
    _sketch_against_plain(Pi, A)
    assert sketch_fused.ALIGNED_COPIES == before + copies


def test_sketch_fused_f32_prologue(card):
    """The float32 call's prologue (Pi's small parts into the wrapper's
    scratch) and its kernel count one launch; the prologue alone equals its
    plain version bit for bit."""
    gen = torch.Generator(device=card).manual_seed(9)
    Pi = torch.randn(130, 516, generator=gen, device=card)
    A = torch.randn(516, 300, generator=gen, device=card)
    ops.reset_launch_counts()
    ops.sketch_fused(Pi, A)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"sketch_fused": 1, "sampled_rescaled_dot": 0,
                            "blocked_fwht": 0, "flash_attention": 0}
    small = sketch_fused.pi_small_launch(ops._library("sketch_fused"), Pi)
    assert torch.equal(small, sketch_fused.pi_small_plain(Pi))


def test_sketch_fused_bf16_repeats_bit_for_bit(card):
    """No atomics and fixed orders: two calls on the same inputs are equal
    bit for bit."""
    gen = torch.Generator(device=card).manual_seed(5)
    Pi = torch.randn(512, 3000, generator=gen, device=card).bfloat16()
    A = torch.randn(3000, 5000, generator=gen, device=card).bfloat16()
    out1, norm1 = ops.sketch_fused(Pi, A, squared=True)
    out2, norm2 = ops.sketch_fused(Pi, A, squared=True)
    assert torch.equal(out1, out2) and torch.equal(norm1, norm2)


@pytest.mark.parametrize("k,d,n,offset,copies", [
    (512, 2048, 1024, False, 0),   # TMA reads both in place
    (64, 1001, 203, False, 2),     # rows of Pi and A not multiples of 8
    (96, 1002, 206, False, 2),
    (130, 16, 129, False, 1),      # only A's rows
    (130, 512, 384, True, 2),      # bases one element past 16 bytes
])
def test_sketch_fused_bf16_aligned_copies_are_counted(card, k, d, n, offset,
                                                      copies):
    """The bf16 wrapper copies, zero-padded, an input whose base or row
    pitch TMA cannot read, and counts each copy in ALIGNED_COPIES."""
    gen = torch.Generator(device=card).manual_seed(k + d + n)
    if offset:
        flat = torch.randn(k * d + d * n + 2, generator=gen,
                           device=card).to(torch.bfloat16)
        Pi = flat[1:1 + k * d].view(k, d)
        A = flat[2 + k * d:].view(d, n)
    else:
        Pi = torch.randn(k, d, generator=gen, device=card).to(torch.bfloat16)
        A = torch.randn(d, n, generator=gen, device=card).to(torch.bfloat16)
    before = sketch_fused.ALIGNED_COPIES
    _sketch_against_plain(Pi, A)
    assert sketch_fused.ALIGNED_COPIES == before + copies


def test_sampled_dot_kernel_matches_plain(card):
    gen = torch.Generator(device=card).manual_seed(0)
    n1, n2, k, m = 3000, 2000, 512, 100_000
    As = torch.randn(n1, k, generator=gen, device=card)
    Bs = torch.randn(n2, k, generator=gen, device=card)
    na = torch.rand(n1, generator=gen, device=card) + 0.5
    nb = torch.rand(n2, generator=gen, device=card) + 0.5
    rows = torch.randint(0, n1, (m,), generator=gen, device=card,
                         dtype=torch.int32)
    cols = torch.randint(0, n2, (m,), generator=gen, device=card,
                         dtype=torch.int32)
    rows[:100], cols[:100] = rows[0], cols[0]          # duplicates
    before = ops.LAUNCHES["sampled_rescaled_dot"]
    out = ops.sampled_rescaled_dot(As, Bs, na, nb, rows, cols)
    assert ops.LAUNCHES["sampled_rescaled_dot"] == before + 1
    ref = ops.KERNELS["sampled_rescaled_dot"].plain(As, Bs, na, nb, rows,
                                                    cols)
    scale = na[rows.long()] * nb[cols.long()]
    assert float(((out - ref).abs() / scale).max()) < RTOL
    assert bool((out[:100] == out[0]).all())

    empty = rows[:0]
    assert ops.sampled_rescaled_dot(As, Bs, na, nb, empty, empty).shape == (0,)
    assert ops.LAUNCHES["sampled_rescaled_dot"] == before + 1   # no launch
    with pytest.raises(IndexError):
        ops.sampled_rescaled_dot(As, Bs, na, nb, rows + n1, cols)
    with pytest.raises(TypeError):
        ops.sampled_rescaled_dot(As, Bs, na, nb, rows.long(), cols.long())


@pytest.mark.parametrize("case", ["uniform", "hot_row", "duplicates", "bf16",
                                  "k_ragged", "k_above_512", "small_n2"])
def test_sampled_dot_kernel_draws(card, case):
    """The bucketed kernel against its plain version on draws that stress
    its buckets: uniform rows and columns over several column blocks of Bs
    (n2 = 20,000 > 8,192 rows a block); one row holding half the samples
    (its buckets cut into many 32-sample segments); many duplicates; bf16
    rows; k not a multiple of 32; k above the 512 that registers hold; n2
    below one block. Values in sample order within RTOL of their nA * nB
    scale, and the same bits on a second call."""
    gen = torch.Generator(device=card).manual_seed(17)
    n1, n2, k, m = 3000, 20_000, 512, 200_000
    k = {"k_ragged": 100, "k_above_512": 600}.get(case, k)
    n2 = 700 if case == "small_n2" else n2
    As = torch.randn(n1, k, generator=gen, device=card)
    Bs = torch.randn(n2, k, generator=gen, device=card)
    if case == "bf16":
        As, Bs = As.bfloat16(), Bs.bfloat16()
    na = torch.rand(n1, generator=gen, device=card) + 0.5
    nb = torch.rand(n2, generator=gen, device=card) + 0.5
    rows = torch.randint(0, n1, (m,), generator=gen, device=card,
                         dtype=torch.int32)
    cols = torch.randint(0, n2, (m,), generator=gen, device=card,
                         dtype=torch.int32)
    if case == "hot_row":
        rows[::2] = 11
    if case == "duplicates":
        rows[: m // 2], cols[: m // 2] = rows[:100].repeat(m // 200), \
            cols[:100].repeat(m // 200)
    out = ops.sampled_rescaled_dot(As, Bs, na, nb, rows, cols)
    ref = ops.KERNELS["sampled_rescaled_dot"].plain(As, Bs, na, nb, rows,
                                                    cols)
    scale = na[rows.long()] * nb[cols.long()]
    assert out.shape == (m,)
    assert float(((out - ref).abs() / scale).max()) < RTOL
    assert torch.equal(ops.sampled_rescaled_dot(As, Bs, na, nb, rows, cols),
                       out)
    if case == "duplicates":
        assert torch.equal(out[100:200], out[:100])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,d_pad,n", [
    (2048, 2048, 1024),     # two passes of radix 32 and 64
    (50_000, 65_536, 96),   # the slice's padding, two passes of 256
    (200, 256, 64),         # one pass (the Pallas kernel's a = 1)
    (777, 1024, 1000),      # ragged n: the last column tile is partial
    (1, 1, 5),              # a transform of length 1
    (70_000, 131_072, 40),  # three passes
])
def test_blocked_fwht_kernel_matches_plain(card, d, d_pad, n, dtype):
    """The kernel does the plain butterfly's float32 adds in the plain
    version's order, so the two agree bit for bit; the check still allows
    1e-4 of each column's largest entry, chip_smoke.py's tolerance."""
    gen = torch.Generator(device=card).manual_seed(d + n)
    wide = torch.randn(d, n + 3, generator=gen, device=card).to(dtype)
    X = wide[:, 1:n + 1]                    # a column slice: row stride n + 3
    signs = torch.randint(0, 2, (d,), generator=gen, device=card) * 2.0 - 1
    before = ops.LAUNCHES["blocked_fwht"]
    out = ops.blocked_fwht(X, signs, d_pad=d_pad)
    assert ops.LAUNCHES["blocked_fwht"] == before + 1
    ref = ops.KERNELS["blocked_fwht"].plain(X, signs, d_pad)
    assert out.dtype == torch.float32 and out.shape == (d_pad, n)
    col_err = ((out - ref).abs().amax(dim=0)
               / ref.abs().amax(dim=0).clamp(min=1e-30))
    assert float(col_err.max()) <= 1e-4
    with pytest.raises(ValueError, match="power of two"):
        ops.blocked_fwht(X, signs, d_pad=3 * d_pad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,d_pad,n", [
    (2048, 2048, 1024),     # two passes of radix 32 and 64
    (50_000, 65_536, 96),   # the slice's padding, two passes of 256
    (200, 256, 64),         # one pass: read, norms and sampled rows at once
    (777, 1024, 1000),      # ragged n: the last column tile is partial
    (1, 1, 5),              # a transform of length 1
    (70_000, 131_072, 40),  # three passes
])
def test_srht_block_kernel_matches_plain(card, d, d_pad, n, dtype):
    """The block mode against its plain version (the full transform's
    sampled rows, rescaled, and ``column_norms``) on a column slice, into a
    wider sketch at a column offset: the sketch bit for bit, the norms (the
    kernel's own order of sums) within 1e-6 relative, the columns outside
    the block untouched, one launch; two calls give the same bits."""
    gen = torch.Generator(device=card).manual_seed(d + n + 1)
    wide = torch.randn(d, n + 3, generator=gen, device=card).to(dtype)
    X = wide[:, 1:n + 1]
    signs = torch.randint(0, 2, (d,), generator=gen, device=card) * 2.0 - 1
    k = min(64, d_pad)
    rows = torch.randperm(d_pad, generator=gen, device=card)[:k].int()
    col0 = 5
    sketch = torch.full((k, n + 9), 7.0, device=card)
    norms = torch.full((n + 9,), 7.0, device=card)
    before = ops.LAUNCHES["blocked_fwht"]
    got_s, got_n = ops.srht_block(X, signs, rows, d_pad=d_pad, sketch=sketch,
                                  norms=norms, col0=col0)
    assert ops.LAUNCHES["blocked_fwht"] == before + 1
    want_s, want_n = hadamard.plain_block(X, signs, rows, d_pad)
    assert torch.equal(got_s, want_s)
    torch.testing.assert_close(got_n, want_n, rtol=1e-6, atol=0)
    assert bool((sketch[:, :col0] == 7.0).all()
                and (sketch[:, col0 + n:] == 7.0).all())
    assert bool((norms[:col0] == 7.0).all() and (norms[col0 + n:] == 7.0).all())
    again = ops.srht_block(X, signs, rows, d_pad=d_pad)
    assert torch.equal(again[0], got_s) and torch.equal(again[1], got_n)


@pytest.mark.parametrize("d,d_pad,k", [(0, 1, 1), (0, 512, 16),
                                       (200, 256, 1), (2048, 4096, 4096)])
def test_srht_block_kernel_edges(card, d, d_pad, k):
    """No input row (zeros, no launch), one sampled row in one pass, every
    row sampled in two: the plain version's values."""
    gen = torch.Generator(device=card).manual_seed(d + k)
    X = torch.randn(d, 70, generator=gen, device=card)
    signs = torch.randint(0, 2, (d,), generator=gen, device=card) * 2.0 - 1
    rows = torch.randperm(d_pad, generator=gen, device=card)[:k].int()
    before = ops.LAUNCHES["blocked_fwht"]
    got_s, got_n = ops.srht_block(X, signs, rows, d_pad=d_pad)
    assert ops.LAUNCHES["blocked_fwht"] == before + (d > 0)
    want_s, want_n = hadamard.plain_block(X, signs, rows, d_pad)
    assert torch.equal(got_s, want_s)
    torch.testing.assert_close(got_n, want_n, rtol=1e-6, atol=0)


def _cluster_edge(dtype, k=512) -> int:
    """The largest d (a multiple of 256) whose strip fits the cluster form
    at d_pad = 65,536 with k sampled rows."""
    d = 256
    while hadamard.block_plan(d + 256, 65_536, dtype, k).form == "cluster":
        d += 256
    return d


# (d, d_pad, n, k, layout): layout "tma" takes a column slice of a matrix
# whose row stride and base are 16-byte aligned (tiles by TMA), "copies" a
# slice one column in (element copies)
CLUSTER_CASES = [
    (50_000, 65_536, 300, 512, "tma"),     # the slice's d, a few hundred
    (50_000, 65_536, 13, 512, "tma"),      # n not a multiple of 8
    (50_000, 65_536, 5, 512, "tma"),       # n < 8
    (777, 1024, 64, 512, "tma"),           # d not a multiple of the radix
    ("edge", 65_536, 40, 512, "tma"),      # the largest d that fits
    ("past", 65_536, 40, 512, "tma"),      # one 256-row group more
    (50_000, 65_536, 37, 512, "copies"),   # a row stride off 16 bytes
    (50_000, 65_536, 24, 1, "tma"),        # k = 1
    (4000, 4096, 24, 4096, "tma"),         # every lo sampled
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,d_pad,n,k,layout", CLUSTER_CASES)
def test_srht_block_cluster_form_matches_plain(card, d, d_pad, n, k, layout,
                                               dtype):
    """The block mode's cluster form (and, one group past its capacity, the
    two-pass form) against the plain version, into a wider sketch at a
    column offset: the sketch bit for bit, the norms within 1e-6 relative,
    a second call's bits equal, one launch in the form ``block_plan``
    names."""
    if d in ("edge", "past"):
        d = _cluster_edge(dtype, k) + (256 if d == "past" else 0)
    form = hadamard.block_plan(d, d_pad, dtype, k).form
    assert form == ("two_pass" if d_pad == 65_536
                    and d > _cluster_edge(dtype, k) else "cluster")
    gen = torch.Generator(device=card).manual_seed(d + n + k)
    pitch = -(-(n + 1) // 8) * 8              # 32 bytes a row in float32
    wide = torch.randn(d, pitch, generator=gen, device=card).to(dtype)
    X = wide[:, :n] if layout == "tma" else wide[:, 1:n + 1]
    signs = torch.randint(0, 2, (d,), generator=gen, device=card) * 2.0 - 1
    rows = torch.randperm(d_pad, generator=gen, device=card)[:k].int()
    col0 = 3
    sketch = torch.full((k, n + 7), 7.0, device=card)
    norms = torch.full((n + 7,), 7.0, device=card)
    ops.reset_launch_counts()
    got_s, got_n = ops.srht_block(X, signs, rows, d_pad=d_pad, sketch=sketch,
                                  norms=norms, col0=col0)
    assert ops.LAUNCHES["blocked_fwht"] == 1
    assert hadamard.BLOCK_FORMS == {"cluster": int(form == "cluster"),
                                    "two_pass": int(form == "two_pass")}
    want_s, want_n = hadamard.plain_block(X, signs, rows, d_pad)
    assert torch.equal(got_s, want_s)
    torch.testing.assert_close(got_n, want_n, rtol=1e-6, atol=0)
    assert bool((sketch[:, :col0] == 7.0).all()
                and (sketch[:, col0 + n:] == 7.0).all())
    assert bool((norms[:col0] == 7.0).all() and (norms[col0 + n:] == 7.0).all())
    again = ops.srht_block(X, signs, rows, d_pad=d_pad)
    assert torch.equal(again[0], got_s) and torch.equal(again[1], got_n)
    assert hadamard.BLOCK_FORMS[form] == 2


def test_srht_block_cluster_form_is_refused_where_it_does_not_fit(card):
    """Asked for the cluster form one group past its capacity, or at one
    pass, the source refuses the launch and the wrapper raises."""
    lib = ops._library("blocked_fwht")
    for d, d_pad in ((_cluster_edge(torch.float32, 8) + 256, 65_536),
                     (200, 256)):
        X = torch.randn(d, 16, device=card)
        signs = torch.ones(d, device=card)
        rows = torch.arange(8, device=card, dtype=torch.int32)
        with pytest.raises(RuntimeError, match="cluster kernel launch"):
            hadamard.launch_block(lib, X, signs, rows, d_pad, 1.0, 1.0,
                                  torch.empty(8, 16, device=card),
                                  torch.empty(16, device=card),
                                  form="cluster")


def test_srht_smppca_on_the_card_matches_the_cpu(card):
    rng = np.random.default_rng(1)
    d, n, r = 2000, 200, 5
    D = (1.0 / np.arange(1.0, n + 1.0)).astype(np.float32)
    A = torch.from_numpy(rng.standard_normal((d, n)).astype(np.float32) * D)
    B = A + 0.3 * torch.from_numpy(
        rng.standard_normal((d, n)).astype(np.float32) * D)
    m = int(10 * n * r * np.log(n))
    ops.reset_launch_counts()
    on_card = smppca(prng.PRNGKey(0), A, B, r=r, k=512, m=m, T=8,
                     method="srht")
    assert ops.LAUNCHES == {"sketch_fused": 0, "sampled_rescaled_dot": 1,
                            "blocked_fwht": 2, "flash_attention": 0}
    on_cpu = smppca(prng.PRNGKey(0), A, B, r=r, k=512, m=m, T=8,
                    method="srht", device="cpu")
    got = (on_card.factors.U @ on_card.factors.V.T).cpu()
    want = on_cpu.factors.U @ on_cpu.factors.V.T
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        < 1e-3


def test_smppca_on_the_card_matches_the_cpu(card):
    rng = np.random.default_rng(0)
    d, n, r = 2000, 200, 5
    D = (1.0 / np.arange(1.0, n + 1.0)).astype(np.float32)
    A = torch.from_numpy(rng.standard_normal((d, n)).astype(np.float32) * D)
    B = A + 0.3 * torch.from_numpy(
        rng.standard_normal((d, n)).astype(np.float32) * D)
    m = int(10 * n * r * np.log(n))
    ops.reset_launch_counts()
    on_card = smppca(prng.PRNGKey(0), A, B, r=r, k=512, m=m, T=8)
    assert ops.LAUNCHES == {"sketch_fused": 2, "sampled_rescaled_dot": 1,
                            "blocked_fwht": 0, "flash_attention": 0}
    on_cpu = smppca(prng.PRNGKey(0), A, B, r=r, k=512, m=m, T=8,
                    device="cpu")
    got = (on_card.factors.U @ on_card.factors.V.T).cpu()
    want = on_cpu.factors.U @ on_cpu.factors.V.T
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        < 1e-3


# ---------------------------------------------------------------------------
# The rest of the estimation engine on the card against the CPU: the probe
# and co-sketch blocks, every estimation method, the error gate, batched
# mode, the baselines and the Bernoulli sampler (plain PyTorch around the
# kernels; the same keys on both devices)
# ---------------------------------------------------------------------------

# U V^T on the card against the CPU: float32 sums in other orders and
# WAltMin's atomics move it by ~1e-5 relative (chip_smoke.py SMALL_UVT_TOL).
UVT_TOL = 1e-3


def _planted(seed=0, d=2000, n=200):
    rng = np.random.default_rng(seed)
    D = (1.0 / np.arange(1.0, n + 1.0)).astype(np.float32)
    A = torch.from_numpy(rng.standard_normal((d, n)).astype(np.float32) * D)
    return A, A + 0.3 * torch.from_numpy(
        rng.standard_normal((d, n)).astype(np.float32) * D)


def _uvt_rel(got, want):
    g = (got.U @ got.V.transpose(-1, -2)).cpu()
    w = (want.U @ want.V.transpose(-1, -2)).cpu()
    return float(torch.linalg.norm(g - w) / torch.linalg.norm(w))


def _summaries(A, B, **kw):
    from repro_torch.core.summary_engine import build_summary
    return {where: build_summary(prng.PRNGKey(0), A, B, 512, backend="cuda",
                                 device=where, **kw)
            for where in ("cuda", "cpu")}


@pytest.mark.parametrize("precision,dtype,tol", [
    (None, torch.float32, 1e-5),
    # a bf16 intermediate (B @ Omega, Psi @ A^T) may round to the
    # neighbouring bf16 value (2^-8 of one term) when the card's float32
    # sum of it differs in its last bit
    ("bf16", torch.float32, 1e-3),
    (None, torch.bfloat16, 1e-3)])
def test_probe_and_cosketch_blocks_on_the_card_match_the_cpu(card, precision,
                                                             dtype, tol):
    from repro_torch.core.summary_engine import build_summary
    A, B = (x.to(dtype) for x in _planted(d=1500, n=120))
    ops.reset_launch_counts()
    got = build_summary(prng.PRNGKey(1), A, B, 64, backend="cuda",
                        precision=precision, probes=6, cosketch=4)
    assert ops.LAUNCHES["sketch_fused"] == 2
    want = build_summary(prng.PRNGKey(1), A, B, 64, backend="cuda",
                         precision=precision, probes=6, cosketch=4,
                         device="cpu")
    for name in ("probes", "cosketch_Y", "cosketch_W"):
        g, w = getattr(got, name).cpu(), getattr(want, name)
        assert g.dtype == torch.float32
        scale = w.abs().amax(dim=0)
        assert bool(((g - w).abs() <= tol * scale).all()), name
    for name in ("probe_omega", "cosketch_omega", "cosketch_psi"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=0, atol=1e-6)


@pytest.mark.parametrize("method,refine", [
    ("rescaled_jl", None), ("lela_waltmin", None), ("direct_svd", None),
    ("power", (0, "tropp")), ("power", (1, "power"))])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_every_method_on_the_card_matches_the_cpu(card, method, refine,
                                                  backend):
    from repro_torch.core.estimation_engine import estimate_product
    from repro_torch.core.refinement import RefineSpec
    A, B = _planted()
    summaries = _summaries(A, B, probes=8, cosketch=10)
    kw = dict(method=method, backend=backend, m=20_000, T=6,
              with_error=True,
              refine=None if refine is None else RefineSpec(*refine))
    if method == "lela_waltmin":
        kw["exact_pair"] = (A, B)
    ops.reset_launch_counts()
    got = estimate_product(prng.PRNGKey(2), summaries["cuda"], 5, **kw)
    assert ops.LAUNCHES["sampled_rescaled_dot"] == int(
        method == "rescaled_jl" and backend == "cuda")
    want = estimate_product(prng.PRNGKey(2), summaries["cpu"], 5,
                            device="cpu", **kw)
    assert got.factors.U.is_cuda
    assert _uvt_rel(got.factors, want.factors) < UVT_TOL
    torch.testing.assert_close(got.error.rel_est.cpu(), want.error.rel_est,
                               rtol=UVT_TOL, atol=0)


def test_svd_on_the_card_is_float32_accurate(card):
    """The port's SVD (``core/linalg.svd``: cuSOLVER's gesvd on the card)
    against float64 on a 200 x 200 matrix with a 1/i spectrum, square and
    wide: singular values within 1e-6 of the largest, the reconstruction
    within 2e-6. torch's default routine (gesvdj) gave 1.1e-5 and 3.0e-5
    on this matrix."""
    from repro_torch.core.linalg import svd
    gen = torch.Generator().manual_seed(0)
    D = 1.0 / torch.arange(1, 201).float()
    M = (torch.randn(200, 200, generator=gen) * D) @ torch.randn(
        200, 200, generator=gen)
    W = torch.randn(13, 20_000, generator=gen) * torch.logspace(
        0, -3, 13)[:, None]
    for X in (M, W):
        U, s, Vh = svd(X.to(card))
        X64 = X.double()
        s64 = torch.linalg.svdvals(X64)
        assert float(((s.cpu().double() - s64).abs()).max() / s64[0]) < 1e-6
        rec = ((U * s) @ Vh).cpu().double()
        assert float((rec - X64).norm() / X64.norm()) < 2e-6


def test_lstsq_on_the_card_matches_the_cpu(card):
    """torch.linalg.lstsq on CUDA has only the 'gels' routine (full rank
    assumed): the tall (2s + 1, s) system of Tropp's reconstruction is."""
    from repro_torch.core import refinement
    A, B = _planted()
    s = _summaries(A, B, cosketch=10)
    Q = {w: torch.linalg.qr(x.cosketch_Y).Q for w, x in s.items()}
    X = {w: torch.linalg.lstsq(x.cosketch_psi @ Q[w], x.cosketch_W).solution
         for w, x in s.items()}
    got, want = Q["cuda"] @ X["cuda"], Q["cpu"] @ X["cpu"]
    assert float(torch.linalg.norm(got.cpu() - want)
                 / torch.linalg.norm(want)) < 1e-4
    for spec in (refinement.RefineSpec(0, "tropp"),
                 refinement.RefineSpec(2, "power")):
        assert _uvt_rel(refinement.refine_factors(s["cuda"], 5, spec),
                        refinement.refine_factors(s["cpu"], 5, spec)) < 1e-4


@pytest.mark.parametrize("refine", [None, (0, "tropp"), (1, "power")])
def test_error_gate_on_the_card_matches_the_cpu(card, refine):
    """The gate on one summary (the CPU's, moved to the card), so that only
    its own SVD, QR, least squares and sums run on the two devices: the
    same rank, the curve's squares (cumulative sums of terms as large as
    the probes' energy, which the curve divides out) within 1e-5, the
    estimates within 1e-4 of themselves."""
    from repro_torch.core import error_engine
    from repro_torch.core.refinement import RefineSpec
    from repro_torch.core.summary_engine import build_summary
    from repro_torch.core.types import SketchSummary
    A, B = _planted()
    want_s = build_summary(prng.PRNGKey(0), A, B, 512, backend="cuda",
                           probes=16, cosketch=10, device="cpu")
    got_s = SketchSummary(*(x.to(card) for x in want_s))
    spec = None if refine is None else RefineSpec(*refine)
    got = error_engine.adaptive_rank(got_s, tol=0.2, r_max=10, refine=spec)
    want = error_engine.adaptive_rank(want_s, tol=0.2, r_max=10,
                                      refine=spec)
    assert got.r == want.r and got.curve.is_cuda
    sq_diff = (got.curve.cpu() ** 2 - want.curve ** 2).abs()
    assert float(sq_diff.max()) <= 1e-5
    for g, w in zip(got.error, want.error):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=0)


def test_batched_on_the_card_matches_the_looped_cpu(card):
    from repro_torch.core.estimation_engine import estimate_product
    from repro_torch.core.summary_engine import build_summary
    from repro_torch.core.types import tree_index
    pairs = [_planted(seed, d=800, n=60) for seed in range(3)]
    A = torch.stack([a for a, _ in pairs])
    B = torch.stack([b for _, b in pairs])
    ops.reset_launch_counts()
    s = build_summary(prng.PRNGKey(3), A, B, 128, backend="cuda", probes=4,
                      cosketch=3)
    got = estimate_product(prng.PRNGKey(4), s, 3, m=5000, T=4,
                           with_error=True)
    assert ops.LAUNCHES["sketch_fused"] == 6
    assert ops.LAUNCHES["sampled_rescaled_dot"] == 3
    keys, est_keys = prng.split(prng.PRNGKey(3), 3), prng.split(
        prng.PRNGKey(4), 3)
    for i in range(3):
        one = build_summary(keys[i], A[i], B[i], 128, backend="cuda",
                            probes=4, cosketch=3, device="cpu")
        want = estimate_product(est_keys[i], one, 3, m=5000, T=4,
                                with_error=True, device="cpu")
        assert _uvt_rel(tree_index(got.factors, i), want.factors) < UVT_TOL


def test_baselines_on_the_card_match_the_cpu(card):
    from repro_torch.core import baselines
    from repro_torch.core.lela import lela
    A, B = _planted()
    for fn in (lambda dev: lela(prng.PRNGKey(5), A, B, r=5, m=20_000,
                                T=6, device=dev),
               lambda dev: baselines.sketch_svd(prng.PRNGKey(5), A, B, r=5,
                                                k=512, device=dev),
               lambda dev: baselines.product_of_pcas(prng.PRNGKey(5), A, B,
                                                     5, device=dev),
               lambda dev: baselines.optimal_rank_r(A, B, 5, device=dev)):
        assert _uvt_rel(fn("cuda"), fn("cpu")) < UVT_TOL


def test_binomial_sampler_on_the_card_matches_the_cpu(card):
    from repro_torch.core import sampling
    A, B = _planted()
    na, nb = A.norm(dim=0), B.norm(dim=0)
    got = sampling.sample_entries_binomial(prng.PRNGKey(6), na.cuda(),
                                           nb.cuda(), 4000)
    want = sampling.sample_entries_binomial(prng.PRNGKey(6), na, nb, 4000)
    for name in ("rows", "cols", "mask"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))


@pytest.mark.parametrize("bq,bk,dh", [
    (bq, bk, dh) for dh in flash_attention.HEAD_DIMS
    for bq, bk in dict.fromkeys(flash_attention.tiles(dh, 4)
                                + flash_attention.tiles(dh, 2))])
def test_flash_kernel_matches_plain(card, bq, bk, dh):
    """Every compiled (tile, head width), causal and not, in each of float32
    and bf16 that compiles the tile (at Dh 64, 96 and 128 each dtype has
    its wgmma instance's one tile alone), with GQA (4 query heads on 2 KV
    heads) and q, k and v read in place from one packed (B, S, H + 2 Hkv,
    Dh) tensor."""
    gen = torch.Generator(device=card).manual_seed(bq + bk + dh)
    B, S, H, Hkv = 2, 256, 4, 2
    packed = torch.randn(B, S, H + 2 * Hkv, dh, generator=gen, device=card)
    cfg = tuning.KernelConfig("flash_attention", (bq, bk))
    for dtype in (torch.float32, torch.bfloat16):
        if (bq, bk) not in flash_attention.tiles(dh, dtype.itemsize):
            continue
        qkv = packed.to(dtype)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
        for causal in (True, False):
            before = ops.LAUNCHES["flash_attention"]
            out = ops.flash_attention(q, k, v, causal=causal, config=cfg)
            assert ops.LAUNCHES["flash_attention"] == before + 1
            ref = ops.KERNELS["flash_attention"].plain(q, k, v, causal)
            assert out.dtype == dtype and out.shape == (B, S, H, dh)
            torch.testing.assert_close(out.float(), ref.float(),
                                       rtol=FLASH_TOL[dtype],
                                       atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 96, 128, 48, 120])
@pytest.mark.parametrize("B,S,H,Hkv,causal", [
    (B, S, H, Hkv, causal)
    for B, S in ((1, 128), (2, 4096))        # one tile; B = 2
    for H, Hkv in ((4, 1), (4, 4))           # GQA 4:1 and MHA
    for causal in (True, False)] + [
    (1, 300, 8, 2, True), (2, 1000, 4, 4, True),   # S flash_prefill pads
    (1, 256, 32, 32, True),                  # phi3-mini-3.8b's heads, MHA
    (2, 384, 12, 12, True),                  # whisper-small's heads, MHA
    (1, 512, 12, 1, True), (1, 512, 12, 1, False),   # GQA 12:1
])
def test_flash_wgmma_instance_matches_plain(card, B, S, H, Hkv, causal, dh,
                                            dtype):
    """The wgmma instances, float32 and bf16 at Dh 64, 96 and 128 and at
    the widths 48 and 120 padded to them: q, k and v as strided views of
    one (B, S, (H + 2 Hkv) Dh) projection, as the LM makes them, through
    ``ops.flash_attention`` at its one tile (a multiple of 128 rows) or,
    for an S it pads, ``attention.flash_prefill`` (causal only): one
    launch, within FLASH_TOL of the plain version. bf16 is held tighter
    too (``flash_attention.bf16_agreement``): within one bf16 ulp, plus the
    float32 FLASH_TOL, of the plain version's bf16 output everywhere, and
    equal to it on all but ``BF16_DIFFER_MAX`` of the entries, which P
    rounded once to bf16 would miss. At a compiled width the call
    allocates its output and, in float32, the prologue's V^T (which the
    prologue alone writes equal to ``vt_plain``); in bf16 nothing else."""
    from repro_torch.models import attention as attn
    gen = torch.Generator(device=card).manual_seed(S + H + Hkv + dh)
    proj = torch.randn(B, S, (H + 2 * Hkv) * dh, generator=gen,
                       device=card).to(dtype)
    qkv = proj.view(B, S, H + 2 * Hkv, dh)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    before = ops.LAUNCHES["flash_attention"]
    allocs = torch.cuda.memory_stats(card)["allocation.all.allocated"]
    if S % 128:
        out = attn.flash_prefill(q, k, v)
    else:
        out = ops.flash_attention(q, k, v, causal=causal)
    allocated = torch.cuda.memory_stats(card)["allocation.all.allocated"] - \
        allocs
    assert ops.LAUNCHES["flash_attention"] == before + 1
    ref = flash_attention.plain(q, k, v, causal)
    assert out.shape == (B, S, H, dh) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])
    if dtype == torch.bfloat16:
        share, excess = flash_attention.bf16_agreement(
            out, ref, FLASH_TOL[torch.float32])
        assert excess <= 0 and share <= flash_attention.BF16_DIFFER_MAX, \
            (share, excess)
    if dh in flash_attention.WGMMA_DH and S % 128 == 0:
        assert allocated == (2 if dtype == torch.float32 else 1)
        if dtype == torch.float32:
            vt = flash_attention.vt_launch(ops._library("flash_attention"), v)
            assert torch.equal(vt, flash_attention.vt_plain(v))


@pytest.mark.parametrize("dh", [*flash_attention.HEAD_DIMS, 50])
@pytest.mark.parametrize("S", [1, 48, 100, 127])
def test_flash_short_s_matches_plain(card, S, dh):
    """An S below 128, which the JAX wrapper runs as one block: one launch
    on a copy zero-padded along S with the keys past S masked, at every
    compiled width and the padded width 50, float32 and bf16, causal and
    not, GQA (4 query heads over 2), within FLASH_TOL of the plain version
    at S; a bf16 call on a wgmma instance also by ``bf16_agreement``. A
    direct launch on 128 random rows with ``kv_len`` = S matches the plain
    version with the same ``kv_len``."""
    gen = torch.Generator(device=card).manual_seed(S + dh)
    q = torch.randn(2, S, 4, dh, generator=gen, device=card)
    k, v = (torch.randn(2, S, 2, dh, generator=gen, device=card)
            for _ in range(2))
    lib = ops._library("flash_attention")
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dtype) for x in (q, k, v))
        for causal in (True, False):
            before = ops.LAUNCHES["flash_attention"]
            out = ops.flash_attention(qd, kd, vd, causal=causal)
            assert ops.LAUNCHES["flash_attention"] == before + 1
            ref = flash_attention.plain(qd, kd, vd, causal)
            assert out.shape == qd.shape and out.dtype == dtype
            torch.testing.assert_close(out.float(), ref.float(),
                                       rtol=FLASH_TOL[dtype],
                                       atol=FLASH_TOL[dtype])
            if dtype == torch.bfloat16 and flash_attention.on_wgmma(dh, 2):
                share, excess = flash_attention.bf16_agreement(
                    out, ref, FLASH_TOL[torch.float32])
                assert excess <= 0 and \
                    share <= flash_attention.BF16_DIFFER_MAX, (share, excess)
        if dh not in flash_attention.HEAD_DIMS:
            continue
        rows = (torch.randn(2, 128, h, dh, generator=gen, device=card)
                .to(dtype) for h in (4, 2, 2))
        qp, kp, vp = rows
        bq, bk = flash_attention.tiles(dh, dtype.itemsize)[0]
        out = flash_attention.launch(lib, qp, kp, vp, False, bq, bk,
                                     kv_len=S)
        ref = flash_attention.plain(qp, kp, vp, False, kv_len=S)
        torch.testing.assert_close(out.float(), ref.float(),
                                   rtol=FLASH_TOL[dtype],
                                   atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("dh", [64, 96, 128])
def test_flash_bf16_wgmma_reads_v_by_key_and_column(card, dh):
    """bf16 at Dh 64, 96 and 128 reads V's tile MN-major as TMA lands it:
    each query attends to one key alone (q_i is 32 k_pi(i), its score tens
    above every other key's), so its output row is that key's V row.
    With V's entries the key's index, and again the column's, both exact
    in bf16, a V read transposed, from another key or from another column
    (a swizzle undone wrongly) cannot give back either, across GQA 2:1 and
    the k-tiles of S = 256 (keys up to 256 are exact in bf16)."""
    gen = torch.Generator(device=card).manual_seed(dh)
    B, S, H, Hkv = 1, 256, 4, 2
    k = torch.randn(B, S, Hkv, dh, generator=gen, device=card).bfloat16()
    pi = torch.randperm(S, generator=gen, device=card)
    q = (32 * k[:, pi]).repeat_interleave(H // Hkv, dim=2)
    keys = torch.arange(S, device=card, dtype=torch.float32)
    cols = torch.arange(dh, device=card, dtype=torch.float32)
    v_key = keys[None, :, None, None].expand(B, S, Hkv, dh).bfloat16()
    v_col = cols.expand(B, S, Hkv, dh).bfloat16()
    out_key = ops.flash_attention(q, k, v_key.contiguous(), causal=False)
    out_col = ops.flash_attention(q, k, v_col.contiguous(), causal=False)
    assert torch.equal(out_key.float(),
                       pi.float()[None, :, None, None].expand(B, S, H, dh))
    assert torch.equal(out_col.float(), cols.expand(B, S, H, dh))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 96, 128])
def test_flash_bf16_wgmma_repeats_bit_for_bit(card, dh, causal):
    """Two calls of a bf16 wgmma instance on the same inputs give the same
    bits: a CTA's sums run in one fixed order."""
    gen = torch.Generator(device=card).manual_seed(7 * dh)
    q, k, v = (torch.randn(2, 1024, h, dh, generator=gen,
                           device=card).bfloat16() for h in (8, 2, 2))
    first = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(first, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("dh", [48, 80, 200, 256, 50, 13])
def test_head_widths_between_compiled_ones_launch_once(card, dh):
    """Widths between the compiled ones run on a copy zero-padded to the
    next wider instance (48 and 50 on Dh 64's, 80 on 96's, 200 on 256's,
    13 on 16's; 48, 50 and 80 on the wgmma instances of either dtype), 256 on
    its warp pairs: one launch a call, the scale of the true Dh, within
    FLASH_TOL of the plain version, causal and not, float32 and bf16, GQA 4
    over 2 at the tile ``tuning.lookup`` resolves."""
    gen = torch.Generator(device=card).manual_seed(dh)
    B, S, H, Hkv = 1, 256, 4, 2
    q = torch.randn(B, S, H, dh, generator=gen, device=card)
    k, v = (torch.randn(B, S, Hkv, dh, generator=gen, device=card)
            for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dtype) for x in (q, k, v))
        for causal in (True, False):
            before = ops.LAUNCHES["flash_attention"]
            out = ops.flash_attention(qd, kd, vd, causal=causal)
            assert ops.LAUNCHES["flash_attention"] == before + 1
            ref = flash_attention.plain(qd, kd, vd, causal)
            assert out.dtype == dtype and out.shape == (B, S, H, dh)
            torch.testing.assert_close(out.float(), ref.float(),
                                       rtol=FLASH_TOL[dtype],
                                       atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("dh", [264, 320])
def test_uncompiled_head_width_raises_before_a_launch(card, dh):
    """A head width past 256 (no config of the repo has one) raises on the
    card before anything launches: no padding, no plain fallback."""
    gen = torch.Generator(device=card).manual_seed(dh)
    q = torch.randn(1, 128, 2, dh, generator=gen, device=card)
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="compiled"):
        ops.flash_attention(q, q, q)
    assert ops.LAUNCHES["flash_attention"] == before


def test_flash_block_shape_independence(card):
    gen = torch.Generator(device=card).manual_seed(3)
    # float32 at Dh 32, whose mma.sync instances compile all four tiles
    # (float32 at Dh 64 runs the wgmma instance's one)
    q, k, v = torch.randn(3, 2, 512, 2, 32, generator=gen, device=card)
    o1 = ops.flash_attention(q, k, v, config=tuning.KernelConfig(
        "flash_attention", (128, 64)))
    o2 = ops.flash_attention(q, k, v, config=tuning.KernelConfig(
        "flash_attention", (64, 32)))
    torch.testing.assert_close(o1, o2, rtol=1e-5, atol=1e-5)
    q, k, v = torch.randn(3, 2, 512, 2, 64, generator=gen, device=card)
    # 48 of the 64 columns, zero-padded back to 64 in a copy, on Dh 64's
    # instance
    o3 = ops.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    torch.testing.assert_close(
        o3, flash_attention.plain(q[..., :48], k[..., :48], v[..., :48],
                                  True), rtol=FLASH_TOL[torch.float32],
        atol=FLASH_TOL[torch.float32])
    wide = torch.randn(1, 512, 2, 264, generator=gen, device=card)
    with pytest.raises(ValueError, match="compiled"):
        ops.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="divisible"):
        ops.flash_attention(q[:, :192], k[:, :192], v[:, :192])


def test_default_config_gives_the_bits_of_today(card):
    """The three older kernels resolve to the tiles they always had:
    config=None and DEFAULTS passed explicitly give the same bits."""
    gen = torch.Generator(device=card).manual_seed(7)
    Pi = torch.randn(130, 517, generator=gen, device=card)
    A = torch.randn(517, 259, generator=gen, device=card)
    for a, b in zip(ops.sketch_fused(Pi, A), ops.sketch_fused(
            Pi, A, config=tuning.DEFAULTS["sketch_fused"])):
        assert torch.equal(a, b)
    X = torch.randn(777, 300, generator=gen, device=card)
    signs = torch.randint(0, 2, (777,), generator=gen, device=card) * 2.0 - 1
    assert torch.equal(ops.blocked_fwht(X, signs, d_pad=1024),
                       ops.blocked_fwht(X, signs, d_pad=1024,
                                        config=tuning.DEFAULTS["blocked_fwht"]))
    As = torch.randn(300, 64, generator=gen, device=card)
    na = torch.rand(300, generator=gen, device=card) + 0.5
    rows = torch.randint(0, 300, (5000,), generator=gen, device=card,
                         dtype=torch.int32)
    args = (As, As, na, na, rows, rows.flip(0))
    assert torch.equal(ops.sampled_rescaled_dot(*args),
                       ops.sampled_rescaled_dot(
                           *args, config=tuning.DEFAULTS["sampled_dot"]))


@pytest.mark.parametrize("kernel,shape", [
    ("sketch_fused", (128, 4096, 512)), ("blocked_fwht", (2048, 512)),
    ("sampled_dot", (1024, 1024, 128, 4096)),
    ("flash_attention", (8, 1024, 128))])
def test_tuner_measures_on_the_card(card, kernel, shape):
    us = tuning.measure_config(tuning.DEFAULTS[kernel], shape, reps=2)
    assert us > 0
    winner, records = tuning.autotune(kernel, shape, measure_top=2, reps=2)
    assert winner in tuning.candidate_configs(kernel, shape)
    assert all(r["us_per_call"] > 0 and r["achieved_gbps"] > 0
               for r in records)


# ---------------------------------------------------------------------------
# Streaming on the card: the chunk function (two sketch_fused launches)
# against its plain version, the kernel's squared norms, ingest's copy
# stream against the update loop, and checkpoints of card state
# ---------------------------------------------------------------------------

def test_sketch_fused_squared_norms_are_the_kernels_sums(card):
    """squared=True returns the kernel's own sums: their square roots are
    the default output bit for bit, and they agree with sqrt-free plain
    sums of squares."""
    gen = torch.Generator(device=card).manual_seed(5)
    Pi = torch.randn(64, 3001, generator=gen, device=card)
    A = torch.randn(3001, 515, generator=gen, device=card)
    before = ops.LAUNCHES["sketch_fused"]
    out2, norm2 = ops.sketch_fused(Pi, A, squared=True)
    out, norm = ops.sketch_fused(Pi, A)
    assert ops.LAUNCHES["sketch_fused"] == before + 2
    assert torch.equal(out, out2) and torch.equal(norm, norm2.sqrt())
    torch.testing.assert_close(norm2, (A ** 2).sum(dim=0), rtol=RTOL, atol=0)


@pytest.mark.parametrize("method", ["gaussian", "srht"])
@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("t", [1024, 848])
def test_chunk_contribution_on_the_card_matches_plain(card, method,
                                                      precision, t):
    """One chunk's (dA, dB, dna2, dnb2) on the card (two launches) against
    the plain products on the CPU, from the same key and ids."""
    from repro_torch.core import summary_engine
    rng = np.random.default_rng(t)
    A = torch.from_numpy(rng.standard_normal((t, 300)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((t, 200)).astype(np.float32))
    gids = torch.arange(4096, 4096 + t)

    def run(dev):
        key = prng.PRNGKey(3, device=dev)
        plan = None
        if method == "srht":
            plan = summary_engine.srht_plan(key, 6000, 128)[:2]
        return summary_engine.chunk_contribution(
            key, plan, A.to(dev), B.to(dev), gids.to(dev), k=128,
            method=method, precision=precision)

    ops.reset_launch_counts()
    got = run(card)
    assert ops.LAUNCHES["sketch_fused"] == 2
    for g, w in zip(got, run("cpu")):
        g = g.cpu()
        scale = w.abs().amax(dim=0) if w.ndim == 2 else w.abs()
        assert bool(((g - w).abs() <= RTOL * scale).all())


@pytest.mark.parametrize("method", ["gaussian", "srht"])
@pytest.mark.parametrize("chunk", [600, 768])
def test_stream_on_the_card_is_the_scan_backend_bit_for_bit(card, method,
                                                            chunk):
    """Chunks of c rows on the card == build_summary(scan, block=c) on the
    card, with probes and co-sketch. At 768 the last chunk is ragged (3000
    = 3 * 768 + 696): the sketches and norms stay bit-identical (the scan's
    zero rows add only zeros in the kernel's fixed 64-row stages), while
    the probe and co-sketch blocks, cuBLAS products whose algorithm may
    follow the chunk's length, are held to tolerance there."""
    from repro_torch.core import streaming, summary_engine
    A, B = _planted(1, d=3000, n=300)
    summ = streaming.StreamingSummarizer(256, method=method, probes=4,
                                         cosketch=3)
    ops.reset_launch_counts()
    state = summ.init(prng.PRNGKey(1), (3000, 300, 300))
    for off in range(0, 3000, chunk):
        state = summ.update(state, A[off:off + chunk], B[off:off + chunk],
                            off)
    n_chunks = -(-3000 // chunk)
    assert ops.LAUNCHES["sketch_fused"] == 2 * n_chunks
    got = summ.finalize(state)
    want = summary_engine.build_summary(
        prng.PRNGKey(1), A, B, 256, method=method, backend="scan",
        block=chunk, probes=4, cosketch=3)
    for name, x, y in zip(got._fields, got, want):
        if 3000 % chunk == 0 or name in ("A_sketch", "B_sketch", "norm_A",
                                         "norm_B"):
            assert torch.equal(x, y), name
        else:
            assert bool(((x - y).abs()
                         <= RTOL * y.abs().amax(dim=0)).all()), name
    on_cpu = streaming.StreamingSummarizer(256, method=method,
                                           device="cpu").summarize_chunks(
        prng.PRNGKey(1), (3000, 300, 300),
        ((A[off:off + chunk], B[off:off + chunk])
         for off in range(0, 3000, chunk)))
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        g, w = getattr(got, name).cpu(), getattr(on_cpu, name)
        assert bool(((g - w).abs() <= RTOL * w.abs().max()).all()), name


@pytest.mark.parametrize("prefetch", [0, 1, 2])
@pytest.mark.parametrize("source", ["numpy", "pageable", "pinned"])
def test_ingest_on_the_card_is_the_update_loop(card, prefetch, source):
    """ingest from host chunks through the pinned ring and the copy stream
    == the update loop over the same chunks on the card, bit for bit; the
    last chunk is ragged, and the ring is reused several times."""
    from repro_torch.core import streaming
    A, B = _planted(2, d=3000, n=300)
    summ = streaming.StreamingSummarizer(128, probes=4, cosketch=2)
    chunk = 256
    ref = summ.init(prng.PRNGKey(2), (3000, 300, 300))
    for off in range(0, 3000, chunk):
        ref = summ.update(ref, A[off:off + chunk].to(card),
                          B[off:off + chunk].to(card), off)

    def host(x):
        if source == "numpy":
            return x.numpy()
        return x.pin_memory() if source == "pinned" else x.clone()

    chunks = [(host(A[off:off + chunk]), host(B[off:off + chunk]))
              for off in range(0, 3000, chunk)]
    got = summ.ingest(summ.init(prng.PRNGKey(2), (3000, 300, 300)),
                      iter(chunks), prefetch=prefetch)
    for name, x, y in zip(got._fields, got, ref):
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name


def test_checkpoint_of_card_state_restores_on_the_cpu(card, tmp_path):
    """A card state saved mid-pass, restored into a CPU template and into
    a card template: equal to the card state's values, bit for bit, and
    resuming on the card is the uninterrupted pass."""
    from repro_torch.ckpt import checkpoint
    from repro_torch.core import streaming
    A, B = _planted(3, d=2000, n=200)
    on_card = streaming.StreamingSummarizer(128, method="srht", probes=4,
                                            decay=0.9)
    on_cpu = streaming.StreamingSummarizer(128, method="srht", probes=4,
                                           decay=0.9, device="cpu")
    half = on_card.advance(on_card.update(
        on_card.init(prng.PRNGKey(3), (2000, 200, 200)), A[:1000], B[:1000],
        0), 2)
    checkpoint.save_stream_state(str(tmp_path), 1, half)
    cpu = checkpoint.restore_stream_state(
        str(tmp_path), on_cpu.init(prng.PRNGKey(0), (2000, 200, 200)))
    card_back = checkpoint.restore_stream_state(
        str(tmp_path), on_card.init(prng.PRNGKey(0), (2000, 200, 200)))
    for name, x, y, z in zip(half._fields, half, cpu, card_back):
        if x is None:
            assert y is None and z is None, name
            continue
        assert y.device.type == "cpu" and z.device == x.device, name
        assert torch.equal(x.cpu(), y) and torch.equal(x, z), name
    resumed = on_card.update(card_back, A[1000:], B[1000:], 1000)
    direct = on_card.update(half, A[1000:], B[1000:], 1000)
    for x, y in zip(on_card.finalize(resumed), on_card.finalize(direct)):
        if x is not None:
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The pipeline cache and the serving loop on the card
# ---------------------------------------------------------------------------

# Two runs of one call on the card: WAltMin's index_add_ atomics add in no
# fixed order, float32 rounding that its T half-steps carry into U V^T:
# held to 1e-4 relative, a tenth of the card-against-CPU UVT_TOL.
RERUN_UVT_TOL = 1e-4

def test_warm_engine_builds_nothing_on_the_card(card):
    """A second identical call on the card is a cache hit with no build and
    launches the same kernels; its factors equal the first call's to
    float32 rounding (WAltMin's index_add_ atomics add in no fixed order),
    its summary bit for bit. A CPU call of the same plan builds its own
    entry."""
    from repro_torch.core import pipeline
    A, B = _planted(5, d=2000, n=200)
    A, B = A.to(card), B.to(card)
    eng = pipeline.PipelineEngine()
    plan = pipeline.smppca_plan(r=5, k=512, m=20_000, T=6, backend="cuda")
    ops.reset_launch_counts()
    cold = eng.run(plan, prng.PRNGKey(0), A, B)
    launches = dict(ops.LAUNCHES)
    warm = eng.run(plan, prng.PRNGKey(0), A, B)
    assert (eng.stats.traces, eng.stats.misses, eng.stats.hits) == (1, 1, 1)
    assert launches == {"sketch_fused": 2, "sampled_rescaled_dot": 1,
                        "blocked_fwht": 0, "flash_attention": 0}
    assert {k: 2 * v for k, v in launches.items()} == ops.LAUNCHES
    assert torch.equal(cold.summary.A_sketch, warm.summary.A_sketch)
    assert _uvt_rel(warm.estimate.factors, cold.estimate.factors) \
        < RERUN_UVT_TOL
    eng.run(plan, prng.PRNGKey(0), A.cpu(), B.cpu())
    assert (eng.stats.traces, len(eng)) == (2, 2)


@pytest.mark.parametrize("backend", ["scan", "cuda"])
def test_dispatcher_batch_equals_requests_alone_on_the_card(card, backend):
    """A bucket of four requests served as one batched call on the card:
    each request's summary equals the request served alone, bit for bit;
    its factors to float32 rounding (WAltMin's atomics), held to UVT_TOL:
    at m = 6,000 samples of a 128 x 128 product its solves amplify the
    atomics' rounding (1.1e-4 and 1.5e-4 relative measured on an H100)."""
    from repro_torch.core import pipeline
    from repro_torch.serve.scheduler import (
        LoopConfig, PipelineWork, ServingLoop)
    plan = pipeline.PipelinePlan(
        sketch=pipeline.SketchSpec(k=128, backend=backend, block=1024,
                                   probes=16),
        estimation=pipeline.EstimationSpec(m=6000, T=4),
        rank=pipeline.RankPolicy(r=5), key_layout="service", with_error=True)
    pairs = [tuple(x.to(card) for x in _planted(10 + i, d=4096, n=128))
             for i in range(4)]
    keys = [prng.fold_in(prng.PRNGKey(1), i) for i in range(4)]
    loop = ServingLoop(engine=pipeline.PipelineEngine(),
                       config=LoopConfig(pad="pow2"))
    fs = [loop.submit(k, A, B, work=PipelineWork(plan))
          for k, (A, B) in zip(keys, pairs)]
    assert loop.drain() == 1
    alone = pipeline.PipelineEngine()
    for f, k, (A, B) in zip(fs, keys, pairs):
        got = f.result(timeout=120)
        want = alone.run(plan, k, A, B)
        for name in ("A_sketch", "B_sketch", "norm_A", "norm_B", "probes"):
            assert torch.equal(getattr(got.summary, name),
                               getattr(want.summary, name)), name
        assert _uvt_rel(got.estimate.factors, want.estimate.factors) \
            < UVT_TOL


# ---------------------------------------------------------------------------
# spectral norms, the distributed pass, the training-side sketches
# ---------------------------------------------------------------------------

def test_spectral_norm_on_the_card_is_float32_accurate(card):
    """``linalg.spectral_norm`` (cuSOLVER's gesvd on the card) against
    float64 on the 200 x 200 matrix with a 1/i spectrum above: within 1e-6
    of the largest singular value."""
    from repro_torch.core.linalg import spectral_norm
    gen = torch.Generator().manual_seed(0)
    D = 1.0 / torch.arange(1, 201).float()
    M = (torch.randn(200, 200, generator=gen) * D) @ torch.randn(
        200, 200, generator=gen)
    s64 = torch.linalg.svdvals(M.double())[0]
    got = spectral_norm(M.to(card))
    assert got.ndim == 0 and got.is_cuda
    assert float((got.cpu().double() - s64).abs() / s64) < 1e-6


# One NCCL rank on the card: distributed_sketch_summary and
# distributed_smppca against the cuda backend and the card's own smppca
# steps; run in a child process so the test process makes no group.
_NCCL_CHILD = r"""
import sys
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from repro_torch import prng
from repro_torch.core import distributed, summary_engine
from repro_torch.core.smppca import smppca_from_summary
from repro_torch.kernels import ops
torch.backends.cuda.matmul.allow_tf32 = False
store = dist.FileStore(sys.argv[2], 1)
dist.init_process_group("nccl", store=store, rank=0, world_size=1)
rng = np.random.default_rng(0)
D = (1.0 / np.arange(1.0, 201.0)).astype(np.float32)
A = torch.from_numpy(rng.standard_normal((2000, 200)).astype(np.float32) * D)
B = A + 0.3 * torch.from_numpy(
    rng.standard_normal((2000, 200)).astype(np.float32) * D)
A, B = A.cuda(), B.cuda()
key = prng.PRNGKey(0)
for method in ("gaussian", "srht"):
    ops.reset_launch_counts()
    got = distributed.distributed_sketch_summary(
        dist.group.WORLD, key, A, B, 512, method=method)
    assert ops.LAUNCHES["sketch_fused"] == 2, ops.LAUNCHES
    want = summary_engine.build_summary(key, A, B, 512, method=method,
                                        backend="cuda")
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        g, w = getattr(got, name), getattr(want, name)
        scale = w.abs().amax(dim=0)
        assert bool(((g - w).abs() <= 1e-4 * scale).all()), (method, name)
ops.reset_launch_counts()
f = distributed.distributed_smppca(dist.group.WORLD, key, A, B, r=5, k=512,
                                   m=40_000, T=6)
assert ops.LAUNCHES == {"sketch_fused": 2, "sampled_rescaled_dot": 1,
                        "blocked_fwht": 0, "flash_attention": 0}, ops.LAUNCHES
k1, k2 = prng.split(key)
s = summary_engine.build_summary(k1, A, B, 512, backend="cuda")
ref = smppca_from_summary(k2, s, r=5, m=40_000, T=6).factors
g = (f.U @ f.V.T).cpu()
w = (ref.U @ ref.V.T).cpu()
assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) < 1e-3
dist.destroy_process_group()
print("NCCL_OK", flush=True)
"""


def test_distributed_at_world_size_one_on_the_card(card, tmp_path):
    """One NCCL rank: the distributed pass (two ``sketch_fused`` launches)
    within 1e-4 of each column's largest entry of the ``cuda`` backend's
    summary, and ``distributed_smppca`` (launches 2 and 1) against the
    card's own steps to UVT_TOL (WAltMin's atomics)."""
    import pathlib
    import subprocess
    import sys
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    proc = subprocess.run([sys.executable, "-c", _NCCL_CHILD, str(src),
                           str(tmp_path / "store")],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "NCCL_OK" in proc.stdout, \
        proc.stdout[-3000:] + proc.stderr[-3000:]


def test_identity_product_summary_on_the_card_matches_the_cpu(card):
    """One ``sketch_fused`` launch (Pi @ G and G's squared norms) against
    the CPU's plain products: per column within RTOL of its largest
    entry, norms RTOL relative."""
    from repro_torch.core.summary_engine import identity_product_summary
    G = torch.randn(512, 768, generator=torch.Generator().manual_seed(3))
    before = ops.LAUNCHES["sketch_fused"]
    got = identity_product_summary(prng.PRNGKey(1), G, 128, n_workers=3,
                                   device=card)
    assert ops.LAUNCHES["sketch_fused"] == before + 1
    want = identity_product_summary(prng.PRNGKey(1), G, 128, n_workers=3,
                                    device="cpu")
    assert torch.equal(got.norm_A.cpu(), want.norm_A)
    for name in ("A_sketch", "B_sketch"):     # normals: an ulp apart at most
        g, w = getattr(got, name).cpu(), getattr(want, name)
        assert bool(((g - w).abs() <= RTOL * w.abs().amax(dim=0)).all())
    torch.testing.assert_close(got.norm_B.cpu(), want.norm_B, rtol=RTOL,
                               atol=0)


def test_tap_pair_summary_on_the_card_matches_the_cpu(card):
    """Two ``sketch_fused`` launches on Pi^T against the CPU's plain
    products, and the tap layer's backward on the card: dW zero, dx the
    plain product's."""
    from repro_torch.core.summary_engine import tap_pair_summary
    from repro_torch.train import sketched_dense as sd
    gen = torch.Generator().manual_seed(4)
    X, Y = torch.randn(4096, 256, generator=gen), torch.randn(
        4096, 320, generator=gen)
    before = ops.LAUNCHES["sketch_fused"]
    got = tap_pair_summary(prng.PRNGKey(2), X.to(card), Y.to(card), 64)
    assert ops.LAUNCHES["sketch_fused"] == before + 2
    want = tap_pair_summary(prng.PRNGKey(2), X, Y, 64)
    for g, w in zip(got[:2], want[:2]):
        scale = w.abs().amax(dim=0)
        assert bool(((g.cpu() - w).abs() <= RTOL * scale).all())
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g.cpu(), w, rtol=RTOL, atol=0)
    w = (torch.randn(256, 320, generator=gen) * 0.05).to(card)
    x = X.reshape(8, 512, 256).to(card).requires_grad_()
    w.requires_grad_()
    taps = {f: v.requires_grad_()
            for f, v in sd.tap_init(256, 320, 64, device=card).items()}
    torch.mean(sd.sketched_dense(w, taps, x, prng.PRNGKey(2), 64) ** 2
               ).backward()
    assert bool((w.grad == 0).all())
    x2 = x.detach().clone().requires_grad_()
    torch.mean((x2 @ w.detach()) ** 2).backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the LM stack on the card
# ---------------------------------------------------------------------------

def _lm(name, device, cd="float32", **overrides):
    """A reduced arch at its own head width, 16 (the flash kernel takes
    it), unless ``overrides`` say otherwise, its parameters from
    PRNGKey(0) drawn on the CPU and moved to ``device``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config(name).reduced(),
                              **dict(dict(compute_dtype=cd), **overrides))
    params = build(cfg, device="cpu").init_params(prng.PRNGKey(0))
    return build(cfg, device=device), params.to(device)


def _lm_batch(cfg, device, B=2, S=100):
    gen = torch.Generator().manual_seed(S)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen)}
    for name, L in (("enc_frames", cfg.enc_context),
                    ("img_embeds", cfg.n_img_tokens)):
        if L:
            batch[name] = (0.1 * torch.randn(B, L, cfg.d_model, generator=gen)
                           ).bfloat16()
    return {k: v.to(device) for k, v in batch.items()}


# float32 compute: the card's float32 GEMMs (TF32 off) and the kernel's
# three split TF32 passes against the CPU, sums in another order: 1e-4 at
# logits of scale 4. bf16 compute: the port's bf16 tolerance against JAX
# (tests/test_torch_models.py), 0.05.
LM_TOL = {"float32": 1e-4, "bfloat16": 0.05}
RECURRENT_TOL = 5e-3


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lm_on_the_card_matches_the_cpu(card, cd):
    """Reduced granite-3-8b at its head width 16: the full forward, the
    prefill and 4 decode steps on the card against the CPU on the same
    weights; a prefill of S = 100 (padded to the tile) launches the
    kernel once a layer."""
    from repro_torch.models import attention as attn
    m_gpu, p_gpu = _lm("granite-3-8b", card, cd)
    m_cpu, p_cpu = _lm("granite-3-8b", "cpu", cd)
    b_gpu = _lm_batch(m_gpu.cfg, card)
    b_cpu = {k: v.cpu() for k, v in b_gpu.items()}
    layers = m_gpu.cfg.n_layers
    with torch.inference_mode():
        before = ops.LAUNCHES["flash_attention"]
        attn.reset_route_counts()
        full = m_gpu.forward(p_gpu, b_gpu)
        assert ops.LAUNCHES["flash_attention"] == before + layers
        assert attn.ROUTES == {"flash": layers, "plain": 0}
        want = m_cpu.forward(p_cpu, b_cpu)
        torch.testing.assert_close(full.cpu(), want, rtol=0, atol=LM_TOL[cd])
        P = 96
        outs = []
        for m, p, b in ((m_gpu, p_gpu, b_gpu), (m_cpu, p_cpu, b_cpu)):
            caches = m.init_cache(2, 100)
            lg, caches = m.prefill(p, dict(b, tokens=b["tokens"][:, :P]),
                                   caches)
            steps = [lg[:, 0].cpu()]
            for t in range(P, 100):
                lg, caches = m.decode_step(p, caches,
                                           b["tokens"][:, t:t + 1], t)
                steps.append(lg[:, 0].cpu())
            outs.append(torch.stack(steps))
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=LM_TOL[cd])


#: the reduced configs' head layout where the route test needs the full
#: arch's: starcoder2-15b's GQA 12:1, phi3-mini-3.8b's head width 96 (on
#: the kernel since it compiles Dh 96), and mistral-large-123b at Dh 32 (a
#: compiled width no reduced config has); the others run at the reduced
#: width, 16
ROUTE_OVERRIDES = {"starcoder2-15b": dict(n_heads=12, n_kv_heads=1),
                   "phi3-mini-3.8b": dict(head_dim=96),
                   "mistral-large-123b": dict(head_dim=32)}


@pytest.mark.parametrize("name,flash,plain", [
    ("granite-3-8b", 2, 0),          # causal self-attention
    ("whisper-small", 2, 4),         # decoder flash; enc x2, cross x2 plain
    ("llama-3.2-vision-11b", 8, 2),  # (attn x4, xattn) x 2
    ("starcoder2-15b", 2, 0),        # GQA 12:1 on the kernel
    ("phi3-mini-3.8b", 2, 0),        # Dh 96 on the kernel
    ("mistral-large-123b", 2, 0),    # Dh 32 on the kernel
    ("kimi-k2-1t-a32b", 3, 0),       # the reduced width 16, no override
])
def test_attention_routes_on_the_card(card, name, flash, plain):
    from repro_torch.models import attention as attn
    m, p = _lm(name, card, **ROUTE_OVERRIDES.get(name, {}))
    assert m.cfg.head_dim == ROUTE_OVERRIDES.get(name, {}).get("head_dim", 16)
    attn.reset_route_counts()
    before = ops.LAUNCHES["flash_attention"]
    with torch.inference_mode():
        m.forward(p, _lm_batch(m.cfg, card, S=64))
    assert attn.ROUTES == {"flash": flash, "plain": plain}
    assert ops.LAUNCHES["flash_attention"] == before + flash


def test_windowed_attention_takes_the_plain_route_on_the_card(card):
    from repro_torch.models import attention as attn
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v = attention_qkv(gen, card, S=256, H=4, Hkv=2, Dh=64)
    attn.reset_route_counts()
    before = ops.LAUNCHES["flash_attention"]
    got = attn.attention(q, k, v, causal=True, window=64)
    assert attn.ROUTES == {"flash": 0, "plain": 1}
    assert ops.LAUNCHES["flash_attention"] == before
    want = attn.dense_attention(q.cpu(), k.cpu(), v.cpu(), causal=True,
                                window=64)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def attention_qkv(gen, device, S, H, Hkv, Dh, B=2):
    return (torch.randn(B, S, H, Dh, generator=gen, device=device),
            torch.randn(B, S, Hkv, Dh, generator=gen, device=device),
            torch.randn(B, S, Hkv, Dh, generator=gen, device=device))


@pytest.mark.parametrize("layout", [(32, 8, 128), (16, 1, 256), (4, 4, 16)])
@pytest.mark.parametrize("S", [1000, 100, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_flash_route_matches_plain(card, S, dtype, layout):
    """S right-padded with zeros to the tile, one launch, sliced back:
    the plain version on the unpadded sequence within FLASH_TOL. Heads,
    KV heads and width of granite-3-8b, recurrentgemma-9b (whose tile is
    (64, 32)) and the reduced configs."""
    from repro_torch.models import attention as attn
    gen = torch.Generator(device=card).manual_seed(S)
    q, k, v = (t.to(dtype) for t in attention_qkv(gen, card, S, *layout))
    before = ops.LAUNCHES["flash_attention"]
    got = attn.flash_prefill(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert tuple(got.shape) == tuple(q.shape) and got.dtype == dtype
    want = flash_attention.plain(q, k, v, True)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_engine_on_the_card_matches_the_cpu(card):
    """Greedy tokens of reduced granite (head width 16, float32 compute)
    on the card equal the CPU's."""
    from repro_torch.serve.engine import Engine, ServeConfig
    outs = []
    for dev in (card, "cpu"):
        m, p = _lm("granite-3-8b", dev)
        batch = _lm_batch(m.cfg, dev, S=40)
        outs.append(Engine(m, p, ServeConfig(max_new_tokens=8)).generate(
            batch).cpu())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("name,flash,plain", [
    ("moonshot-v1-16b-a3b", 3, 0),   # attn_dense_first + attn_moe x 2
    ("recurrentgemma-9b", 0, 2),     # (rglru, rglru, local_attn) x 2
    ("xlstm-350m", 0, 0),            # (mlstm, slstm) x 2: no attention
])
def test_moe_and_recurrent_lm_on_the_card_match_the_cpu(card, name, flash,
                                                        plain):
    """Reduced MoE, hybrid and recurrent archs (head width 16, float32
    compute): the forward's routes and flash launches, two forwards on the
    card equal bit for bit (the MoE's fixed-order combine, no atomics), and
    the forward, a prefill and 4 decode steps against the CPU. The RG-LRU
    and xLSTM blocks take some products in bf16 whatever the compute dtype
    (the gates, as the reference does), where float32 noise between the
    devices tips a bf16 rounding now and then: those two are held to
    RECURRENT_TOL (measured 7e-4 and 3e-4 at logits of scale 4)."""
    tol = LM_TOL["float32"] if name.startswith("moonshot") else RECURRENT_TOL
    from repro_torch.models import attention as attn
    m_gpu, p_gpu = _lm(name, card)
    m_cpu, p_cpu = _lm(name, "cpu")
    b_gpu = _lm_batch(m_gpu.cfg, card, S=64)
    b_cpu = {k: v.cpu() for k, v in b_gpu.items()}
    with torch.inference_mode():
        before = ops.LAUNCHES["flash_attention"]
        attn.reset_route_counts()
        full = m_gpu.forward(p_gpu, b_gpu)
        assert attn.ROUTES == {"flash": flash, "plain": plain}
        assert ops.LAUNCHES["flash_attention"] == before + flash
        assert torch.equal(full, m_gpu.forward(p_gpu, b_gpu))
        want = m_cpu.forward(p_cpu, b_cpu)
        torch.testing.assert_close(full.cpu(), want, rtol=0, atol=tol)
        P = 60
        outs = []
        for m, p, b in ((m_gpu, p_gpu, b_gpu), (m_cpu, p_cpu, b_cpu)):
            caches = m.init_cache(2, 64)
            lg, caches = m.prefill(p, dict(b, tokens=b["tokens"][:, :P]),
                                   caches)
            steps = [lg[:, 0].cpu()]
            for t in range(P, 64):
                lg, caches = m.decode_step(p, caches,
                                           b["tokens"][:, t:t + 1], t)
                steps.append(lg[:, 0].cpu())
            outs.append(torch.stack(steps))
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=tol)


def test_moe_layer_on_the_card_matches_the_cpu(card):
    """One MoE layer at moonshot's expert width (64 experts of d_ff 1,408,
    top 6, 2 shared, d 2,048) in bf16 parameters and compute: the batched
    bf16 products with float32 outputs on the card against the CPU's
    upcast operands, and two runs equal bit for bit. The float32 sums run
    in another order, so a hidden activation near a bf16 rounding edge
    rounds the other way now and then: within 2 bf16 ulps of the value
    plus half an ulp of the largest output (test_torch_models.py's bf16
    criterion)."""
    from repro_torch.models import moe
    p = moe.MoE(2048, 1408, 64, n_shared=2, dtype=torch.bfloat16,
                device="cpu").requires_grad_(False)
    p.reset(prng.PRNGKey(5))
    x = torch.randn(2, 96, 2048, generator=torch.Generator().manual_seed(5))
    kw = dict(top_k=6, act="silu", compute_dtype=torch.bfloat16)
    want, aux_cpu = moe.moe_apply(p, x, **kw)
    p_gpu = p.to(card)
    got, aux = moe.moe_apply(p_gpu, x.to(card), **kw)
    again, _ = moe.moe_apply(p_gpu, x.to(card), **kw)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.cpu(), want, rtol=2.0 ** -6,
                               atol=2.0 ** -8 * float(want.abs().max()))
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=1e-5, atol=1e-6)


# Training on the card against the CPU, float32 compute: float32 sums in
# other orders (TF32 off), 1e-4 of each gradient leaf's largest entry, as
# chip_smoke.py's phase 20 (c) holds a whole train step.
TRAIN_GRAD_RTOL = 1e-4


def _grads(model, params, batch):
    loss = model.loss(params, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.cpu() for n, p in
                                  params.named_parameters()}


def test_training_attention_on_the_card_matches_the_cpu(card):
    """Granite reduced at its head width 16, which the flash kernel takes:
    inference on the card takes the flash route, ``loss.backward()`` the
    plain one, and every gradient (the attention projections' included)
    equals the CPU's. Before the route took the grad flag, the kernel's
    output had no grad_fn and wq, wk and wv got no gradient on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config("granite-3-8b").reduced(),
                              compute_dtype="float32")
    params = build(cfg, device="cpu").init_params(prng.PRNGKey(0))
    batch = _lm_batch(cfg, "cpu", S=64)
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    m_gpu, p_gpu = build(cfg, device=card), copy_module(params, card)
    b_gpu = {k: v.to(card) for k, v in batch.items()}
    attn.reset_route_counts()
    with torch.no_grad():
        m_gpu.forward(p_gpu, b_gpu)
    assert attn.ROUTES == {"flash": cfg.n_layers, "plain": 0}
    attn.reset_route_counts()
    before = ops.LAUNCHES["flash_attention"]
    loss_gpu, g_gpu = _grads(m_gpu, p_gpu, b_gpu)
    assert attn.ROUTES == {"flash": 0, "plain": cfg.n_layers}
    assert ops.LAUNCHES["flash_attention"] == before
    loss_cpu, g_cpu = _grads(build(cfg, device="cpu"), params, batch)
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for n, g in g_cpu.items():
        assert bool(g_gpu[n].any()) == bool(g.any()), n
        torch.testing.assert_close(
            g_gpu[n], g, rtol=0,
            atol=TRAIN_GRAD_RTOL * float(g.abs().max().clamp(min=1e-30)),
            msg=n)
    assert bool(g_gpu["groups.0.0.0.attn.wq.w"].any())


def copy_module(module, device):
    """A copy of ``module`` on ``device`` (the original stays put)."""
    import copy
    return copy.deepcopy(module).to(device)


def test_flash_attention_under_grad_raises_on_the_card(card):
    q = torch.randn(1, 128, 2, 64, device=card, requires_grad=True)
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, q, q)
    assert ops.LAUNCHES["flash_attention"] == before
    with torch.no_grad():
        ops.flash_attention(q, q, q)
    assert ops.LAUNCHES["flash_attention"] == before + 1


def test_bf16_training_on_the_card_reaches_every_parameter(card):
    """bf16 compute: the card's bf16 GEMMs with float32 outputs get their
    backward from ``common._F32Out`` (torch's ``mm(..., out_dtype=)`` has
    none). Every parameter gets a finite nonzero gradient, within a bf16
    rounding of the cotangent (2**-6 of each leaf's largest entry) of the
    CPU's, which upcasts the bf16 operands."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(),
                              compute_dtype="bfloat16")
    params = build(cfg, device="cpu").init_params(prng.PRNGKey(0))
    batch = _lm_batch(cfg, "cpu", S=64)
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    _, g_gpu = _grads(build(cfg, device=card), copy_module(params, card),
                      {k: v.to(card) for k, v in batch.items()})
    _, g_cpu = _grads(build(cfg, device="cpu"), params, batch)
    for n, g in g_cpu.items():
        assert bool(torch.isfinite(g_gpu[n]).all()) and bool(g_gpu[n].any()), n
        torch.testing.assert_close(
            g_gpu[n], g, rtol=0,
            atol=2.0 ** -6 * float(g.abs().max().clamp(min=1e-30)), msg=n)
