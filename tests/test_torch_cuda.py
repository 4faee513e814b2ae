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
from repro_torch.kernels import flash_attention, hadamard, ops, tuning

pytestmark = pytest.mark.cuda

# float32 sums over d in another order (sketch_fused: three split TF32
# passes on the tensor cores, float32 class): sketch entries within 1e-5 of
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
    (64, 1001, 203),    # d and n odd: element copies, bf16 rows 2-byte aligned
    (96, 1002, 206),    # d and n even, not multiples of 4 or 8
    (200, 100, 256),    # 16-byte copies; d not a multiple of BK; k of BM
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
    starts one element past a 16-byte boundary: element copies."""
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


@pytest.mark.parametrize("dh", flash_attention.HEAD_DIMS)
@pytest.mark.parametrize("bq,bk", tuning.TILE_MENUS["flash_attention"])
def test_flash_kernel_matches_plain(card, bq, bk, dh):
    """Every compiled tile and head width, causal and not, float32 and
    bf16, with GQA (4 query heads on 2 KV heads) and q, k and v read in
    place from one packed (B, S, H + 2 Hkv, Dh) tensor."""
    gen = torch.Generator(device=card).manual_seed(bq + bk + dh)
    B, S, H, Hkv = 2, 256, 4, 2
    packed = torch.randn(B, S, H + 2 * Hkv, dh, generator=gen, device=card)
    cfg = tuning.KernelConfig("flash_attention", (bq, bk))
    for dtype in (torch.float32, torch.bfloat16):
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


def test_flash_block_shape_independence(card):
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v = torch.randn(3, 2, 512, 2, 64, generator=gen, device=card)
    o1 = ops.flash_attention(q, k, v, config=tuning.KernelConfig(
        "flash_attention", (128, 64)))
    o2 = ops.flash_attention(q, k, v, config=tuning.KernelConfig(
        "flash_attention", (64, 32)))
    torch.testing.assert_close(o1, o2, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="compiled"):
        ops.flash_attention(q[..., :48], k[..., :48], v[..., :48])
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
