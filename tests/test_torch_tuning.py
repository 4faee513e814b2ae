"""The port's kernel tuner: twins of tests/kernels/test_tuning.py for the
Hopper tile menus, the tuning table shared with the JAX package, and the
config resolution of the ``ops`` wrappers against the JAX wrappers'.

Inputs are made with numpy from a seed and handed to both packages; the
JAX kernels run in interpret mode, as the JAX suite runs them on the CPU.
"""
import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import tuning as jax_tuning
from repro_torch.kernels import (flash_attention, hadamard, ops, sampled_dot,
                                  sketch_fused)
from repro_torch.kernels import tuning
from repro_torch.kernels.tuning import (
    DEFAULTS, KernelConfig, TuningSpec, TuningTable, candidate_configs,
    rank_candidates, smem_bytes, table_key, validate_config)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "kernels" / "csrc"

# benchmarks/run.py::kernel_sweep's shapes, and granite-3-8b's attention at
# prefill_32k as the flash kernel's full width.
SHAPES = {"sketch_fused": (128, 4096, 512), "blocked_fwht": (2048, 512),
          "sampled_dot": (1024, 1024, 128, 4096),
          "flash_attention": (32, 32768, 128)}
TINY = {"sketch_fused": (8, 64, 32), "blocked_fwht": (64, 16),
        "sampled_dot": (16, 16, 8, 40), "flash_attention": (2, 128, 32)}
# a width of the mma.sync instances' four-tile menu in float32 (float32 at
# Dh 128 runs the wgmma instance, one tile)
FLASH = (8, 1024, 112)


def _sk(**kw):
    return KernelConfig("sketch_fused", sketch_fused.TILE, **kw)


@pytest.fixture()
def empty_tables(monkeypatch):
    """Both packages' table caches, emptied for the test."""
    monkeypatch.setattr(tuning, "_TABLE_CACHE", {})
    monkeypatch.setattr(jax_tuning, "_TABLE_CACHE", {})


def test_validate_config_rejects_bad_configs():
    with pytest.raises(ValueError, match="unknown kernel"):
        validate_config(KernelConfig("nope", (128, 128)))
    with pytest.raises(ValueError, match="block"):
        validate_config(KernelConfig("sketch_fused", (128,)))
    with pytest.raises(ValueError, match="not compiled"):
        validate_config(KernelConfig("sketch_fused", (256, 512)))
    with pytest.raises(ValueError, match="not compiled"):
        validate_config(KernelConfig("blocked_fwht", (128, 256)))
    with pytest.raises(ValueError, match="not compiled"):
        validate_config(KernelConfig("flash_attention", (256, 64)))
    with pytest.raises(ValueError, match="positive"):
        validate_config(KernelConfig("flash_attention", (64, -64)))
    with pytest.raises(ValueError, match="grid_order"):
        validate_config(_sk(grid_order="p_inner"))
    with pytest.raises(ValueError, match="precision"):
        validate_config(_sk(precision="f64"))
    with pytest.raises(TypeError):
        validate_config(("sketch_fused", (128, 16)))
    for cfg in DEFAULTS.values():
        validate_config(cfg)
    validate_config(_sk(grid_order="d_inner", precision="bf16"))


def test_tuning_spec_rejects_duplicate_kernels():
    fl = KernelConfig("flash_attention", (64, 32))
    with pytest.raises(ValueError, match="more than once"):
        TuningSpec((fl, KernelConfig("flash_attention", (64, 64)))).validate()
    ts = TuningSpec((_sk(), fl))
    ts.validate()
    assert ts.config_for("flash_attention") == fl
    assert ts.config_for("sampled_dot") is None


def test_menus_are_the_tiles_the_sources_compile():
    """DEFAULTS and the menus name exactly the tiles the CUDA sources
    compile, read from the sources themselves."""
    def const(src, name):
        text = (CSRC / src).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    # sketch_fused: its float32 instance's (BN, F32_BK); the bf16 instance's
    # stages are BF16_TILE's
    assert tuning.TILE_MENUS["sketch_fused"] == (
        (const("sketch_fused.cu", "BN"), const("sketch_fused.cu", "F32_BK")),)
    assert sketch_fused.BF16_TILE == (const("sketch_fused.cu", "BN"),
                                      const("sketch_fused.cu", "BK"))
    assert tuning.TILE_MENUS["blocked_fwht"] == (
        (1 << const("blocked_fwht.cu", "MAX_LOG_RADIX"),
         const("blocked_fwht.cu", "COLS")),)
    flash_src = (CSRC / "flash_attention.cu").read_text()

    def cases(fn):
        body = re.search(rf"int {fn}\(.*?\n}}\n", flash_src, re.S)[0]
        return tuple(int(c) for c in re.findall(r"case (\d+):", body))

    assert cases("run") == flash_attention.BLOCK_Q
    assert cases("launch_bk") == flash_attention.BLOCK_K
    assert cases("launch_dh") == flash_attention.HEAD_DIMS
    # a compiled width runs on its own instance, unpadded
    assert [flash_attention.tile_width(w) for w in flash_attention.HEAD_DIMS] \
        == list(flash_attention.HEAD_DIMS)
    assert flash_attention.MAX_HEAD_DIM == flash_attention.HEAD_DIMS[-1]
    # the Dh 256 menu, and the width above which it applies
    wide = tuple(int(re.search(rf"{n} = (\d+)", flash_src)[1])
                 for n in ("WIDE_BQ", "WIDE_BK"))
    assert flash_attention.WIDE_TILES == (wide,)
    assert "return DH <= 128 || (BQ == WIDE_BQ && BK == WIDE_BK);" in \
        flash_src
    assert "SPLIT = DH > 128 ? 2 : 1;" in flash_src
    assert flash_attention.SPLIT_ABOVE == 128
    mma_tiles = tuple((bq, bk) for bq in flash_attention.BLOCK_Q
                      for bk in flash_attention.BLOCK_K)
    assert tuning.TILE_MENUS["flash_attention"][:4] == mma_tiles
    for dh in flash_attention.HEAD_DIMS:
        want = mma_tiles if dh <= 128 else flash_attention.WIDE_TILES
        for size in (4, 2):
            assert flash_attention.tiles(dh, size) == (
                ((128, flash_attention.WGMMA_FORMS[size, dh].bk),)
                if dh in (64, 96, 128) else want)
            assert set(flash_attention.tiles(dh, size)) <= \
                set(tuning.TILE_MENUS["flash_attention"])
    # the wgmma instances: float32 and bf16 at Dh 64, 96 and 128, their one
    # tile, each width's form as the source's WForm and BForm, the entries'
    # switches, and no mma.sync instance of those widths
    assert "constexpr int W_BQ = 128, W_BK = 32;" in flash_src
    assert flash_attention.WGMMA_DH == (64, 96, 128)
    assert flash_attention.WGMMA_BQ == 128
    widths = re.search(r"bool wgmma_width\(int DH\) \{\s*return ([^;]*);",
                       flash_src)[1]
    assert tuple(int(w) for w in re.findall(r"DH == (\d+)", widths)) == \
        flash_attention.WGMMA_DH
    for (size, dh), form in flash_attention.WGMMA_FORMS.items():
        if size == 4:
            assert form.bk == 32 and form.swizzle == 128
            assert f"struct WForm<{dh}> {{ static constexpr int STAGES = " \
                f"{form.stages}, SETS = {form.sets}; }};" in flash_src, dh
        else:
            assert form.sets == 0
            assert f"struct BForm<{dh}> {{ static constexpr int BK = " \
                f"{form.bk}, STAGES = {form.stages}, SWIZZLE = " \
                f"{form.swizzle}; }};" in flash_src, dh
    assert cases("flash_attention_f32_wgmma") == \
        cases("flash_attention_bf16_wgmma") == \
        cases("flash_attention_vt") == flash_attention.WGMMA_DH
    assert "if constexpr (compiled(BQ, BK, DH) && !wgmma_width(DH))" in \
        flash_src
    assert DEFAULTS["sketch_fused"].block == (128, 32)
    assert DEFAULTS["blocked_fwht"].block == (256, 32)
    assert DEFAULTS["sampled_dot"].block == ()
    assert DEFAULTS["flash_attention"].block in \
        tuning.TILE_MENUS["flash_attention"]


def test_sketch_fused_constants_are_the_sources():
    """The block, thread count, stages, CTAs per SM and shared memory the
    tuner models for sketch_fused are the ones its CUDA source compiles."""
    text = (CSRC / "sketch_fused.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert sketch_fused.BM == const("BM")
    # the float32 instance: TMA and wgmma, two consumer warpgroups and a
    # producer warp, a ring of Pi's tile, its small part's and A's tile
    assert sketch_fused.STAGES == const("F32_STAGES")
    assert "constexpr int F32_THREADS = 32 * (F32_CONSUMER_WARPS + 1);" \
        in text
    assert sketch_fused.THREADS == 32 * (const("F32_CONSUMER_WARPS") + 1)
    assert ("__launch_bounds__(F32_THREADS, 1)" in text
            and sketch_fused.CTAS_PER_SM == 1)
    assert sketch_fused.F32_CLUSTER == (const("F32_CLUSTER_MAX"),
                                        const("F32_CLUSTER_N"))
    assert sketch_fused.BF16_CLUSTER == (const("BF16_CLUSTER_MAX"), 1)
    assert ("constexpr int F32_SMEM = 1024 + F32_STAGES * F32_STAGE_BYTES +\n"
            "                         F32_SUM_BYTES + 2 * 8 * F32_STAGES;") \
        in text
    assert "constexpr int F32_SUM_BYTES = BM * BN * 2;" in text
    assert ("constexpr int F32_STAGE_BYTES = 2 * F32_PI_BYTES + F32_A_BYTES;"
            in text)
    bn, bk = sketch_fused.TILE
    assert sketch_fused.smem_bytes(4) == 1024 + const("F32_STAGES") * 4 * (
        2 * const("BM") * bk + bk * bn) + 2 * const("BM") * bn + 16 * const(
            "F32_STAGES") == 230_464
    assert tuning.smem_bytes(_sk(), SHAPES["sketch_fused"]) == \
        sketch_fused.SMEM_BYTES <= tuning.SMEM_BUDGET_BYTES
    assert [sketch_fused.cluster_shape(k, n, 2) for k, n in (
        (1, 1), (130, 5000), (512, 100_000), (1024, 1))] == \
        [(1, 1), (2, 1), (4, 1), (4, 1)]
    assert [sketch_fused.cluster_shape(k, n) for k, n in (
        (1, 1), (512, 128), (512, 129), (512, 100_000))] == \
        [(1, 1), (1, 1), (1, 2), (1, 2)]
    # no mma.sync instance left
    assert "mma.sync" not in text.split("namespace {", 1)[1]
    # the bf16 instance's own layout: TMA tiles without padding, a
    # 1,024-byte aligned ring, two barriers a stage
    assert sketch_fused.BF16_STAGES == const("BF16_STAGES")
    assert sketch_fused.BF16_THREADS == 32 * (const("BF16_CONSUMER_WARPS")
                                              + 4)
    assert ("constexpr int BF16_SMEM = 1024 + BF16_STAGES * STAGE_BYTES +\n"
            "                          2 * 8 * BF16_STAGES;") in text
    assert "constexpr int STAGE_BYTES = PI_TILE_BYTES + A_TILE_BYTES;" in text
    bn, bk = sketch_fused.BF16_TILE
    assert sketch_fused.smem_bytes(2) == 1024 + const("BF16_STAGES") * 2 * (
        const("BM") * bk + bk * bn) + 16 * const("BF16_STAGES")
    assert tuning.smem_bytes(_sk(precision="bf16"), SHAPES["sketch_fused"]) \
        == sketch_fused.smem_bytes(2) <= tuning.SMEM_BUDGET_BYTES


@pytest.mark.parametrize("kernel", ["sampled_dot", "blocked_fwht"])
def test_bucketing_and_block_mode_constants_are_the_sources(kernel):
    """What the wrappers size scratch by, and the tuner models, is what the
    CUDA sources compile: sampled_dot's gather CTA, scan and radix tiles;
    blocked_fwht's largest radix and its block-mode entry points."""
    if kernel == "sampled_dot":
        text = (CSRC / "sampled_dot.cu").read_text()
    else:
        text = (CSRC / "blocked_fwht.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    if kernel == "sampled_dot":
        assert sampled_dot.SAMPLES_PER_CTA == const("WARPS") * const("SEG")
        assert sampled_dot.GATHER_THREADS == 32 * const("WARPS")
        assert sampled_dot.SCAN_TILE == \
            const("SCAN_THREADS") * const("SCAN_ITEMS")
        assert sampled_dot.BINS == 1 << const("RADIX_BITS")
        assert "constexpr int SORT_THREADS = BINS;" in text
        assert sampled_dot.SORT_TILE == sampled_dot.BINS * const("SORT_ITEMS")
    else:
        assert hadamard.MAX_LOG_RADIX == const("MAX_LOG_RADIX")
        for entry in hadamard._BLOCK_ENTRY.values():
            assert f'extern "C" int {entry}(' in text


def test_cluster_form_constants_are_the_sources():
    """What ``hadamard.block_plan`` sizes the cluster form by is what
    csrc/blocked_fwht.cu compiles and lays out."""
    text = (CSRC / "blocked_fwht.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert hadamard.TILE == (1 << const("MAX_LOG_RADIX"), const("COLS"))
    assert hadamard.CLUSTER_COLS == const("CLUSTER_COLS")
    assert hadamard.CLUSTER_CTAS == const("CLUSTER_CTAS")
    assert hadamard.CLUSTER_THREADS == const("CLUSTER_THREADS")
    assert hadamard.CLUSTER_STAGES == const("CLUSTER_STAGES")
    assert hadamard.CLUSTER_LOG_RUN == const("CLUSTER_LOG_RUN")
    assert hadamard.SMEM_MAX == const("SMEM_MAX")
    for line in (
            "static constexpr int R1 = cmin(Radix<LOG_L1>::R, "
            "1 << CLUSTER_LOG_RUN);",
            "static constexpr int W1 = T1 * C / 32;",
            "static constexpr int AREA = S * TILE_BYTES;",
            "16 * S + 8 * C + 8 * W1 * C + 4 * (3 * LO + 2);",
            "return AREA + (size_t)e_live * Z_ROW + SMALL + 4 * (size_t)k;",
            "static constexpr int Z_ROW = LO * C * 4;",
            "static constexpr int LO = L1 / N;",
            "if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;"):
        assert line in text, line
    # the entry points take the form, and the occupancy query the shape
    for entry in hadamard._BLOCK_ENTRY.values():
        assert re.search(rf'extern "C" int {entry}\([^)]*int64_t cluster,',
                         text)
    assert 'extern "C" int srht_cluster_slots(int64_t d_valid' in text


@pytest.mark.parametrize("precision,size", [(None, 4), ("bf16", 2)])
def test_roofline_cost_charges_the_cluster_form_one_read_of_x(precision,
                                                              size):
    """The SRHT block mode's cost at the call shape: the cluster form
    reads X once and writes the k rows and the norms, at one CTA an SM;
    past its capacity the two-pass form also moves its intermediate."""
    cfg = KernelConfig("blocked_fwht", hadamard.TILE, precision=precision)
    d, n, k = 50_000, 8_192, 512
    cost = tuning.roofline_cost(cfg, (65_536, n), srht=(d, k))
    assert cost.hbm_bytes == size * d * n + 4 * d + 4 * (k + 1) * n
    assert cost.ctas == 8 * (n // 8) and cost.slots == tuning.SMS
    big = 60_000
    two = tuning.roofline_cost(cfg, (65_536, n), srht=(big, k))
    assert hadamard.block_plan(big, 65_536, torch.float32 if size == 4
                               else torch.bfloat16, k).form == "two_pass"
    assert two.hbm_bytes == (size * big * n + 4 * big + 4 * (k + 1) * n
                             + 8 * big * n)
    # without srht: the full mode the tuner measures, as before
    full = tuning.roofline_cost(cfg, (65_536, n))
    assert full.hbm_bytes == (65_536 * n * size + 4 * 65_536 * n
                              + 8 * 65_536 * n + 4 * 65_536)


def test_flash_attention_constants_are_the_sources():
    """The stages, passes and shared-memory layout the tuner models for
    flash_attention are the ones its CUDA source compiles."""
    text = (CSRC / "flash_attention.cu").read_text()
    assert f"constexpr int STAGES = {flash_attention.STAGES};" in text
    assert "std::is_same<T, float>::value ? 3 : 2;" in text
    assert flash_attention.PASSES == {
        ("mma.sync", 4): (3, 3, "tf32"), ("mma.sync", 2): (2, 2, "tf32"),
        ("wgmma", 4): (3, 3, "tf32"), ("wgmma", 2): (1, 2, "bf16")}
    for line in ("LDQ = DH + 8;", "LDK = DH + 8;",
                 "LDV = DH + 16 / (int)sizeof(T);",
                 "BQ * LDQ * (int)sizeof(float) + STAGES * STAGE_ELEMS",
                 "STAGE_ELEMS = BK * (LDK + LDV);",
                 "THREADS = 32 * WARPS;", "WARPS = BQ / 16 * SPLIT;",
                 "XCH_FLOATS = SPLIT > 1 ? WARPS * 16 * BK : 0;",
                 "+ XCH_FLOATS * (int)sizeof(float);"):
        assert line in text, line
    for bq, bk, dh, size in ((128, 32, 112, 2), (64, 64, 32, 2),
                             (64, 32, 16, 4), (128, 64, 16, 2)):
        ldk, ldv = dh + 8, dh + 16 // size
        assert flash_attention.smem_bytes(bq, bk, dh, size) == \
            4 * bq * (dh + 8) + 2 * bk * (ldk + ldv) * size
        assert flash_attention.threads(bq, dh, size) == 32 * bq // 16
    # float32 at Dh 64, 96 and 128, the wgmma instances (WTile): Q big and
    # small, the width's raw K and V^T stages and sets of small parts, two
    # barriers a stage and three a set, 1,024 bytes of alignment; three
    # warpgroups, whose registers setmaxnreg moves from the producer to the
    # consumers. Dh 128 keeps two stages and one set: 230,456 bytes; a
    # third stage or a second set would not fit.
    for line in ("static constexpr int SMEM = 1024 + OFF_BARS + 8 * BARRIERS;",
                 "static constexpr int STAGE = K_BYTES + VT_BYTES;",
                 "static constexpr int OFF_SMALL = OFF_RING + STAGES * STAGE;",
                 "static constexpr int OFF_BARS = OFF_SMALL + SETS * STAGE;",
                 "static constexpr int BARRIERS = 2 * STAGES + 3 * SETS;",
                 "static constexpr int Q_BYTES = CHUNKS * Q_CHUNK;",
                 "constexpr int W_THREADS = 384;",
                 "constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;"):
        assert line in text, line
    assert flash_attention.WGMMA_FORMS[4, 128][1:3] == (2, 1)
    for dh in flash_attention.WGMMA_DH:
        _, stages, sets, _ = flash_attention.WGMMA_FORMS[4, dh]
        got = flash_attention.smem_bytes(128, 32, dh, 4)
        assert got == 1024 + 2 * 4 * 128 * dh + (stages + sets) * 2 * 4 * 32 \
            * dh + 8 * (2 * stages + 3 * sets) <= 232_448
        # the source's layout, reckoned per width: two, three or four
        # stages, one or two sets
        assert got == {128: {(2, 1): 230_456},
                       96: {(2, 1): 173_112, (3, 1): 197_704,
                            (4, 1): 222_296, (2, 2): 197_712,
                            (3, 2): 222_304},
                       64: {(2, 1): 115_768, (3, 1): 132_168,
                            (4, 1): 148_568, (2, 2): 132_176,
                            (3, 2): 148_576}}[dh][stages, sets]
        assert flash_attention.threads(128, dh) == \
            flash_attention.WGMMA_THREADS == 384
    assert flash_attention.smem_bytes(128, 32, 120) == 230_456
    assert flash_attention.smem_bytes(128, 32, 80) == \
        flash_attention.smem_bytes(128, 32, 96)
    assert 128 * 56 + 256 * 224 == 384 * flash_attention.WGMMA_REGISTERS
    assert flash_attention.WGMMA_REGISTERS == 65_536 // 384 // 8 * 8
    # Dh 256: a warp pair a 16 rows and the exchange, 16 x bk float32 a
    # warp: 218,112 bytes at (64, 32) float32, as the source's header says
    for size in (4, 2):
        ldk, ldv = 256 + 8, 256 + 16 // size
        assert flash_attention.threads(64, 256) == 256
        assert flash_attention.smem_bytes(64, 32, 256, size) == \
            4 * 64 * 264 + 2 * 32 * (ldk + ldv) * size + 4 * 8 * 16 * 32
    assert flash_attention.smem_bytes(64, 32, 256) == 218_112
    # a width between compiled ones takes its instance's layout
    assert flash_attention.smem_bytes(128, 32, 48) == \
        flash_attention.smem_bytes(128, 32, 64)
    assert flash_attention.smem_bytes(128, 32, 24, 4) == \
        flash_attention.smem_bytes(128, 32, 32, 4)
    assert flash_attention.smem_bytes(64, 32, 200) == 218_112
    cfg = KernelConfig("flash_attention", (128, 32), precision="bf16")
    assert smem_bytes(cfg, (32, 4096, 128)) == \
        flash_attention.smem_bytes(128, 32, 128, 2)
    # bf16 at Dh 64, 96 and 128, the bf16 wgmma instances (BTile): Q's tile
    # and the form's stages of K and V tiles, each in Dh / COLS whole
    # chunks of the swizzle's columns, two barriers a stage and Q's one,
    # 1,024 bytes of alignment; no small parts, no V^T
    for line in ("static constexpr int SMEM = 1024 + OFF_BARS + 8 * BARRIERS;",
                 "static constexpr int STAGE = 2 * K_BYTES;",
                 "static constexpr int OFF_BARS = OFF_RING + STAGES * STAGE;",
                 "static constexpr int BARRIERS = 2 * STAGES + 1;",
                 "static constexpr int CHUNKS = DH / COLS;",
                 "static constexpr int Q_CHUNK = W_BQ * SW;",
                 "static constexpr int KV_CHUNK = BK * SW;",
                 "constexpr int B_PRODUCER_REGS = 40, B_CONSUMER_REGS = 232;"):
        assert line in text, line
    assert 128 * 40 + 256 * 232 <= 65_536
    for dh in flash_attention.WGMMA_DH:
        bk, stages, _, sw = flash_attention.WGMMA_FORMS[2, dh]
        assert dh % (sw // 2) == 0
        got = flash_attention.smem_bytes(128, bk, dh, 2)
        assert got == 1024 + 2 * 128 * dh + stages * 2 * 2 * bk * dh + \
            8 * (2 * stages + 1) <= 232_448
        assert flash_attention.threads(128, dh, 2) == 384


@pytest.mark.parametrize("precision,passes", [(None, 3), ("bf16", 1)])
def test_sketch_fused_cost_counts_the_tensor_core_passes(precision, passes):
    """The model charges sketch_fused its tensor-core passes: three TF32
    passes for float32 inputs (31.03 ms at the slice's shape), one pass on
    the bf16 tensor cores for bf16 (5.18 ms)."""
    k, d, n = 512, 50_000, 100_000
    cost = tuning.roofline_cost(_sk(precision=precision), (k, d, n))
    peak = 989e12 if precision == "bf16" else 495e12
    assert cost.flops == passes * 2.0 * k * d * n
    assert cost.t_compute == pytest.approx(passes * 2.0 * k * d * n / peak)
    assert cost.slots == tuning.SMS * sketch_fused.CTAS_PER_SM
    if precision is None:
        assert cost.t_compute == pytest.approx(31.03e-3, rel=1e-3)
        assert cost.t_compute > cost.t_memory
    else:
        assert cost.t_compute == pytest.approx(5.18e-3, rel=1e-3)


@pytest.mark.parametrize("kernel", tuning.KERNELS)
def test_candidates_respect_smem_budget_and_menu(kernel):
    shape = SHAPES[kernel]
    cands = candidate_configs(kernel, shape)
    assert cands
    for cfg in cands:
        validate_config(cfg)
        assert smem_bytes(cfg, shape) <= tuning.SMEM_BUDGET_BYTES
    if kernel == "flash_attention":
        # at Dh 128 both dtypes run a wgmma instance, with its one tile
        assert [c.block for c in cands] == [DEFAULTS[kernel].block]
        assert [c.block for c in candidate_configs(
            kernel, shape, precision="bf16")] == [(128, 128)]


def test_flash_candidates_follow_the_sequence_length():
    """Blocks larger than S or not dividing it are no candidates; a head
    width takes its own menu (a width between compiled ones its instance's;
    float32 at the wgmma widths, and those padded to them, (128, 32) alone;
    Dh 256 (64, 32) alone), and one no instance runs leaves only the
    default."""
    assert candidate_configs("flash_attention", (4, 96, 32)) == \
        [DEFAULTS["flash_attention"]]
    got = {c.block for c in candidate_configs("flash_attention", (4, 192, 32))}
    assert got == {(64, 32), (64, 64)}
    got = {c.block for c in candidate_configs("flash_attention", (4, 192, 32),
                                              precision="bf16")}
    assert got == {(64, 32), (64, 64)}
    assert {c.block for c in candidate_configs(
        "flash_attention", (4, 256, 24))} == \
        set(tuning.TILE_MENUS["flash_attention"][:4])
    for dh in (48, 64, 80, 96):
        assert candidate_configs("flash_attention", (4, 256, dh)) == \
            [KernelConfig("flash_attention", (128, 32))]
        assert candidate_configs("flash_attention", (4, 256, dh),
                                 precision="bf16") == \
            [KernelConfig("flash_attention", (128, 128), precision="bf16")]
    # the wgmma widths' one tile has 128 query rows: at S = 192 no tile
    # of either dtype divides S there, so such a call raises before a
    # launch (bf16 on mma.sync compiled (64, 32) and (64, 64) at Dh 64)
    for precision in (None, "bf16"):
        (cfg,) = candidate_configs("flash_attention", (4, 192, 64),
                                   precision=precision)
        assert 192 % cfg.block[0]
    for dh in (200, 256):
        assert candidate_configs("flash_attention", (4, 256, dh)) == \
            [KernelConfig("flash_attention", (64, 32))]
    assert candidate_configs("flash_attention", (4, 256, 264)) == \
        [DEFAULTS["flash_attention"]]


def test_candidates_tiny_budget_falls_back_to_min_footprint():
    cands = candidate_configs("flash_attention", FLASH, smem_budget=1)
    assert len(cands) == 1
    full = candidate_configs("flash_attention", FLASH)
    assert min(smem_bytes(c, FLASH) for c in full) == \
        smem_bytes(cands[0], FLASH)


def test_ranking_is_deterministic():
    r1 = rank_candidates("flash_attention", FLASH)
    r2 = rank_candidates("flash_attention", FLASH)
    assert r1 == r2 and len(r1) >= 2
    costs = [tuning.roofline_cost(c, FLASH).t_total for c in r1]
    assert costs == sorted(costs)


def test_roofline_cost_counts_the_causal_work():
    """At the full width the model's FLOP are the causal 2 S^2 Dh per head
    plus the masked halves of the diagonal tiles, times the kernel's three
    TF32 passes for float32 inputs, at the TF32 rate. With 128-row query
    tiles the operations bound it; 64-row tiles read K and V twice as often,
    and the model's bytes (every K/V re-read counted) then outweigh them."""
    BH, S, Dh = SHAPES["flash_attention"]
    qk, pv, kind = flash_attention.PASSES["wgmma", 4]
    assert kind == "tf32"
    exact = BH * S * S * Dh * (qk + pv)
    for cfg in candidate_configs("flash_attention", (BH, S, Dh)):
        bq, bk = cfg.block
        cost = tuning.roofline_cost(cfg, (BH, S, Dh))
        assert exact < cost.flops <= exact * (1 + 2 * max(bq, bk) / S)
        assert cost.t_compute == pytest.approx(cost.flops / 495e12)
        assert cost.t_total >= max(cost.t_compute, cost.t_memory)
        if bq == max(flash_attention.BLOCK_Q):
            assert cost.t_compute > cost.t_memory


def test_flash_cost_counts_two_passes_for_bf16():
    """bf16 inputs on ``mma.sync`` (Dh 112): two TF32 passes per product (k
    and v are exact in TF32), two thirds of float32's FLOP. On the bf16
    ``wgmma`` instance (Dh 128): one bf16 pass on QK^T and two on PV, at
    the bf16 rate: 13.3 ms at the full width, plus the masked halves of
    the diagonal tiles, and no prologue's bytes."""
    BH, S, _ = SHAPES["flash_attention"]
    cfg = KernelConfig("flash_attention", (128, 32))
    f32 = tuning.roofline_cost(cfg, (BH, S, 112))
    bf16 = tuning.roofline_cost(cfg._replace(precision="bf16"), (BH, S, 112))
    assert bf16.flops == pytest.approx(f32.flops * 2 / 3)
    assert bf16.t_compute == pytest.approx(bf16.flops / 495e12)
    assert bf16.hbm_bytes == pytest.approx(f32.hbm_bytes / 2)
    Dh = 128
    cfg = KernelConfig("flash_attention", (128, 128), precision="bf16")
    bf16 = tuning.roofline_cost(cfg, (BH, S, Dh))
    assert flash_attention.PASSES["wgmma", 2] == (1, 2, "bf16")
    assert bf16.t_compute == pytest.approx(bf16.flops / 989e12)
    assert bf16.t_compute == pytest.approx(
        3 * BH * S * S * Dh / 989e12, rel=2 * 128 / S)
    assert bf16.t_compute == pytest.approx(13.3e-3, rel=1e-2)
    # q in and o out once, K and V once a k-tile of each query tile
    tiles = sum((qt * 128 + 127) // 128 + 1 for qt in range(S // 128))
    assert bf16.hbm_bytes == 2 * BH * S * Dh * 2 + 2 * BH * tiles * 128 * \
        Dh * 2


def test_flash_cost_caps_ctas_by_registers():
    """The flash kernel's launch bounds let a thread take up to 255
    registers, so registers, not threads or shared memory, cap its CTAs
    per SM: one 128-row CTA at every head width, two 64-row ones at
    Dh = 112, three at Dh = 32; the wgmma instances at Dh 64, 96 and 128,
    in either dtype, one."""
    assert all(r <= 255 for r in flash_attention.REGISTERS.values())
    assert sorted(flash_attention.REGISTERS) == sorted(
        set(flash_attention.HEAD_DIMS) - set(flash_attention.WGMMA_DH))
    assert [flash_attention.ctas_per_sm(128, dh)
            for dh in (32, 64, 96, 112, 128)] == [1, 1, 1, 1, 1]
    assert [flash_attention.ctas_per_sm(64, dh, 2)
            for dh in (32, 64, 96, 112, 128)] == [3, 1, 1, 2, 1]
    # the wgmma instances: 384 threads at 168 registers, one CTA an SM
    for size in (4, 2):
        assert flash_attention.ctas_per_sm(128, 128, size) == 1
    # Dh 256's 64-row CTA is 8 warps at up to 255 registers: one an SM
    assert flash_attention.ctas_per_sm(64, 256) == 1
    assert flash_attention.ctas_per_sm(64, 200) == 1
    for shape in (TINY["flash_attention"], FLASH, SHAPES["flash_attention"]):
        for cfg in candidate_configs("flash_attention", shape):
            slots = tuning.roofline_cost(cfg, shape).slots
            bq = min(cfg.block[0], shape[1])
            assert slots <= tuning.SMS * flash_attention.ctas_per_sm(
                bq, shape[2])


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_flash_model_ranks_a_128_row_tile_first_at_full_width(precision):
    """At granite-3-8b's layer (S = 32,768) the 128-row tiles were
    measured fastest on the mma.sync design; both dtypes now run a wgmma
    instance there, whose one 128-row tile the model ranks alone and
    first."""
    ranked = rank_candidates("flash_attention", SHAPES["flash_attention"],
                             precision=precision,
                             dtype_bytes=2 if precision else 4)
    size = 2 if precision else 4
    # both dtypes run a wgmma instance there, whose one tile is the
    # default float32 keeps and bf16 resolves
    assert ranked[0].block == flash_attention.tiles(128, size)[0] == \
        tuning.default_config("flash_attention", SHAPES["flash_attention"],
                              size).block
    assert len(ranked) == 1
    if precision is None:
        assert ranked[0].block == DEFAULTS["flash_attention"].block


def test_autotune_static_mode_returns_ranking_head():
    winner, records = tuning.autotune("flash_attention", FLASH)
    assert winner == rank_candidates("flash_attention", FLASH)[0]
    assert records and "t_total" in records[0]
    assert "us_per_call" not in records[0]


def test_table_round_trip_and_version_check(tmp_path):
    t = TuningTable(backend="h100")
    cfg = KernelConfig("flash_attention", (128, 32))
    t.put("flash_attention", (30, 3000, 100), cfg,
          stats={"us_per_call": 7.0})
    assert t.get("flash_attention", (32, 4096, 128)) == cfg
    assert t.get("flash_attention", (32, 8192, 128)) is None
    path = str(tmp_path / "h100.json")
    t.save(path)
    back = TuningTable.load(path)
    assert back.get("flash_attention", (30, 3000, 100)) == cfg
    assert back.backend == "h100" and back.version == tuning.TABLE_VERSION
    with open(path) as f:
        blob = json.load(f)
    blob["version"] = tuning.TABLE_VERSION + 1
    with open(path, "w") as f:
        json.dump(blob, f)
    with pytest.raises(ValueError, match="version"):
        TuningTable.load(path)


def test_tables_cross_between_the_packages(tmp_path):
    """A table either package saves, the other loads with the same entries;
    a config read back names the same kernel, block and knobs."""
    jt = jax_tuning.TuningTable(backend="tpu")
    jt.put("sketch_fused", (100, 3000, 400),
           jax_tuning.KernelConfig("sketch_fused", (128, 1024)),
           stats={"us_per_call": 3.5})
    jt.put("flash_attention", (8, 1024, 128),
           jax_tuning.KernelConfig("flash_attention", (64, 128)),
           dtype_bytes=2)
    jt.save(str(tmp_path / "jax.json"))
    pt = TuningTable.load(str(tmp_path / "jax.json"))
    assert pt.entries == jt.entries and pt.backend == "tpu"
    assert tuple(pt.get("flash_attention", (8, 1024, 128), 2)) == \
        tuple(jt.get("flash_attention", (8, 1024, 128), 2))

    pt2 = TuningTable(backend="h100")
    pt2.put("flash_attention", (32, 32768, 128),
            KernelConfig("flash_attention", (64, 64)),
            stats={"us_per_call": 4e5, "achieved_gbps": 0.7})
    pt2.put("sampled_dot", (10, 10, 4, 9), KernelConfig("sampled_dot", (),
                                                        precision="bf16"))
    pt2.save(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_text() == \
        json.dumps({"backend": "h100", "entries": pt2.entries,
                    "version": 1}, indent=2, sort_keys=True) + "\n"
    jt2 = jax_tuning.TuningTable.load(str(tmp_path / "port.json"))
    assert jt2.entries == pt2.entries
    for kernel, shape in (("flash_attention", (32, 32768, 128)),
                          ("sampled_dot", (10, 10, 4, 9))):
        assert tuple(jt2.get(kernel, shape)) == tuple(pt2.get(kernel, shape))
        assert jax_tuning.table_key(kernel, shape) == table_key(kernel, shape)


def test_lookup_unknown_shape_falls_back_to_defaults(empty_tables):
    assert table_key("sketch_fused", (100, 3000, 400)) == \
        table_key("sketch_fused", (128, 4096, 512))
    for backend in ("cpu", "h100"):
        for kernel in tuning.KERNELS:
            assert tuning.lookup(kernel, TINY[kernel], backend=backend) == \
                DEFAULTS[kernel]


def test_backend_of_names_the_table():
    assert tuning.backend_of("cpu") == "cpu"
    assert tuning.backend_of(torch.device("cpu")) == "cpu"
    assert tuning.dtype_bytes_of(torch.zeros(2, dtype=torch.bfloat16)) == 2
    assert tuning.dtype_bytes_of(torch.float64) == 4
    assert tuning.dtype_bytes_of(np.zeros(2, np.float32)) == 4
    assert tuning.dtype_bytes_of(jnp.zeros(2, jnp.bfloat16)) == 2


@pytest.mark.parametrize("kernel", tuning.KERNELS)
def test_measure_config_on_the_cpu(kernel):
    us = tuning.measure_config(DEFAULTS[kernel], TINY[kernel], reps=1,
                               device="cpu")
    assert us > 0


def test_autotune_measured_on_the_cpu_records_the_winner():
    table = TuningTable(backend="cpu")
    winner, records = tuning.autotune("flash_attention", (2, 128, 32),
                                      measure_top=2, reps=1, table=table,
                                      device="cpu")
    assert len(records) == 2
    assert all(r["us_per_call"] > 0 and r["achieved_gbps"] > 0
               for r in records)
    assert table.get("flash_attention", (2, 128, 32)) == winner
    assert tuning.achieved_gbps(winner, (2, 128, 32), 1.0) == \
        pytest.approx(tuning.roofline_cost(winner, (2, 128, 32)).hbm_bytes
                      / 1e3)


def test_autotune_always_measures_the_default():
    """A measured winner never loses to the default tile: when the static
    ranking leaves the default out of its top N, it is measured too."""
    shape = FLASH
    head = rank_candidates("flash_attention", shape)[0]
    assert head != DEFAULTS["flash_attention"]
    winner, records = tuning.autotune("flash_attention", shape,
                                      measure_top=1, reps=1, device="cpu")
    assert [r["config"] for r in records] == \
        [head.tag(), DEFAULTS["flash_attention"].tag()]
    assert winner in (head, DEFAULTS["flash_attention"])


def test_retune_writes_a_table(tmp_path):
    out = tmp_path / "cpu.json"
    table = tuning.retune({"sampled_dot": [TINY["sampled_dot"]]},
                          backend="cpu", measure_top=1, reps=1,
                          out_path=str(out), device="cpu")
    assert TuningTable.load(str(out)).entries == table.entries
    assert table.get("sampled_dot", TINY["sampled_dot"]) == \
        DEFAULTS["sampled_dot"]


def test_ops_kwarg_overrides_config_and_kernel_mismatch_rejected():
    rng = np.random.default_rng(4)
    Pi = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    A = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32))
    got, _ = ops.sketch_fused(Pi, A, precision="f32",
                              config=_sk(precision="bf16"))
    want, _ = ops.sketch_fused(Pi, A)
    assert torch.equal(got, want)
    half, _ = ops.sketch_fused(Pi, A, config=_sk(precision="bf16"))
    want_half, _ = ops.sketch_fused(Pi, A, precision="bf16")
    assert torch.equal(half, want_half) and not torch.equal(half, want)
    with pytest.raises(ValueError, match="sketch_fused"):
        ops.sketch_fused(Pi, A, config=DEFAULTS["blocked_fwht"])
    with pytest.raises(ValueError, match="blocked_fwht"):
        ops.blocked_fwht(A, torch.ones(256), config=_sk())
    with pytest.raises(ValueError, match="not compiled"):
        ops.sketch_fused(Pi, A, config=KernelConfig("sketch_fused",
                                                    (256, 512)))


@pytest.mark.parametrize("precision,read", [(None, 4), ("f32", 4),
                                             ("bf16", 2)])
def test_sketch_fused_looks_up_the_dtype_it_reads(precision, read,
                                                  monkeypatch):
    """precision='bf16' casts float32 inputs after the config is resolved:
    the wrapper and the summary's sketch_configs look the table up under
    the dtype the kernel reads, not the inputs'."""
    from repro_torch.core import summary_engine
    seen = []
    real = tuning.lookup

    def lookup(kernel, shape, **kw):
        seen.append((kernel, kw["dtype_bytes"]))
        return real(kernel, shape, **kw)
    monkeypatch.setattr(tuning, "lookup", lookup)
    Pi, A = torch.ones(8, 64), torch.ones(64, 32)
    ops.sketch_fused(Pi, A, precision=precision)
    summary_engine.sketch_configs("cuda", "gaussian", 8, 1024, precision, A,
                                  A)
    assert seen == [("sketch_fused", read)] * 3


def test_table_hit_reaches_the_wrapper(empty_tables):
    """A table hit for the shape bucket resolves before DEFAULTS, in both
    packages; a hit naming a tile the source does not compile is refused."""
    q = torch.zeros(1, 256, 2, 32)
    shape = (2, 256, 32)
    hit = KernelConfig("flash_attention", (128, 32))
    tuning._TABLE_CACHE["cpu"] = TuningTable(backend="cpu")
    tuning._TABLE_CACHE["cpu"].put("flash_attention", shape, hit)
    assert ops._resolved("flash_attention", shape, q, None) == hit
    jax_tuning._TABLE_CACHE["cpu"] = jax_tuning.TuningTable(backend="cpu")
    jax_tuning._TABLE_CACHE["cpu"].put(
        "flash_attention", shape,
        jax_tuning.KernelConfig("flash_attention", (128, 32)))
    assert tuple(jax_ops._resolved("flash_attention", shape,
                                   jnp.zeros((1, 256, 2, 32)), None)) == \
        tuple(hit)
    tuning._TABLE_CACHE["cpu"].entries[table_key(
        "flash_attention", shape)]["block"] = [256, 32]
    with pytest.raises(ValueError, match="not compiled"):
        ops.flash_attention(q, q, q)


def _sampled_inputs(seed=3):
    rng = np.random.default_rng(seed)
    As = rng.standard_normal((64, 32)).astype(np.float32)
    Bs = rng.standard_normal((64, 32)).astype(np.float32)
    na = (np.abs(rng.standard_normal(64)) + 0.5).astype(np.float32)
    nb = (np.abs(rng.standard_normal(64)) + 0.5).astype(np.float32)
    rows = rng.integers(0, 64, 50).astype(np.int32)
    cols = rng.integers(0, 64, 50).astype(np.int32)
    return As, Bs, na, nb, rows, cols


@pytest.mark.parametrize("source", ["miss", "config", "kwarg"])
def test_resolution_order_matches_jax(source, empty_tables):
    """A table miss, an explicit config, and a kwarg over a config each
    resolve to the precision the JAX wrapper's ``_resolved`` picks, and the
    two wrappers then agree: the JAX suite's 5e-2 for bf16 gathers
    (test_sampled_dot_precision_sweep), 1e-5 of the scale otherwise."""
    arrays = _sampled_inputs()
    jcfg = {"miss": None, "config": jax_tuning.KernelConfig(
        "sampled_dot", (), precision="bf16"),
        "kwarg": jax_tuning.KernelConfig("sampled_dot", (),
                                         precision="bf16")}[source]
    pcfg = None if jcfg is None else KernelConfig("sampled_dot", (),
                                                  precision=jcfg.precision)
    kw = {"precision": "f32"} if source == "kwarg" else {}
    want = jax_ops.sampled_rescaled_dot(*(jnp.asarray(a) for a in arrays),
                                        config=jcfg, **kw)
    got = ops.sampled_rescaled_dot(*(torch.from_numpy(a) for a in arrays),
                                   config=pcfg, **kw)
    n1, k = arrays[0].shape
    shape = (n1, arrays[1].shape[0], k, arrays[4].shape[0])
    resolved = ops._resolved("sampled_dot", shape,
                             torch.from_numpy(arrays[0]), pcfg)
    jresolved = jax_ops._resolved("sampled_dot", shape,
                                  jnp.asarray(arrays[0]), jcfg)
    assert resolved.precision == jresolved.precision
    scale = float(np.abs(np.asarray(want)).max())
    tol = 5e-2 if kw.get("precision", resolved.precision) == "bf16" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_fwht_config_precision_reads_x_in_that_precision(precision):
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal((256, 24)).astype(np.float32))
    signs = torch.from_numpy(rng.choice([-1.0, 1.0], 256).astype(np.float32))
    got = ops.blocked_fwht(X, signs, config=KernelConfig(
        "blocked_fwht", hadamard.TILE, precision=precision))
    Xr = X if precision is None else X.to(torch.bfloat16)
    assert torch.equal(got, ops.blocked_fwht(Xr, signs))
