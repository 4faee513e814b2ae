"""The port's flash attention against the JAX package's, and the port's
independence from JAX.

Inputs are made with numpy from a seed and handed to both packages. The JAX
Pallas kernel runs as the JAX suite runs it on the CPU (interpret mode,
through ``repro.kernels.ops.flash_attention``); the port's wrapper takes
its plain version on CPU tensors.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import flash_attention, ops, ref, tuning

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The JAX suite's tolerances for its kernel against its oracle
# (tests/kernels/test_flash_attention.py::test_flash_matches_oracle).
TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


# S below 128, which the JAX wrapper runs as one block of S rows and the
# card on a copy zero-padded along S with the keys past S masked; every
# compiled width and the padded width 50; GQA (4 query heads over 2) and
# MHA (2 over 2)
SHORT_S = (1, 48, 80, 100, 127)
SHORT_WIDTHS = (16, 32, 64, 96, 112, 128, 256, 50)
SHORT_LAYOUTS = ((4, 2), (2, 2))


def _qkv(B, S, H, Hkv, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, Dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hkv,Dh", [
    (1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 512, 2, 1, 128),
    (1, 384, 3, 3, 64),
    (1, 256, 4, 2, 96),     # phi3-mini-3.8b's head width, GQA 2:1
    (1, 384, 2, 1, 112),    # kimi-k2-1t-a32b's head width, MQA
    (1, 128, 4, 4, 16),     # the reduced configs' width, 4 over 4 heads
    (1, 256, 4, 2, 48),     # widths between compiled ones, which the card
    (1, 128, 2, 1, 80),     # zero-pads to the next one: to Dh 64, to 96,
    (1, 128, 4, 2, 200),    # to 256,
    (1, 128, 2, 1, 50),     # and to 64 from a width not a multiple of 4
    (1, 256, 4, 1, 256),    # recurrentgemma-9b's width, MQA
] + [(1, S, H, Hkv, Dh) for S in SHORT_S for Dh in SHORT_WIDTHS
     for H, Hkv in SHORT_LAYOUTS])
def test_flash_matches_jax(B, S, H, Hkv, Dh, causal, dtype):
    q, k, v = _qkv(B, S, H, Hkv, Dh, seed=S + H)
    want = jax_ops.flash_attention(
        *(jnp.asarray(x).astype(_JNP[dtype]) for x in (q, k, v)),
        causal=causal)
    got = ops.flash_attention(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), causal=causal)
    assert got.dtype == dtype and tuple(got.shape) == (B, S, H, Dh)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_attention_chunks_rows_without_changing_them(monkeypatch):
    """The plain version takes query rows in chunks to bound its memory;
    the chunk size does not change a row's numbers."""
    q, k, v = (torch.from_numpy(x[0].transpose(1, 0, 2).copy())
               for x in _qkv(1, 96, 2, 2, 32, seed=5))
    whole = ref.flash_attention_ref(q, k, v, causal=True)
    monkeypatch.setattr(ref, "_SCORE_CHUNK", 96 * 7)   # 7 rows a step
    chunked = ref.flash_attention_ref(q, k, v, causal=True)
    assert torch.equal(whole, chunked)


def test_flash_shape_errors():
    q = torch.zeros(1, 160, 2, 32)
    with pytest.raises(ValueError, match="divisible"):
        ops.flash_attention(q, q, q, config=tuning.KernelConfig(
            "flash_attention", (64, 64)))
    q3 = torch.zeros(1, 128, 3, 32)
    kv2 = torch.zeros(1, 128, 2, 32)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q3, kv2, kv2)
    with pytest.raises(ValueError, match="disagree"):
        ops.flash_attention(q3, kv2, torch.zeros(1, 128, 2, 16))
    with pytest.raises(ValueError, match="not compiled"):
        ops.flash_attention(q3, q3, q3, config=tuning.KernelConfig(
            "flash_attention", (96, 64)))


@pytest.mark.parametrize("bq,bk,dh", [(64, 64, 264), (32, 64, 64),
                                      (64, 16, 64), (128, 256, 128),
                                      (128, 32, 256), (64, 64, 256),
                                      (128, 64, 256), (64, 32, 0)])
def test_uncompiled_tiles_are_refused_before_a_launch(bq, bk, dh):
    """What the CUDA branch checks before it launches: a head width past
    256 (or none), or a (clamped) block the source does not compile at the
    width, raises, naming the menu. At Dh 256 only (64, 32) is compiled."""
    with pytest.raises(ValueError, match="compiled"):
        flash_attention.check_tile(bq, bk, dh)


def test_compiled_tiles_fit_shared_memory():
    """Every width's own menu fits the 227 KB a CTA may take, in both
    dtypes, and the tiles left out at Dh 256 do not."""
    for dh in flash_attention.HEAD_DIMS:
        for size in (4, 2):
            for bq, bk in flash_attention.tiles(dh, size):
                flash_attention.check_tile(bq, bk, dh, size)
                assert flash_attention.smem_bytes(bq, bk, dh, size) <= \
                    tuning.SMEM_BUDGET_BYTES
    for bq, bk in ((64, 64), (128, 32)):
        assert flash_attention.smem_bytes(bq, bk, 256, 2) > \
            tuning.SMEM_BUDGET_BYTES


@pytest.mark.parametrize("dh,width", [
    (1, 16), (13, 16), (16, 16), (17, 32), (48, 64), (50, 64), (80, 96),
    (100, 112), (128, 128), (129, 256), (200, 256), (256, 256)])
def test_every_width_up_to_256_maps_to_a_compiled_instance(dh, width):
    """A head width runs on the smallest compiled width at least as wide
    (the card zero-pads a copy of q, k and v to it where the width is not
    compiled), with that width's tiles."""
    assert flash_attention.tile_width(dh) == width
    assert (width in flash_attention.HEAD_DIMS) and \
        (dh == width) == (dh in flash_attention.HEAD_DIMS)
    assert flash_attention.tiles(dh) == flash_attention.tiles(width)
    bq, bk = tuning.default_config("flash_attention", (1, 4096, dh)).block
    flash_attention.check_tile(bq, bk, dh)


@pytest.mark.parametrize("dh", [13, 48, 50, 200])
def test_uncompiled_width_is_zero_padded_to_the_next_compiled_one(
        monkeypatch, dh):
    """The card's path through ``ops.flash_attention`` with the launch
    stood in for by the kernel's function (attention at the width it is
    given, with the scale it is passed): one launch on q, k and v
    zero-padded to ``tile_width(dh)`` at the scale of the true width, and
    the output sliced back to the attention of width ``dh``."""
    calls = []

    def launch(lib, q, k, v, causal, bq, bk, scale_dh=None, kv_len=None):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1], scale_dh))
        stretch = (q.shape[-1] / (scale_dh or q.shape[-1])) ** 0.5
        return flash_attention.plain(q * stretch, k, v, causal)

    monkeypatch.setattr(ops, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(ops, "_library", lambda name: None)
    monkeypatch.setattr(flash_attention, "launch", launch)
    monkeypatch.setitem(ops.LAUNCHES, "flash_attention", 0)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 128, 4, 2, dh, seed=dh))
    got = ops.flash_attention(q, k, v, causal=True)
    width = flash_attention.tile_width(dh)
    assert calls == [(width, width, width, dh)]
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, flash_attention.plain(q, k, v, True),
                               rtol=1e-5, atol=1e-5)


def _card_path(monkeypatch, calls):
    """``ops.flash_attention``'s card path with the launch stood in for by
    the kernel's function (attention at the width it is given, with the
    scale and the key length it is passed); each launch's (q's shape, bq,
    bk, scale width, kv_len) goes into ``calls``."""
    def launch(lib, q, k, v, causal, bq, bk, scale_dh=None, kv_len=None):
        calls.append((tuple(q.shape), bq, bk, scale_dh, kv_len))
        stretch = (q.shape[-1] / (scale_dh or q.shape[-1])) ** 0.5
        return flash_attention.plain(q * stretch, k, v, causal, kv_len)

    monkeypatch.setattr(ops, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(ops, "_library", lambda name: None)
    monkeypatch.setattr(flash_attention, "launch", launch)
    monkeypatch.setitem(ops.LAUNCHES, "flash_attention", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 50, 64, 112, 256])
@pytest.mark.parametrize("S", [1, 48, 100, 127])
def test_short_s_runs_one_launch_on_a_copy_padded_along_s(monkeypatch, S, dh,
                                                           dtype):
    """The card's path at an S below 128, which no compiled tile divides:
    one launch on one copy of q, k and v zero-padded along S to a multiple
    of the resolved tile's larger block (``seq_padding``: 128 on a
    ``wgmma`` instance, 64 or 128 on an ``mma.sync`` one; Dh padded to its
    compiled width in the same copy), at that tile, with ``kv_len`` = S,
    and the output's first S rows, contiguous: the plain version at S."""
    calls = []
    _card_path(monkeypatch, calls)
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _qkv(2, S, 4, 2, dh, seed=S + dh))
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        assert got.shape == q.shape and got.dtype == dtype and \
            got.is_contiguous()
        torch.testing.assert_close(
            got.float(), flash_attention.plain(q, k, v, causal).float(),
            rtol=1e-5 if dtype == torch.float32 else 1e-2,
            atol=1e-5 if dtype == torch.float32 else 1e-2)
    tile = tuning.lookup("flash_attention", (8, S, dh),
                         dtype_bytes=dtype.itemsize, backend="cpu").block
    padded = S + flash_attention.seq_padding(S, tile)
    assert padded % max(tile) == 0 and padded - S < max(tile)
    width = flash_attention.tile_width(dh)
    assert calls == [((2, padded, 4, width), *tile, dh, S)] * 2
    assert ops.LAUNCHES["flash_attention"] == 2


@pytest.mark.parametrize("dh", [16, 64, 256])
@pytest.mark.parametrize("S", [160, 200])
def test_s_the_jax_wrapper_refuses_is_refused_before_a_launch(
        monkeypatch, S, dh):
    """An S of 128 or more that is not a multiple of 128 raises ValueError
    in both wrappers, and on the card's path before any launch, though the
    kernel's key-length mask could run it: the reference has no such
    call."""
    q, k, v = _qkv(1, S, 2, 1, dh, seed=S)
    with pytest.raises(ValueError, match="divisible"):
        jax_ops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)))
    with pytest.raises(ValueError, match="divisible"):
        ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    calls = []
    _card_path(monkeypatch, calls)
    with pytest.raises(ValueError, match="divisible"):
        ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert calls == [] and ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", SHORT_WIDTHS)
@pytest.mark.parametrize("S", SHORT_S)
def test_padding_plan_with_kv_len_is_the_plain_version_at_s(S, dh, dtype):
    """The card's plan for an S below 128 in the plain version: q, k and v
    zero-padded along S by ``seq_padding`` at every tile compiled at the
    width, the plain version with ``kv_len`` = S, then its first S rows,
    equal the plain version at S bit for bit, causal and not, GQA and MHA.
    Without the mask a non-causal call gives the zero keys past S weight
    (a causal row never sees them)."""
    for H, Hkv in SHORT_LAYOUTS:
        q, k, v = (torch.from_numpy(x).to(dtype)
                   for x in _qkv(2, S, H, Hkv, dh, seed=S + dh + H))
        for causal in (True, False):
            want = flash_attention.plain(q, k, v, causal)
            for tile in flash_attention.tiles(dh, dtype.itemsize):
                pad = flash_attention.seq_padding(S, tile)
                assert pad > 0 and (S + pad) % max(tile) == 0
                qp, kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                              for t in (q, k, v))
                got = flash_attention.plain(qp, kp, vp, causal, kv_len=S)
                assert torch.equal(got[:, :S], want)
                if not causal:
                    unmasked = flash_attention.plain(qp, kp, vp, causal)
                    assert not torch.equal(unmasked[:, :S], want)


def test_seq_padding_leaves_s_from_128_on_as_it_is():
    """From 128 on the tile divides S and nothing is padded; below it S
    goes up to the next multiple of the tile's larger block."""
    for tile in ((128, 32), (64, 32), (128, 128), (64, 64)):
        for S in (128, 256, 4096):
            assert flash_attention.seq_padding(S, tile) == 0
        assert [S + flash_attention.seq_padding(S, tile)
                for S in (1, 64, 65, 127)] == \
            [max(tile), max(tile), 128, 128]


@pytest.mark.parametrize("dh", [0, 257, 264, 320])
def test_widths_past_256_have_no_instance(dh):
    with pytest.raises(ValueError, match="compiled"):
        flash_attention.tile_width(dh)
    assert tuning.default_config("flash_attention", (1, 4096, dh)) == \
        tuning.DEFAULTS["flash_attention"]


def test_default_tile_is_one_the_width_compiles():
    """``tuning.lookup`` (what ``ops.flash_attention`` and ``flash_prefill``
    resolve) keeps (128, 32) up to Dh 128, so their results stay bit for
    bit, and gives Dh 256 its one tile, (64, 32)."""
    for dh in (16, 32, 48, 64, 96, 112, 128):
        assert tuning.lookup("flash_attention", (8, 4096, dh),
                             backend="cpu") == \
            tuning.DEFAULTS["flash_attention"]
    for dh in (129, 200, 256):
        assert tuning.lookup("flash_attention", (8, 4096, dh),
                             backend="cpu").block == (64, 32)


@pytest.mark.parametrize("s_blocks,dh,seed", [(1, 32, 0), (2, 64, 1),
                                              (3, 32, 2), (4, 64, 3)])
def test_rows_are_convex_combinations(s_blocks, dh, seed):
    """Causal output rows lie in the convex hull of the V rows (softmax
    weights sum to 1), checked through the max bound."""
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(1, 128 * s_blocks, 2, 1, dh, seed))
    out = ops.flash_attention(q, k, v, causal=True)
    assert float(out.abs().max()) <= float(v.abs().max()) + 1e-4
    # row 0 sees key 0 only: exactly v[0]
    torch.testing.assert_close(out[0, 0], v[0, 0].expand(2, dh),
                               rtol=0, atol=1e-6)


def test_port_imports_no_jax():
    """Every module of repro_torch, and chip_smoke.py, import with jax made
    unimportable, and none of them pulls in the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and "
        "(m.split('.')[0] in ('repro', 'jax', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 68


def test_port_sources_name_no_jax_import():
    """No import statement anywhere in repro_torch or chip_smoke.py, at top
    level or inside a function, names jax or the JAX package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), \
                    f"{path.relative_to(ROOT)} imports {name}"


# The tensor-core flash_attention.cu, emulated in numpy: what the kernel
# feeds its TF32 MMAs and how they add. A TF32 value keeps the top 19 bits
# of a float32: the kernel rounds an operand x to nearest TF32 (``big``),
# and the MMA reads only the top 19 bits of ``small = x - big``. An MMA adds
# its products into its accumulator rounding toward zero. (The helpers are
# those of tests/test_torch_sketch.py, copied.)
_TF32_MASK = np.uint32(0xFFFFE000)


def _tf32_nearest(x):
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & _TF32_MASK).view(np.float32)


def _tf32_truncated(x):
    return (x.astype(np.float32).view(np.uint32) & _TF32_MASK).view(np.float32)


def _round_toward_zero(x64):
    f = x64.astype(np.float32)
    over = np.abs(f) > np.abs(x64)
    return (f.view(np.uint32) - over).view(np.float32)  # one ulp toward 0


def _operands(x, passes):
    """(a, b) pairs of one product's passes for operands x = (left, right):
    three passes (small*big, big*small, big*big); two when the right side is
    exact in TF32 (small*right, big*right); one pass big*big."""
    left, right = x
    lb, rb = _tf32_nearest(left), _tf32_nearest(right)
    ls, rs = _tf32_truncated(left - lb), _tf32_truncated(right - rb)
    return {3: [(ls, rb), (lb, rs), (lb, rb)], 2: [(ls, right), (lb, right)],
            1: [(lb, rb)]}[passes]


def _mma_sum(pairs, fresh_every=None):
    """sum_k a[:, k] b[k, :] as the MMAs add it: each k8 step's products of
    every pass, summed exactly, added into a float32 fragment that rounds
    toward zero. ``fresh_every``: the fragment is added to a float32 sum
    (round to nearest) after that many k8 steps and restarted; None: one
    fragment takes the whole sum."""
    n = pairs[0][0].shape[1]
    shape = (pairs[0][0].shape[0], pairs[0][1].shape[1])
    total = np.zeros(shape, np.float32)
    frag = np.zeros(shape, np.float32)
    for step, k0 in enumerate(range(0, n, 8), start=1):
        for a, b in pairs:
            prod = a[:, k0:k0 + 8].astype(np.float64) @ \
                b[k0:k0 + 8].astype(np.float64)
            frag = _round_toward_zero(frag.astype(np.float64) + prod)
        if fresh_every and step % fresh_every == 0:
            total, frag = total + frag, np.zeros(shape, np.float32)
    return total + frag


def _wgmma_operands(x):
    """The wgmma instance's passes of one product x = (left, right), in the
    order it issues them: the operands' raw float32 values are their big
    parts, of which the tensor core reads the top 19 bits (it truncates),
    and small = x - trunc(x), truncated again. First small*big and big*big
    at every k8 step (the raw tiles, as soon as they land), then big*small
    at every k8 step (once the splitters have written the small part)."""
    left, right = x
    lb, rb = _tf32_truncated(left), _tf32_truncated(right)
    ls, rs = _tf32_truncated(left - lb), _tf32_truncated(right - rb)
    return [(ls, rb), (lb, rb)], [(lb, rs)]


def _wgmma_sum(first, last, issued=None):
    """sum_k a[:, k] b[k, :] as a wgmma instance adds it into one fresh
    accumulator: one instruction a pass and k8 step, each adding its exact
    k8 products and rounding toward zero; the passes of ``first`` at every
    k8 step, then those of ``last``. ``issued``: a list to which the count
    of instructions is appended."""
    n = first[0][0].shape[1]
    frag = np.zeros((first[0][0].shape[0], first[0][1].shape[1]), np.float32)
    count = 0
    for pairs in (first, last):
        for k0 in range(0, n, 8):
            for a, b in pairs:
                prod = a[:, k0:k0 + 8].astype(np.float64) @ \
                    b[k0:k0 + 8].astype(np.float64)
                frag = _round_toward_zero(frag.astype(np.float64) + prod)
                count += 1
    if issued is not None:
        issued.append(count)
    return frag


def _emulated_attention(q, k, v, passes, bk=32, halves=1, wgmma=False,
                        issued=None):
    """flash_attention.cu's arithmetic for one causal head at its default
    k-tile: q (S, Dh) scaled in float32; QK^T straight into its fragment
    over Dh, or with ``halves=2`` (the Dh 256 warp pair) into one fragment
    per half of d, the two added in float32 (the pair's FADD); the online
    softmax in float32 per k-tile of ``bk`` keys; PV into a fresh fragment
    per k-tile, added to O with one rounding (the kernel's FFMA). A k-tile
    changes nothing for the rows before it (their p is exactly 0), so
    those rows are skipped, as the kernel skips the tiles past its
    diagonal. ``wgmma``: the float32 wgmma instances' split and order of
    passes (``_wgmma_operands``, ``_wgmma_sum``); ``passes`` is then
    (3, 3), and ``issued`` (a dict) collects the instructions of each
    k-tile's QK^T ("qk") and PV ("pv") product."""
    S, Dh = q.shape
    qs = (q * np.float32(1 / np.sqrt(Dh))).astype(np.float32)
    m = np.full((S, 1), -1e30, np.float32)
    lsum = np.zeros((S, 1), np.float32)
    o = np.zeros((S, Dh), np.float32)
    w = Dh // halves
    for k0 in range(0, S, bk):
        r = slice(k0, S)
        s = np.zeros((S - k0, bk), np.float32)
        for c in range(0, Dh, w):
            x = (qs[r, c:c + w], k[k0:k0 + bk, c:c + w].T)
            s = s + (_wgmma_sum(*_wgmma_operands(x),
                                issued=issued["qk"] if issued else None)
                     if wgmma else _mma_sum(_operands(x, passes[0])))
        s[k0 + np.arange(bk)[None, :] > np.arange(k0, S)[:, None]] = -1e30
        mn = np.maximum(m[r], s.max(1, keepdims=True))
        corr = np.exp(m[r] - mn)
        p = np.exp(s - mn)
        lsum[r] = lsum[r] * corr + p.sum(1, keepdims=True, dtype=np.float32)
        m[r] = mn
        x = (p, v[k0:k0 + bk])
        part = (_wgmma_sum(*_wgmma_operands(x),
                           issued=issued["pv"] if issued else None)
                if wgmma else _mma_sum(_operands(x, passes[1])))
        o[r] = (o[r].astype(np.float64) * corr + part).astype(np.float32)
    return o / np.maximum(lsum, np.float32(1e-30))


def _exact_attention(q, k, v):
    S, Dh = q.shape
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) / np.sqrt(Dh)
    s[np.triu_indices(S, 1)] = -np.inf
    p = np.exp(s - s.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)) @ v.astype(np.float64)


def _excess(got, want, tol):
    """max(|got - want| - tol |want|): the kernel meets ``tol`` (the JAX
    test's rtol = atol = tol) when this is at most tol."""
    return float((np.abs(got - want) - tol * np.abs(want)).max())


@pytest.fixture(scope="module")
def head():
    """One causal head of Dh = 128 at S = 2,048 from a numpy seed, and its
    float64 attention."""
    rng = np.random.default_rng(16)
    q, k, v = (rng.standard_normal((2048, 128)).astype(np.float32)
               for _ in range(3))
    return q, k, v, _exact_attention(q, k, v)


def test_split_tf32_passes_meet_the_flash_tolerance(head):
    """The kernel's pass counts meet the float32 FLASH_TOL (5e-5) against
    float64: three and three for float32 inputs, two and two for bf16-valued
    k and v (exact in TF32; bf16 inputs are held to 2e-2, so this is float32
    class). One TF32 pass misses it: a causal row that sees few keys gets
    v's TF32 rounding, 2^-12 relative, almost undiluted."""
    q, k, v, exact = head
    tol = TOL[torch.float32]
    three = _emulated_attention(q, k, v, (3, 3))
    assert _excess(three, exact, tol) <= tol / 10
    kb, vb = (torch.from_numpy(x).bfloat16().float().numpy() for x in (k, v))
    two = _emulated_attention(q, kb, vb, (2, 2))
    assert _excess(two, _exact_attention(q, kb, vb), tol) <= tol / 10
    one = _emulated_attention(q, k, v, (1, 1))
    assert _excess(one, exact, tol) > tol


@pytest.fixture(scope="module", params=[64, 96, 128])
def wgmma_head(request):
    """One causal head at each width of the float32 wgmma instances (64,
    96 and 128) at S = 2,048 from a numpy seed, and its float64 attention
    (Dh 128 the ``head`` fixture's)."""
    dh = request.param
    rng = np.random.default_rng(16 if dh == 128 else dh)
    q, k, v = (rng.standard_normal((2048, dh)).astype(np.float32)
               for _ in range(3))
    return q, k, v, _exact_attention(q, k, v)


def test_wgmma_instance_passes_meet_the_flash_tolerance(wgmma_head):
    """The float32 instances on wgmma (Dh 64, 96 and 128): their split (the
    raw value as big, which the tensor core truncates to TF32; small = x -
    trunc(x), truncated again), one instruction a pass and k8 step, each
    rounded toward zero into its accumulator in the order the kernel
    issues them (QK^T: 3 Dh / 8, 24, 36 or 48, into one over Dh; PV: 12
    into a fresh one a 32-key tile), meet the float32 FLASH_TOL against
    float64 with room to spare, as the mma.sync design's emulation does.
    Without the small parts (one pass, truncated) it misses."""
    q, k, v, exact = wgmma_head
    tol = TOL[torch.float32]
    issued = {"qk": [], "pv": []}
    wgmma = _excess(_emulated_attention(q, k, v, (3, 3), wgmma=True,
                                        issued=issued), exact, tol)
    assert wgmma <= tol / 10
    assert set(issued["qk"]) == {3 * q.shape[1] // 8}
    assert set(issued["pv"]) == {12}
    assert len(issued["qk"]) == len(issued["pv"]) == q.shape[0] // 32
    S, Dh = q.shape
    qs = (q * np.float32(1 / np.sqrt(Dh))).astype(np.float32)
    one = [(_tf32_truncated(qs), _tf32_truncated(k.T))]
    scores = _mma_sum(one).astype(np.float64)
    scores[np.triu_indices(S, 1)] = -np.inf
    w = np.exp(scores - scores.max(1, keepdims=True))
    rough = (w / w.sum(1, keepdims=True)) @ _tf32_truncated(v)
    assert _excess(rough, exact, tol) > tol


def _bf16(x):
    """x rounded to the nearest bf16, as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16() \
        .float().numpy()


def _bf16_wgmma_sum(pairs, issued=None):
    """sum_k a[:, k] b[k, :] as the bf16 wgmma instance adds it into one
    fresh accumulator: one instruction a k16 step and pair (a step's pairs
    in the order given), each adding its products of bf16 values, exact in
    float32, summed exactly, and rounding toward zero. ``issued``: a list
    to which the count of instructions is appended."""
    frag = np.zeros((pairs[0][0].shape[0], pairs[0][1].shape[1]), np.float32)
    count = 0
    for k0 in range(0, pairs[0][0].shape[1], 16):
        for a, b in pairs:
            prod = a[:, k0:k0 + 16].astype(np.float64) @ \
                b[k0:k0 + 16].astype(np.float64)
            frag = _round_toward_zero(frag.astype(np.float64) + prod)
            count += 1
    if issued is not None:
        issued.append(count)
    return frag


def _bf16_wgmma_attention(q, k, v, parts, bk=128, issued=None):
    """flash_attention.cu's bf16 wgmma instance for one causal head on
    bf16-valued q, k and v, before the output's rounding to bf16: QK^T in
    one bf16 pass (Dh / 16 instructions into one fresh accumulator), the
    scale applied to the float32 S; the online softmax in float32 per
    k-tile of ``bk`` keys; P in ``parts`` bf16 parts (hi = bf16(p), lo =
    bf16(p - hi), each remainder exact in float32); PV one instruction a
    k16 step and part into a fresh accumulator a k-tile, added to O with
    one rounding (the kernel's FFMA). ``issued`` (a dict) collects the
    instructions of each k-tile's QK^T ("qk") and PV ("pv")."""
    S, Dh = q.shape
    scale = np.float32(1 / np.sqrt(Dh))
    m = np.full((S, 1), -1e30, np.float32)
    lsum = np.zeros((S, 1), np.float32)
    o = np.zeros((S, Dh), np.float32)
    for k0 in range(0, S, bk):
        r = slice(k0, S)
        s = _bf16_wgmma_sum([(q[r], k[k0:k0 + bk].T)],
                            issued["qk"] if issued else None) * scale
        s[k0 + np.arange(bk)[None, :] > np.arange(k0, S)[:, None]] = -1e30
        mn = np.maximum(m[r], s.max(1, keepdims=True))
        corr = np.exp(m[r] - mn)
        p = np.exp(s - mn)
        lsum[r] = lsum[r] * corr + p.sum(1, keepdims=True, dtype=np.float32)
        m[r] = mn
        split, rest = [], p
        for _ in range(parts):
            split.append(_bf16(rest))
            rest = rest - split[-1]
        part = _bf16_wgmma_sum([(x, v[k0:k0 + bk]) for x in split],
                               issued["pv"] if issued else None)
        o[r] = (o[r].astype(np.float64) * corr + part).astype(np.float32)
    return o / np.maximum(lsum, np.float32(1e-30))


def test_bf16_wgmma_passes_meet_the_flash_tolerance(wgmma_head):
    """The bf16 instances on wgmma (Dh 64, 96 and 128) on bf16 q, k and v:
    QK^T exact in one bf16 pass with the scale after, P in two bf16 parts
    on the same V (one instruction a k16 step and part into a fresh
    accumulator a 128-key tile), meet the float32 FLASH_TOL against
    float64 before the output's rounding to bf16, so the output is the
    reference's function rounded once. P in one bf16 part (2^-9 relative a
    weight, as a flash kernel that rounds P to bf16 computes) misses it."""
    q, k, v = (_bf16(x) for x in wgmma_head[:3])
    exact = _exact_attention(q, k, v)
    tol = TOL[torch.float32]
    issued = {"qk": [], "pv": []}
    two = _excess(_bf16_wgmma_attention(q, k, v, 2, issued=issued), exact, tol)
    assert two <= tol / 10
    S, Dh = q.shape
    assert set(issued["qk"]) == {Dh // 16}
    assert set(issued["pv"]) == {2 * 128 // 16}
    assert len(issued["qk"]) == len(issued["pv"]) == S // 128
    one = _excess(_bf16_wgmma_attention(q, k, v, 1), exact, tol)
    assert one > tol


def test_bf16_wgmma_rounds_as_the_plain_version(wgmma_head):
    """The card tests' hold on the bf16 wgmma instances
    (``flash_attention.bf16_agreement``): the design's output, rounded once
    to bf16, is within one bf16 ulp (plus the float32 FLASH_TOL) of the
    plain version's bf16 output on the same inputs everywhere and equal to
    it on all but at most ``BF16_DIFFER_MAX`` of the entries. P in one
    bf16 part fails both: it differs on tens of percent of the entries,
    some by more than an ulp."""
    q, k, v = (_bf16(x) for x in wgmma_head[:3])
    ref = flash_attention.plain(*(torch.from_numpy(x)[None, :, None]
                                  .bfloat16() for x in (q, k, v)), True)
    tol = TOL[torch.float32]
    got = {}
    for parts in (2, 1):
        out = torch.from_numpy(_bf16_wgmma_attention(q, k, v, parts))
        got[parts] = flash_attention.bf16_agreement(
            out[None, :, None].bfloat16(), ref, tol)
    assert got[2][0] <= flash_attention.BF16_DIFFER_MAX / 2
    assert got[2][1] <= 0
    assert got[1][0] > 10 * flash_attention.BF16_DIFFER_MAX
    assert got[1][1] > 0


@pytest.fixture(scope="module")
def wide_head():
    """One causal head of Dh = 256 at S = 1,024 from a numpy seed, and its
    float64 attention."""
    rng = np.random.default_rng(256)
    q, k, v = (rng.standard_normal((1024, 256)).astype(np.float32)
               for _ in range(3))
    return q, k, v, _exact_attention(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dh256_pair_sum_meets_the_flash_tolerance(wide_head, dtype):
    """The Dh 256 warp pair: each warp's QK^T over its 128 columns of d (16
    k8 steps into one truncating fragment), the two partial scores added in
    float32, meets the float32 FLASH_TOL against float64 with the kernel's
    passes (three, or two for bf16-valued k and v). One fragment over all
    256 columns (32 k8 steps), which the pair avoids for registers, meets
    it too: the emulation puts its excess at about twice the pair's, two
    orders of magnitude inside the tolerance."""
    q, k, v, exact = wide_head
    passes = (3, 3)
    if dtype == "bfloat16":
        k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (k, v))
        exact, passes = _exact_attention(q, k, v), (2, 2)
    tol = TOL[torch.float32]
    pair = _excess(_emulated_attention(q, k, v, passes, halves=2), exact, tol)
    chain = _excess(_emulated_attention(q, k, v, passes, halves=1), exact, tol)
    assert pair <= tol / 10
    assert chain <= tol / 10
    assert pair < chain


def test_pv_needs_a_fresh_fragment_per_k_tile():
    """The MMA's truncating adds, on one 16-row m-tile of P V at the full
    S = 32,768 (4,096 k8 steps): with a fresh fragment per 32-key k-tile,
    added to O with round to nearest (the kernel), the normalised output
    stays far inside FLASH_TOL; one long accumulator drifts toward zero by
    several 1e-4 of it and misses. v has a common offset, as real values
    do, so the output is not a cancelling sum near zero. QK^T sums over
    Dh = 128 only, 16 k8 steps, and needs no fresh fragment: the emulation
    above, which meets the tolerance, includes its truncation."""
    rng = np.random.default_rng(32)
    S, tol = 32_768, TOL[torch.float32]
    p = np.exp(rng.standard_normal((16, S)) - 3).astype(np.float32)
    v = (1 + rng.standard_normal((S, 128))).astype(np.float32)
    lsum = p.astype(np.float64).sum(1, keepdims=True)
    exact = p.astype(np.float64) @ v.astype(np.float64) / lsum
    pairs = _operands((p, v), 3)
    fresh = _mma_sum(pairs, fresh_every=4) / lsum
    long = _mma_sum(pairs) / lsum
    assert _excess(fresh, exact, tol) <= tol / 10
    assert _excess(long, exact, tol) > tol


@pytest.mark.parametrize("product", ["qk", "pv", "pv_wgmma"])
def test_fragment_key_order_gives_the_plain_product(product):
    """The MMA takes its k slots t and t + 4 of each k8 step as the 2t-th
    and (2t+1)-th element (d for QK^T, keys for PV). Building each lane's A
    and B fragments that way, and for PV the A fragment straight from the
    score accumulator's registers (c0, c2, c1, c3), the m16n8k8 product is
    the plain one. ``pv_wgmma``: the wgmma instance's B operand is V^T in
    shared memory as the prologue writes it (``vt_plain``: slot p of a
    group of 8 keys is key ``VT_ORDER[p]``), read K-major: slot p of column
    n is V^T[n, p]; with the same A fragment the product is the plain
    one."""
    rng = np.random.default_rng({"qk": 3, "pv": 4, "pv_wgmma": 5}[product])
    left = rng.standard_normal((16, 8))
    right = rng.standard_normal((8, 8))
    A = np.zeros((16, 8))          # A[row, slot], B[slot, col] as the MMA
    B = np.zeros((8, 8))           # reads them
    if product == "pv_wgmma":
        vt = flash_attention.vt_plain(
            torch.from_numpy(right)[None, :, None, :])[0, 0].numpy()
    for lane in range(32):
        g, t = lane // 4, lane % 4
        if product == "pv_wgmma":
            c = [left[g, 2 * t], left[g, 2 * t + 1], left[g + 8, 2 * t],
                 left[g + 8, 2 * t + 1]]
            A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = \
                c[0], c[2], c[1], c[3]
            B[:, g] = vt[g]
            continue
        if product == "pv":
            # the lane's score registers: (row g, key 2t), (g, 2t + 1),
            # (g + 8, 2t), (g + 8, 2t + 1)
            c = [left[g, 2 * t], left[g, 2 * t + 1], left[g + 8, 2 * t],
                 left[g + 8, 2 * t + 1]]
            a = [c[0], c[2], c[1], c[3]]
        else:
            a = [left[g, 2 * t], left[g + 8, 2 * t], left[g, 2 * t + 1],
                 left[g + 8, 2 * t + 1]]
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a
        B[t, g], B[t + 4, g] = right[2 * t, g], right[2 * t + 1, g]
    np.testing.assert_allclose(A @ B, left @ right, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dh", [16, 64, 96])
def test_vt_plain_is_v_transposed_in_the_fragment_key_order(dh):
    """The prologue's function (``vt_plain``) on a strided view, as the LM
    makes v: V^T[b, g, d, 8 c + p] = v[b, 8 c + VT_ORDER[p], g, d], and
    the order lists slots t and t + 4 as keys 2t and 2t + 1; at whisper's
    and phi3's widths (64, 96) too."""
    rng = np.random.default_rng(8 + dh)
    packed = torch.from_numpy(
        rng.standard_normal((2, 64, 7, dh)).astype(np.float32))
    v = packed[:, :, 5:7]
    vt = flash_attention.vt_plain(v)
    assert vt.shape == (2, 2, dh, 64) and vt.is_contiguous()
    order = flash_attention.VT_ORDER
    assert [order[t] for t in range(4)] == [0, 2, 4, 6]
    assert [order[t + 4] for t in range(4)] == [1, 3, 5, 7]
    for c in range(8):
        for p in range(8):
            assert torch.equal(vt[:, :, :, 8 * c + p],
                               v[:, 8 * c + order[p]])


@pytest.mark.parametrize("dh", [64, 96, 128])
@pytest.mark.parametrize("block", [(64, 32), (64, 64), (128, 32),
                                   (128, 64), (128, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dh128_resolves_and_checks_tiles_by_the_kernel_dtype(
        monkeypatch, block, dtype, dh):
    """At Dh 64, 96 and 128 each dtype runs a wgmma instance, whose one
    tile is (128, bk) with the form's bk (float32 32, bf16 128): the card's
    path through ``ops.flash_attention`` (the launch stood in for by the
    kernel's function) refuses a tile off that menu before a launch, takes
    the one on it, and resolves no config to a tile the kernel's dtype
    lacks."""
    calls = []

    def launch(lib, q, k, v, causal, bq, bk, scale_dh=None, kv_len=None):
        calls.append((q.dtype, bq, bk))
        return flash_attention.plain(q, k, v, causal)

    monkeypatch.setattr(ops, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(ops, "_library", lambda name: None)
    monkeypatch.setattr(flash_attention, "launch", launch)
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _qkv(1, 128, 2, 1, dh, seed=dh))
    cfg = tuning.KernelConfig("flash_attention", block)
    size = torch.empty((), dtype=dtype).element_size()
    wgmma_tile = (128, {4: 32, 2: 128}[size])
    if block in flash_attention.tiles(dh, size):
        ops.flash_attention(q, k, v, config=cfg)
        assert calls == [(dtype, *block)]
    else:
        with pytest.raises(ValueError, match="compiled"):
            ops.flash_attention(q, k, v, config=cfg)
        assert calls == []
    assert (block in flash_attention.tiles(dh, size)) == (block == wgmma_tile)
    got = tuning.lookup("flash_attention", (8, 4096, dh), dtype_bytes=size,
                        backend="cpu")
    assert got.block == wgmma_tile
    assert {c.block for c in tuning.candidate_configs(
        "flash_attention", (8, 4096, dh),
        precision=None if size == 4 else "bf16")} == {wgmma_tile}


@pytest.mark.parametrize("dh", range(1, 257))
def test_every_bf16_width_maps_to_its_instance(dh):
    """Every bf16 width from 1 to 256: its compiled width, whether it runs
    the bf16 wgmma instance (33 to 96 and 113 to 128: the widths that pad
    to 64, 96 or 128) or an mma.sync one, its tiles, threads, shared memory
    within the 232,448 bytes of a CTA and passes, as the float32 width does
    where both run mma.sync."""
    width = flash_attention.tile_width(dh)
    wgmma = 33 <= dh <= 96 or 113 <= dh <= 128
    assert flash_attention.on_wgmma(dh, 2) == wgmma
    assert flash_attention.on_wgmma(dh, 4) == wgmma
    assert flash_attention.design(dh, 2) == ("wgmma" if wgmma else
                                             "mma.sync")
    menu = flash_attention.tiles(dh, 2)
    for bq, bk in menu:
        assert flash_attention.smem_bytes(bq, bk, dh, 2) <= 232_448
    if wgmma:
        form = flash_attention.wgmma_form(dh, 2)
        assert width in (64, 96, 128) and menu == ((128, form.bk),)
        assert form.sets == 0 and form.swizzle == (64 if width == 96 else 128)
        assert flash_attention.threads(128, dh, 2) == 384
        assert flash_attention.PASSES["wgmma", 2] == (1, 2, "bf16")
        assert flash_attention.ctas_per_sm(128, dh, 2) == 1
    else:
        assert menu == flash_attention.tiles(dh, 4) == \
            flash_attention.tiles(width, 2)
        assert all(flash_attention.threads(bq, dh, 2) ==
                   flash_attention.threads(bq, dh, 4) == 2 * bq * (
                       2 if width == 256 else 1) for bq, _ in menu)
    bq, bk = tuning.default_config("flash_attention", (1, 4096, dh), 2).block
    flash_attention.check_tile(bq, bk, dh, 2)


def test_probe_edits_apply_to_the_kernel_source():
    """tools/flash_attention_probe.py builds its variants by editing
    flash_attention.cu's text; each edit must still find what it replaces."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "flash_attention_probe", ROOT / "tools" / "flash_attention_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    text = (ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu").read_text()
    for variant in (probe.no_copies, probe.no_mma, probe.no_split,
                    probe.p_once, probe.qk_ahead):
        assert variant(text) != text
    assert probe.MMA_ASM not in probe.no_mma(text)
    assert probe.REFILL not in probe.no_copies(text)
    assert "0x1000u" not in probe.no_split(text)
    assert probe.SMALL_PART not in probe.no_split(text)
    # the wgmma instances' TMA loads and wgmma instructions: QK^T's
    # m64n32k8 and PV's at each width, m64n128k8, m64n96k8 and m64n64k8
    assert probe.TMA_EXPECT not in probe.no_copies(text)
    assert all(op in text for op in probe.WGMMA_OPS)
    assert not any(op in probe.no_mma(text) for op in probe.WGMMA_OPS)
    assert [f"m64n{n}k8" in op for n, op in
            zip((32, 128, 96, 64), probe.WGMMA_OPS)] == [True] * 4
    # the forms of the Dh 64 and 96 instances: each edits both widths'
    # WForm and leaves Dh 128's; the baseline's widths from its source
    forms = probe.form_variants(text)
    assert forms and all(name.startswith("stages") for name in forms)
    for name, variant in forms.items():
        stages, sets = (int(x) for x in name[len("stages"):].split("_sets"))
        for dh in (64, 96):
            assert probe.FORM.format(dh=dh, stages=stages, sets=sets) in \
                variant
        assert probe.fits(stages, sets, 96)
        assert variant.count("struct WForm<128>") == 1
        assert re.search(r"struct WForm<128> .*", variant)[0] == \
            re.search(r"struct WForm<128> .*", text)[0]
    assert not probe.fits(4, 2, 96) and probe.fits(4, 2, 64)
    assert probe.wgmma_widths(text) == flash_attention.WGMMA_DH
    assert probe.wgmma_widths("constexpr int W_DH = 128, W_BQ = 128; "
                              "flash_attention_f32_wgmma") == (128,)
    assert probe.wgmma_widths("flash_attention_f32(") == ()
    # the bf16 wgmma instances: their m64nNk16 instructions (QK^T's at N =
    # BK, PV's at N = Dh), the second PV pass p_once drops, the QK^T of
    # the next tile that qk_ahead issues before this tile's softmax, and
    # their forms, each as the wrapper's WGMMA_FORMS
    assert probe.wgmma_widths(text, torch.bfloat16) == \
        flash_attention.WGMMA_DH
    assert probe.wgmma_widths(text.replace("flash_attention_bf16_wgmma", ""),
                              torch.bfloat16) == ()
    assert all(op in text for op in probe.BF16_WGMMA_OPS)
    assert not any(op in probe.no_mma(text) for op in probe.BF16_WGMMA_OPS)
    assert probe.PV_LO not in probe.p_once(text)
    assert "(part, a_hi, v_desc, j > 0);" in probe.p_once(text)
    ahead = probe.qk_ahead(text)
    assert probe.QK_NOW not in ahead
    assert ahead.count("issue_qk(s_next, kt + 1);") == 1
    assert ahead.count("s[i] = s_next[i];") == 1
    # the float32 wgmma kernel's body is left as it is
    f32 = slice(text.index("flash_fwd_wgmma("),
                text.index("flash_fwd_wgmma_bf16("))
    assert ahead[f32] == text[f32]
    assert probe.bf16_forms(text) == {
        dh: (form.bk, form.stages, form.swizzle)
        for (size, dh), form in flash_attention.WGMMA_FORMS.items()
        if size == 2}
    bf16_forms = probe.bf16_form_variants(text)
    assert bf16_forms and all(name.startswith("bf16_bk") for name in
                              bf16_forms)
    for name, variant in bf16_forms.items():
        bk, stages = (int(x) for x in name[len("bf16_bk"):].split("_stages"))
        got = probe.bf16_forms(variant)
        for dh, (b, s, sw) in got.items():
            assert sw == probe.bf16_forms(text)[dh][2]
            assert ((b, s) == (bk, stages)) == probe.fits_bf16(bk, stages, dh)
            assert probe.fits_bf16(b, s, dh)
        assert probe.form_variants(variant).keys() == forms.keys()
    assert probe.fits_bf16(128, 3, 128) and not probe.fits_bf16(128, 4, 128)
    assert probe.fits_bf16(128, 4, 96) and not probe.fits_bf16(128, 5, 96)
    for (size, dh), form in flash_attention.WGMMA_FORMS.items():
        if size == 2:
            assert probe.fits_bf16(form.bk, form.stages, dh)
            assert flash_attention.smem_bytes(128, form.bk, dh, 2) <= 232_448
