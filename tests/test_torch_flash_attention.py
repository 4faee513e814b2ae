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
])
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
    q = torch.zeros(1, 100, 2, 32)
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


@pytest.mark.parametrize("bq,bk,dh", [(64, 64, 48), (32, 64, 64),
                                      (64, 16, 64), (128, 256, 128)])
def test_uncompiled_tiles_are_refused_before_a_launch(bq, bk, dh):
    """What the CUDA branch checks before it launches: a head width or a
    (clamped) block the source does not compile raises, naming the menu."""
    with pytest.raises(ValueError, match="compiled"):
        flash_attention.check_tile(bq, bk, dh)


def test_compiled_tiles_fit_shared_memory():
    for bq in flash_attention.BLOCK_Q:
        for bk in flash_attention.BLOCK_K:
            for dh in flash_attention.HEAD_DIMS:
                flash_attention.check_tile(bq, bk, dh)
                assert flash_attention.smem_bytes(bq, bk, dh) <= \
                    tuning.SMEM_BUDGET_BYTES


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
    assert int(res.stdout.split()[-1]) >= 20


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
