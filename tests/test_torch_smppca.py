"""The port's whole slice against the JAX package, and the port's rules.

* ``smppca(device="cpu")`` against the JAX ``smppca`` (Pallas sketch, jit
  estimation) on the same key and a numpy-made planted pair;
* the port meets the JAX suite's own error bound
  (``test_smppca_recovers_correlated_product``);
* the probe-residual threshold of ``chip_smoke.py`` holds for the JAX
  package at this size;
* the port and ``chip_smoke.py`` import neither jax nor the JAX package;
* the entry points run on CUDA by default and raise without a card.

Every jax call runs under the classic key tree
(``jax.threefry_partitionable(False)``), with a fresh PipelineEngine so
that no executable cached under another key-tree mode is reused.
"""
import ast
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline
from repro_torch import convert, prng
from repro_torch.core.smppca import smppca, spectral_error_vs_optimal
from repro_torch.core.types import LowRankFactors

REPO = pathlib.Path(__file__).resolve().parents[1]
D, N, K, R, T = 2000, 200, 512, 5, 8
M = int(10 * N * R * np.log(N))
# U V^T of port and JAX on the same key: identical keys and samples (up to
# a rare inverse-CDF tie), float32 sums in other orders; 1e-3 relative
# Frobenius leaves two orders of magnitude over what the two differ by.
SLICE_RTOL = 1e-3


def planted_pair_np(seed, d, n, corr=0.3):
    """tests/conftest.py::planted_pair (decay 1) with numpy draws."""
    rng = np.random.default_rng(seed)
    D_ = (1.0 / np.arange(1.0, n + 1.0)).astype(np.float32)
    A = rng.standard_normal((d, n)).astype(np.float32) * D_
    B = A + corr * rng.standard_normal((d, n)).astype(np.float32) * D_
    return A, B


def probe_residual(A, B, U, V, seed=1):
    """||(A^T B - U V^T) W||_F / ||A^T B W||_F with W (n2, 8) Gaussian, in
    float64: the quantity chip_smoke.py checks at full width."""
    W = np.random.default_rng(seed).standard_normal((B.shape[1], 8))
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    AtBW = A.T @ (B @ W)
    E = AtBW - np.asarray(U, np.float64) @ (np.asarray(V, np.float64).T @ W)
    return np.linalg.norm(E) / np.linalg.norm(AtBW)


@pytest.fixture(scope="module")
def slice_runs():
    A, B = planted_pair_np(0, D, N)
    with jax.threefry_partitionable(False):
        plan = pipeline.smppca_plan(r=R, k=K, m=M, T=T, backend="pallas",
                                    est_backend="jit")
        jres = pipeline.PipelineEngine().run(plan, jax.random.PRNGKey(0),
                                             jnp.asarray(A), jnp.asarray(B))
        jax_factors = LowRankFactors(*(np.asarray(x)
                                       for x in jres.estimate.factors))
        jax_rows = np.asarray(jres.estimate.samples.rows)
    port = smppca(prng.PRNGKey(0), torch.from_numpy(A), torch.from_numpy(B),
                  r=R, k=K, m=M, T=T, device="cpu")
    return A, B, jax_factors, jax_rows, port


def test_smppca_matches_jax(slice_runs):
    A, B, jf, jax_rows, port = slice_runs
    assert (port.samples.rows.numpy() == jax_rows).mean() >= 0.999
    want = jf.U @ jf.V.T
    got = (port.factors.U @ port.factors.V.T).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < SLICE_RTOL
    assert port.summary.A_sketch.shape == (K, N)
    assert port.sampled_values.shape == (M,)


def test_smppca_recovers_correlated_product(slice_runs):
    """The JAX suite's bound (tests/core/test_waltmin_smppca.py), met by
    the port at the same size."""
    A, B, _, _, port = slice_runs
    err, opt = spectral_error_vs_optimal(torch.from_numpy(A),
                                         torch.from_numpy(B), R, port.factors)
    assert float(err) < 3.0 * float(opt) + 0.05, (float(err), float(opt))


# smppca(precision='bf16') at a tiny size: both packages round Pi, A and B
# to bf16 and sum the exact products in float32, in other orders, so the
# sketches differ by float32 rounding (a few 1e-7 relative) and the
# estimate moves with them through WAltMin; 1e-3 relative Frobenius, as
# the float32 slice above, leaves two orders of magnitude over that. The
# JAX side runs its reference sketch backend, the same function as its
# Pallas kernel: XLA:CPU has no bf16 x bf16 = float32 dot for the kernel's
# interpret mode inside the jitted pipeline.
BF16_D, BF16_N, BF16_K, BF16_R, BF16_T = 400, 60, 64, 3, 6
BF16_M = int(10 * BF16_N * BF16_R * np.log(BF16_N))


@pytest.fixture(scope="module")
def bf16_runs():
    A, B = planted_pair_np(2, BF16_D, BF16_N)
    with jax.threefry_partitionable(False):
        plan = pipeline.smppca_plan(r=BF16_R, k=BF16_K, m=BF16_M, T=BF16_T,
                                    backend="reference", est_backend="jit",
                                    precision="bf16")
        jres = pipeline.PipelineEngine().run(plan, jax.random.PRNGKey(1),
                                             jnp.asarray(A), jnp.asarray(B))
        jax_factors = LowRankFactors(*(np.asarray(x)
                                       for x in jres.estimate.factors))
        jax_sketch = np.asarray(jres.summary.A_sketch)
        jax_rows = np.asarray(jres.estimate.samples.rows)
    port = smppca(prng.PRNGKey(1), torch.from_numpy(A), torch.from_numpy(B),
                  r=BF16_R, k=BF16_K, m=BF16_M, T=BF16_T, precision="bf16",
                  device="cpu")
    return jax_factors, jax_sketch, jax_rows, port


def test_smppca_bf16_matches_jax(bf16_runs):
    jf, jax_sketch, jax_rows, port = bf16_runs
    sketch = port.summary.A_sketch.numpy()
    assert sketch.dtype == np.float32
    np.testing.assert_allclose(sketch, jax_sketch, rtol=0,
                               atol=1e-5 * np.abs(jax_sketch).max())
    assert (port.samples.rows.numpy() == jax_rows).mean() >= 0.999
    want = jf.U @ jf.V.T
    got = (port.factors.U @ port.factors.V.T).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < SLICE_RTOL


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_threshold_holds_for_jax(slice_runs):
    """chip_smoke.py's full-width probe-residual threshold is derived from
    the JAX package here: its residual must stay below half of it, and the
    port's residual agrees with it."""
    A, B, jf, _, port = slice_runs
    bound = _chip_smoke().PROBE_RESIDUAL_MAX
    jax_resid = probe_residual(A, B, jf.U, jf.V)
    port_resid = probe_residual(A, B, port.factors.U.numpy(),
                                port.factors.V.numpy())
    assert jax_resid < bound / 2, jax_resid
    assert abs(port_resid - jax_resid) < 1e-3 * jax_resid


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert files, "no port sources found"
    return files + [REPO / "chip_smoke.py"]


def _forbidden_imports(source: str):
    """Imported module names that belong to jax or to the JAX package."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [name for name in names
                if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    return bad


def test_port_imports_no_jax_and_no_reference_package():
    bad = {str(path.relative_to(REPO)): _forbidden_imports(path.read_text())
           for path in _port_files()}
    assert {path: names for path, names in bad.items() if names} == {}


def test_import_check_catches_offenders():
    source = ("import jax.numpy as jnp\nfrom repro.core import sketch\n"
              "from repro_torch import prng\nimport repro_torch.core\n"
              "def f():\n    import jaxlib\n")
    assert _forbidden_imports(source) == ["jax.numpy", "repro.core", "jaxlib"]


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    """The entry points default to CUDA; without a card they raise instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, B = torch.randn(16, 4), torch.randn(16, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smppca(prng.PRNGKey(0), A, B, r=1, k=4, m=10, T=1)
    from repro_torch.core import estimation_engine, summary_engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        summary_engine.build_summary(prng.PRNGKey(0), A, B, 4)
    summary = summary_engine.build_summary(prng.PRNGKey(0), A, B, 4,
                                           device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        estimation_engine.estimate_product(prng.PRNGKey(0), summary, 1, m=10)


def test_wrappers_refuse_devices_without_a_kernel():
    from repro_torch.kernels import ops
    meta = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.sketch_fused(meta, meta)
    with pytest.raises(ValueError, match="several devices"):
        ops.sketch_fused(torch.zeros(4, 4), meta)


def test_keys_and_factors_convert_both_ways_exactly():
    with jax.threefry_partitionable(False):
        keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 4))
    np.testing.assert_array_equal(
        convert.key_to_numpy(convert.key_from_numpy(keys)), keys)
    with pytest.raises(ValueError):
        convert.key_from_numpy(keys.astype(np.int32))
    f = (np.random.default_rng(0).standard_normal((7, 2)).astype(np.float32),
         np.random.default_rng(1).standard_normal((5, 2)).astype(np.float32))
    back = convert.factors_to_numpy(convert.factors_from_numpy(f))
    for x, y in zip(back, f):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
