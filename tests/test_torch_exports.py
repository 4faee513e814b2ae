"""The port's public surface against the JAX package's, and the three faults
of the port repaired with it:

* ``repro_torch.core`` exports every name ``repro.core`` exports (both
  ``__init__`` files parsed, no list of exceptions), and the reference's own
  usage (examples/quickstart.py's calls, copied here at a tiny size) runs
  against the port on the CPU;
* the spectral-error helpers take their norms from ``core/linalg.py``;
* ``prng.random_bits`` splits the key into blocks past ``_BLOCK`` elements
  as jax's classic path does, bit for bit (on a small stand-in block).
"""
import ast
import importlib
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jax_core
from repro.kernels import ops as jax_ops
from repro_torch import convert, prng
from repro_torch import core
from repro_torch.core import estimation_engine, linalg, summary_engine
from repro_torch.kernels import ops

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
# U V^T of port and JAX on the same key: identical keys and samples up to
# a rare inverse-CDF tie (tests/test_torch_smppca.py's SLICE_RTOL).
UVT_RTOL = 1e-3


def exported(package: str) -> set:
    """The names a package's ``__init__`` imports (its public names)."""
    tree = ast.parse((SRC / package / "__init__.py").read_text())
    return {alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names}


# ---------------------------------------------------------------------------
# the exports
# ---------------------------------------------------------------------------

def test_port_exports_every_name_of_repro_core():
    want = exported("repro/core")
    got = exported("repro_torch/core")
    assert len(want) == 105
    assert want <= got, sorted(want - got)
    assert all(hasattr(core, name) for name in want)


def test_core_names_are_the_functions():
    """``core.smppca``, ``core.lela`` and ``core.waltmin`` are the
    functions, as in ``repro.core``, not the modules of the same names."""
    for name in ("smppca", "lela", "waltmin", "build_summary",
                 "distributed_smppca", "identity_product_summary"):
        assert callable(getattr(core, name)), name
        assert callable(getattr(jax_core, name)), name
    assert importlib.import_module("repro_torch.core.smppca").smppca is \
        core.smppca


def test_quickstart_calls_run_on_the_cpu():
    """examples/quickstart.py's calls at a tiny size against the port
    (``est_backend``/``backend`` are the port's: 'reference' for the eager
    oracle), and its SMP-PCA against the JAX package's on the same key."""
    d, n, r = 400, 40, 3
    rng = np.random.default_rng(0)
    D = (1.0 / np.arange(1.0, n + 1.0)).astype(np.float32)
    A = rng.standard_normal((d, n)).astype(np.float32) * D
    B = A + 0.3 * rng.standard_normal((d, n)).astype(np.float32) * D
    m = int(10 * n * r * math.log(n))
    key = prng.PRNGKey(0)
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)
    result = core.smppca(key, tA, tB, r=r, k=64, m=m, T=8, backend="scan",
                         device="cpu")
    summary = core.build_summary(key, tA, tB, 64, backend="scan",
                                 device="cpu")
    assert tuple(summary.A_sketch.shape) == (64, n)
    assert summary.n1 + summary.n2 == 2 * n
    est = core.estimate_product(prng.fold_in(key, 2), summary, r,
                                method="rescaled_jl", backend="reference",
                                m=m, T=8, device="cpu")
    assert tuple(est.factors.U.shape) == (n, r)
    err, opt = core.spectral_error_vs_optimal(tA, tB, r, result.factors)
    assert 0 < float(opt) <= float(err) < 1
    sf = core.sketch_svd(key, tA, tB, r=r, k=64, device="cpu")
    err_svd, _ = core.spectral_error_vs_optimal(tA, tB, r, sf)
    assert math.isfinite(float(err_svd))
    with jax.threefry_partitionable(False):
        jres = jax_core.smppca(jax.random.PRNGKey(0), jnp.asarray(A),
                               jnp.asarray(B), r=r, k=64, m=m, T=8,
                               backend="scan")
        want = np.asarray(jres.factors.U @ jres.factors.V.T)
    got = (result.factors.U @ result.factors.V.T).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < UVT_RTOL


def test_backend_and_estimator_registries():
    """The lists the JAX suite reads (tests/core/test_summary_engine.py,
    test_estimation_engine.py), and a registration round trip."""
    assert set(summary_engine.backends()) >= set(summary_engine.BACKENDS) \
        | {"distributed"}
    cells = set(estimation_engine.estimators())
    assert {(m, b) for m in estimation_engine.METHODS
            for b in estimation_engine.BACKENDS} <= cells
    key = prng.PRNGKey(0)
    A, B = torch.randn(32, 5), torch.randn(32, 4)

    @summary_engine.register_backend("test_twice_reference")
    def _twice(key, A, B, k, *, method, block, precision, configs):
        s = summary_engine._BACKENDS["reference"](
            key, A, B, k, method=method, block=block, precision=precision)
        return s._replace(A_sketch=2 * s.A_sketch)

    @estimation_engine.register_estimator("direct_svd", "test_cell")
    def _cell(key, summary, r, **kw):
        return estimation_engine._REGISTRY[("direct_svd", "reference")](
            key, summary, r, **kw)

    try:
        assert "test_twice_reference" in summary_engine.backends()
        s = summary_engine.build_summary(key, A, B, 8,
                                         backend="test_twice_reference",
                                         device="cpu")
        ref = summary_engine.build_summary(key, A, B, 8, device="cpu")
        assert torch.equal(s.A_sketch, 2 * ref.A_sketch)
        got = estimation_engine.estimate_product(
            key, ref, 2, method="direct_svd", backend="test_cell",
            device="cpu")
        want = estimation_engine.estimate_product(
            key, ref, 2, method="direct_svd", backend="reference",
            device="cpu")
        assert torch.equal(got.factors.U, want.factors.U)
    finally:
        del summary_engine._BACKENDS["test_twice_reference"]
        del estimation_engine._REGISTRY[("direct_svd", "test_cell")]
    with pytest.raises(ValueError, match="backend"):
        estimation_engine.estimate_product(key, ref, 2, backend="nope",
                                           device="cpu")


def test_waltmin_reference_is_waltmin():
    """The eager oracle of the JAX package is the port's (eager)
    ``waltmin``: the same factors, bit for bit."""
    key = prng.PRNGKey(3)
    A, B = torch.randn(64, 12), torch.randn(64, 10)
    s = core.build_summary(key, A, B, 16, device="cpu")
    samples = core.sample_entries(key, s.norm_A, s.norm_B, 400)
    values = core.rescaled_entries(s, samples.rows, samples.cols)
    a = core.waltmin(key, samples, values, 12, 10, 2, 3, norm_A=s.norm_A)
    b = core.waltmin_reference(key, samples, values, 12, 10, 2, 3,
                               norm_A=s.norm_A)
    assert torch.equal(a.U, b.U) and torch.equal(a.V, b.V)


def test_sketch_summary_fused_matches_core():
    """The twin of tests/kernels/test_kernels.py's: the kernel-backed
    summary is the ``cuda`` backend's (on the CPU its plain versions), with
    exact column norms, and the JAX package's to tolerance."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((500, 60)).astype(np.float32)
    B = rng.standard_normal((500, 40)).astype(np.float32)
    key = prng.PRNGKey(0)
    s = ops.sketch_summary_fused(key, torch.from_numpy(A),
                                 torch.from_numpy(B), k=32, device="cpu")
    np.testing.assert_allclose(s.norm_A.numpy(), np.linalg.norm(A, axis=0),
                               rtol=1e-4)
    assert tuple(s.A_sketch.shape) == (32, 60)
    assert tuple(s.B_sketch.shape) == (32, 40)
    ref = summary_engine.build_summary(key, torch.from_numpy(A),
                                       torch.from_numpy(B), 32,
                                       backend="cuda", device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(s[:4], ref[:4]))
    with jax.threefry_partitionable(False):
        want = jax_ops.sketch_summary_fused(jax.random.PRNGKey(0),
                                            jnp.asarray(A), jnp.asarray(B),
                                            k=32)
    scale = np.abs(np.asarray(want.A_sketch)).max(axis=0)
    assert np.all(np.abs(s.A_sketch.numpy() - np.asarray(want.A_sketch))
                  <= 1e-5 * scale)


# ---------------------------------------------------------------------------
# spectral norms through core/linalg.py
# ---------------------------------------------------------------------------

def test_spectral_norm_keeps_the_cpu_bits():
    """On the CPU ``linalg.spectral_norm`` is ``matrix_norm(ord=2)``, so the
    spectral-error helpers keep their bits there."""
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.standard_normal((60, 12)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((60, 9)).astype(np.float32))
    M = A.T @ B
    assert torch.equal(linalg.spectral_norm(M),
                       torch.linalg.matrix_norm(M, ord=2))
    f = core.optimal_rank_r(A, B, 2, device="cpu")
    want = (torch.linalg.matrix_norm(M - f.U @ f.V.T, ord=2)
            / torch.linalg.matrix_norm(M, ord=2))
    assert torch.equal(core.spectral_error(A, B, f), want)
    err, opt = core.spectral_error_vs_optimal(A, B, 2, f)
    torch.testing.assert_close(err, opt, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# random bits past one block of counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [2500, 2000, 999])
def test_random_bits_block_split_matches_jax(monkeypatch, size):
    """With ``_BLOCK`` cut to 1,000: ``split(key, nblocks + 1)``, full
    blocks of 1,000 counts under each of the first subkeys, the remainder
    under the last, concatenated, as jax's classic
    ``_threefry_random_bits_original`` builds it (composed here from jax's
    public API); a draw within one block is unchanged."""
    monkeypatch.setattr(prng, "_BLOCK", 1000)
    nblocks, rem = divmod(size, 1000)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(42)
        if nblocks:
            subkeys = jax.random.split(key, nblocks + 1)
            want = np.concatenate(
                [np.asarray(jax.random.bits(subkeys[i], (1000,)))
                 for i in range(nblocks)]
                + [np.asarray(jax.random.bits(subkeys[nblocks], (rem,)))])
        else:
            want = np.asarray(jax.random.bits(key, (size,)))
    got = prng.random_bits(convert.key_from_numpy(np.asarray(key)), (size,))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_random_bits_block_split_with_a_key_stack(monkeypatch):
    """A (t, 2) key stack splits each key alike; the shape is kept."""
    monkeypatch.setattr(prng, "_BLOCK", 1000)
    keys = prng.split(prng.PRNGKey(1), 3)
    got = prng.random_bits(keys, (50, 50))
    assert tuple(got.shape) == (3, 50, 50)
    for i in range(3):
        assert torch.equal(got[i], prng.random_bits(keys[i], (50, 50)))
    whole = prng.random_bits(keys[0], (2500,))
    assert torch.equal(got[0].reshape(-1), whole)


def test_multihost_doctests_run():
    """``dist/multihost.py``'s examples (one process: ``initialize`` a
    no-op, ``sharded_ingest`` the local pass) run as written."""
    import doctest

    from repro_torch.dist import multihost
    result = doctest.testmod(multihost)
    assert result.attempted >= 6 and result.failed == 0
