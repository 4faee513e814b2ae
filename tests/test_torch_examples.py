"""The five examples' twins over the port (examples/*_torch.py) against the
originals, on the CPU at a tiny size.

* quickstart: ``make_pair`` draws ``jax.random.normal``'s values (an ulp
  or two apart, a draw near erf_inv's branch point within 1e-3: at most
  0.1% of them; tests/test_torch_models.py); ``run`` on one numpy pair
  against the original's calls: SMP-PCA's U V^T within UVT_RTOL, the
  printed errors within ERR_RTOL.
* streaming: the twin's pass over ``cooccurrence_stream`` against the JAX
  ``StreamingSummarizer``'s (each column within STATE_RTOL of its largest
  entry, tests/test_torch_streaming.py), the restored checkpoint equal to
  the saved state bit for bit, the spectral error within ERR_RTOL.
* gradient_compression and train_lm: the losses within HISTORY_TOL of the
  original's (tests/test_torch_training.py); train_lm's preset shrunk in
  both modules so that the scripts run as written.
* serve_lm: both scripts run as written, in float32 compute, the twin on
  the original's parameters (``convert.lm_params_from_numpy``): the same
  prompts and tokens, greedy and at temperature 0.8; the sketch session's
  rows and shapes, U V^T within UVT_RTOL.
* No twin imports jax or repro, and each defaults to the card.

Every jax call runs under the classic key tree with a fresh pipeline
engine (the shared one caches executables regardless of the flag).
"""
import ast
import contextlib
import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jax_core
from repro.core import pipeline as jax_pipeline
from repro.core import streaming as jax_streaming
from repro.configs import get_config as jax_get_config
from repro_torch import convert, prng
from repro_torch.configs import get_config
from repro_torch import core as port_core
from repro_torch.data.pipeline import cooccurrence_stream

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TWINS = ("quickstart", "streaming_cooccurrence", "gradient_compression",
         "train_lm", "serve_lm")
# U V^T of port and JAX on the same key (tests/test_torch_exports.py).
UVT_RTOL = 1e-3
# Relative spectral errors computed from those factors.
ERR_RTOL = 1e-3
STATE_RTOL = 1e-5
HISTORY_TOL = 1e-3


def load(stem):
    """An example as a module (its ``main`` guarded, not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{stem}", EXAMPLES / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def classic_keys():
    with jax.threefry_partitionable(False), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pipeline, "_DEFAULT_ENGINE",
                   jax_pipeline.PipelineEngine())
        yield


def uvt(factors):
    return np.asarray(factors.U @ factors.V.T)


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: these tiny ops lose more to thread hand-offs
    than they gain beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# imports and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stem", TWINS)
def test_twin_imports_neither_jax_nor_repro(stem):
    tree = ast.parse((EXAMPLES / f"{stem}_torch.py").read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    roots = {n.split(".")[0] for n in names}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)


@pytest.mark.parametrize("stem", TWINS)
def test_twin_defaults_to_the_card(stem, monkeypatch):
    """With no ``--device`` a twin asks for the card and, without one,
    raises; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(f"{stem}_torch").main([])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_pair_draws_the_jax_normals():
    d, n = 400, 40
    A, B = load("quickstart_torch").make_pair(prng.PRNGKey(0), d, n, "cpu")
    with classic_keys():
        key = jax.random.PRNGKey(0)
        D = jnp.diag(1.0 / jnp.arange(1.0, n + 1.0))
        jA = jax.random.normal(key, (d, n)) @ D
        jB = jA + 0.3 * jax.random.normal(jax.random.fold_in(key, 1),
                                          (d, n)) @ D
    for got, want in ((A, jA), (B, jB)):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= 1e-3
        assert np.mean(diff > 1e-6) <= 1e-3


def test_quickstart_run_matches_the_original_calls(capsys):
    d, n, r, k, T = 400, 40, 5, 64, 8
    m = int(10 * n * r * math.log(n))
    rng = np.random.default_rng(0)
    D = (1.0 / np.arange(1.0, n + 1.0)).astype(np.float32)
    A = rng.standard_normal((d, n)).astype(np.float32) * D
    B = A + 0.3 * rng.standard_normal((d, n)).astype(np.float32) * D
    got = load("quickstart_torch").run(
        torch.from_numpy(A), torch.from_numpy(B), prng.PRNGKey(0), r, k, m,
        T, "scan", "cpu")
    lines = capsys.readouterr().out.splitlines()
    with classic_keys():
        key = jax.random.PRNGKey(0)
        jA, jB = jnp.asarray(A), jnp.asarray(B)
        res = jax_core.smppca(key, jA, jB, r=r, k=k, m=m, T=T, backend="scan")
        summary = jax_core.build_summary(key, jA, jB, k, backend="scan")
        est = jax_core.estimate_product(
            jax.random.fold_in(key, 2), summary, r, method="rescaled_jl",
            backend="jit", m=m, T=T)
        err, opt = jax_core.spectral_error_vs_optimal(jA, jB, r, res.factors)
        sf = jax_core.sketch_svd(key, jA, jB, r=r, k=k)
        err_svd, _ = jax_core.spectral_error_vs_optimal(jA, jB, r, sf)
    assert lines[0] == f"summary: sketches {summary.A_sketch.shape} + " \
        f"{summary.n1 + summary.n2} norms"
    assert lines[1] == f"estimate_product factors: U {est.factors.U.shape}, " \
        f"V {est.factors.V.shape}"
    assert lines[4] == f"factors: U {res.factors.U.shape}, " \
        f"V {res.factors.V.shape}"
    assert rel(uvt(got["result"].factors), uvt(res.factors)) < UVT_RTOL
    assert rel(uvt(got["estimate"].factors), uvt(est.factors)) < UVT_RTOL
    for name, want in (("err", err), ("opt", opt), ("err_svd", err_svd)):
        assert abs(got[name] - float(want)) <= ERR_RTOL * float(want), name
    assert got["opt"] <= got["err"] < got["err_svd"]


# ---------------------------------------------------------------------------
# streaming_cooccurrence
# ---------------------------------------------------------------------------

def test_streaming_pass_matches_the_jax_summarizer(tmp_path, capsys):
    d, n1, n2, rank, k, chunk = 1024, 60, 40, 4, 32, 128
    tw = load("streaming_cooccurrence_torch")
    key = prng.PRNGKey(0)
    summary, rows, (saved, restored) = tw.stream(
        key, d, n1, n2, rank, k, chunk, str(tmp_path), "cpu")
    assert rows == d
    assert capsys.readouterr().out.splitlines() == [
        f"checkpointed + restored at {d // 2} rows"]
    for name, x, y in zip(saved._fields, saved, restored):
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), name
    m = int(10 * max(n1, n2) * rank * math.log(max(n1, n2)))
    res = port_core.smppca_from_summary(key, summary, r=rank, m=m, T=8,
                                          device="cpu")
    A, B = tw.ground_truth(d, n1, n2, rank, "cpu")
    err, opt = port_core.spectral_error_vs_optimal(A, B, rank, res.factors)

    with classic_keys():
        jkey = jax.random.PRNGKey(0)
        summ = jax_streaming.StreamingSummarizer(k=k)
        state = summ.init(jkey, (d, n1, n2))
        for row_ids, A_rows, B_rows in cooccurrence_stream(
                seed=0, d=d, n1=n1, n2=n2, rank=rank, chunk=chunk):
            state = summ.update_rows(state, jnp.asarray(row_ids),
                                     jnp.asarray(A_rows), jnp.asarray(B_rows))
        want = summ.finalize(state)
        jres = jax_core.smppca_from_summary(jkey, want, r=rank, m=m, T=8)
        jerr, jopt = jax_core.spectral_error_vs_optimal(
            jnp.asarray(A.numpy()), jnp.asarray(B.numpy()), rank,
            jres.factors)
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        g = getattr(summary, name).numpy()
        w = np.asarray(getattr(want, name))
        scale = np.abs(w).max(axis=0, keepdims=True) if w.ndim == 2 \
            else np.abs(w).max()
        assert np.all(np.abs(g - w) <= STATE_RTOL * scale), name
    assert rel(uvt(res.factors), uvt(jres.factors)) < UVT_RTOL
    assert abs(float(err) - float(jerr)) <= ERR_RTOL * float(jerr)
    assert abs(float(opt) - float(jopt)) <= ERR_RTOL * float(jopt)


# ---------------------------------------------------------------------------
# gradient_compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "taps"])
def test_gradient_compression_losses_match_the_original(mode):
    got = load("gradient_compression_torch").run(mode, 3, device="cpu")
    with classic_keys():
        want = load("gradient_compression").run(mode, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=HISTORY_TOL)


def test_gradient_compression_lowrank_runs():
    tw = load("gradient_compression_torch")
    none = tw.run("none", 1, device="cpu")
    low = tw.run("lowrank", 2, device="cpu")
    assert len(low) == 2 and low[0] == none[0]
    assert all(math.isfinite(x) for x in low)


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

# (d_model, heads, kv, d_ff, layers, batch, seq): 2 sequences of 32 in
# the two microbatches
TINY_PRESET = (64, 4, 4, 128, 2, 2, 32)


def test_train_lm_matches_the_original(tmp_path, monkeypatch, capsys):
    tw, orig = load("train_lm_torch"), load("train_lm")
    for mod in (tw, orig):
        monkeypatch.setitem(mod.PRESETS, "20m", TINY_PRESET)
    got = tw.main(["--steps", "2", "--ckpt-dir", str(tmp_path / "torch"),
                   "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "2",
                                      "--ckpt-dir", str(tmp_path / "jax")])
    with classic_keys():
        orig.main()
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got["steps"] == want["steps"] == 2
    for name in ("loss_first", "loss_last"):
        assert abs(got[name] - want[name]) <= HISTORY_TOL, name
    assert (tmp_path / "torch").is_dir()


def test_train_lm_checkpoints_apart_from_the_original(
        tmp_path, monkeypatch, capsys):
    """The port's checkpoints keep the JAX layout: one default directory
    for both would resume one package's run from the other's. The twin's
    is repro_torch_train_lm in the temporary directory."""
    tw = load("train_lm_torch")
    monkeypatch.setitem(tw.PRESETS, "20m", TINY_PRESET)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    tw.main(["--steps", "2", "--device", "cpu"])
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["repro_torch_train_lm"]
    assert (tmp_path / "repro_torch_train_lm" / "step_00000002").is_dir()
    assert '"--ckpt-dir", default="/tmp/repro_train_lm"' in \
        (EXAMPLES / "train_lm.py").read_text()


def test_train_lm_rerun_past_its_steps_stops(tmp_path, monkeypatch, capsys):
    """A second run into one directory resumes at the first's last step:
    with nothing left to train it says so instead of printing a line."""
    tw = load("train_lm_torch")
    monkeypatch.setitem(tw.PRESETS, "20m", TINY_PRESET)
    argv = ["--steps", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    tw.main(argv)
    capsys.readouterr()
    with pytest.raises(SystemExit, match="holds step 2, at or past --steps 2"):
        tw.main(argv)
    assert capsys.readouterr().out.splitlines()[-1].startswith("model: ")


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------

def f32(get):
    return lambda name: dataclasses.replace(get(name),
                                            compute_dtype="float32")


def run_original(monkeypatch, capsys, argv):
    """The original script as written, in float32 compute; returns what
    its Engine and SketchService saw and made, and its lines."""
    orig = load("serve_lm")
    seen = {}

    class Engine(orig.Engine):
        def generate(self, batch):
            out = super().generate(batch)
            seen.update(params=self.params, batch=batch, tokens=out)
            return out

    class SketchService(orig.SketchService):
        def stream_factors(self, *a, **kw):
            seen["sketch"] = super().stream_factors(*a, **kw)
            return seen["sketch"]

    monkeypatch.setattr(orig, "get_config", f32(jax_get_config))
    monkeypatch.setattr(orig, "Engine", Engine)
    monkeypatch.setattr(orig, "SketchService", SketchService)
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"] + argv)
    with classic_keys():
        orig.main()
        seen = jax.tree.map(np.asarray, seen)
    return seen, capsys.readouterr().out.splitlines()


def run_twin(monkeypatch, capsys, argv, params):
    """The twin as written, in float32 compute, on the original's
    parameters; returns its result and lines."""
    tw = load("serve_lm_torch")
    real_build = tw.build

    def build(cfg, device):
        model = real_build(cfg, device=device)

        class Loaded(type(model)):
            def init_params(self, key):
                return convert.lm_params_from_numpy(params, self.cfg,
                                                    self.device)
        return Loaded(model.cfg, model.device)

    monkeypatch.setattr(tw, "get_config", f32(get_config))
    monkeypatch.setattr(tw, "build", build)
    out = tw.main(argv + ["--device", "cpu"])
    return out, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "recurrentgemma-9b"])
@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_serve_lm_tokens_equal_the_original(arch, temperature, monkeypatch,
                                           capsys):
    argv = ["--arch", arch, "--temperature", temperature]
    want, want_lines = run_original(monkeypatch, capsys, argv)
    got, lines = run_twin(monkeypatch, capsys, argv, want["params"])
    assert np.array_equal(got["tokens"][:, :32].numpy(),
                          want["batch"]["tokens"])
    assert np.array_equal(got["tokens"].numpy(), want["tokens"])
    assert lines == want_lines


def test_serve_lm_sketch_session_matches_the_original(monkeypatch, capsys):
    argv = ["--sketch-demo", "--batch", "1", "--prompt-len", "8",
            "--new-tokens", "2"]
    want, want_lines = run_original(monkeypatch, capsys, argv)
    got, lines = run_twin(monkeypatch, capsys, argv, want["params"])
    assert lines[-1] == want_lines[-1] == \
        "sketch session: 2048 rows -> factors U(96, 4) V(96, 4)"
    assert rel(uvt(got["sketch"].factors), uvt(want["sketch"].factors)) \
        < UVT_RTOL
