"""The port's training substrate against the JAX package's: the twins of
tests/train/test_training.py's optimizer, trainer and data tests, held
against the reference where it can be.

* ``warmup_cosine`` and ``constant`` equal the JAX schedules bit for bit.
* ``AdamW.update`` on the same gradients, parameters and state (converted
  from JAX) equals JAX's leaf by leaf within ADAMW_TOL, float32 and bf16
  moments, with and without clipping.
* ``SyntheticLM.batch`` equals JAX's bit for bit.
* One ``train_step`` of reduced phi3-mini in float32 compute, 2
  microbatches, from the same ``TrainState`` (``convert.
  train_state_from_numpy``): loss and ``grad_norm`` within STEP_RTOL
  relative, and the gradients the update reads (after compression) within
  STEP_RTOL of each leaf's largest entry, for ``none``, ``lowrank`` and
  ``taps``. The step's update is not compared leaf by leaf: AdamW's first
  step moves each entry by about lr * sign(g), so an entry whose gradient
  is float32 noise moves by 2 lr between the packages.
* Tapped reconstructions: both packages draw the same samples but the
  inverse-CDF sampler may move a rare sample (a float32 tie; ROADMAP
  Queue 3), which moves a rank-8 reconstruction through WAltMin:
  TAP_RTOL of the leaf's largest entry (4.5e-6 measured at this size).
* A JAX ``Trainer`` checkpoint at step 10 resumes in the port's
  ``Trainer``, which runs to step 20 with the JAX Trainer's losses within
  HISTORY_TOL (float32 compute; AdamW's sign sensitivity moves entries by
  up to 2 lr a step, the losses by far less). A checkpoint the port writes
  resumes in the JAX Trainer bit for bit. Two runs from each package's
  own draws (``prng.normal`` is an ulp off now and then) drift further:
  their first 10 losses within DRIFT_TOL (1.03e-3 measured at step 3).

Every jax call runs under ``jax.threefry_partitionable(False)``. JAX
results are computed once in module-scoped fixtures.
"""
import dataclasses
import io
import json
import os
import shutil
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import build as jax_build
from repro.optim import AdamW as JaxAdamW
from repro.optim import constant as jax_constant
from repro.optim import grad_compression as jgc
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro.train import sketched_dense as jsd
from repro_torch import convert
from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.optim import AdamW, AdamWState, constant, warmup_cosine
from repro_torch.train import (
    TrainConfig, Trainer, TrainerConfig, make_train_step)

ADAMW_TOL = 1e-6
STEP_RTOL = 1e-4
TAP_RTOL = 1e-3
HISTORY_TOL = 1e-3
DRIFT_TOL = 2e-3
ARCH = "phi3-mini-3.8b"
B, S = 4, 64



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread while this module runs: its tiny ops lose far
    more to thread hand-offs than they gain, most of all beside other
    test workers on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"x": 2.0 * params["x"]}
        params, state = opt.update(grads, state, params)
    assert float(params["x"].abs().max()) < 1e-2


def test_adamw_bf16_moments():
    opt = AdamW(lr=1e-2, moment_dtype=torch.bfloat16)
    params = {"w": torch.ones((8, 8))}
    state = opt.init(params)
    assert state.mu["w"].dtype == torch.bfloat16
    params2, state2 = opt.update({"w": torch.ones((8, 8))}, state, params)
    assert bool(torch.isfinite(params2["w"]).all())
    assert state2.nu["w"].dtype == torch.bfloat16 and int(state2.step) == 1


def test_warmup_cosine_shape():
    s = warmup_cosine(1.0, 10, 100)
    step = lambda i: torch.tensor(i, dtype=torch.int32)  # noqa: E731
    assert float(s(step(0))) == 0.0
    assert abs(float(s(step(10))) - 1.0) < 0.11
    assert float(s(step(100))) < 0.2


@pytest.mark.parametrize("args", [(1e-3, 10, 100), (3e-3, 5, 30),
                                  (0.7, 0, 1000), (1e-3, 1, 3, 0.2)])
def test_schedules_match_jax_bit_for_bit(args):
    want = jax_warmup_cosine(*args)
    got = warmup_cosine(*args)
    steps = np.arange(0, args[2] + 20, dtype=np.int32)
    w = np.asarray(jax.vmap(want)(jnp.asarray(steps)))
    g = np.array([got(torch.tensor(i)).item() for i in steps], np.float32)
    assert w.tobytes() == g.tobytes()
    assert np.float32(jax_constant(args[0])(jnp.int32(3))).tobytes() == \
        constant(args[0])(torch.tensor(3)).numpy().tobytes()


def _adamw_inputs(seed, scale, dtype=np.float32):
    """Leaves of 1, 2 and 3 dimensions (weight decay on the last two), in
    ``dtype`` (a bf16 leaf is the float32 draw rounded)."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (7,), "b": (12, 5), "c": (3, 8, 6)}
    params = {k: rng.standard_normal(s).astype(np.float32).astype(dtype)
              for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              .astype(dtype) for k, s in shapes.items()} for _ in range(3)]
    return params, grads


def _to_torch(x: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a torch tensor of its dtype (bf16 through its bits)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


# the first four cases: float32 parameters and gradients, unclipped and
# clipped; the last: bf16 parameters and gradients at a clipping scale,
# where the gradient is scaled in float32 (as JAX promotes bf16 * float32)
@pytest.mark.parametrize("moments,scale,dtype", [
    ("float32", 0.01, "float32"), ("float32", 10.0, "float32"),
    ("bfloat16", 0.01, "float32"), ("bfloat16", 10.0, "float32"),
    ("float32", 10.0, "bfloat16")],
    ids=["float32-0.01", "float32-10.0", "bfloat16-0.01", "bfloat16-10.0",
         "float32-10.0-bf16_params"])
def test_adamw_update_matches_jax(moments, scale, dtype):
    """Three updates from the same state on the same gradients: parameters
    and moments leaf by leaf within ADAMW_TOL (bf16 parameters equal),
    moments in their dtype."""
    params, grads = _adamw_inputs(1, scale, getattr(jnp, dtype))
    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-2, 1, 5), weight_decay=0.1,
                    moment_dtype=getattr(jnp, moments))
    topt = AdamW(lr=warmup_cosine(1e-2, 1, 5), weight_decay=0.1,
                 moment_dtype=getattr(torch, moments))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: _to_torch(v) for k, v in params.items()}
    tstate = topt.init(tp)
    for g in grads:
        jp, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jp)
        tp, tstate = topt.update({k: _to_torch(v) for k, v in g.items()},
                                 tstate, tp)
        assert int(tstate.step) == int(jstate.step)
        for k in params:
            assert tp[k].dtype == getattr(torch, dtype)
            if dtype == "bfloat16":
                assert torch.equal(tp[k], _to_torch(np.asarray(jp[k])))
            else:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                           rtol=0, atol=ADAMW_TOL)
            for t, j in ((tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
                assert t[k].dtype == getattr(torch, moments)
                np.testing.assert_allclose(
                    t[k].float().numpy(), np.asarray(j[k], np.float32),
                    rtol=ADAMW_TOL, atol=ADAMW_TOL)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,n_hosts,host_id", [
    (0, 0, 1, 0), (3, 17, 1, 0), (5, 123_456, 2, 1), (7, 2, 4, 3)])
def test_synthetic_lm_matches_jax(seed, step, n_hosts, host_id):
    kw = dict(vocab_size=32_064, batch_size=3, seq_len=40, seed=seed,
              n_hosts=n_hosts, host_id=host_id)
    with jax.threefry_partitionable(False):
        want = JaxSyntheticLM(**kw).batch(step)
    got = SyntheticLM(**kw, device="cpu").batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_data_pipeline_deterministic_skip_ahead():
    d1 = SyntheticLM(vocab_size=100, batch_size=2, seq_len=16, seed=3,
                     device="cpu")
    d2 = SyntheticLM(vocab_size=100, batch_size=2, seq_len=16, seed=3,
                     device="cpu")
    b1 = d1.batch(17)
    assert torch.equal(b1["tokens"], d2.batch(17)["tokens"])
    assert not torch.equal(b1["tokens"], d1.batch(18)["tokens"])
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


def test_data_pipeline_host_sharding_disjoint():
    a, b = (SyntheticLM(vocab_size=100, batch_size=2, seq_len=16, n_hosts=2,
                        host_id=h, device="cpu").batch(0) for h in (0, 1))
    assert not torch.equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# one train step against the JAX package's
# ---------------------------------------------------------------------------

def _overrides(compression):
    kw = dict(compute_dtype="float32")
    if compression == "taps":
        kw["sketched_mlp"] = True
    return kw


def _jax_reference_grads(m, params, batch, key_step, tcfg):
    """The gradients the JAX step hands its optimizer: the microbatch mean
    of ``value_and_grad``, then the compression."""
    n = tcfg.microbatches
    gsum = None
    for i in range(n):
        mb = jax.tree.map(lambda x: x[i * (B // n):(i + 1) * (B // n)], batch)
        _, g = jax.value_and_grad(m.loss)(params, mb)
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
    grads = jax.tree.map(lambda g: g / n, gsum)
    if tcfg.compression == "lowrank":
        grads, _, _ = jgc.compress_grads(key_step, grads,
                                         jgc.init_state(params), tcfg.comp_cfg)
    elif tcfg.compression == "taps":
        grads = jsd.decompress_tapped_grads(key_step, grads, tcfg.tap_cfg)
    return grads


@pytest.fixture(scope="module", params=["none", "lowrank", "taps"])
def jax_step(request):
    """The JAX state after init (the Trainer's keys), batch(3), the step's
    metrics and the gradients its update reads."""
    comp = request.param
    with jax.threefry_partitionable(False):
        cfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                                  **_overrides(comp))
        m = jax_build(cfg)
        opt = JaxAdamW(lr=jax_warmup_cosine(3e-3, 5, 30), weight_decay=0.01)
        tcfg = JaxTrainConfig(microbatches=2, compression=comp)
        key = jax.random.PRNGKey(0)
        state = jax_init_state(jax.random.fold_in(key, 2),
                               m.init_params(jax.random.fold_in(key, 1)), opt,
                               tcfg)
        batch = JaxSyntheticLM(vocab_size=cfg.vocab_size, batch_size=B,
                               seq_len=S).batch(3)
        _, metrics = jax.jit(jax_make_train_step(m.loss, opt, tcfg))(state,
                                                                     batch)
        grads = jax.jit(lambda p, b, k: _jax_reference_grads(
            m, p, b, k, tcfg))(state.params, batch,
                               jax.random.fold_in(state.key, state.step))
        return {"comp": comp, "state": jax.tree.map(np.asarray, state),
                "batch": jax.tree.map(np.asarray, batch),
                "metrics": {k: float(v) for k, v in metrics.items()
                            if np.ndim(v) == 0},
                "grads": jax.tree.map(np.asarray, grads)}


def test_train_state_round_trips(jax_step):
    """JAX state -> port -> JAX layout: every leaf equal, in the JAX tree's
    structure (what a checkpoint stores)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              **_overrides(jax_step["comp"]))
    state = convert.train_state_from_numpy(jax_step["state"], cfg, "cpu")
    back = convert.train_state_to_numpy(state)
    def leaves(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {jax.tree_util.keystr(p): x for p, x in flat}
    want, got = leaves(jax_step["state"]), leaves(back)
    assert list(want) == list(got)
    for path, w in want.items():
        assert w.dtype == got[path].dtype and np.array_equal(w, got[path]), \
            path


def test_train_step_matches_jax(jax_step):
    comp = jax_step["comp"]
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **_overrides(comp))
    state = convert.train_state_from_numpy(jax_step["state"], cfg, "cpu")
    opt = AdamW(lr=warmup_cosine(3e-3, 5, 30), weight_decay=0.01)
    step = make_train_step(build(cfg, device="cpu").loss, opt,
                           TrainConfig(microbatches=2, compression=comp))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             jax_step["batch"].items()}
    new, metrics = step(state, batch)
    want = jax_step["metrics"]
    assert set(want) == set(metrics)
    for k in ("loss", "grad_norm"):
        assert abs(float(metrics[k]) - want[k]) <= STEP_RTOL * abs(want[k]), k
    assert float(metrics["lr"]) == want["lr"]
    assert int(new.step) == 1 and int(new.opt.step) == 1
    for name, p in new.params.named_parameters():
        ref = np.asarray(convert.lm_leaf(jax_step["grads"], name), np.float32)
        tapped = comp == "taps" and name.endswith(("mlp.up.w", "mlp.down.w"))
        tol = TAP_RTOL if tapped else STEP_RTOL
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= tol * scale, (comp, name, err, scale)
    if comp == "lowrank":
        assert metrics["n_compressed"] == want["n_compressed"]
        assert abs(metrics["comm_fraction"] - want["comm_fraction"]) <= 1e-6


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _tiny(td, steps=30, compression="none", cfg=None):
    """The port's twin of the JAX suite's ``_tiny_setup``."""
    cfg = cfg or get_config(ARCH).reduced()
    m = build(cfg, device="cpu")
    data = SyntheticLM(vocab_size=cfg.vocab_size, batch_size=B, seq_len=S,
                       device="cpu")
    opt = AdamW(lr=warmup_cosine(3e-3, 5, steps), weight_decay=0.01)
    return Trainer(m.loss, opt, data,
                   TrainConfig(microbatches=2, compression=compression),
                   TrainerConfig(num_steps=steps, ckpt_dir=td, ckpt_every=10,
                                 log_every=1000),
                   init_params_fn=m.init_params)


def _jax_tiny(td, steps, cfg):
    m = jax_build(cfg)
    data = JaxSyntheticLM(vocab_size=cfg.vocab_size, batch_size=B, seq_len=S)
    opt = JaxAdamW(lr=jax_warmup_cosine(3e-3, 5, steps), weight_decay=0.01)
    return JaxTrainer(m.loss, opt, data, JaxTrainConfig(microbatches=2),
                      JaxTrainerConfig(num_steps=steps, ckpt_dir=td,
                                       ckpt_every=10, log_every=1000),
                      init_params_fn=m.init_params)


def test_loss_decreases(tmp_path):
    tr = _tiny(str(tmp_path))
    tr.run()
    losses = [h["loss"] for h in tr.metrics_history]
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])


@pytest.mark.parametrize("compression", ["none", "taps"])
def test_fault_recovery_resumes_from_checkpoint(tmp_path, compression):
    """A failure at step 11 rolls back to step 10's checkpoint; the replayed
    steps give the losses of a run without the failure."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              sketched_mlp=compression == "taps")
    clean = _tiny(str(tmp_path / "clean"), steps=12, compression=compression,
                  cfg=cfg)
    clean.run()
    tr = _tiny(str(tmp_path / "faulty"), steps=12, compression=compression,
               cfg=cfg)
    fired = []

    def hook(step):
        if step == 11 and not fired:
            fired.append(step)
            raise RuntimeError("simulated preemption")
    state = tr.run(fault_hook=hook)
    assert int(state.step) == 12 and fired == [11]
    assert [h["step"] for h in tr.metrics_history] == \
        list(range(11)) + [10, 11]
    assert [h["loss"] for h in tr.metrics_history[11:]] == \
        [h["loss"] for h in clean.metrics_history[10:]]


def test_failure_without_checkpoint_reinitialises(tmp_path):
    """No checkpoint yet: recovery draws the state afresh from the seed
    (parameters, moments, counters; ``.grad`` cleared) and replays from
    step 0."""
    tr = _tiny(None, steps=6)
    fired = []

    def hook(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("simulated preemption")
    tr.run(fault_hook=hook)
    losses = [h["loss"] for h in tr.metrics_history]
    assert [h["step"] for h in tr.metrics_history] == [0, 1, 2] + list(range(6))
    assert losses[:3] == losses[3:6]


def test_restart_continues_training(tmp_path):
    """Stop after 20 steps; a fresh Trainer resumes at the checkpoint."""
    _tiny(str(tmp_path), steps=20).run()
    tr2 = _tiny(str(tmp_path), steps=30)
    state = tr2.run()
    assert int(state.step) == 30
    assert tr2.metrics_history[0]["step"] == 20


@pytest.fixture(scope="module")
def jax_run_to_20(tmp_path_factory):
    """JAX Trainer, float32 compute: 10 steps (checkpoint at 10), then a
    second Trainer resumes to 20. The step-10 checkpoint and both loss
    histories."""
    td = str(tmp_path_factory.mktemp("jax_ckpt"))
    with jax.threefry_partitionable(False):
        cfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                                  compute_dtype="float32")
        first = _jax_tiny(td, 10, cfg)
        first.run()
        at10 = str(tmp_path_factory.mktemp("jax_at_10"))
        shutil.copytree(td, at10, dirs_exist_ok=True)
        second = _jax_tiny(td, 20, cfg)
        second.run()
    return {"at10": at10,
            "first": [h["loss"] for h in first.metrics_history],
            "second": [h["loss"] for h in second.metrics_history],
            "second_steps": [h["step"] for h in second.metrics_history]}


def test_jax_checkpoint_resumes_in_the_port(jax_run_to_20, tmp_path):
    """The JAX Trainer's step-10 checkpoint restores in the port's Trainer,
    which runs steps 10 to 19 as the JAX Trainer does."""
    td = str(tmp_path / "ckpt")
    shutil.copytree(jax_run_to_20["at10"], td)
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="float32")
    tr = _tiny(td, steps=20, cfg=cfg)
    state = tr.run()
    assert int(state.step) == 20
    assert [h["step"] for h in tr.metrics_history] == \
        jax_run_to_20["second_steps"] == list(range(10, 20))
    got = [h["loss"] for h in tr.metrics_history]
    np.testing.assert_allclose(got, jax_run_to_20["second"], rtol=0,
                               atol=HISTORY_TOL)


def test_port_checkpoint_resumes_in_jax(jax_run_to_20, tmp_path):
    """The other way round: the port's Trainer restores the JAX step-10
    checkpoint and writes its own at step 10, which the JAX Trainer resumes
    to the same losses as from its own, bit for bit. The port's own first
    10 steps (from its own draws) are within DRIFT_TOL of JAX's."""
    td = str(tmp_path / "ckpt")
    shutil.copytree(jax_run_to_20["at10"], td)
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              compute_dtype="float32")
    tr = _tiny(td, steps=10, cfg=cfg)
    assert int(tr.run().step) == 10 and tr.metrics_history == []
    with jax.threefry_partitionable(False):
        jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                                   compute_dtype="float32")
        jtr = _jax_tiny(td, 20, jcfg)
        jtr.run()
    assert [h["loss"] for h in jtr.metrics_history] == jax_run_to_20["second"]
    own = _tiny(str(tmp_path / "own"), steps=10, cfg=cfg)
    own.run()
    np.testing.assert_allclose([h["loss"] for h in own.metrics_history],
                               jax_run_to_20["first"], rtol=0, atol=DRIFT_TOL)


def test_checkpoint_holds_the_jax_layout(tmp_path):
    """The port's checkpoint of a train state lists the JAX TrainState's
    leaf paths, dtypes and shapes."""
    tr = _tiny(str(tmp_path), steps=1)
    tr.run()
    got = checkpoint.read_manifest(str(tmp_path))["leaves"]
    with jax.threefry_partitionable(False):
        m = jax_build(jax_get_config(ARCH).reduced())
        opt = JaxAdamW()
        state = jax_init_state(jax.random.PRNGKey(2),
                               m.init_params(jax.random.PRNGKey(1)), opt,
                               JaxTrainConfig())
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    want = {jax.tree_util.keystr(p): {"shape": list(np.shape(x)),
                                      "dtype": str(np.asarray(x).dtype)}
            for p, x in flat}
    assert got == want


def test_launch_train_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main(["--arch", ARCH, "--reduced", "--steps", "12",
                           "--batch", "4", "--seq", "32", "--device", "cpu",
                           "--log-every", "100"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(out) == {"first_loss", "last_loss", "steps", "stragglers"}
    assert out["steps"] == 12 and out["last_loss"] < out["first_loss"]
    assert launch_train.parser().parse_args([]).device == "cuda"


def test_adamw_state_is_the_named_tuple():
    assert AdamWState._fields == ("step", "mu", "nu")
    assert os.path.basename(launch_train.__file__) == "train.py"
