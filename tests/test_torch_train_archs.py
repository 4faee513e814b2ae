"""Gradients of the port's LM stack against the JAX package's, the
rematerialized forward, and the attention route under autograd.

The twin of tests/models/test_archs.py::test_smoke_forward_and_train_step,
held against the reference: for all ten archs, reduced, in float32
compute, the port's ``Model.loss`` and every parameter's gradient against
``jax.value_and_grad(m.loss)`` on the same weights (``convert.
lm_params_from_numpy`` of the JAX tree) and batch. That covers the MoE aux
loss, the RG-LRU and the sLSTM/mLSTM blocks, and (granite with
``sketched_mlp``) the gradient taps. Every jax call runs under
``jax.threefry_partitionable(False)``; the JAX results are computed once
per arch in a module-scoped fixture.

Tolerances: the loss within 1e-5 (a mean of 128 log-probabilities,
float32 sums in other orders); each gradient within GRAD_RTOL of its
leaf's largest entry. Float32 backward passes sum in other orders than
XLA's (the attention's softmax backward, the norms' reductions, the
recurrences' scans), and a leaf's small entries are sums of terms that
cancel, so entries are held against the leaf's scale, not their own. A
leaf whose gradient is zero in exact arithmetic (the key bias: softmax
ignores a constant added to a row of scores) holds float32 noise of order
1e-9, so a leaf's scale is at least SCALE_FLOOR of the model's largest
gradient entry. recurrentgemma-9b and xlstm-350m keep the reference's bf16
gate products in float32 compute (the RG-LRU's gates, the mLSTM's w_if,
the sLSTM's recurrence), whose backward products round to bf16 as well: a
value near a bf16 rounding edge rounds the other way now and then and
moves its leaf and those below by up to a bf16 ulp of the leaf's scale
(2.7e-3 measured): those two archs are held within 2**-8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro_torch import convert, prng
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import build

ARCHS = ("phi3-mini-3.8b", "starcoder2-15b", "granite-3-8b",
         "mistral-large-123b", "whisper-small", "llama-3.2-vision-11b",
         "kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "recurrentgemma-9b",
         "xlstm-350m")
CASES = ARCHS + ("granite-3-8b+taps",)
B, S = 2, 32
GRAD_RTOL = 1e-4
BF16_GATE_RTOL = 2.0 ** -8
SCALE_FLOOR = 1e-3
LOSS_TOL = 1e-5



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread while this module runs: its tiny ops lose far
    more to thread hand-offs than they gain, most of all beside other
    test workers on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

def _overrides(case):
    name, _, taps = case.partition("+")
    kw = dict(compute_dtype="float32")
    if taps:
        kw["sketched_mlp"] = True
    return name, kw


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    for name, L in (("enc_frames", cfg.enc_context),
                    ("img_embeds", cfg.n_img_tokens)):
        if L:
            x = 0.1 * rng.standard_normal((B, L, cfg.d_model))
            out[name] = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return out


def _open_gates(tree):
    """Cross-attention gates start at 0, which erases the block and its
    gradients below it: give them non-zero values."""
    for group in tree["groups"]:
        for slot in group:
            for gate, val in (("gate_attn", 0.7), ("gate_mlp", -0.4)):
                if gate in slot:
                    slot[gate] = np.full_like(slot[gate], val)
    return tree


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """Per case: the JAX tree from PRNGKey(0) (gates opened), a batch, and
    the JAX package's loss and gradient tree."""
    name, kw = _overrides(request.param)
    with jax.threefry_partitionable(False):
        jcfg = dataclasses.replace(jax_get_config(name).reduced(), **kw)
        m = jax_build(jcfg)
        tree = _open_gates(jax.tree.map(
            np.asarray, m.init_params(jax.random.PRNGKey(0))))
        batch = _batch(jcfg, seed=len(name))
        loss, grads = jax.jit(jax.value_and_grad(m.loss))(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()})
    return {"case": request.param, "name": name, "kw": kw, "tree": tree,
            "batch": batch, "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads)}


def _port_grads(case, **cfg_kw):
    cfg = dataclasses.replace(get_config(case["name"]).reduced(),
                              **case["kw"], **cfg_kw)
    params = convert.lm_params_from_numpy(case["tree"], cfg, "cpu")
    batch = {k: convert.tensor_from_numpy(v) for k, v in case["batch"].items()}
    loss = build(cfg, device="cpu").loss(params, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  params.named_parameters()}


def test_loss_and_every_gradient_match_jax(case):
    loss, grads = _port_grads(case)
    assert abs(loss - case["loss"]) <= LOSS_TOL, (loss, case["loss"])
    floor = SCALE_FLOOR * max(float(np.abs(g).max())
                              for g in jax.tree.leaves(case["grads"]))
    rtol = BF16_GATE_RTOL if case["name"] in (
        "recurrentgemma-9b", "xlstm-350m") else GRAD_RTOL
    for name, g in grads.items():
        want = np.asarray(convert.lm_leaf(case["grads"], name), np.float32)
        got = np.zeros_like(want) if g is None else g.numpy()
        scale = max(float(np.abs(want).max()), floor)
        err = float(np.abs(got - want).max())
        assert err <= rtol * scale, (case["case"], name, err, scale)
    if case["kw"].get("sketched_mlp"):
        # the tapped layers' dW is zero and their taps carry the sketches
        assert not bool(grads["groups.0.0.0.mlp.up.w"].any())
        assert bool(grads["groups.0.0.0.mlp.up.taps.a"].any())


@pytest.mark.parametrize("case_name", CASES)
def test_remat_gives_the_same_gradients(case_name):
    """A checkpointed slot recomputes the same forward: loss and every
    gradient (the taps' sketches included) equal without and with remat."""
    name, kw = _overrides(case_name)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(name).reduced(), remat=remat,
                                  **kw)
        m = build(cfg, device="cpu")
        params = m.init_params(prng.PRNGKey(0))
        batch = {k: convert.tensor_from_numpy(v)
                 for k, v in _batch(cfg, seed=5).items()}
        loss = m.loss(params, batch)
        loss.backward()
        out.append((float(loss.detach()),
                    {n: p.grad for n, p in params.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    assert g0.keys() == g1.keys()
    for n in g0:
        if g0[n] is None:
            assert g1[n] is None, n
        else:
            torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0,
                                       msg=n)


def test_save_attn_out_policy_is_not_ported():
    """The policy now runs (it raised before it was ported); a policy
    the port does not know raises, and inference keeps no activations
    under either."""
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(),
                              remat=True, remat_policy="save_attn_out")
    m = build(cfg, device="cpu")
    params = m.init_params(prng.PRNGKey(0))
    batch = {k: convert.tensor_from_numpy(v)
             for k, v in _batch(cfg, seed=1).items()}
    assert torch.isfinite(m.loss(params, batch))
    bad = build(dataclasses.replace(cfg, remat_policy="dots"), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        bad.loss(params, batch)
    with torch.no_grad():          # inference keeps no activations
        assert torch.isfinite(bad.loss(params, batch))


SAVE_ATTN_ARCHS = ("phi3-mini-3.8b", "recurrentgemma-9b")


@pytest.mark.parametrize("name", SAVE_ATTN_ARCHS)
def test_save_attn_out_gradients_match_full_and_jax(name):
    """``remat_policy="save_attn_out"`` (an attention arch and a hybrid
    one): loss and every gradient equal the port's ``full`` remat bit for
    bit, and JAX's ``save_attn_out`` gradients within this file's
    tolerance."""
    kw = dict(compute_dtype="float32", remat=True)
    with jax.threefry_partitionable(False):
        jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                                   remat_policy="save_attn_out", **kw)
        m = jax_build(jcfg)
        tree = jax.tree.map(np.asarray, m.init_params(jax.random.PRNGKey(0)))
        batch = _batch(jcfg, seed=len(name))
        jloss, jgrads = jax.jit(jax.value_and_grad(m.loss))(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()})
    out = {}
    for policy in ("full", "save_attn_out"):
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  remat_policy=policy, **kw)
        params = convert.lm_params_from_numpy(tree, cfg, "cpu")
        loss = build(cfg, device="cpu").loss(
            params, {k: convert.tensor_from_numpy(v)
                     for k, v in batch.items()})
        loss.backward()
        out[policy] = (float(loss.detach()),
                       {n: p.grad for n, p in params.named_parameters()})
    (l0, g0), (l1, g1) = out["full"], out["save_attn_out"]
    assert l0 == l1
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=0, msg=n)
    assert abs(l1 - float(jloss)) <= LOSS_TOL
    jleaves = jax.tree.leaves(jgrads)
    floor = SCALE_FLOOR * max(float(np.abs(np.asarray(g)).max())
                              for g in jleaves)
    rtol = BF16_GATE_RTOL if name == "recurrentgemma-9b" else GRAD_RTOL
    for n, g in g1.items():
        want = np.asarray(convert.lm_leaf(jgrads, n), np.float32)
        scale = max(float(np.abs(want).max()), floor)
        assert float(np.abs(g.numpy() - want).max()) <= rtol * scale, n


def _saved_bytes(cfg, batch, monkeypatch):
    """(bytes autograd saves through ``saved_tensors_hooks`` in one loss
    forward, each storage once; bytes the selective checkpoint's policy
    keeps), on the parameters of PRNGKey(0) (a block reads its policy
    from the config it was built with)."""
    from repro_torch.models import transformer
    kept = []
    policy = transformer._save_attn_out

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            kept.append(args[0].numel() * args[0].element_size())
        return out

    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    m = build(cfg, device="cpu")
    params = m.init_params(prng.PRNGKey(0))
    with monkeypatch.context() as mp:
        mp.setattr(transformer, "_save_attn_out", counting)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = m.loss(params, batch)
        loss.backward()
    return sum(seen.values()), sum(kept)


def test_save_attn_out_saves_exactly_the_attention_outputs(monkeypatch):
    """Under ``save_attn_out`` the checkpointed slots keep what ``full``
    keeps (each slot's input and what autograd saves outside the slots,
    read through ``saved_tensors_hooks``) and besides exactly one float32
    (B, S, d) attention output a layer (read through the policy)."""
    base = dataclasses.replace(get_config("phi3-mini-3.8b").reduced(),
                               remat=True)
    batch = {k: convert.tensor_from_numpy(v)
             for k, v in _batch(base, seed=2).items()}
    hooks_full, kept_full = _saved_bytes(base, batch, monkeypatch)
    cfg = dataclasses.replace(base, remat_policy="save_attn_out")
    hooks_sao, kept_sao = _saved_bytes(cfg, batch, monkeypatch)
    assert kept_full == 0
    assert hooks_sao == hooks_full
    assert kept_sao == base.n_layers * B * S * base.d_model * 4


def test_attention_under_grad_takes_the_plain_route():
    """``attention`` passes the grad flag to ``route``: on the CPU both
    are plain, and the output carries a grad_fn."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 4, 32))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    tattn.reset_route_counts()
    out = tattn.attention(q, k, v, causal=True)
    assert tattn.ROUTES == {"flash": 0, "plain": 1}
    out.sum().backward()
    assert all(t.grad is not None and bool(t.grad.any()) for t in (q, k, v))


def test_flash_attention_under_grad_raises():
    """The kernel has no backward: with grad mode on and an input that
    requires grad the wrapper raises (on any device), under no_grad it
    runs."""
    q = torch.zeros(1, 128, 2, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, q, q)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).shape == q.shape
    assert ops.flash_attention(q.detach(), q.detach(), q.detach()
                               ).grad_fn is None
