"""The port's LM stack (configs, models/common, models/attention,
models/transformer, models/factory, convert.lm_*) against the JAX package's.

Inputs are made with numpy (or drawn by the JAX package under a key) and
handed to both packages as numpy arrays; both get the same weights
(``convert.lm_params_from_numpy`` of the JAX tree). Every jax call runs
under ``jax.threefry_partitionable(False)``, the key tree the port
reproduces. JAX results are computed once per arch in module-scoped
fixtures.

Tolerances:
* float32 compute: logits within 1e-4 of the JAX package's (measured
  about 4e-6 at logits of scale 4: products summed in another order, RoPE
  and softmax in another libm);
* bf16 compute: within 0.05 (a bf16 ulp is 0.4% of a value, and a value
  that lands near a rounding edge rounds the other way now and then, then
  moves the rest of the layer by a bf16 ulp; the JAX suite holds its own
  bf16 prefill against its forward to 0.15);
* caches: the bf16 KV entries within 2 bf16 ulps (1.6%) of the value
  plus half an ulp of the leaf's largest entry (small entries come from
  sums whose terms flipped), a whole ulp in the hybrid and recurrent
  stacks, whose recurrences carry a flip on through every step; float32
  recurrent states within 1e-4 of their largest entry;
* parameters: normal draws within 1e-6 (an ulp or two), except that a
  draw near the erf_inv polynomials' branch point (w = 5) may take the
  other branch when torch's ``log1p`` rounds the other way: at most 0.1%
  of a leaf, within 1e-3 of the draw. A wrong key moves every draw. The
  RG-LRU's ``lam`` (uniforms bit for bit, then log(exp(y) - 1) with y
  down to 2.5e-4, where an ulp of exp moves lam by up to 4.8e-4) within
  5e-4;
* MoE archs: routing is float32 on both sides, and the port drops the same
  assignments as the reference at the config's capacity (a decode step's
  C is 1), so they are held to the same tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs import shapes as jax_shapes
from repro.models import attention as jattn
from repro.models import build as jax_build
from repro.models import common as jcommon
from repro.models import transformer as jt
from repro_torch import convert, prng
from repro_torch.configs import base as port_base
from repro_torch.configs import get_config, list_archs, shapes
from repro_torch.models import attention as tattn
from repro_torch.models import build
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as tt

ARCHS = ("phi3-mini-3.8b", "starcoder2-15b", "granite-3-8b",
         "mistral-large-123b", "whisper-small", "llama-3.2-vision-11b",
         "kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "recurrentgemma-9b",
         "xlstm-350m")
CDTYPES = ("float32", "bfloat16")
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.05}
B, S, P = 2, 16, 12          # batch, sequence, prompt (then 4 decode steps)


def _t(x):
    return convert.tensor_from_numpy(np.asarray(x))


def _np(t):
    return t.detach().float().cpu().numpy()


def _cfgs(name, cd):
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), compute_dtype=cd)
    pcfg = dataclasses.replace(get_config(name).reduced(), compute_dtype=cd)
    return jcfg, pcfg


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


def _open_gates(params_np):
    """Cross-attention gates start at 0, which erases the block: give them
    non-zero values so the comparison sees it."""
    for group in params_np["groups"]:
        for slot in group:
            for gate, val in (("gate_attn", 0.7), ("gate_mlp", -0.4)):
                if gate in slot:
                    slot[gate] = np.full_like(slot[gate], val)
    return params_np


def _jax_run(jcfg, params_np, batch):
    """The JAX package on one arch: full-sequence logits, prefill logits
    and caches over the first P tokens, 4 decode steps' logits, the caches
    after them, the loss."""
    jp = jax.tree.map(jnp.asarray, params_np)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    m = jax_build(jcfg)
    ctx = {"positions": jnp.arange(S),
           "xattn_ctx": jt._xattn_context(jp, jcfg, jb)}
    x = jt._embed_tokens(jp, jcfg, jb["tokens"])
    x, _, _ = jt._backbone(jp, jcfg, x, ctx, mode="seq")
    full = np.asarray(jt._logits(jp, jcfg, x))
    pre = dict(jb, tokens=jb["tokens"][:, :P])
    lg, cache = jax.jit(m.prefill)(jp, pre, m.init_cache(B, S))
    pre_cache = jax.tree.map(np.asarray, cache)
    steps = [np.asarray(lg[:, 0])]
    dstep = jax.jit(m.decode_step)
    for t in range(P, S):
        lg, cache = dstep(jp, cache, jb["tokens"][:, t:t + 1], jnp.int32(t))
        steps.append(np.asarray(lg[:, 0]))
    return {"full": full, "steps": steps, "pre_cache": pre_cache,
            "cache": jax.tree.map(np.asarray, cache),
            "loss": float(jax.jit(m.loss)(jp, jb))}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """Per arch: the JAX tree from PRNGKey(0) (gates opened), the batch,
    and the JAX package's outputs in both compute dtypes."""
    name = request.param
    with jax.threefry_partitionable(False):
        jcfg, _ = _cfgs(name, "float32")
        raw = jax.tree.map(np.asarray,
                           jax_build(jcfg).init_params(jax.random.PRNGKey(0)))
        params_np = _open_gates(jax.tree.map(np.copy, raw))
        batch = _batch(jcfg, seed=len(name))
        runs = {cd: _jax_run(_cfgs(name, cd)[0], params_np, batch)
                for cd in CDTYPES}
    return {"name": name, "raw": raw, "params": params_np, "batch": batch,
            "runs": runs}


def _port(arch, cd):
    _, pcfg = _cfgs(arch["name"], cd)
    params = convert.lm_params_from_numpy(arch["params"], pcfg, "cpu")
    batch = {k: _t(v) for k, v in arch["batch"].items()}
    return build(pcfg, device="cpu"), params, batch


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol, (what, err, tol)


def _vocab(cfg, x):
    return x[..., :cfg.vocab_size]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_has_the_same_archs():
    assert list_archs() == jax_list_archs()
    assert len(list_archs()) == 10


@pytest.mark.parametrize("name", jax_list_archs())
def test_config_matches_jax(name):
    jcfg, pcfg = jax_get_config(name), get_config(name)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(pcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    for j, p in ((jcfg, pcfg), (jcfg.reduced(), pcfg.reduced())):
        assert p.n_params() == j.n_params()
        assert p.n_active_params() == j.n_active_params()
        assert (p.head_dim_, p.vocab_padded, p.is_encdec,
                p.supports_long_context) == (j.head_dim_, j.vocab_padded,
                                             j.is_encdec, j.supports_long_context)
    for shape in jax_shapes.SHAPES:
        assert shapes.cell_applicable(pcfg.family, shape) == \
            jax_shapes.cell_applicable(jcfg.family, shape)


def test_shapes_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_shapes.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(port_base.ArchConfig)] == \
        [f.name for f in dataclasses.fields(jax_base.ArchConfig)]


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

_CD = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("cd", CDTYPES)
def test_dense_apply_matches_jax(cd, bias):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    jp = {"w": jnp.asarray(w)}
    layer = tcommon.Dense(24, 40, bias=bias, device="cpu")
    with torch.no_grad():
        layer.w.copy_(_t(w))
        if bias:
            jp["b"] = jnp.asarray(b)
            layer.b.copy_(_t(b))
    want = np.asarray(jcommon.dense_apply(jp, jnp.asarray(x), _CD[cd][1]))
    got = tcommon.dense_apply(layer, _t(x), _CD[cd][0])
    assert got.dtype == torch.float32
    # float32 sums of 24 products in another order; bf16 operands' products
    # are exact in float32, so the same bound holds
    _close(_np(got), want, 1e-5, "dense")


@pytest.mark.parametrize("batched", [False, True])
def test_f32out_backward_against_jax(batched):
    """The card's backward for bf16 GEMMs with float32 outputs
    (``common._F32Out``, run here through its CPU products): the cotangent
    rounded to bf16, then bf16 products summed in float32. It equals that
    rule exactly, and JAX's ``vjp`` of ``dot_general(...,
    preferred_element_type=float32)`` on the CPU (which keeps the float32
    cotangent) within that rounding: 2**-8 |ct| carried through |w| (|x|),
    plus the two results' bf16 roundings, 2**-8 of each."""
    rng = np.random.default_rng(7)
    lead = (3,) if batched else ()
    x = rng.standard_normal(lead + (24, 40)).astype(np.float32)
    w = rng.standard_normal(lead + (40, 56)).astype(np.float32)
    ct = rng.standard_normal(lead + (24, 56)).astype(np.float32)
    dims = (((x.ndim - 1,), (w.ndim - 2,)),
            (((0,), (0,)) if batched else ((), ())))
    _, vjp = jax.vjp(lambda a, b: jax.lax.dot_general(
        a, b, dims, preferred_element_type=jnp.float32),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(ct))]
    xt, wt = (_t(a).to(torch.bfloat16).requires_grad_() for a in (x, w))
    y = tcommon._F32Out.apply(xt, wt)
    assert y.dtype == torch.float32
    y.backward(_t(ct))
    g = _t(ct).to(torch.bfloat16).float()
    xf, wf = xt.detach().float(), wt.detach().float()
    rule = [(g @ wf.transpose(-1, -2)).to(torch.bfloat16),
            (xf.transpose(-1, -2) @ g).to(torch.bfloat16)]
    ct_abs = np.abs(ct)
    carried = [ct_abs @ np.abs(_np(wf)).swapaxes(-1, -2),
               np.abs(_np(xf)).swapaxes(-1, -2) @ ct_abs]
    for got, exact, ref, spread in zip((xt.grad, wt.grad), rule, want,
                                       carried):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, exact)
        err = np.abs(_np(got) - ref)
        bound = 2.0 ** -8 * (spread + np.abs(_np(got)) + np.abs(ref)) * 1.01
        assert (err <= bound).all(), float((err - bound).max())
        assert err.max() > 0        # the roundings differ somewhere


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((4, 7, 32)) + 1).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    jp = {"scale": jnp.asarray(scale)}
    p = tcommon.norm_init(kind, 32, device="cpu")
    with torch.no_grad():
        p.scale.copy_(_t(scale))
        if kind == "layernorm":
            jp["bias"] = jnp.asarray(bias)
            p.bias.copy_(_t(bias))
    want = np.asarray(jcommon.norm_apply(kind, jp, jnp.asarray(x)))
    _close(_np(tcommon.norm_apply(kind, p, _t(x))), want, 1e-5, kind)


def test_rope_and_sinusoid_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.arange(100, 140)
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         10000.0))
    got = tcommon.apply_rope(_t(x), torch.from_numpy(pos), 10000.0)
    # float32 sin and cos of angles up to 140 rad in two libms
    _close(_np(got), want, 1e-5, "rope")
    _close(_np(tcommon.sinusoidal_positions(48, 64)),
           np.asarray(jcommon.sinusoidal_positions(48, 64)), 1e-5, "sinusoid")
    one = tcommon.sinusoidal_at(torch.tensor([37.0]), 64)
    _close(_np(one), np.asarray(jcommon.sinusoidal_positions(48, 64))[37],
           1e-6, "one position")


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jax(gated, act):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    with jax.threefry_partitionable(False):
        jp = jcommon.mlp_init(jax.random.PRNGKey(7), 16, 48, gated=gated)
        want = np.asarray(jcommon.mlp_apply(jp, jnp.asarray(x), act,
                                            jnp.float32))
    mlp = tcommon.MLP(16, 48, gated=gated, device="cpu")
    mlp.reset(prng.PRNGKey(7))
    for name in ("up", "down") + (("gate",) if gated else ()):
        _close(_np(getattr(mlp, name).w), np.asarray(jp[name]["w"]), 1e-6, name)
    got = tcommon.mlp_apply(mlp, _t(x), act, torch.float32)
    _close(_np(got), want, 1e-5, act)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(Sq, Skv, H=4, Hkv=2, Dh=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, Sq, H, Dh)).astype(np.float32),
            rng.standard_normal((2, Skv, Hkv, Dh)).astype(np.float32),
            rng.standard_normal((2, Skv, Hkv, Dh)).astype(np.float32))


@pytest.mark.parametrize("kw,Sq", [
    (dict(causal=True), 40), (dict(causal=False), 40),
    (dict(causal=True, window=8), 40),
    (dict(causal=False, kv_valid_len=23), 40),
    (dict(causal=True, q_offset=30), 10),
])
def test_dense_attention_matches_jax(kw, Sq):
    q, k, v = _qkv(Sq, 40, seed=Sq)
    want = jattn.dense_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    got = tattn.dense_attention(*(_t(a) for a in (q, k, v)), **kw)
    _close(_np(got), np.asarray(want), 1e-5, kw)


@pytest.mark.parametrize("window", [None, 300])
def test_chunked_attention_matches_dense_and_jax(window):
    """Twins of tests/models/test_archs.py's chunked tests at S = 1,024
    with 256-row chunks; the JAX suite's 2e-3 against dense."""
    q, k, v = _qkv(1024, 1024, H=2, Hkv=1 if window else 2, seed=5)
    tq, tk, tv = (_t(a) for a in (q, k, v))
    got = tattn.chunked_attention(tq, tk, tv, causal=True, window=window,
                                  q_chunk=256, kv_chunk=256)
    dense = tattn.dense_attention(tq, tk, tv, causal=True, window=window)
    _close(_np(got), _np(dense), 2e-3, "chunked vs dense")
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=True, window=window, q_chunk=256,
                                   kv_chunk=256)
    _close(_np(got), np.asarray(want), 1e-5, "chunked vs jax")


def test_attention_takes_chunked_above_threshold():
    q, k, v = (_t(a) for a in _qkv(2048 + 1024, 2048 + 1024, H=1, Hkv=1,
                                   Dh=8, seed=6))
    before = dict(tattn.ROUTES)
    got = tattn.attention(q, k, v, causal=True)
    assert tattn.ROUTES["plain"] == before["plain"] + 1
    assert tattn.ROUTES["flash"] == before["flash"]
    want = tattn.chunked_attention(q, k, v, causal=True)
    assert torch.equal(got, want)


def test_route_is_a_function_of_device_causal_window_and_head_width():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tattn.route(cuda, True, None, 128) == "flash"
    for dh in (32, 64):
        assert tattn.route(cuda, True, None, dh) == "flash"
    for dev in (cuda, torch.device("meta")):
        assert tattn.route(dev, True, None, 96) == "flash"    # phi3-mini
        assert tattn.route(dev, True, None, 112) == "flash"   # kimi-k2
    for dev in (cuda, torch.device("meta")):
        assert tattn.route(dev, True, None, 256) == "flash"   # recurrentgemma
        assert tattn.route(dev, True, None, 16) == "flash"    # reduced
        assert tattn.route(dev, True, None, 48) == "flash"    # between widths
    assert tattn.route(cuda, True, None, 264) == "plain"      # past 256
    assert tattn.route(cuda, False, None, 128) == "plain"     # enc, xattn
    assert tattn.route(cuda, True, 2048, 128) == "plain"      # local_attn
    assert tattn.route(cuda, True, 2048, 256) == "plain"      # its window
    assert tattn.route(cpu, True, None, 128) == "plain"
    # under autograd: the kernel has no backward
    assert tattn.route(cuda, True, None, 128, needs_grad=False) == "flash"
    for dh in (16, 32, 64, 96, 112, 128, 256):
        assert tattn.route(cuda, True, None, dh, needs_grad=True) == "plain"
    assert tattn.route(cpu, True, None, 128, needs_grad=True) == "plain"


@pytest.mark.parametrize("S", [100, 200])
def test_padded_flash_route_at_dh_256_on_the_cpu(S):
    """recurrentgemma-9b's head layout (16 over 1 of 256): the route pads to
    its width's tile, (64, 32), and gives the unpadded causal attention."""
    q, k, v = (_t(a) for a in _qkv(S, S, H=16, Hkv=1, Dh=256, seed=S))
    got = tattn.flash_prefill(q, k, v)
    assert tuple(got.shape) == tuple(q.shape)
    want = tattn.dense_attention(q, k, v, causal=True)
    _close(_np(got), _np(want), 1e-5, "padded")


@pytest.mark.parametrize("S", [100, 128, 200])
def test_padded_flash_route_on_the_cpu(S):
    """The card's route (zero-padded to the tile, sliced back) gives the
    unpadded causal attention: on CPU tensors ``flash_prefill`` runs the
    kernel's plain version on the padded sequence."""
    q, k, v = (_t(a) for a in _qkv(S, S, H=4, Hkv=2, Dh=32, seed=S))
    got = tattn.flash_prefill(q, k, v)
    assert tuple(got.shape) == tuple(q.shape)
    want = tattn.dense_attention(q, k, v, causal=True)
    _close(_np(got), _np(want), 1e-5, "padded")


@pytest.mark.parametrize("ring", [False, True])
def test_cache_update_and_decode_match_jax(ring):
    rng = np.random.default_rng(7)
    L, Hkv, H, Dh = 8, 2, 4, 16
    ck = rng.standard_normal((2, L, Hkv, Dh)).astype(np.float32)
    cv = rng.standard_normal((2, L, Hkv, Dh)).astype(np.float32)
    kn = rng.standard_normal((2, 1, Hkv, Dh)).astype(np.float32)
    vn = rng.standard_normal((2, 1, Hkv, Dh)).astype(np.float32)
    q = rng.standard_normal((2, 1, H, Dh)).astype(np.float32)
    window = L if ring else None
    for pos in (5, 11) if ring else (0, 5):
        jc = {"k": jnp.asarray(ck, jnp.bfloat16), "v": jnp.asarray(cv, jnp.bfloat16)}
        jc = jattn.cache_update(jc, jnp.asarray(kn), jnp.asarray(vn),
                                jnp.int32(pos), ring=ring)
        tc = {"k": _t(ck).bfloat16(), "v": _t(cv).bfloat16()}
        tc = tattn.cache_update(tc, _t(kn), _t(vn), pos, ring=ring)
        for name in ("k", "v"):
            assert np.array_equal(_np(tc[name]),
                                  np.asarray(jc[name], np.float32)), (pos, name)
        want = jattn.decode_attention(jnp.asarray(q), jc, jnp.int32(pos),
                                      window=window)
        got = tattn.decode_attention(_t(q), tc, pos, window=window)
        _close(_np(got), np.asarray(want), 1e-5, ("decode", pos))


# ---------------------------------------------------------------------------
# the whole model, six archs
# ---------------------------------------------------------------------------

def test_init_params_reproduce_the_jax_key_tree(arch):
    _, pcfg = _cfgs(arch["name"], "float32")
    got = convert.lm_params_to_numpy(
        build(pcfg, device="cpu").init_params(prng.PRNGKey(0)))
    want = jax.tree_util.tree_flatten_with_path(arch["raw"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(got) == {path for path, _ in want}
    for path, w in want:
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        err = np.abs(g.astype(np.float32) - w.astype(np.float32))
        if path[-1] == jax.tree_util.DictKey("lam"):
            assert float(err.max()) <= 5e-4, path
            continue
        assert float(err.max(initial=0)) <= 1e-3, path
        assert np.mean(err > 1e-6) <= 1e-3, (path, np.mean(err > 1e-6))


def test_convert_round_trips(arch):
    _, pcfg = _cfgs(arch["name"], "float32")
    params = convert.lm_params_from_numpy(arch["params"], pcfg, "cpu")
    back = convert.lm_params_to_numpy(params)
    want = jax.tree_util.tree_flatten_with_path(arch["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == {path for path, _ in want}
    for path, w in want:
        assert np.array_equal(got[path], w), path
    caches = arch["runs"]["bfloat16"]["cache"]
    again = convert.kv_cache_to_numpy(convert.kv_cache_from_numpy(caches))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(caches)[0],
                                jax.tree_util.tree_flatten_with_path(again)[0]):
        assert pa == pb and a.dtype == b.dtype and np.array_equal(a, b), pa


@pytest.mark.parametrize("cd", CDTYPES)
def test_forward_matches_jax(arch, cd):
    model, params, batch = _port(arch, cd)
    with torch.inference_mode():
        got = model.forward(params, batch)
    want = arch["runs"][cd]["full"]
    assert tuple(got.shape) == want.shape
    pad = _np(got)[..., model.cfg.vocab_size:]
    assert pad.size == 0 or float(pad.max()) == -1e30
    _close(_vocab(model.cfg, _np(got)), _vocab(model.cfg, want),
           LOGIT_TOL[cd], (arch["name"], cd))


def _bf16_close(got, want, what, floor=2.0 ** -8):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bad = np.abs(got - want) > 2.0 ** -6 * np.abs(want) \
        + floor * np.abs(want).max()
    assert not bad.any(), (what, int(bad.sum()))


@pytest.mark.parametrize("cd", CDTYPES)
def test_prefill_and_decode_match_jax(arch, cd):
    model, params, batch = _port(arch, cd)
    run = arch["runs"][cd]
    with torch.inference_mode():
        caches = model.init_cache(B, S)
        pre = dict(batch, tokens=batch["tokens"][:, :P])
        lg, caches = model.prefill(params, pre, caches)
        pre_cache = convert.kv_cache_to_numpy(caches)
        steps = [_np(lg[:, 0])]
        for t in range(P, S):
            lg, caches = model.decode_step(params, caches,
                                           batch["tokens"][:, t:t + 1], t)
            steps.append(_np(lg[:, 0]))
    for i, (g, w) in enumerate(zip(steps, run["steps"])):
        _close(_vocab(model.cfg, g), _vocab(model.cfg, w), LOGIT_TOL[cd],
               (arch["name"], cd, "step", i))
    for name, got_c, want_c in (("prefill", pre_cache, run["pre_cache"]),
                                ("decoded", convert.kv_cache_to_numpy(caches),
                                 run["cache"])):
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_flatten_with_path(got_c)[0],
                jax.tree_util.tree_flatten_with_path(want_c)[0]):
            assert pa == pb and a.shape == b.shape, (name, pa)
            kv = pa[-1] in (jax.tree_util.DictKey("k"),
                            jax.tree_util.DictKey("v"))
            if cd == "float32":
                # a recurrent state (the mLSTM's C sums outer products to
                # entries above 10) to 1e-4 of its scale: its gates are
                # bf16 products in float32 compute too, as in the reference
                scale = 1.0 if kv else max(1.0, float(np.abs(b).max()))
                _close(a, b, 1e-4 * scale, (name, pa))
            else:
                # the hybrid and recurrent stacks carry a rounding flip
                # through every step of their recurrences: their entries
                # (states and the local attention's KV) to a bf16 ulp of
                # the leaf's largest, the attention stacks' to half of one
                _bf16_close(a, b, (name, pa), floor=2.0 ** -7 if
                            model.cfg.family in ("hybrid", "ssm")
                            else 2.0 ** -8)


def test_loss_matches_jax(arch):
    for cd in CDTYPES:
        model, params, batch = _port(arch, cd)
        with torch.no_grad():
            got = float(model.loss(params, batch))
        # a mean of B * S log-probabilities over 512 classes
        assert abs(got - arch["runs"][cd]["loss"]) <= (
            1e-5 if cd == "float32" else 2e-3), (cd, got)


@pytest.mark.parametrize("name", ["granite-3-8b", "starcoder2-15b"])
def test_sketched_mlp_loss_matches_jax(name):
    """``lm_loss`` with ``sketched_mlp=True``: the tapped up and down
    layers (no bias) under ``lm_loss``'s ``PRNGKey(17)``, float32."""
    with jax.threefry_partitionable(False):
        jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                                   sketched_mlp=True, compute_dtype="float32")
        m = jax_build(jcfg)
        jp = m.init_params(jax.random.PRNGKey(0))
        batch = _batch(jcfg, seed=3)
        want = float(m.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
        tree = jax.tree.map(np.asarray, jp)
    pcfg = dataclasses.replace(get_config(name).reduced(), sketched_mlp=True,
                               compute_dtype="float32")
    params = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    assert "groups.0.0.0.mlp.up.taps.a" in dict(params.named_parameters())
    with torch.no_grad():
        got = float(build(pcfg, device="cpu").loss(
            params, {k: _t(v) for k, v in batch.items()}))
    assert abs(got - want) <= 1e-5, (got, want)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_matches_forward(name):
    """The port alone: the twin of tests/models/test_archs.py's test, same
    sizes and tolerances (1e-3 in float32, 0.15 in bf16)."""
    cfg = get_config(name).reduced()
    if cfg.n_experts:   # float32 routing and no drops, as the JAX test
        cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                  capacity_factor=8.0)
    m = build(cfg, device="cpu")
    params = m.init_params(prng.PRNGKey(0))
    Bt, St = 2, 32
    batch = {k: _t(v) for k, v in _batch(cfg, seed=9).items()}
    batch["tokens"] = prng.randint(prng.PRNGKey(0), (Bt, St), 0, cfg.vocab_size)
    for k in ("enc_frames", "img_embeds"):
        if k in batch:
            batch[k] = torch.cat([batch[k]] * (Bt // B))
    with torch.inference_mode():
        full = m.forward(params, batch)
        Pt = St // 2
        cache = m.init_cache(Bt, St)
        lg, cache = m.prefill(params, dict(batch, tokens=batch["tokens"][:, :Pt]),
                              cache)
        errs = [float((lg[:, 0] - full[:, Pt - 1]).abs().max())]
        for t in range(Pt, St):
            lg, cache = m.decode_step(params, cache,
                                      batch["tokens"][:, t:t + 1], t)
            errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    tol = 1e-3 if cfg.compute_dtype == "float32" else 0.15
    assert max(errs) < tol, (name, errs)


@pytest.mark.parametrize("name", ARCHS)
def test_param_count_matches_analytic(name):
    """The twin of tests/models/test_archs.py's test, on the meta device
    (no allocation), and the count equals the JAX package's init."""
    cfg = get_config(name).reduced()
    shapes_ = build(cfg, device="cpu").param_shapes()
    assert all(p.device.type == "meta" for p in shapes_.parameters())
    total = sum(p.numel() for p in shapes_.parameters())
    analytic = cfg.n_params()
    assert abs(total - analytic) / analytic < 0.08, (name, total, analytic)
    jshapes = jax_build(jax_get_config(name).reduced()).param_shapes()
    assert total == sum(int(np.prod(leaf.shape))
                        for leaf in jax.tree.leaves(jshapes))


def test_every_block_type_builds():
    """``make_block`` builds all ten block types, each with ``reset``,
    ``seq``, ``prefill`` and ``step``, and a zero cache."""
    used = {b for name in list_archs()
            for pattern, _ in get_config(name).groups for b in pattern}
    assert used | {"enc"} == set(tt.BLOCKS) and len(tt.BLOCKS) == 10
    for btype in sorted(tt.BLOCKS):
        cfg = next(get_config(n).reduced() for n in list_archs()
                   if any(btype in p for p, _ in get_config(n).groups)
                   or (btype == "enc" and get_config(n).is_encdec))
        blk = tt.make_block(btype, cfg, device="meta")
        assert all(hasattr(blk, f) for f in ("reset", "seq", "prefill",
                                             "step")), btype
        cache = tt.block_cache_init(btype, cfg, 1, 8, device="meta")
        assert cache, btype


@pytest.mark.parametrize("cd", CDTYPES)
def test_bf16_parameters_match_jax(cd):
    """Reduced moonshot with ``param_dtype="bfloat16"`` (the precision it
    serves in at full width): the init and the forward against the JAX
    package's on the same bf16 weights."""
    name = "moonshot-v1-16b-a3b"
    kw = dict(param_dtype="bfloat16", compute_dtype=cd)
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), **kw)
    pcfg = dataclasses.replace(get_config(name).reduced(), **kw)
    with jax.threefry_partitionable(False):
        jp = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
        batch = _batch(jcfg, seed=4)
        want = np.asarray(jax_build(jcfg).loss(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}))
        ctx = {"positions": jnp.arange(S), "xattn_ctx": None}
        x = jt._embed_tokens(jp, jcfg, jnp.asarray(batch["tokens"]))
        x, _, _ = jt._backbone(jp, jcfg, x, ctx, mode="seq")
        full = np.asarray(jt._logits(jp, jcfg, x))
    tree = jax.tree.map(np.asarray, jp)
    own = build(pcfg, device="cpu").init_params(prng.PRNGKey(0))
    for n, p in own.named_parameters():
        leaf = convert.lm_leaf(tree, n)
        assert str(p.dtype).split(".")[-1] == str(leaf.dtype), n
        err = np.abs(_np(p) - leaf.astype(np.float32))
        # bf16 leaves equal but for the odd normal an ulp off on a bf16
        # rounding edge; float32 leaves (the routers, the norms) within an
        # ulp or two
        tol = 0.0 if p.dtype == torch.bfloat16 else 1e-6
        assert np.mean(err > tol) <= 1e-3, n
    params = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    assert params.groups[1][0][0].moe.w_up.dtype == torch.bfloat16
    assert params.groups[1][0][0].moe.router.w.dtype == torch.float32
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = build(pcfg, device="cpu").forward(params, tb)
        loss = float(build(pcfg, device="cpu").loss(params, tb))
    _close(_vocab(pcfg, _np(got)), _vocab(pcfg, full), LOGIT_TOL[cd], cd)
    assert abs(loss - float(want)) <= (1e-5 if cd == "float32" else 2e-3)


def test_full_width_granite_shapes_on_meta():
    """granite-3-8b at full width, built on the meta device: 8.37e9
    parameters (7.97e9 in blocks), as ``n_params`` counts, and a bf16 KV
    cache of 163,840 bytes a token."""
    m = build("granite-3-8b", device="cpu")
    params = m.param_shapes()
    total = sum(p.numel() for p in params.parameters())
    assert total == m.cfg.n_params() + sum(
        p.numel() for n, p in params.named_parameters() if "norm" in n)
    blocks = sum(p.numel() for n, p in params.named_parameters()
                 if n.startswith("groups."))
    assert round(blocks / 1e9, 2) == 7.97 and round(total / 1e9, 2) == 8.37
    caches = m.cache_shapes(1, 10)
    per_token = sum(t.numel() * t.element_size() for g in caches
                    for layer in g for c in layer for t in c.values()) / 10
    assert per_token == 163_840


def _cache_bytes(caches):
    return sum(t.numel() * t.element_size() for g in caches for layer in g
               for c in layer for t in _leaves(c))


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


def test_full_width_moe_and_recurrent_shapes_on_meta():
    """moonshot-v1-16b-a3b at full width in bf16 parameters: 28.39e9
    parameters (n_params, plus the norms) in 56.8 GB (the routers float32)
    and a bf16 KV cache of 393,216 bytes a token. recurrentgemma-9b and
    xlstm-350m: a recurrent block's cache does not grow with max_len (the
    local attention's ring stops at the window)."""
    m = build("moonshot-v1-16b-a3b", device="cpu", param_dtype="bfloat16")
    params = m.param_shapes()
    total = sum(p.numel() for p in params.parameters())
    assert total == m.cfg.n_params() + sum(
        p.numel() for n, p in params.named_parameters() if "norm" in n)
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    assert round(total / 1e9, 2) == 28.39 and round(nbytes / 1e9, 1) == 56.8
    assert _cache_bytes(m.cache_shapes(1, 10)) / 10 == 393_216
    for name in ("recurrentgemma-9b", "xlstm-350m"):
        m = build(name, device="cpu")
        assert _cache_bytes(m.cache_shapes(2, 4096)) == \
            _cache_bytes(m.cache_shapes(2, 8192))
