"""The port's recurrent blocks (``repro_torch.models.rglru`` and
``repro_torch.models.xlstm``) against the JAX package's, and the twins of
tests/models/test_archs.py's scan-against-step tests.

Parameters are drawn by the JAX package under a key and handed to the
port as numpy arrays (the init tests draw them on both sides from the same
key); inputs are made with numpy from a seed. Every jax call runs under
``jax.threefry_partitionable(False)``.

Tolerances:
* the RG-LRU scan: within 1e-5 of JAX (the same odd/even reduction, so
  the float32 products and sums are taken in the reference's order; the
  gates' sigmoid, softplus and exp in another libm), and within the JAX
  suite's 1e-4 of the port's own step loop;
* the mLSTM chunked form: within 1e-4 of JAX (cumulative sums, exps and
  (L, L) products in another order, on outputs of scale 1), and within the
  JAX suite's 5e-3 of a step loop;
* whole blocks in float32 compute: 1e-4 (a bf16 gate product inside, as
  in the reference: a float32 difference moves a bf16 rounding now and
  then, by at most a bf16 ulp of a gate value);
* caches: float32 leaves within 1e-4, bf16 leaves within 2 bf16 ulps.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrg
from repro.models import xlstm as jx
from repro_torch import convert, prng
from repro_torch.models import rglru, xlstm

_CD = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _t(x):
    return convert.tensor_from_numpy(np.asarray(x))


def _np(t):
    return t.detach().float().numpy()


def _load(module, jp):
    """Copy the JAX dict ``jp`` into the port's module, leaf by leaf."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = jp
            for part in name.split("."):
                leaf = leaf[part]
            p.copy_(_t(leaf))
    return module.requires_grad_(False)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

D, W = 48, 32


@pytest.fixture(scope="module")
def lru():
    with jax.threefry_partitionable(False):
        jp = jrg.rglru_init(jax.random.PRNGKey(0), D, W)
    return jp, _load(rglru.RGLRU(D, W, device="cpu"), jp)


def test_rglru_init_reproduces_the_jax_key_tree(lru):
    jp, _ = lru
    p = rglru.RGLRU(D, W, device="cpu")
    p.reset(prng.PRNGKey(0))
    for name, t in p.named_parameters():
        leaf = jp
        for part in name.split("."):
            leaf = leaf[part]
        # lam = log(exp(y) - 1) with y = -log(u) / 4 down to 2.5e-4: an
        # ulp of exp(y) moves lam by up to 4.8e-4; the normals within an
        # ulp or two
        _close(_np(t), leaf, 5e-4 if name == "lam" else 1e-6, name)
    u = prng.uniform(prng.split(prng.PRNGKey(0), 6)[0], (W,), 0.9, 0.999)
    with jax.threefry_partitionable(False):
        want = jax.random.uniform(jax.random.split(jax.random.PRNGKey(0), 6)[0],
                                  (W,), jnp.float32, 0.9, 0.999)
    assert np.array_equal(u.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", [64, 37, 1])
def test_associative_scan_matches_jax(S):
    """Cumulative sums and the RG-LRU pair on odd and even lengths."""
    x = _normal(S, 2, S, 5)
    want = jax.lax.associative_scan(jnp.add, jnp.asarray(x), axis=1)
    got = rglru.associative_scan(lambda a, b: (a[0] + b[0],), (_t(x),))[0]
    _close(_np(got), want, 1e-5, "cumsum")
    a = np.exp(-np.abs(x))
    ja, jb = jax.lax.associative_scan(
        lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
        (jnp.asarray(a), jnp.asarray(x)), axis=1)
    ta, tb = rglru.associative_scan(rglru._combine, (_t(a), _t(x)))
    _close(_np(ta), ja, 1e-6, "a")
    _close(_np(tb), jb, 1e-5, "h")


@pytest.mark.parametrize("h0", [False, True])
def test_rglru_seq_matches_jax(lru, h0):
    jp, p = lru
    x = _normal(1, 2, 64, W)
    h = _normal(2, 2, W) if h0 else None
    want, want_last = jrg.rglru_seq(jp, jnp.asarray(x),
                                    None if h is None else jnp.asarray(h))
    got, got_last = rglru.rglru_seq(p, _t(x), None if h is None else _t(h))
    _close(_np(got), want, 1e-5, "y")
    _close(_np(got_last), want_last, 1e-5, "h")


def test_rglru_scan_matches_step(lru):
    """The twin of test_archs.py::test_rglru_associative_scan_matches_step
    (B 2, S 64, W 32; the JAX suite's 1e-4), on the JAX weights."""
    _, p = lru
    x = _t(_normal(1, 2, 64, W))
    y_par, h_final = rglru.rglru_seq(p, x)
    h = torch.zeros(2, W)
    ys = []
    for t in range(64):
        y, h = rglru.rglru_step(p, x[:, t], h)
        ys.append(y)
    torch.testing.assert_close(y_par, torch.stack(ys, 1), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h_final, h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_rglru_block_seq_and_steps_match_jax(lru, cd):
    """The block over a sequence, then steps from a carried conv state and
    h (the conv state rounded to the compute dtype, as the block cache
    holds it)."""
    jp, p = lru
    tcd, jcd = _CD[cd]
    x = _normal(3, 2, 16, D)
    _close(_np(rglru.rglru_block_seq(p, _t(x), tcd)),
           jrg.rglru_block_seq(jp, jnp.asarray(x), jcd), 1e-4, "seq")
    jc = jrg.rglru_block_cache_init(2, W, jcd)
    jc = {"h": jnp.asarray(_normal(4, 2, W)),
          "conv": jnp.asarray(_normal(5, 2, 3, W)).astype(jcd)}
    tc = {k: _t(v).clone() for k, v in jc.items()}
    assert tc["conv"].dtype == tcd
    for t in range(4):
        xt = x[:, t:t + 1]
        want, jc = jrg.rglru_block_step(jp, jnp.asarray(xt), jc, jcd)
        got, tc = rglru.rglru_block_step(p, _t(xt), tc, tcd)
        _close(_np(got), want, 1e-4, ("step", t))
        _close(_np(tc["h"]), jc["h"], 1e-4, ("h", t))
        _close(_np(tc["conv"]), jc["conv"],
               1e-6 if cd == "float32" else 2 ** -7 * 4, ("conv", t))
        assert tc["conv"].dtype == tcd


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_inputs(S, B=1, H=2, Dh=8, seed=0):
    """test_archs.py's construction of q, k, v and the gates, numpy-drawn."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, Dh)).astype(np.float32)
               for _ in range(3))
    f = rng.standard_normal((B, H, S)).astype(np.float32) + 2.0
    log_f = np.asarray(jax.nn.log_sigmoid(jnp.asarray(f)))
    log_i = rng.standard_normal((B, H, S)).astype(np.float32) - 1.0
    return q, k, v, log_f, log_i


def _mlstm_steps(q, k, v, log_f, log_i):
    """The recurrence one step at a time (test_archs.py's reference)."""
    B, H, S, Dh = q.shape
    C = torch.zeros(B, H, Dh, Dh)
    n = torch.zeros(B, H, Dh)
    m = torch.full((B, H), -1e30)
    outs = []
    for t in range(S):
        m_new = torch.maximum(log_f[..., t] + m, log_i[..., t])
        df = torch.exp(log_f[..., t] + m - m_new)
        di = torch.exp(log_i[..., t] - m_new)
        C = df[..., None, None] * C + di[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", k[..., t, :], v[..., t, :])
        n = df[..., None] * n + di[..., None] * k[..., t, :]
        num = torch.einsum("bhd,bhde->bhe", q[..., t, :], C) / math.sqrt(Dh)
        den = torch.maximum(torch.abs(torch.einsum(
            "bhd,bhd->bh", n, q[..., t, :])) / math.sqrt(Dh),
            torch.exp(-m_new))
        outs.append(num / den[..., None])
        m = m_new
    return torch.stack(outs, dim=2), (C, n, m)


def test_mlstm_chunked_matches_jax_and_steps():
    """S = 512 (two chunks, B 1, H 2, Dh 8): the JAX package's chunked form
    within 1e-4, its carry too; the twin of test_archs.py::test_mlstm_
    chunked_matches_stepwise within its 5e-3."""
    ins = _mlstm_inputs(512)
    want, (jC, jn, jm) = jx._mlstm_chunk_parallel(*(jnp.asarray(a)
                                                     for a in ins))
    got, (C, n, m) = xlstm._mlstm_chunk_parallel(*(_t(a) for a in ins))
    _close(_np(got), want, 1e-4, "h")
    for g, w, name in ((C, jC, "C"), (n, jn, "n"), (m, jm, "m")):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    h_seq, (sC, sn, sm) = _mlstm_steps(*(_t(a) for a in ins))
    torch.testing.assert_close(got, h_seq, rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(m, sm, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [100, 256])
def test_mlstm_single_chunk_matches_jax_and_steps(S):
    ins = _mlstm_inputs(S, B=2, seed=S)
    want, (jC, jn, jm) = jx._mlstm_chunk_parallel_single(
        *(jnp.asarray(a) for a in ins))
    got, (C, n, m) = xlstm._mlstm_chunk_parallel_single(*(_t(a) for a in ins))
    _close(_np(got), want, 1e-4, "h")
    for g, w, name in ((C, jC, "C"), (n, jn, "n"), (m, jm, "m")):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    h_seq, _ = _mlstm_steps(*(_t(a) for a in ins))
    torch.testing.assert_close(got, h_seq, rtol=5e-3, atol=5e-3)


def test_mlstm_masks_give_no_nan():
    """Masked log weights are -inf and the stabilizer starts at -1e30:
    exp(-inf - m) is 0, never NaN, even where every gate is tiny."""
    q, k, v, log_f, log_i = (_t(a) for a in _mlstm_inputs(512))
    got, (C, n, m) = xlstm._mlstm_chunk_parallel(q, k, v, log_f - 80.0,
                                                 log_i - 80.0)
    assert torch.isfinite(got).all() and torch.isfinite(C).all()


XD, XH = 32, 2
XDI = int(XD * 2.0)


@pytest.fixture(scope="module")
def mlstm():
    with jax.threefry_partitionable(False):
        jp = jx.mlstm_init(jax.random.PRNGKey(1), XD, XH)
    return jp, _load(xlstm.MLSTM(XD, XH, device="cpu"), jp)


def test_mlstm_init_reproduces_the_jax_key_tree(mlstm):
    jp, _ = mlstm
    p = xlstm.MLSTM(XD, XH, dtype=torch.bfloat16, device="cpu")
    p.reset(prng.PRNGKey(1))
    assert p.w_if.w.dtype == torch.float32 and p.wq.w.dtype == torch.bfloat16
    for name, t in p.named_parameters():
        leaf = jp
        for part in name.split("."):
            leaf = leaf[part]
        want = np.asarray(jnp.asarray(leaf).astype(
            jnp.float32 if name == "w_if.w" else jnp.bfloat16), np.float32)
        _close(_np(t), want, 2 ** -8 * float(np.abs(want).max()), name)


@pytest.mark.parametrize("S", [512, 24])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_mlstm_block_seq_state_and_steps_match_jax(mlstm, cd, S):
    """The block over S tokens (512: the chunked form; 24: the single
    chunk) with its end state, then 3 decode steps from that state."""
    jp, p = mlstm
    tcd, jcd = _CD[cd]
    x = 0.5 * _normal(6, 2, S + 3, XD)
    want, jstate = jx.mlstm_block_seq(jp, jnp.asarray(x[:, :S]), XH, jcd,
                                      return_state=True)
    got, state = xlstm.mlstm_block_seq(p, _t(x[:, :S]), XH, tcd,
                                       return_state=True)
    tol = 1e-4 if cd == "float32" else 0.05
    _close(_np(got), want, tol, "seq")
    assert set(state) == {"C", "n", "m", "conv"}
    for name in state:
        np.testing.assert_allclose(_np(state[name]), np.asarray(jstate[name]),
                                   rtol=1e-3, atol=tol, err_msg=name)
    cache = xlstm.mlstm_cache_init(2, XH, XDI // XH, XDI, device="cpu")
    for name in cache:
        cache[name].copy_(_t(jstate[name]))
    jc = jstate
    for t in range(S, S + 3):
        xt = x[:, t:t + 1]
        w, jc = jx.mlstm_block_step(jp, jnp.asarray(xt), jc, XH, jcd)
        g, cache = xlstm.mlstm_block_step(p, _t(xt), cache, XH, tcd)
        _close(_np(g), w, tol, ("step", t))
        for name in cache:
            np.testing.assert_allclose(_np(cache[name]), np.asarray(jc[name]),
                                       rtol=1e-3, atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slstm():
    with jax.threefry_partitionable(False):
        jp = jx.slstm_init(jax.random.PRNGKey(2), XD, XH)
    return jp, _load(xlstm.SLSTM(XD, XH, device="cpu"), jp)


def test_slstm_init_reproduces_the_jax_key_tree(slstm):
    jp, _ = slstm
    p = xlstm.SLSTM(XD, XH, device="cpu")
    p.reset(prng.PRNGKey(2))
    assert p.w_ff.up.w.shape == (XD, int(XD * 4 / 3))
    for name, t in p.named_parameters():
        leaf = jp
        for part in name.split("."):
            leaf = leaf[part]
        _close(_np(t), leaf, 1e-6, name)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_slstm_block_seq_state_and_steps_match_jax(slstm, cd):
    jp, p = slstm
    tcd, jcd = _CD[cd]
    x = _normal(7, 2, 19, XD)
    want, jstate = jx.slstm_block_seq(jp, jnp.asarray(x[:, :16]), jcd,
                                      return_state=True)
    got, state = xlstm.slstm_block_seq(p, _t(x[:, :16]), tcd,
                                       return_state=True)
    tol = 1e-4 if cd == "float32" else 0.05
    _close(_np(got), want, tol, "seq")
    assert set(state) == {"h", "c", "n", "m"}
    for name in state:
        _close(_np(state[name]), jstate[name], tol, name)
    cache = xlstm.slstm_cache_init(2, XD, device="cpu")
    for name in cache:
        cache[name].copy_(_t(jstate[name]))
    jc = jstate
    for t in range(16, 19):
        xt = x[:, t:t + 1]
        w, jc = jx.slstm_block_step(jp, jnp.asarray(xt), jc, jcd)
        g, cache = xlstm.slstm_block_step(p, _t(xt), cache, tcd)
        _close(_np(g), w, tol, ("step", t))
        for name in cache:
            _close(_np(cache[name]), jc[name], tol, (name, t))
