"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, and the twins of
tests/models/test_moe_serve.py's dispatch invariants.

Parameters are drawn by the JAX package under a key (and by the port from
the same key, for the init test) and handed to both as numpy arrays, as
are the inputs, made with numpy from a seed. Every jax call runs under
``jax.threefry_partitionable(False)``, the key tree the port reproduces.

Tolerances:
* float32 compute: within 1e-5 of the JAX output (outputs of scale 1;
  float32 products of d = 32 or d_ff = 48 terms summed in another order,
  softmax and SiLU in another libm); the aux loss within 1e-6;
* bf16 compute: the same 1e-5 where no rounding flips (the bf16 operands'
  products are exact in float32), and measured within it on these inputs;
* routing (expert ids) and the kept assignments: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch import convert, prng
from repro_torch.models import moe

TOL = 1e-5
_CD = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@dataclasses.dataclass
class Layer:
    jp: dict          # the JAX parameters (jax arrays)
    tp: moe.MoE       # the port's, the same values


def _layer(seed, d, dff, E, shared=0, gated=True, dtype="float32"):
    with jax.threefry_partitionable(False):
        jp = jmoe.moe_init(jax.random.PRNGKey(seed), d, dff, E,
                           n_shared=shared, gated=gated,
                           dtype=_CD[dtype][1])
    tp = moe.MoE(d, dff, E, n_shared=shared, gated=gated,
                 dtype=_CD[dtype][0], device="cpu")
    with torch.no_grad():
        for name, p in tp.named_parameters():
            leaf = jp
            for part in name.split("."):
                leaf = leaf[part]
            p.copy_(convert.tensor_from_numpy(np.asarray(leaf)))
    return Layer(jp, tp.requires_grad_(False))


def _x(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def _both(layer, x, **kw):
    cd = kw.pop("cd", "float32")
    want, aux_w = jmoe.moe_apply(layer.jp, jnp.asarray(x),
                                 compute_dtype=_CD[cd][1], **kw)
    got, aux_g = moe.moe_apply(layer.tp, torch.from_numpy(x),
                               compute_dtype=_CD[cd][0], **kw)
    assert got.dtype == torch.float32 and aux_g.dtype == torch.float32
    return (got.numpy(), float(aux_g)), (np.asarray(want), float(aux_w))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("shared", [0, 2])
def test_init_reproduces_the_jax_key_tree(shared, gated):
    with jax.threefry_partitionable(False):
        jp = jmoe.moe_init(jax.random.PRNGKey(3), 24, 40, 6, n_shared=shared,
                           gated=gated, dtype=jnp.bfloat16)
    tp = moe.MoE(24, 40, 6, n_shared=shared, gated=gated,
                 dtype=torch.bfloat16, device="cpu")
    tp.reset(prng.PRNGKey(3))
    names = {n for n, _ in tp.named_parameters()}
    want = {".".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert names == set(want)
    assert tp.router.w.dtype == torch.float32          # the router stays f32
    for name, p in tp.named_parameters():
        w = np.asarray(want[name], np.float32)
        g = p.detach().float().numpy()
        assert g.shape == w.shape, name
        # normals within an ulp or two, rounded to bf16 alike: equal but
        # for the odd draw on a rounding edge
        err = np.abs(g - w)
        assert float(err.max()) <= 2.0 ** -7 * float(np.abs(w).max()), name
        assert np.mean(err > 1e-6) <= 1e-3, name


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("capacity", [0.5, 1.25, 4.0])
def test_moe_apply_matches_jax(capacity, shared, cd):
    layer = _layer(1, 32, 48, 8, shared=shared, dtype=cd)
    x = _x(2, 2, 24, 32)
    (got, aux_g), (want, aux_w) = _both(layer, x, top_k=2,
                                        capacity_factor=capacity, cd=cd)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert abs(aux_g - aux_w) <= 1e-6
    if capacity == 0.5:        # pressure: some rows lose an expert
        full, _ = _both(layer, x, top_k=2, capacity_factor=4.0, cd=cd)[0]
        assert np.abs(got - full).max() > 1e-3


def test_zero_router_ties_pick_the_lower_expert_ids():
    """A zero router makes every probability equal: ``jax.lax.top_k``
    returns experts 0..k-1 for every token, and so must the port."""
    layer = _layer(4, 16, 24, 8)
    layer.jp["router"]["w"] = jnp.zeros_like(layer.jp["router"]["w"])
    with torch.no_grad():
        layer.tp.router.w.zero_()
    x = _x(5, 1, 32, 16)
    probs = np.full((32, 8), 1 / 8, np.float32)
    _, want_ids = jax.lax.top_k(jnp.asarray(probs), 3)
    _, got_ids = moe.top_k_stable(torch.from_numpy(probs), 3)
    assert np.array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert np.array_equal(got_ids.numpy(), np.tile(np.arange(3), (32, 1)))
    (got, aux_g), (want, aux_w) = _both(layer, x, top_k=3,
                                        capacity_factor=1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert abs(aux_g - aux_w) <= 1e-6


def test_top_k_matches_jax_with_ties():
    rng = np.random.default_rng(6)
    probs = rng.integers(0, 4, (64, 12)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 5)
    got_v, got_i = moe.top_k_stable(torch.from_numpy(probs), 5)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


def test_full_capacity_matches_dense_experts():
    """The twin of test_moe_serve.py::test_moe_full_capacity_matches_dense_
    experts: with capacity above every assignment, the sort-and-write
    dispatch equals per-token expert evaluation (the JAX test's 2e-3)."""
    B, S, d, dff, E, k = 2, 8, 16, 32, 4, 2
    layer = _layer(0, d, dff, E)
    p = layer.tp
    x = torch.from_numpy(_x(7, B, S, d))
    out, _ = moe.moe_apply(p, x, top_k=k, capacity_factor=float(E),
                           act="silu", compute_dtype=torch.float32)
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt @ p.router.w, -1)
    gates, eids = moe.top_k_stable(probs, k)
    gates = gates / gates.sum(-1, keepdim=True)
    ref = torch.zeros_like(xt)
    with torch.no_grad():
        for e in range(E):
            y = (torch.nn.functional.silu(xt @ p.w_gate[e])
                 * (xt @ p.w_up[e])) @ p.w_down[e]
            for j in range(k):
                ref += torch.where((eids[:, j] == e)[:, None],
                                   gates[:, j:j + 1] * y, 0.0)
    torch.testing.assert_close(out.reshape(-1, d), ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("T,E,seed", [(16, 4, 0), (64, 8, 1), (64, 4, 2),
                                      (16, 8, 3)])
def test_capacity_drop_is_full_or_zero(T, E, seed):
    """The twin of test_moe_serve.py's property test: top_k = 1, no
    shared experts, capacity 0.5: every token's row is its full-capacity
    row (kept) or exactly zero (dropped), and not every row is dropped."""
    layer = _layer(seed, 8, 16, E)
    x = torch.from_numpy(_x(seed + 100, 1, T, 8))
    kw = dict(top_k=1, act="silu", compute_dtype=torch.float32)
    lo, _ = moe.moe_apply(layer.tp, x, capacity_factor=0.5, **kw)
    hi, _ = moe.moe_apply(layer.tp, x, capacity_factor=float(E), **kw)
    lo, hi = lo.reshape(T, 8).numpy(), hi.reshape(T, 8).numpy()
    assert np.isfinite(lo).all()
    row_is_full = np.all(np.abs(lo - hi) < 1e-4, axis=-1)
    row_is_zero = np.all(np.abs(lo) < 1e-5, axis=-1)
    assert np.all(row_is_full | row_is_zero)
    assert row_is_full.any() and not row_is_full.all()


def test_aux_loss_of_a_balanced_router_is_minimal():
    """The twin of test_moe_serve.py::test_moe_aux_loss_balanced_router_is_
    minimal: a zero router's aux loss is about 1."""
    layer = _layer(0, 8, 16, 4)
    with torch.no_grad():
        layer.tp.router.w.zero_()
    x = torch.from_numpy(_x(8, 1, 64, 8))
    _, aux = moe.moe_apply(layer.tp, x, top_k=1, capacity_factor=4.0,
                           act="silu", compute_dtype=torch.float32)
    assert 0.9 < float(aux) < 1.1


def test_decode_capacity_drops_as_the_reference_does():
    """T = 4 tokens, E = 64, k = 6: C = ceil(4 * 6 / 64 * 1.25) = 1, so an
    expert chosen by two tokens keeps only the first; the port drops the
    same assignments as the JAX package. At T = 1 nothing is dropped."""
    layer = _layer(9, 16, 8, 64)
    for T in (4, 1):
        x = _x(10 + T, T, 1, 16)
        (got, _), (want, _) = _both(layer, x, top_k=6, capacity_factor=1.25)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    x = torch.from_numpy(_x(11, 1, 1, 16))
    kw = dict(top_k=6, act="silu", compute_dtype=torch.float32)
    one, _ = moe.moe_apply(layer.tp, x, capacity_factor=1.25, **kw)
    full, _ = moe.moe_apply(layer.tp, x, capacity_factor=64.0, **kw)
    # the same products in a buffer of another capacity, which BLAS may
    # block otherwise: float32 rounding only
    torch.testing.assert_close(one, full, rtol=0, atol=1e-6)


def test_two_runs_are_equal_bit_for_bit():
    layer = _layer(12, 32, 48, 8, shared=1, dtype="bfloat16")
    x = torch.from_numpy(_x(13, 2, 40, 32))
    kw = dict(top_k=2, act="silu", compute_dtype=torch.bfloat16)
    a, aux_a = moe.moe_apply(layer.tp, x, **kw)
    b, aux_b = moe.moe_apply(layer.tp, x, **kw)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
