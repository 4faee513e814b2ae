"""Gradient-tap dense layer: the paper's one-pass product sketch applied to
the factored form of the weight gradient.

The port of ``repro.train.sketched_dense``. For a dense layer y = x W,
autodiff gives dW = X^T dY with X (T x n_in) and dY (T x n_out), T tokens:
the paper's A^T B with the long streamed dimension d = T. The layer's
parameters carry zero *tap* tensors ``{a: (k, n_in), b: (k, n_out), na2:
(n_in,), nb2: (n_out,)}``; the backward pass writes the one-pass summary of
(X, dY) into the taps' gradients and zeros into W's, so the sketches ride
the ordinary gradients (summed over workers like any gradient, since
sketches and squared norms add over token shards), and
``decompress_tapped_grads`` runs the same-keyed SMP-PCA completion to
form the rank-r dW on every worker.

The JAX ``custom_vjp`` becomes a ``torch.autograd.Function`` whose inputs
are W, the four tap tensors one by one (``a``, ``b``, ``na2``, ``nb2``:
PyTorch wants one gradient per tensor input), x, the key, k and the block;
the last three take no gradient. Make the taps leaves with
``requires_grad=True`` to collect their gradients.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core import streaming
from repro_torch.core.smppca import smppca_from_summary
from repro_torch.core.summary_engine import tap_pair_summary

TAP_FIELDS = ("a", "b", "na2", "nb2")


class TapConfig(NamedTuple):
    sketch_k: int = 64
    rank: int = 8
    sample_factor: int = 8
    als_iters: int = 4
    block: int = 2048           # kept for the JAX package's signature


def tap_init(n_in: int, n_out: int, k: int,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Zero taps of a (n_in, n_out) layer with a k-row sketch, on
    ``device``."""
    dev = _device.resolve(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return {"a": zeros(k, n_in), "b": zeros(k, n_out), "na2": zeros(n_in),
            "nb2": zeros(n_out)}


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with w in x's dtype, summed in float32 into a float32 result
    (products of bf16 values are exact in float32)."""
    return torch.matmul(x.float(), w.to(x.dtype).float())


class _SketchedDense(torch.autograd.Function):
    """y = x @ w; the backward pass gives the taps' sketches, zero dW and
    the layer's own dx."""

    @staticmethod
    def forward(ctx, w, a, b, na2, nb2, x, key, k, block):
        del a, b, na2, nb2, block
        ctx.save_for_backward(w, x, key)
        ctx.k = k
        return _dense(x, w)

    @staticmethod
    def backward(ctx, gy):
        w, x, key = ctx.saved_tensors
        n_in, n_out = w.shape
        dx = torch.matmul(gy.to(x.dtype), w.to(x.dtype).T).to(x.dtype)
        taps = tap_pair_summary(key, x.reshape(-1, n_in).float(),
                                gy.reshape(-1, n_out).float(), ctx.k)
        # dW is never formed: the taps carry its one-pass summary
        return (torch.zeros_like(w), *taps, dx, None, None, None)


def sketched_dense(w: torch.Tensor, taps: Dict[str, torch.Tensor],
                   x: torch.Tensor, key: torch.Tensor, k: int = 64,
                   block: int = 2048) -> torch.Tensor:
    """y = x @ w (float32); its backward pass writes the k-row sketches of
    (x, dy) and their squared column norms into the taps' gradients, and
    zeros into w's. x (..., n_in), w (n_in, n_out)."""
    return _SketchedDense.apply(w, *(taps[f] for f in TAP_FIELDS), x,
                                key.to(x.device), k, block)


def tap_state(tap_grads: Dict[str, torch.Tensor]) -> streaming.StreamState:
    """A tap-gradient dict as a partial ``streaming.StreamState``: {a, b}
    the running sketches, {na2, nb2} the running squared norms. The taps'
    Pi is drawn per call over the tokens, not per global row, so the state
    carries no key or plan: it can be merged and finalized, not updated."""
    return streaming.StreamState(
        key=None, A_acc=tap_grads["a"], B_acc=tap_grads["b"],
        na2=torch.clamp(tap_grads["na2"], min=0.0),
        nb2=torch.clamp(tap_grads["nb2"], min=0.0),
        rows_seen=streaming._count(0), row_high=streaming._count(0),
        d_total=streaming._count(-1), signs=None, srows=None)


def accumulate_taps(t1: Dict[str, torch.Tensor],
                    t2: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Merge the tap gradients of two microbatches: ``merge_states`` of
    their states, so accumulating and then decompressing equals
    decompressing the summary of the concatenated tokens."""
    m = streaming.merge_states(tap_state(t1), tap_state(t2))
    return {"a": m.A_acc, "b": m.B_acc, "na2": m.na2, "nb2": m.nb2}


def decompress_tap(key: torch.Tensor, tap_grads: Dict[str, torch.Tensor],
                   cfg: TapConfig) -> torch.Tensor:
    """The same-keyed SMP-PCA completion of a tapped summary: the rank-r
    dW (n_in, n_out), on the taps' device."""
    summary = streaming.finalize_state(tap_state(tap_grads))
    n1, n2 = summary.n1, summary.n2
    m = int(cfg.sample_factor * (n1 + n2) * cfg.rank)
    res = smppca_from_summary(key, summary, r=cfg.rank, m=m, T=cfg.als_iters,
                              device=tap_grads["a"].device)
    return res.factors.U @ res.factors.V.T


def _layer_keys(key: torch.Tensor, leaf_paths, layers):
    """The key the JAX package's tree walk gives each tapped layer.
    ``leaf_paths``: every leaf's path in the tree (its dict keys and
    list/tuple indices); ``layers``: ``{path of a {'w', 'taps'} node:
    count}``, count the layers of a stacked group or None. Down a path the
    key takes ``fold_in`` of each entry's index among its dict's sorted
    keys, or of its list index; a stacked group's key is then ``split(key,
    count)``, one a layer. Returns ``{path: key or (count, 2) keys}``."""
    children: Dict[tuple, set] = {}
    for path in leaf_paths:
        for i in range(len(path)):
            children.setdefault(path[:i], set()).add(path[i])
    out = {}
    for path, count in layers.items():
        k = key
        for i, part in enumerate(path):
            idx = part if isinstance(part, int) else \
                sorted(children[path[:i]]).index(part)
            k = prng.fold_in(k, idx)
        out[path] = k if count is None else prng.split(k, count)
    return out


def _leaves(node, path=()):
    if isinstance(node, dict):
        for kk, vv in node.items():
            yield from _leaves(vv, path + (kk,))
    elif isinstance(node, (list, tuple)):
        for i, vv in enumerate(node):
            yield from _leaves(vv, path + (i,))
    else:
        yield path, node


def decompress_tapped_grads(key: torch.Tensor, grads, cfg: TapConfig):
    """Walk a gradient tree; wherever a dict holds {'w', 'taps'}, put the
    SMP-PCA reconstruction in place of the zero dW and zero the taps, each
    layer under its key from ``_layer_keys`` (a stacked (L, ...) group,
    one key a layer)."""
    leaves = dict(_leaves(grads))
    layers = {p[:-2]: (v.shape[0] if v.ndim == 3 else None)
              for p, v in leaves.items()
              if p[-2:] == ("taps", "a") and p[:-2] + ("w",) in leaves}
    keys = _layer_keys(key, leaves, layers)

    def walk(path, node):
        if path in keys:
            node = dict(node)
            taps, k = node["taps"], keys[path]
            if layers[path] is not None:
                recon = torch.stack([
                    decompress_tap(k[i], {f: taps[f][i] for f in taps}, cfg)
                    for i in range(layers[path])])
            else:
                recon = decompress_tap(k, taps, cfg)
            node["w"] = recon.to(node["w"].dtype)
            node["taps"] = {f: torch.zeros_like(v) for f, v in taps.items()}
            return node
        if isinstance(node, dict):
            return {kk: walk(path + (kk,), vv) for kk, vv in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(path + (i,), vv)
                              for i, vv in enumerate(node))
        return node
    return walk((), grads)


def tap_keys(key: torch.Tensor, names) -> Dict[str, torch.Tensor]:
    """The key ``decompress_tapped_grads`` gives each tapped layer of a
    gradient tree in the JAX package's layout, from the port's parameter
    names alone (no stacked tree is formed): ``{prefix: key}`` for each
    layer whose parameters ``prefix.w`` and ``prefix.taps.*`` exist, e.g.
    ``groups.0.5.0.mlp.up``, its path taken from ``convert.jax_path``."""
    from repro_torch import convert
    paths, tapped, counts = [], {}, {}
    for name in names:
        path, c = convert.jax_path(name)
        paths.append(path)
        if name.endswith(".taps.a"):
            tapped[name[:-len(".taps.a")]] = (path[:-2], c)
            if c is not None:
                counts[path[:-2]] = counts.get(path[:-2], 0) + 1
    keys = _layer_keys(key, paths, {p: counts.get(p) for p, _ in
                                    tapped.values()})
    return {prefix: keys[p] if c is None else keys[p][c]
            for prefix, (p, c) in tapped.items()}


@torch.no_grad()
def decompress_tapped_params(key: torch.Tensor, grads: Dict[str, torch.Tensor],
                             cfg: TapConfig) -> None:
    """``decompress_tapped_grads`` on gradients held under the port's
    parameter names, in place: each tapped layer's ``w`` gradient becomes
    the SMP-PCA reconstruction under its key (``tap_keys``) and its taps'
    gradients are zeroed."""
    for prefix, k in tap_keys(key, grads).items():
        taps = {f: grads[f"{prefix}.taps.{f}"] for f in TAP_FIELDS}
        grads[prefix + ".w"].copy_(decompress_tap(k, taps, cfg))
        for t in taps.values():
            t.zero_()
