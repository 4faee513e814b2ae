"""Carry state between the JAX package and the port, as numpy arrays.

The JAX package's keys, summaries, samples, factors and error estimates
are NamedTuples of arrays; ``numpy.asarray`` of each field gives what these
functions take, and a field that is None (a summary without probes or
co-sketch) stays None.
Key data is uint32 (2,) in JAX and int64 (2,) here, holding the same two
32-bit words. Every other field keeps its dtype (int32 indices, float32
values, bool mask), so a round trip through the port is exact.

Streaming states (``StreamState``, ``WindowState``, ``CompressedState``)
keep their 0-d fields (counters, the decay clock) on the CPU, as
``core/streaming.py`` holds them, and their other fields on ``device``. A
bfloat16 wire block crosses as its bit pattern: numpy knows bfloat16 only
where ``ml_dtypes`` is loaded (as with jax), and there the way back gives
that type; elsewhere it gives the uint16 bit patterns.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.streaming import (
    CompressedState, StreamState, WindowState)
from repro_torch.core.types import (
    ErrorEstimate, LowRankFactors, SampleSet, SketchSummary)


def key_from_numpy(key_data, device="cpu") -> torch.Tensor:
    """uint32 key data (..., 2) -> the port's int64 key."""
    arr = np.asarray(key_data)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"expected uint32 key data (..., 2), got "
                         f"{arr.dtype} {arr.shape}")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """The port's int64 key -> uint32 key data, as jax.random uses it."""
    return key.cpu().numpy().astype(np.uint32)


def _from_numpy(cls, state, device):
    return cls(*(None if x is None else torch.from_numpy(np.array(x)).to(device)
                 for x in state))


def _to_numpy(cls, state: NamedTuple):
    return cls(*(None if x is None else x.detach().cpu().numpy()
                 for x in state))


def summary_from_numpy(state, device="cpu") -> SketchSummary:
    """A JAX ``SketchSummary`` (fields as numpy arrays or None) -> port."""
    return _from_numpy(SketchSummary, state, device)


def summary_to_numpy(summary: SketchSummary) -> SketchSummary:
    """Port ``SketchSummary`` -> the same NamedTuple holding numpy arrays."""
    return _to_numpy(SketchSummary, summary)


def samples_from_numpy(state, device="cpu") -> SampleSet:
    """A JAX ``SampleSet`` -> port (int32 rows/cols, float32 q_hat, bool)."""
    return _from_numpy(SampleSet, state, device)


def samples_to_numpy(samples: SampleSet) -> SampleSet:
    """Port ``SampleSet`` -> the same NamedTuple holding numpy arrays."""
    return _to_numpy(SampleSet, samples)


def factors_from_numpy(state, device="cpu") -> LowRankFactors:
    """JAX ``LowRankFactors`` -> port."""
    return _from_numpy(LowRankFactors, state, device)


def factors_to_numpy(factors: LowRankFactors) -> LowRankFactors:
    """Port ``LowRankFactors`` -> the same NamedTuple holding numpy arrays."""
    return _to_numpy(LowRankFactors, factors)


def error_from_numpy(state, device="cpu") -> ErrorEstimate:
    """A JAX ``ErrorEstimate`` (six scalars) -> port (0-d float32)."""
    return _from_numpy(ErrorEstimate, state, device)


def error_to_numpy(error: ErrorEstimate) -> ErrorEstimate:
    """Port ``ErrorEstimate`` -> the same NamedTuple holding numpy arrays."""
    return _to_numpy(ErrorEstimate, error)


def _bf16_numpy_dtype():
    """numpy's bfloat16 where ``ml_dtypes`` registered it, else None."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        return None


def bits_to_tensor(arr: np.ndarray, bf16: bool = False) -> torch.Tensor:
    """A host array as a CPU tensor (a copy); with ``bf16`` the array holds
    bfloat16 bit patterns (uint16 or int16) and the tensor is bfloat16."""
    arr = np.array(arr)
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def tensor_to_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; bfloat16 as its uint16 bit patterns, the
    form the wire format and checkpoints store (numpy needs no bfloat16
    type for it)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (0-d arrays stay on the CPU);
    a numpy bfloat16 array becomes a torch bfloat16 tensor, bit for bit."""
    arr = np.asarray(arr)
    t = bits_to_tensor(arr, bf16=arr.dtype.name == "bfloat16")
    return t if t.ndim == 0 else t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 as numpy's bfloat16 where it is
    registered, else as its uint16 bit patterns."""
    arr = tensor_to_bits(t)
    bf16 = _bf16_numpy_dtype()
    if t.dtype != torch.bfloat16 or bf16 is None:
        return arr
    return arr.view(bf16)


def _state_from_numpy(cls, state, device):
    fields = dict(zip(cls._fields, state))
    return cls(**{name: (None if x is None else
                         key_from_numpy(x, device) if name == "key" else
                         tensor_from_numpy(x, device))
                  for name, x in fields.items()})


def _state_to_numpy(cls, state):
    return cls(*(None if x is None else
                 key_to_numpy(x) if name == "key" else tensor_to_numpy(x)
                 for name, x in zip(state._fields, state)))


def stream_state_from_numpy(state, device="cpu") -> StreamState:
    """A JAX ``StreamState`` (fields as numpy arrays or None) -> port."""
    return _state_from_numpy(StreamState, state, device)


def stream_state_to_numpy(state: StreamState) -> StreamState:
    """Port ``StreamState`` -> the same NamedTuple holding numpy arrays,
    the key as uint32 key data."""
    return _state_to_numpy(StreamState, state)


def compressed_state_from_numpy(state, device="cpu") -> CompressedState:
    """A JAX ``CompressedState`` (numpy arrays or None) -> port."""
    return _state_from_numpy(CompressedState, state, device)


def compressed_state_to_numpy(state: CompressedState) -> CompressedState:
    """Port ``CompressedState`` -> the same NamedTuple holding numpy
    arrays."""
    return _state_to_numpy(CompressedState, state)


def window_state_from_numpy(state, device="cpu") -> WindowState:
    """A JAX ``WindowState`` (key, tuple of StreamStates, head; numpy
    leaves) -> port."""
    key, buckets, head = state
    return WindowState(key_from_numpy(key, device),
                       tuple(stream_state_from_numpy(b, device)
                             for b in buckets),
                       tensor_from_numpy(head))


def window_state_to_numpy(state: WindowState) -> WindowState:
    """Port ``WindowState`` -> the same NamedTuples holding numpy arrays."""
    return WindowState(key_to_numpy(state.key),
                       tuple(stream_state_to_numpy(b) for b in state.buckets),
                       tensor_to_numpy(state.head))


def _tree_from_numpy(tree, device):
    from repro_torch.core.types import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [tensor_from_numpy(x, device)
                                 for x in tree_leaves(tree)])


def _tree_to_numpy(tree):
    from repro_torch.core.types import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [tensor_to_numpy(x)
                                 for x in tree_leaves(tree)])


def compression_state_from_numpy(state, device="cpu"):
    """A JAX ``CompressionState`` (its residual tree and step as numpy
    arrays, or as jax's own arrays) -> port: every residual on ``device``
    but the 0-d ones, the step a 0-d int32 CPU tensor."""
    from repro_torch.optim.grad_compression import CompressionState
    err = _tree_from_numpy(state.err, device)
    return CompressionState(err, tensor_from_numpy(state.step))


def compression_state_to_numpy(state):
    """Port ``CompressionState`` -> the same NamedTuple holding numpy
    arrays in the same tree."""
    from repro_torch.optim.grad_compression import CompressionState
    return CompressionState(_tree_to_numpy(state.err),
                            tensor_to_numpy(state.step))


def taps_from_numpy(taps, device="cpu") -> dict:
    """A tap dict ``{a, b, na2, nb2}`` (numpy arrays, or a tree of such
    dicts) -> port tensors on ``device``."""
    return _tree_from_numpy(taps, device)


def taps_to_numpy(taps) -> dict:
    """Port taps (a dict of tensors, or a tree of such dicts) -> numpy."""
    return _tree_to_numpy(taps)


# ---------------------------------------------------------------------------
# LM parameters and KV caches
# ---------------------------------------------------------------------------
#
# The JAX package's LM parameters are nested dicts whose ``groups`` (and
# ``enc.groups``) hold one tuple per group, one dict per pattern position,
# each leaf stacked over the group's layers (count, ...). The port's
# ``transformer.LM`` names the same leaf of layer c
# ``groups.{gi}.{c}.{p}.<path>``; every other leaf has the same path in
# both. Its caches are, per group, a list over layers of the pattern's
# tuple of block caches, where the JAX package stacks each cache leaf over
# the layers. The mapping goes by path, so it covers every block type: the
# MoE leaves (``moe.router.w``, ``moe.w_up``, ..., ``moe.shared.*``), the
# RG-LRU's (``lru.w_in.w``, ``lru.lam``, ...), the mLSTM's and sLSTM's
# (``core.*``), and the recurrent caches ({h, conv}, {C, n, m, conv},
# {h, c, n, m}) beside the KV caches.

def _split_group_name(name: str):
    """``a.groups.gi.c.p.rest`` -> (prefix, gi, c, p, rest), or None for a
    name outside the groups."""
    parts = name.split(".")
    if "groups" not in parts:
        return None
    i = parts.index("groups")
    gi, c, p = (int(s) for s in parts[i + 1:i + 4])
    return tuple(parts[:i]), gi, c, p, tuple(parts[i + 4:])


def _walk(node, path):
    for part in path:
        node = node[part]
    return node


def _as_array(leaf):
    return leaf if torch.is_tensor(leaf) else np.asarray(leaf)


def lm_leaf(tree, name: str):
    """The leaf of the port's parameter ``name`` in a tree of the JAX
    package's layout (numpy or jax arrays, or tensors): layer c of a stacked
    group leaf, else the leaf at the same path."""
    split = _split_group_name(name)
    if split is None:
        return _as_array(_walk(tree, name.split(".")))
    prefix, gi, c, p, rest = split
    stacked = _walk(_walk(tree, prefix)["groups"][gi][p], rest)
    return _as_array(stacked)[c]


def jax_path(name: str):
    """(path, layer) of the port's parameter ``name`` in the JAX package's
    tree: its dict keys and list/tuple indices in order, and the layer
    index of a stacked group leaf (None outside the groups).
    ``groups.0.5.0.mlp.up.w`` -> (("groups", 0, 0, "mlp", "up", "w"), 5)."""
    split = _split_group_name(name)
    if split is None:
        return tuple(name.split(".")), None
    prefix, gi, c, p, rest = split
    return prefix + ("groups", gi, p) + rest, c


def lm_params_from_numpy(tree, cfg, device="cpu"):
    """The JAX package's LM parameter tree (numpy arrays, or jax's own) ->
    a ``transformer.LM`` of ``cfg`` on ``device`` holding the same values,
    each cast to the port's parameter dtype (the config's, as in JAX)."""
    import torch
    from repro_torch.models.transformer import LM
    params = LM(cfg, device=device)
    with torch.no_grad():
        for name, p in params.named_parameters():
            arr = lm_leaf(tree, name)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX leaf {arr.shape}, port "
                                 f"{tuple(p.shape)}")
            p.copy_(tensor_from_numpy(arr))
    return params


def _nested_set(tree: dict, path, value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def lm_tree(named: dict, stack) -> dict:
    """Leaves under the port's parameter names -> the JAX package's tree:
    each group leaf ``stack``-ed over the layers (``np.stack`` or
    ``torch.stack``), ``groups`` a list of tuples."""
    out: dict = {}
    stacks: dict = {}
    for name, leaf in named.items():
        split = _split_group_name(name)
        if split is None:
            _nested_set(out, name.split("."), leaf)
            continue
        prefix, gi, c, pi, rest = split
        stacks.setdefault(prefix, {}).setdefault(gi, {}).setdefault(
            pi, {}).setdefault(rest, {})[c] = leaf
    for prefix, groups in stacks.items():
        tuples = []
        for gi in sorted(groups):
            slots = []
            for pi in sorted(groups[gi]):
                slot: dict = {}
                for rest, layers in groups[gi][pi].items():
                    _nested_set(slot, rest,
                                stack([layers[c] for c in sorted(layers)]))
                slots.append(slot)
            tuples.append(tuple(slots))
        _nested_set(out, prefix + ("groups",), tuples)
    return out


def lm_params_to_numpy(params) -> dict:
    """A ``transformer.LM`` -> the JAX package's parameter tree of numpy
    arrays: group leaves stacked over the layers, ``groups`` a list of
    tuples."""
    return lm_tree({name: tensor_to_numpy(p)
                    for name, p in params.named_parameters()}, np.stack)


def _map_cache(fn, node):
    if isinstance(node, dict):
        return {k: _map_cache(fn, v) for k, v in node.items()}
    return fn(node)


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node


def kv_cache_from_numpy(caches, device="cpu"):
    """The JAX package's LM caches (per group a tuple of block caches with
    leaves stacked over the layers; numpy or jax arrays) -> the port's
    (per group a list over layers of block-cache tuples) on ``device``,
    bf16 leaves bit for bit."""
    out = []
    for group in caches:
        count = np.asarray(_first_leaf(group[0])).shape[0]
        out.append([
            tuple(_map_cache(lambda a: tensor_from_numpy(np.asarray(a)[c],
                                                         device), blk)
                  for blk in group)
            for c in range(count)])
    return out


def kv_cache_to_numpy(caches):
    """The port's LM caches -> the JAX package's layout of numpy arrays
    (bfloat16 where numpy has it, else its bit patterns)."""
    out = []
    for group in caches:
        slots = []
        for p in range(len(group[0])):
            layers = [layer[p] for layer in group]
            slots.append(_map_cache(
                lambda path: np.stack([tensor_to_numpy(_walk(lyr, path))
                                       for lyr in layers]),
                _paths(layers[0])))
        out.append(tuple(slots))
    return out


def _paths(node, prefix=()):
    """A cache dict with each leaf replaced by its path of keys."""
    if isinstance(node, dict):
        return {k: _paths(v, prefix + (k,)) for k, v in node.items()}
    return prefix


# ---------------------------------------------------------------------------
# training state
# ---------------------------------------------------------------------------
#
# The JAX package's ``TrainState(params, opt=AdamWState(step, mu, nu), comp,
# step, key)`` holds its parameters and moments in the parameter tree's
# layout, and its compression state (``()`` or a ``CompressionState``
# whose residuals are in that layout too). The port's ``TrainState`` holds
# an ``LM`` module and its moments as dicts under the module's parameter
# names; its ``comp`` keeps the JAX layout (the compressor walks that tree).
# A checkpoint of either package stores the JAX layout.

def _tree_map(fn, tree):
    from repro_torch.core.types import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def train_state_layout(state, leaf, stack):
    """The port's ``TrainState`` in the JAX package's layout, each tensor
    through ``leaf`` and each group's layers through ``stack``."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.train_step import TrainState
    named = dict(state.params.named_parameters())

    def tree(leaves):
        return lm_tree({n: leaf(leaves[n]) for n in named}, stack)
    return TrainState(
        tree(named),
        AdamWState(leaf(state.opt.step), tree(state.opt.mu),
                   tree(state.opt.nu)),
        _tree_map(leaf, state.comp) if state.comp else (),
        leaf(state.step), leaf(state.key))


def train_state_to_numpy(state):
    """The port's ``TrainState`` -> the JAX package's layout as numpy: the
    parameter tree, ``AdamWState(step, mu, nu)`` in that tree, ``comp``,
    the step and the key data (uint32)."""
    out = train_state_layout(state, tensor_to_numpy, np.stack)
    return out._replace(key=key_to_numpy(state.key))


def load_train_state(state, tree) -> None:
    """Write a JAX-layout training state ``tree`` (numpy arrays, jax's, or
    CPU tensors; bf16 as numpy's bfloat16 or as tensors) into the port's
    ``state`` in place: parameters, moments, residuals, counters, key."""
    def put(dst, src):
        src = src if torch.is_tensor(src) else tensor_from_numpy(src)
        dst.copy_(src)
    with torch.no_grad():
        for name, p in state.params.named_parameters():
            put(p, lm_leaf(tree.params, name))
            put(state.opt.mu[name], lm_leaf(tree.opt.mu, name))
            put(state.opt.nu[name], lm_leaf(tree.opt.nu, name))
        if state.comp:
            from repro_torch.core.types import tree_leaves
            for dst, src in zip(tree_leaves(state.comp),
                                tree_leaves(tree.comp)):
                put(dst, src)
        put(state.opt.step, tree.opt.step)
        put(state.step, tree.step)
        key = np.asarray(tree.key).astype(np.int64)
        state.key.copy_(torch.from_numpy(key))


def train_state_from_numpy(state, cfg, device="cpu"):
    """A JAX ``TrainState`` (numpy arrays, or jax's) -> the port's, on
    ``device``: an ``LM`` of ``cfg`` holding the parameters, the moments in
    their stored dtype, ``comp`` on ``device``, the counters as 0-d int32
    CPU tensors."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.train_step import TrainState
    params = lm_params_from_numpy(state.params, cfg, device)
    moments = [{name: tensor_from_numpy(lm_leaf(tree, name), device)
                for name, _ in params.named_parameters()}
               for tree in (state.opt.mu, state.opt.nu)]
    comp = compression_state_from_numpy(state.comp, device) \
        if len(state.comp) else ()
    return TrainState(params,
                      AdamWState(tensor_from_numpy(state.opt.step), *moments),
                      comp, tensor_from_numpy(state.step),
                      key_from_numpy(state.key, device))
