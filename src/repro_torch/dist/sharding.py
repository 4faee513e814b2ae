"""Path-based sharding rules: parameter and KV-cache specs, and their
DTensor placements.

The port of ``repro.dist.sharding``. Rules are keyed on the JAX package's
pytree *path* (``/mlp/up/w``, ``/embed/table``, ``/groups/0/0/attn/wo/w``)
so model code never mentions a mesh. A spec is a tuple with one entry a
dim: None (replicated), a mesh axis name, or a tuple of axis names, the
entries of the ``PartitionSpec`` the JAX rule returns. Every rule applies a
divisibility fallback: an axis that does not divide its mesh axes is
replicated on that dim instead (whisper's 12 heads on an 8-way model axis).

Conventions, as in the JAX package:
* 2D weights are (d_in, d_out): d_in shards over the data-parallel axes
  (FSDP, ``policy='fsdp_tp'``), d_out over the tensor-parallel axis.
* ``embed`` tables are (vocab, d_model): vocab over TP, d_model over DP.
* Stacked layer-group leading dims are never sharded.
* KV caches (..., B, S, KV, Dh): batch over DP; the TP axis prefers the KV
  head dim and falls back to head_dim when KV heads do not divide it.

A mesh is anything with a ``shape`` mapping axis names to sizes (the
rules read nothing else), or a ``torch.distributed.DeviceMesh`` with
``mesh_dim_names``. ``params_shardings`` and ``cache_shardings`` give each
tensor of the port its placements: the spec of the JAX leaf it is a layer
of (``convert.jax_path``), with the stacked layer dim dropped. Where the
JAX rule treats a stacked 1-D leaf (a layer's norm scale, stacked
(count, d)) as a 2D weight and shards its layer dim over DP, a per-layer
tensor has no such dim: it stays replicated over DP.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

Axes = Union[str, Tuple[str, ...]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def _as_tuple(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _entry(axes: Tuple[str, ...]):
    """A spec entry over ``axes``, as ``PartitionSpec`` holds it: one axis
    by its name, several as a tuple."""
    return axes[0] if len(axes) == 1 else axes


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axes_size(mesh, axes: Axes) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in _as_tuple(axes))


def param_spec(mesh, path: str, shape: Tuple[int, ...], *,
               policy: str = "fsdp_tp", dp: Axes = ("data",),
               tp: str = "model") -> Spec:
    """The spec of one parameter leaf at ``path`` with ``shape``."""
    dp = _as_tuple(dp)
    sizes = mesh_sizes(mesh)
    ndim = len(shape)
    if ndim < 2:
        return (None,) * ndim                # biases/scales: replicated
    spec = [None] * ndim
    din, dout = ndim - 2, ndim - 1           # leading stacked dims stay None
    if "embed" in path:
        if shape[din] % sizes[tp] == 0:
            spec[din] = tp
        if shape[dout] % _axes_size(mesh, dp) == 0:
            spec[dout] = _entry(dp)
        return tuple(spec)
    if policy == "fsdp_tp" and shape[din] % _axes_size(mesh, dp) == 0:
        spec[din] = _entry(dp)
    if shape[dout] % sizes[tp] == 0:
        spec[dout] = tp
    return tuple(spec)


def cache_spec(mesh, path: str, shape: Tuple[int, ...], *,
               dp: Axes = ("data",), tp: str = "model") -> Spec:
    """The spec of a KV-cache leaf shaped (..., B, S, KV, Dh)."""
    del path
    dp = _as_tuple(dp)
    ndim = len(shape)
    spec = [None] * ndim
    bdim, kv_dim, dh_dim = ndim - 4, ndim - 2, ndim - 1
    if bdim >= 0 and shape[bdim] % _axes_size(mesh, dp) == 0:
        spec[bdim] = _entry(dp)
    tp_size = mesh_sizes(mesh)[tp]
    if shape[kv_dim] % tp_size == 0:
        spec[kv_dim] = tp
    elif shape[dh_dim] % tp_size == 0:
        spec[dh_dim] = tp
    return tuple(spec)


def placements(mesh, spec: Spec):
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) of ``spec``: mesh
    dim i is ``Shard(d)`` where dim d names axis i, else ``Replicate()``.
    A dim over several axes (``("pod", "data")``) is split over them in
    order, the first the outermost, as ``PartitionSpec`` splits it."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in _as_tuple(entry):
            out[names.index(axis)] = Shard(d)
    return tuple(out)


def _jax_leaf(name: str) -> Tuple[str, int]:
    """The JAX path string of the port's parameter or cache leaf ``name``
    and the number of stacked dims its JAX leaf has in front (1 in a layer
    group, 0 outside)."""
    from repro_torch.convert import jax_path
    path, layer = jax_path(name)
    return "/" + "/".join(str(p) for p in path), (0 if layer is None else 1)


def _group_counts(model) -> Dict[Tuple[str, int], int]:
    """(prefix, group index) -> its layer count, for the stacked shapes."""
    cfg = model.cfg
    out = {("", gi): count for gi, (_, count) in enumerate(cfg.groups)}
    if cfg.is_encdec:
        out[("enc", 0)] = cfg.n_enc_layers
    return out


def params_specs(model, mesh, *, policy: str = "fsdp_tp",
                 dp: Axes = ("data",), tp: str = "model") -> Dict[str, Spec]:
    """The spec of every parameter of ``model`` (a ``transformer.LM``),
    keyed by its name in the module: the spec the JAX rule gives its
    stacked leaf, the layer dim dropped."""
    counts = _group_counts(model)
    out = {}
    for name, p in model.named_parameters():
        path, stacked = _jax_leaf(name)
        shape = tuple(p.shape)
        if stacked:
            parts = name.split(".")
            i = parts.index("groups")
            count = counts[(".".join(parts[:i]), int(parts[i + 1]))]
            shape = (count,) + shape
        out[name] = param_spec(mesh, path, shape, policy=policy, dp=dp,
                               tp=tp)[stacked:]
    return out


def params_shardings(mesh, model, *, policy: str = "fsdp_tp",
                     dp: Axes = ("data",), tp: str = "model"):
    """Parameter name -> DTensor placements on ``mesh``, for every
    parameter of ``model`` (path-based rules, ``params_specs``)."""
    return {name: placements(mesh, spec) for name, spec in
            params_specs(model, mesh, policy=policy, dp=dp, tp=tp).items()}


def _cache_leaves(caches):
    """(name, tensor) of every cache leaf, named as the JAX package's cache
    tree: ``{gi}/{p}/<keys>`` (the layer index apart)."""
    for gi, group in enumerate(caches):
        for c, slot in enumerate(group):
            for p, blk in enumerate(slot):
                stack = [((), blk)]
                while stack:
                    keys, node = stack.pop()
                    if isinstance(node, dict):
                        stack.extend((keys + (k,), v) for k, v in node.items())
                    else:
                        yield (gi, c, p, keys), node


def cache_shardings(mesh, caches, *, dp: Axes = ("data",), tp: str = "model"):
    """A cache tree of the port's layout (per group a list over layers of
    block-cache tuples) with each leaf replaced by its DTensor placements:
    the spec the JAX rule gives the leaf stacked over the group's layers,
    the layer dim dropped."""
    places = {}
    for (gi, c, p, keys), leaf in _cache_leaves(caches):
        path = "/" + "/".join([str(gi), str(p), *keys])
        shape = (len(caches[gi]),) + tuple(leaf.shape)
        places[(gi, c, p, keys)] = placements(
            mesh, cache_spec(mesh, path, shape, dp=dp, tp=tp)[1:])

    def rebuild(gi, c, p, node, keys=()):
        if isinstance(node, dict):
            return {k: rebuild(gi, c, p, v, keys + (k,))
                    for k, v in node.items()}
        return places[(gi, c, p, keys)]

    return [[tuple(rebuild(gi, c, p, blk) for p, blk in enumerate(slot))
             for c, slot in enumerate(group)]
            for gi, group in enumerate(caches)]


def _dtensor_mesh(tensors):
    """The mesh of the first DTensor among ``tensors``, else None."""
    from torch.distributed.tensor import DTensor
    for t in tensors:
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


def local_over(fn, args, dims, out_dims):
    """``fn(*args)`` run on each device's shard where an op-by-op DTensor
    trace cannot shard it (a loop over sequence chunks, a scan's strided
    writes, a view that splits a sharded dim): the sharding GSPMD would
    keep, made explicit. ``dims[i]`` is ``(batch_dim, split_dim)`` of
    ``args[i]`` (either None), ``out_dims`` the same for each output (a
    tuple when ``fn`` returns several). Batch dims are split over the
    data-parallel axes (``pod``, ``data``) that divide them, split dims
    over ``model`` when every arg's split dim divides by it (else all stay
    whole there); the inputs are redistributed to that (the collectives
    DTensor inserts), and the outputs come back with it. Without a DTensor
    among ``args`` it is ``fn(*args)``."""
    mesh = _dtensor_mesh(args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    sizes = mesh_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    dp = [a for a in names if a in ("pod", "data")]
    tp_ok = "model" in sizes and all(
        s is None or a.shape[s] % sizes["model"] == 0
        for a, (_, s) in zip(args, dims))
    batch = [a.shape[b] for a, (b, _) in zip(args, dims) if b is not None]
    dp_use, rem = [], (batch[0] if batch else 0)
    for a in dp:
        if batch and rem % sizes[a] == 0:
            dp_use.append(a)
            rem //= sizes[a]

    def place(b, s):
        out = []
        for name in names:
            if name in dp_use and b is not None:
                out.append(Shard(b))
            elif name == "model" and tp_ok and s is not None:
                out.append(Shard(s))
            else:
                out.append(Replicate())
        return tuple(out)

    in_pl = tuple(place(b, s) for b, s in dims)
    multi = isinstance(out_dims, tuple) and isinstance(out_dims[0], tuple)
    out_pl = tuple(place(b, s) for b, s in out_dims) if multi \
        else (place(*out_dims),)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def gather_dp(w):
    """A weight as FSDP uses it: a DTensor's shards over the data-parallel
    axes (``pod``, ``data``) gathered (its gradient then reduce-scatters
    back), its tensor-parallel sharding kept. Anything else is returned
    as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if n in ("pod", "data") else p
               for n, p in zip(names, w.placements))
    return w if pl == tuple(w.placements) else \
        w.redistribute(w.device_mesh, pl)


def fit_heads(t, n_heads: int):
    """``t`` (..., n_heads * head_dim) ready to be split into heads: a
    DTensor whose last dim is sharded over a mesh axis that does not
    divide ``n_heads`` (whisper's 12 heads, or 4 KV heads, on an 8-way
    ``model`` axis) is gathered on that axis first, as GSPMD would insert
    the collective; DTensor cannot split a sharded dim unevenly. Anything
    else is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    last = t.ndim - 1
    sizes = t.device_mesh.shape
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == last
               and n_heads % sizes[i] else p
               for i, p in enumerate(t.placements))
    return t if pl == tuple(t.placements) else \
        t.redistribute(t.device_mesh, pl)
