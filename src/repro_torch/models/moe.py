"""Mixture-of-Experts layer: top-k routing, capacity-bounded sort-based
dispatch.

The port of ``repro.models.moe``. ``moe_init`` becomes the ``MoE`` module
(``router.w``, ``w_up``, ``w_gate``, ``w_down`` and the ``shared`` MLP, as
the JAX tree names them) with ``reset(key)``; ``moe_apply`` a function of
it. Dispatch, as in the JAX package:

  1. router logits (float32) -> top-k (expert ids, gates) per token;
  2. flatten the (T*k) assignments, sort them by expert id (stably);
  3. rank within expert from a cumulative count over the sorted list; drop
     ranks >= capacity C = ceil(T*k/E * capacity_factor);
  4. write the kept tokens into an (E, C, d) buffer (kept slots are unique;
     every dropped assignment goes to the spare row E*C);
  5. batched expert products ``einsum('ecd,edf->ecf')`` in the compute
     dtype with float32 results (``common.bmm_f32``: a library call, as the
     JAX package computes them outside any Pallas kernel);
  6. gather back, weight by gates, add the shared experts.

Two choices keep the port equal to the reference where PyTorch promises
less than XLA: the top k come from a stable descending sort, so ties
(a zero router) pick the lower expert id as ``jax.lax.top_k`` does; and a
token's k contributions are summed in a fixed order (ascending expert id,
the order of ``segment_sum`` over the sorted list) instead of with
``index_add_``, whose atomics on the card add in no fixed order, so two
runs agree bit for bit.

Capacity is the reference's too: a decode step at batch 4 has T = 4 and
C = 1, so assignments are dropped there as they are in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import prng
from repro_torch.models import common


class MoE(nn.Module):
    """The router (float32 whatever ``dtype`` is), the experts' stacked
    ``w_up``, ``w_gate`` (when gated) and ``w_down``, and ``shared`` (an
    MLP of width ``(shared_d_ff or d_ff) * n_shared``) when ``n_shared``."""

    def __init__(self, d: int, d_ff: int, n_experts: int, *, n_shared: int = 0,
                 shared_d_ff: int | None = None, gated: bool = True,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.router = common.Dense(d, n_experts, device=device)
        self.w_up = nn.Parameter(torch.empty(n_experts, d, d_ff, **kw))
        self.w_gate = (nn.Parameter(torch.empty(n_experts, d, d_ff, **kw))
                       if gated else None)
        self.w_down = nn.Parameter(torch.empty(n_experts, d_ff, d, **kw))
        self.shared = (common.MLP(d, (shared_d_ff or d_ff) * n_shared,
                                  gated=gated, **kw)
                       if n_shared > 0 else None)

    def reset(self, key: torch.Tensor) -> None:
        """``moe_init``: ``kr, ke, ks = split(key, 3)``; the router from kr
        scaled by 1/sqrt(d); ``w_up``, ``w_gate``, ``w_down`` from
        ``fold_in(ke, 0)``, ``(ke, 1)``, ``(ke, 2)`` (the last scaled by
        1/sqrt(d_ff)); the shared experts ``mlp_init(ks, ...)``."""
        kr, ke, ks = prng.split(key.to(self.w_up.device), 3)
        E, d, d_ff = self.w_up.shape
        self.router.reset(kr)
        with torch.no_grad():
            self.w_up.copy_(prng.normal(prng.fold_in(ke, 0), (E, d, d_ff))
                            * (1.0 / math.sqrt(d)))
            if self.w_gate is not None:
                self.w_gate.copy_(prng.normal(prng.fold_in(ke, 1),
                                              (E, d, d_ff))
                                  * (1.0 / math.sqrt(d)))
            self.w_down.copy_(prng.normal(prng.fold_in(ke, 2), (E, d_ff, d))
                              * (1.0 / math.sqrt(d_ff)))
        if self.shared is not None:
            self.shared.reset(ks)


def top_k_stable(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values, then
    their indices, equal values in ascending index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu",
              compute_dtype=torch.bfloat16):
    """x: (B, S, d) -> (out (B, S, d) float32, aux_loss float32 scalar).
    Under DTensor (``_moe_sharded``) each data-parallel shard routes its
    own tokens."""
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, act=act,
              compute_dtype=compute_dtype)
    from repro_torch.dist import sharding
    mesh = sharding._dtensor_mesh((x,))
    if mesh is not None:
        return _moe_sharded(p, x, mesh, **kw)
    return _moe_local(p, x, **kw)


def _moe_sharded(p: MoE, x, mesh, **kw):
    """The MoE on each device's tokens: the sort, the capacity and the
    dispatch do not shard op by op, so each data-parallel shard routes its
    own tokens (capacity from its own count) against the experts' weights
    gathered over the data axes (FSDP) and split over ``model`` on d_ff
    (the experts' products, as the shared MLP's, then sum over ``model``:
    the output is a partial sum there, the aux loss an average over the
    data axes)."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist import sharding
    names = list(mesh.mesh_dim_names)
    sizes = sharding.mesh_sizes(mesh)
    dp, rem = [], x.shape[0]
    for a in names:
        if a in ("pod", "data") and rem % sizes[a] == 0:
            dp.append(a)
            rem //= sizes[a]

    def pl(dp_dim=None, tp_dim=None, tp_partial=False, dp_partial=False):
        out = []
        for a in names:
            if a in dp and dp_dim is not None:
                out.append(Shard(dp_dim))
            elif a in dp and dp_partial:
                out.append(Partial("avg"))
            elif a == "model" and tp_partial:
                out.append(Partial())
            elif a == "model" and tp_dim is not None:
                out.append(Shard(tp_dim))
            else:
                out.append(Replicate())
        return tuple(out)

    sh = p.shared
    weights = [p.router.w, p.w_up, p.w_gate, p.w_down]
    wpl = [pl(), pl(tp_dim=2), pl(tp_dim=2), pl(tp_dim=1)]
    if sh is not None:
        weights += [sh.up.w, sh.gate.w if sh.gate is not None else None,
                    sh.down.w]
        wpl += [pl(tp_dim=1), pl(tp_dim=1), pl(tp_dim=0)]
    keep = [i for i, w in enumerate(weights) if w is not None]

    def local(xl, *ws):
        full = [None] * len(weights)
        for i, w in zip(keep, ws):
            full[i] = w
        dense = lambda w: SimpleNamespace(w=w, b=None)
        q = SimpleNamespace(router=dense(full[0]), w_up=full[1],
                            w_gate=full[2], w_down=full[3], shared=None)
        if sh is not None:
            q.shared = SimpleNamespace(
                up=dense(full[4]), down=dense(full[6]),
                gate=dense(full[5]) if full[5] is not None else None)
        return _moe_local(q, xl, **kw)

    fn = local_map(local, out_placements=(pl(0, tp_partial=True),
                                          pl(dp_partial=True)),
                   in_placements=(pl(0),) + tuple(wpl[i] for i in keep),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, *(weights[i] for i in keep))


def _moe_local(p, x: torch.Tensor, *, top_k: int, capacity_factor: float,
               act: str, compute_dtype):
    B, S, d = x.shape
    T = B * S
    E = p.w_up.shape[0]
    dev = x.device
    xt = x.reshape(T, d)

    # --- routing -----------------------------------------------------------
    logits = xt.float() @ p.router.w.float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eids = top_k_stable(probs, top_k)                    # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(0)
    ce = F.one_hot(eids[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)

    # --- sort-based capacity assignment -------------------------------------
    C = int(math.ceil(T * top_k / E * capacity_factor))
    flat_e = eids.reshape(-1)                                   # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(top_k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    idx = torch.arange(T * top_k, device=dev)
    # the assignments per expert (``bincount``, which has no meta kernel)
    counts = torch.zeros(E, dtype=se.dtype, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    rank = idx - starts[se]
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)              # E*C = dropped

    # --- dispatch ------------------------------------------------------------
    # Kept slots are unique and every dropped assignment writes zeros to row
    # E*C, so the indexed write is the reference's scatter-add exactly.
    buf = torch.zeros((E * C + 1, d), dtype=compute_dtype, device=dev)
    buf[slot] = (xt[st] * keep[:, None]).to(compute_dtype)
    h = buf[:E * C].reshape(E, C, d)

    # --- expert FFNs ---------------------------------------------------------
    up = common.bmm_f32(h, p.w_up, compute_dtype)
    if p.w_gate is not None:
        g = common.bmm_f32(h, p.w_gate, compute_dtype)
        hidden = common.ACTIVATIONS[act](g) * up
    else:
        hidden = common.ACTIVATIONS[act](up)
    out_e = common.bmm_f32(hidden.to(compute_dtype), p.w_down,
                           compute_dtype)                        # (E, C, d)

    # --- combine -------------------------------------------------------------
    out_flat = torch.cat([out_e.reshape(E * C, d),
                          torch.zeros((1, d), device=dev)])
    back = out_flat[slot] * (sg * keep)[:, None]                # (T*k, d)
    # segment_sum over the sorted list: token t's contributions in the order
    # they hold there (ascending expert id), added one after another
    where = torch.empty_like(order)
    where[order] = idx
    rows = torch.sort(where.reshape(T, top_k), dim=1).values    # (T, k)
    out = back[rows[:, 0]]
    for j in range(1, top_k):
        out = out + back[rows[:, j]]

    if p.shared is not None:
        out = out + common.mlp_apply(p.shared, xt, act, compute_dtype)
    return out.reshape(B, S, d).float(), aux

