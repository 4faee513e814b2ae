"""Dry run of one (arch x shape x mesh) cell: per-device FLOPs, bytes,
collective bytes, peak memory and the roofline, with no card.

The port of ``repro.launch.dryrun``. The JAX package lowers each cell on
512 placeholder devices and reads the compiled program; here the cell is
traced eagerly in one process on the ``meta`` device (shapes, no data)
over a fake process group (``launch.mesh.init_fake_process_group``):

1. the model's parameters, AdamW state, batch and cache are built on
   ``meta`` and made DTensors with the placements of
   ``dist.sharding.params_shardings`` / ``cache_shardings`` on the
   production mesh, with ``_fit_dp`` and the JAX package's defaults for
   the policy and the moments' dtype;
2. one train step, prefill or decode step runs under
   ``roofline.trace_analyzer`` (per device, from the local shards, with
   the collectives DTensor's redistributions insert) and
   ``torch.distributed._tools.mem_tracker.MemTracker`` (the peak of the
   local tensors alive a device);
3. the record carries the JAX record's keys.

``meta`` tensors trace the card's routes (``models.common``,
``models.attention``): bf16 GEMMs with float32 outputs, and prefill's
causal attention through the flash kernel, whose work the analyzer counts
as the kernel's (``routes`` in the record says which attention routes the
cell took). Plain tensors the model makes (positions, masks, zero states)
are replicated (``implicit_replication``). DTensor has no sharding rule
for ``mm``/``bmm`` with ``out_dtype`` or for the port's own ops;
``register_rules`` gives them theirs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k [--multi-pod] [--reduced] [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, cell_applicable, get_shape
from repro_torch.dist import meshctx
from repro_torch.dist import sharding as shr
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention as attn
from repro_torch.models import build
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.roofline import analysis as roof
from repro_torch.roofline import trace_analyzer
from repro_torch.train import train_step as ts

_RULES_REGISTERED = False


def register_rules() -> None:
    """Sharding rules for the ops DTensor has none for: ``mm``/``bmm``
    with ``out_dtype`` (as ``mm``/``bmm``), the ``attn_out`` tag and
    ``log_sigmoid_backward`` (elementwise: any placement, kept)."""
    global _RULES_REGISTERED
    if _RULES_REGISTERED:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    R = Replicate()

    @register_sharding(aten.mm.dtype)
    def _mm(x, w, out_dtype):
        return [([R], [R, R, None]),
                ([Shard(0)], [Shard(0), R, None]),
                ([Shard(1)], [R, Shard(1), None]),
                ([Partial()], [Shard(1), Shard(0), None])]

    @register_sharding(aten.bmm.dtype)
    def _bmm(x, w, out_dtype):
        return [([R], [R, R, None]),
                ([Shard(0)], [Shard(0), Shard(0), None]),
                ([Shard(1)], [Shard(1), R, None]),
                ([Shard(2)], [R, Shard(2), None]),
                ([Partial()], [Shard(2), Shard(1), None])]

    @register_sharding(torch.ops.repro_torch.attn_out.default)
    def _tag(o):
        return [([R], [R])] + [([Shard(d)], [Shard(d)])
                               for d in range(len(o.shape))]

    @register_sharding(aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad, x, buffer):
        # elementwise: the three operands and the result alike
        return [([R], [R, R, R])] + [([Shard(d)], [Shard(d)] * 3)
                                     for d in range(len(x.shape))]

    _RULES_REGISTERED = True


def _fit_dp(mesh, dp, B):
    """Largest prefix of dp axes that divides B (long_500k has B=1)."""
    sizes = shr.mesh_sizes(mesh)
    out = []
    rem = B
    for a in dp:
        if rem % sizes[a] == 0:
            out.append(a)
            rem //= sizes[a]
    return tuple(out) if out else None


def _dtensor(shape, dtype, mesh, placements):
    """A DTensor of global ``shape`` with ``placements`` on ``mesh``, its
    local shard an empty ``meta`` tensor."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for name, p in zip(mesh.mesh_dim_names, placements):
        if isinstance(p, Shard):
            local[p.dim] = math.ceil(local[p.dim] / sizes[name])
    glob = torch.empty(shape, dtype=dtype, device="meta")
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"),
                              mesh, placements, run_check=False,
                              shape=glob.shape, stride=glob.stride())


def _distribute_params(params: torch.nn.Module, mesh, shardings) -> None:
    """Replace each parameter of ``params`` by a DTensor parameter with its
    placements (``shardings``: name -> placements)."""
    for mod_name, mod in params.named_modules():
        for pn, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{pn}" if mod_name else pn
            setattr(mod, pn, torch.nn.Parameter(
                _dtensor(p.shape, p.dtype, mesh, shardings[name]),
                requires_grad=p.requires_grad))


def _distribute_caches(caches, mesh, cshard):
    def one(leaf, places):
        if isinstance(leaf, dict):
            return {k: one(v, places[k]) for k, v in leaf.items()}
        return _dtensor(leaf.shape, leaf.dtype, mesh, places)
    return [[tuple(one(b, pb) for b, pb in zip(slot, pslot))
             for slot, pslot in zip(group, pgroup)]
            for group, pgroup in zip(caches, cshard)]


def _batch(model, mesh, dp, B, S, kind):
    spec = shr.placements(mesh, (dp, None))
    out = {"tokens": _dtensor((B, S), torch.int32, mesh, spec)}
    if kind == "train":
        out["labels"] = _dtensor((B, S), torch.int32, mesh, spec)
    for name, t in model.aux_input_shapes(B).items():
        out[name] = _dtensor(t.shape, t.dtype, mesh,
                             shr.placements(mesh, (dp, None, None)))
    return out


def _local_bytes(tensors) -> int:
    total = 0
    for t in tensors:
        loc = t.to_local() if hasattr(t, "to_local") else t
        total += loc.numel() * loc.element_size()
    return total


def _cache_leaves(caches):
    for group in caches:
        for slot in group:
            for blk in slot:
                stack = [blk]
                while stack:
                    node = stack.pop()
                    if isinstance(node, dict):
                        stack.extend(node.values())
                    else:
                        yield node


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               policy: Optional[str] = None, moments: Optional[str] = None,
               compression: str = "none", reduced: bool = False,
               mesh=None, extra_overrides: Optional[Dict[str, Any]] = None):
    """Trace one (arch x shape x mesh) cell; returns its record. ``mesh``:
    a ``DeviceMesh`` to use instead of the production one (the caller
    started its process group); ``reduced``: the arch's reduced config."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = get_shape(shape_name)
    if mesh is not None:
        mesh_name = "x".join(str(n) for n in mesh.shape)
    else:
        mesh_name = "2x32x8" if multi_pod else "32x8"
    ok, reason = cell_applicable(cfg.family, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "SKIP", "reason": reason}

    overrides: Dict[str, Any] = dict(extra_overrides or {})
    if shape.kind != "train":
        overrides.setdefault("param_dtype", "bfloat16")
        overrides.setdefault("remat", False)
    model = build(cfg, device="meta", **overrides)
    cfg = model.cfg

    if mesh is None:
        shape_ = mesh_lib.MULTI_POD_SHAPE if multi_pod \
            else mesh_lib.PRODUCTION_SHAPE
        import torch.distributed as dist
        if not dist.is_initialized():
            mesh_lib.init_fake_process_group(math.prod(shape_))
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    register_rules()
    meshctx.set_mesh(mesh)
    chips = mesh.size()
    dp = _fit_dp(mesh, mesh_lib.dp_axes(mesh), shape.global_batch)
    big = cfg.n_params() > 2e10
    if policy is None:
        policy = "fsdp_tp" if (shape.kind == "train" or big) else "tp_only"
    if moments is None:
        moments = "bfloat16" if cfg.n_params() > 5e10 else "float32"

    params = model.param_shapes()
    pshard = shr.params_shardings(mesh, params, policy=policy,
                                  dp=dp or ("data",), tp="model")
    _distribute_params(params, mesh, pshard)
    B, S = shape.global_batch, shape.seq_len

    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication
    mt = MemTracker()
    mt.track_external(params)
    attn.reset_route_counts()
    analyzer = trace_analyzer.TraceAnalyzer(
        trace_analyzer.axes_of_mesh(mesh))
    t0 = time.time()
    if shape.kind == "train":
        mdtype = torch.bfloat16 if moments == "bfloat16" else torch.float32
        opt = AdamW(moment_dtype=mdtype)
        tcfg = ts.TrainConfig(microbatches=1, compression=compression)
        step_fn = ts.make_train_step(model.loss, opt, tcfg)
        named = dict(params.named_parameters())

        def moment():       # sharded as its parameter
            return {n: _dtensor(p.shape, mdtype, mesh, pshard[n])
                    for n, p in named.items()}
        state = ts.TrainState(
            params, AdamWState(torch.zeros((), dtype=torch.int32), moment(),
                               moment()),
            (), torch.zeros((), dtype=torch.int32), prng.PRNGKey(0))
        batch = _batch(model, mesh, dp, B, S, "train")
        args = (list(state.opt.mu.values()) + list(state.opt.nu.values())
                + list(batch.values()))
        mt.track_external(*args)
        with mt, analyzer, implicit_replication():
            step_fn(state, batch)
        tokens = B * S
        mf = roof.model_flops("train", cfg.n_active_params(), tokens)
    else:
        caches = model.cache_shapes(B, S)
        cshard = shr.cache_shardings(mesh, caches, dp=dp or ("data",))
        caches = _distribute_caches(caches, mesh, cshard)
        args = list(_cache_leaves(caches))
        if shape.kind == "prefill":
            batch = _batch(model, mesh, dp, B, S, "prefill")
            args += list(batch.values())
            mt.track_external(*args)
            with mt, analyzer, implicit_replication(), torch.no_grad():
                model.prefill(params, batch, caches)
            tokens = B * S
        else:
            tok = _dtensor((B, 1), torch.int32, mesh,
                           shr.placements(mesh, (dp, None)))
            args.append(tok)
            mt.track_external(*args)
            with mt, analyzer, implicit_replication(), torch.no_grad():
                model.decode_step(params, caches, tok, S - 1)
            tokens = B
        mf = roof.model_flops(shape.kind, cfg.n_active_params(), tokens)
    t_trace = time.time() - t0
    meshctx.clear_mesh()

    cost = analyzer.cost
    arg_bytes = _local_bytes(list(params.parameters()) + args)
    peak = max((snap.get("Total", 0) for snap in
                mt.get_tracker_snapshot("peak").values()), default=0)
    stats = cost.stats()
    rl = roof.Roofline(flops=cost.flops, bytes_accessed=cost.bytes,
                       coll_bytes=cost.coll_bytes,
                       model_flops_per_device=mf / chips, chips=chips,
                       coll_by_axis=dict(cost.coll_by_axis))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "OK", "policy": policy, "moments": moments,
        "compression": compression, "reduced": reduced,
        "remat_policy": cfg.remat_policy if cfg.remat else None,
        "routes": dict(attn.ROUTES), "ops": cost.ops,
        "lower_s": round(t_trace, 1), "compile_s": None,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "temp_size_in_bytes": max(peak - arg_bytes, 0),
                   "peak_size_in_bytes": peak},
        "collectives": {"total_bytes": stats.total_bytes,
                        "by_op": stats.by_op, "by_axis": stats.by_axis,
                        "count": stats.count},
        "roofline": rl.as_dict(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (tests, quick looks)")
    ap.add_argument("--policy", default=None,
                    choices=[None, "fsdp_tp", "tp_only"])
    ap.add_argument("--moments", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "taps", "lowrank"])
    ap.add_argument("--scores-bf16", action="store_true")
    ap.add_argument("--remat-policy", default=None,
                    choices=[None, "full", "save_attn_out"])
    ap.add_argument("--sketched-mlp", action="store_true")
    ap.add_argument("--constrain-acts", action="store_true")
    ap.add_argument("--tag", default="", help="extra label in the record")
    ap.add_argument("--out", default=None, help="append JSONL record here")
    args = ap.parse_args(argv)

    overrides = {}
    if args.scores_bf16:
        overrides["attn_scores_dtype"] = "bfloat16"
    if args.remat_policy:
        overrides["remat_policy"] = args.remat_policy
    if args.sketched_mlp:
        overrides["sketched_mlp"] = True
    if args.constrain_acts:
        overrides["constrain_activations"] = True
    rec = lower_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                     policy=args.policy, moments=args.moments,
                     compression=args.compression, reduced=args.reduced,
                     extra_overrides=overrides or None)
    if args.tag:
        rec["tag"] = args.tag
    print(json.dumps(rec, indent=2))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0 if rec["status"] in ("OK", "SKIP") else 1


if __name__ == "__main__":
    sys.exit(main())
