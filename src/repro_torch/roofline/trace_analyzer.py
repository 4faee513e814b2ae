"""Per-device cost of a traced PyTorch program: FLOPs, bytes and collectives.

The torch counterpart of ``repro.roofline.hlo_analyzer``. The JAX package
parses compiled HLO and recovers each loop's trip count; torch eager runs
every loop unrolled, so here a ``TorchDispatchMode`` sees each op as it
runs and trip counts come for free. The counting rule is the HLO
analyzer's:

  flops:  a dot counts 2 * its output size * its contracted size; an
          elementwise op counts its output elements; a reduction counts
          its input elements (softmax and its kin count the elementwise
          ops and reductions they fuse, ``_FUSED``);
  bytes:  the operands plus the outputs of each op (eager PyTorch runs
          each op as its own kernel: nothing is fused). Views count
          nothing. In-place slice writes (``copy_`` into a view), gathers
          and scatters count the slice;
  collectives: each ``_c10d_functional`` collective counts its output's
          bytes, by op (the HLO names) and by mesh axis.

Counts are **per device**. Under DTensor the mode passes each op on
DTensors down (``NotImplemented``), so what it counts is the op DTensor
runs on the local shards, and the collectives that its redistributions
insert. The shape propagation DTensor runs on global shapes (under a
``FakeTensorMode``) is not counted.

Ops whose meaning the trace cannot see carry their own rule
(``RULES``): a dry-run trace of the flash kernel
(``kernels.flash_attention.trace``) counts the kernel's own work, not
the plain route's S^2 scores, and the remat tag
(``models.transformer.attn_out``) counts nothing, as ``checkpoint_name``
is no op in HLO.

A loop whose steps are alike can be traced once and counted as many
times as it runs, as the HLO analyzer multiplies a while loop's body by
its trip count: ``TraceAnalyzer.scaled(n)`` multiplies every op counted
under it by n (0 counts nothing), and ``current()`` finds the analyzer a
model is traced under (the sLSTM's time loop on ``meta`` tensors,
``models.xlstm``).

On the CPU, ``models.common._mm_f32`` upcasts bf16 operands to float32 and
multiplies those; on the card (and on ``meta`` tensors, which trace the
card's route) it is one bf16 GEMM with a float32 output
(``aten.mm.dtype``), which is what the dry run counts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

from repro_torch.roofline import analysis

aten = torch.ops.aten


@dataclasses.dataclass
class Cost:
    """The fields of ``hlo_analyzer.Cost`` and the collectives behind
    them."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: (op, bytes, axis) of every collective, in order
    collectives: List[Tuple[str, int, Optional[str]]] = \
        dataclasses.field(default_factory=list)
    ops: int = 0
    #: op name -> [calls, flops, bytes]: where the counts come from
    by_op: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def stats(self) -> analysis.CollectiveStats:
        return analysis.collective_bytes(self.collectives)


def _numel(t: torch.Tensor) -> int:
    return math.prod(t.shape)


def _nbytes(t: torch.Tensor) -> int:
    return _numel(t) * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _name(func) -> str:
    """``aten::mm.dtype`` -> ``mm``; ``_c10d_functional::all_reduce`` ->
    ``all_reduce``."""
    return func._schema.name.split("::")[-1]


_VIEWS = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "slice", "select", "unsqueeze", "squeeze", "as_strided", "alias",
    "detach", "split", "split_with_sizes", "unbind", "diagonal", "narrow",
    "_reshape_alias", "unfold", "lift_fresh", "chunk", "view_as",
    "expand_as", "movedim", "_conj", "_neg_view", "empty", "empty_strided",
    "empty_like", "new_empty", "new_empty_strided", "_to_copy_view",
    "wait_tensor", "_wrap_tensor_autograd", "is_same_size", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "set", "resize",
}

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "_scaled_mm"}

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "any", "all", "norm", "linalg_vector_norm",
    "cumsum", "cumprod", "logsumexp", "argmax", "argmin", "nll_loss_forward",
    "nll_loss_backward", "count_nonzero",
}

#: ops PyTorch runs as one kernel for what XLA writes as several: counted
#: as the elementwise ops and reductions they stand for, a multiple of
#: their largest operand's elements (softmax: max, subtract, exp, sum,
#: divide; its backward: multiply, sum, subtract, multiply)
_FUSED = {
    "_softmax": 5, "_log_softmax": 6, "_softmax_backward_data": 4,
    "_log_softmax_backward_data": 4,
}

#: ops that move data and compute nothing
_MOVES = {
    "clone", "cat", "stack", "sort", "argsort", "topk", "flip", "roll",
    "constant_pad_nd", "repeat", "repeat_interleave", "copy", "contiguous",
    "_unsafe_index", "tril", "triu", "one_hot", "arange", "full", "zeros",
    "ones", "zeros_like", "ones_like", "full_like", "fill", "zero",
    "scalar_tensor", "lift", "randn", "rand", "randint", "new_zeros",
    "new_ones", "new_full",
}

#: gathers and scatters: the slice they read or write, twice (read and
#: write), as the HLO analyzer charges them
_SLICED = {"index", "gather", "embedding", "index_select", "take",
           "embedding_dense_backward"}
_SCATTERS = {"index_put", "scatter", "scatter_add", "index_add",
             "scatter_reduce", "index_copy", "_index_put_impl",
             "slice_scatter", "select_scatter", "masked_scatter"}

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}

def _flash_rule(args, kwargs, out):
    from repro_torch.kernels.flash_attention import trace_cost
    return trace_cost(*args, **kwargs)


#: op name -> rule(args, kwargs, out) -> (flops, bytes): ops whose work the
#: generic rule cannot see
RULES: Dict[str, Callable] = {
    "repro_torch::flash_attention_trace": _flash_rule,
    "repro_torch::attn_out": lambda args, kwargs, out: (0.0, 0.0),
}


def _dot_flops(name: str, args, out: torch.Tensor) -> float:
    if name in ("addmm", "baddbmm"):
        a = args[1]
    else:
        a = args[0]
    return 2.0 * _numel(out) * a.shape[-1]


class TraceAnalyzer(TorchDispatchMode):
    """Counts each op that runs on local tensors while it is active into
    ``cost``. ``axis_of_group`` maps a process group's name to the mesh
    axis it spans (``axes_of_mesh``)."""

    def __init__(self, axis_of_group: Optional[Dict[str, str]] = None):
        super().__init__()
        self.cost = Cost()
        self.axis_of_group = dict(axis_of_group or {})
        self.scale = 1

    @contextlib.contextmanager
    def scaled(self, n: int):
        """Count each op run inside n times (nested: the product)."""
        outer = self.scale
        self.scale = outer * n
        try:
            yield
        finally:
            self.scale = outer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor(types):
            return NotImplemented           # count the ops on its shards
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is None:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = _name(func)
        if name.endswith("_"):
            name = name[:-1]                # in place: as its functional op
        c = self.cost
        if name in _VIEWS or self.scale == 0:
            return
        n = self.scale
        c.ops += n
        flops0, bytes0 = c.flops, c.bytes
        coll0, ncoll0 = c.coll_bytes, len(c.collectives)
        try:
            self._count_op(func, name, args, kwargs, out)
        finally:
            if n != 1:
                self._repeat(n - 1, c.flops - flops0, c.bytes - bytes0,
                             c.coll_bytes - coll0, c.collectives[ncoll0:])
            row = c.by_op.setdefault(name, [0, 0.0, 0.0])
            row[0] += n
            row[1] += c.flops - flops0
            row[2] += c.bytes - bytes0

    def _repeat(self, k, flops, nbytes, coll_bytes, collectives) -> None:
        """Count an op's ``flops``, ``nbytes`` and ``collectives`` k more
        times."""
        c = self.cost
        c.flops += k * flops
        c.bytes += k * nbytes
        c.coll_bytes += k * coll_bytes
        for op, b, axis in collectives:
            c.coll_by_op[op] += k * b
            if axis is not None:
                c.coll_by_axis[axis] += k * b
        c.collectives.extend(list(collectives) * k)

    def _count_op(self, func, name, args, kwargs, out) -> None:
        c = self.cost
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        rule = RULES.get(func._schema.name)
        if rule is not None:
            flops, nbytes = rule(args, kwargs, out)
            c.flops += flops
            c.bytes += nbytes
            return
        if name in _COLLECTIVES:
            nbytes = sum(_nbytes(t) for t in outs)
            op = _COLLECTIVES[name]
            group = args[-1] if isinstance(args[-1], str) else \
                kwargs.get("group_name")
            axis = self.axis_of_group.get(group)
            c.coll_bytes += nbytes
            c.coll_by_op[op] = c.coll_by_op.get(op, 0) + nbytes
            if axis is not None:
                c.coll_by_axis[axis] = c.coll_by_axis.get(axis, 0) + nbytes
            c.collectives.append((op, nbytes, axis))
            c.bytes += 2 * nbytes
            return
        in_bytes = sum(_nbytes(t) for t in ins)
        out_bytes = sum(_nbytes(t) for t in outs)
        if name in _SLICED:
            c.bytes += 2 * out_bytes
            return
        if name in _SCATTERS:
            src = ins[-1] if name not in ("slice_scatter", "select_scatter") \
                else ins[1]
            c.bytes += 2 * _nbytes(src)
            return
        if func is aten.copy_.default:
            # a write into a slice view counts the slice: source and
            # destination (a view of the slice) are the same size
            c.flops += _numel(ins[0])
            c.bytes += _nbytes(ins[0]) + _nbytes(ins[1])
            return
        c.bytes += in_bytes + out_bytes
        if name in _DOTS:
            c.flops += _dot_flops(name, args, outs[0])
        elif name in _FUSED:
            c.flops += _FUSED[name] * max(_numel(t) for t in ins)
        elif name in _REDUCTIONS:
            c.flops += max((_numel(t) for t in ins), default=0)
        elif name in _MOVES:
            pass
        else:                               # elementwise
            c.flops += sum(_numel(t) for t in outs)


def _is_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def current() -> Optional[TraceAnalyzer]:
    """The innermost active ``TraceAnalyzer``, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, TraceAnalyzer):
            return mode
    return None


def axes_of_mesh(mesh) -> Dict[str, str]:
    """Process group name -> mesh axis name, for each axis of a
    ``DeviceMesh``."""
    if mesh is None:
        return {}
    return {mesh.get_group(name).group_name: name
            for name in mesh.mesh_dim_names}


def analyze(fn, *args, mesh=None, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` and count it per device; returns the
    ``Cost``. ``mesh``: the ``DeviceMesh`` whose axes the collectives are
    booked to."""
    mode = TraceAnalyzer(axes_of_mesh(mesh))
    with mode:
        fn(*args, **kwargs)
    return mode.cost
