"""Training step: microbatched gradient accumulation, optional SMP-PCA
gradient compression (the tap path or the A = I baseline), AdamW.

The port of ``repro.train.train_step``. The state's parameters are a
module (``transformer.LM``) whose ``.grad`` tensors accumulate the
microbatches' gradients in place, as the reference's scan sums them into
float32 zeros; with tap compression the sketch taps accumulate over the
microbatches the same way, so the full dW never exists. The step then
divides by ``microbatches``, compresses, clips and updates in place (see
``optim/adamw.py``): at full width it allocates no second copy of the
parameters or gradients.

``TrainConfig.group`` (a ``torch.distributed`` ``ProcessGroup``) takes the
place of the reference's ``dp_axis``: the compressors sum their summaries
over it, and without compression the gradients are averaged over it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import convert, prng
from repro_torch.optim import grad_compression as gc
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.train import sketched_dense as sd


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    compression: str = "none"          # none | lowrank | taps
    comp_cfg: gc.CompressionConfig = gc.CompressionConfig()
    tap_cfg: sd.TapConfig = sd.TapConfig()
    group: Optional[Any] = None        # ProcessGroup for data parallelism
    n_workers: int = 1


class TrainState(NamedTuple):
    params: Any                        # the module (transformer.LM)
    opt: AdamWState                    # moments under the parameter names
    comp: Any                          # gc.CompressionState or ()
    step: torch.Tensor                 # () int32, on the CPU
    key: torch.Tensor


def init_state(key: torch.Tensor, params: torch.nn.Module, optimizer: AdamW,
               tcfg: TrainConfig) -> TrainState:
    """Moments (and lowrank's residuals, in the JAX package's tree) for
    ``params``, step 0."""
    named = dict(params.named_parameters())
    comp = ()
    if tcfg.compression == "lowrank":
        comp = gc.init_state(convert.lm_tree(named, torch.stack))
    return TrainState(params, optimizer.init(named), comp,
                      torch.zeros((), dtype=torch.int32), key)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """n microbatches of contiguous rows, as the reference's reshape to
    (n, B // n, ...)."""
    def rows(x, i):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch of {B} rows is not a multiple of "
                             f"{n} microbatches")
        return x[i * (B // n):(i + 1) * (B // n)]
    return [{k: rows(v, i) for k, v in batch.items()} for i in range(n)]


def _zero_grads(named: Dict[str, torch.nn.Parameter]
                ) -> Dict[str, torch.Tensor]:
    """The float32 gradient accumulators, zeroed: the ``.grad`` of each
    float32 parameter (allocated at the first step, then reused), and a
    float32 buffer beside each other one, into which its ``.grad`` is
    added after each microbatch. Parameters the loss does not reach keep
    a zero gradient, as in JAX."""
    grads = {}
    for name, p in named.items():
        if p.dtype != torch.float32:
            p.grad = None
            grads[name] = torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()
        grads[name] = p.grad
    return grads


def _lowrank(key, grads, state, tcfg):
    """``compress_grads`` over the gradients in the JAX package's tree (a
    stacked copy: lowrank runs at reduced sizes, where its error-feedback
    copy fits), the result written back in place."""
    out, comp, stats = gc.compress_grads(
        key, convert.lm_tree(grads, torch.stack), state.comp, tcfg.comp_cfg,
        group=tcfg.group, n_workers=tcfg.n_workers)
    with torch.no_grad():
        for name, g in grads.items():
            g.copy_(convert.lm_leaf(out, name))
    return comp, stats


def make_train_step(loss_fn: Callable, optimizer: AdamW, tcfg: TrainConfig):
    """``loss_fn(params, microbatch) -> scalar``. Returns ``train_step(state,
    batch) -> (state, metrics)``, which updates the state's tensors in
    place and returns a new ``TrainState`` holding them."""
    if tcfg.compression not in ("none", "lowrank", "taps"):
        raise ValueError(f"unknown compression {tcfg.compression!r}")

    def train_step(state: TrainState, batch) -> tuple[TrainState, Dict]:
        named = dict(state.params.named_parameters())
        grads = _zero_grads(named)
        n = tcfg.microbatches
        lsum = None
        for mb in _split_microbatches(batch, n):
            loss = loss_fn(state.params, mb)
            loss.backward()
            with torch.no_grad():
                for name, p in named.items():
                    if grads[name] is not p.grad and p.grad is not None:
                        grads[name].add_(p.grad)
                        p.grad = None
            loss = loss.detach().to(torch.float32)
            lsum = loss if lsum is None else lsum + loss
        with torch.no_grad():
            if n > 1:
                for g in grads.values():
                    g.div_(n)
        loss = lsum / n

        key_step = prng.fold_in(state.key, state.step)
        comp_state = state.comp
        stats: Dict[str, Any] = {}
        if tcfg.compression == "lowrank":
            comp_state, stats = _lowrank(key_step, grads, state, tcfg)
        elif tcfg.compression == "taps":
            sd.decompress_tapped_params(key_step, grads, tcfg.tap_cfg)
        elif tcfg.group is not None:
            size = dist.get_world_size(tcfg.group)
            for g in grads.values():
                dist.all_reduce(g, group=tcfg.group)
                g.div_(size)

        gnorm = global_norm(grads)
        _, opt = optimizer.update(grads, state.opt, named)
        new_state = TrainState(state.params, opt, comp_state, state.step + 1,
                               state.key)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": optimizer._lr(opt.step), **stats}
        return new_state, metrics

    return train_step
