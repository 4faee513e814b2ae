"""AdamW over name->tensor dicts: optional bf16 moments, decoupled weight
decay, global-norm clipping.

The port of ``repro.optim.adamw``, with its functional ``init`` and
``update(grads, state, params)``. The update runs the reference's
arithmetic in its order (global-norm clip, bias corrections ``1 - b**step``
in float32, weight decay on leaves of two or more dimensions, moments
rounded to ``moment_dtype`` each step) and differs only in where it writes:
under ``torch.no_grad()`` it writes the parameters and moments in place,
one leaf at a time, so that its temporaries are a few tensors of one
leaf's size (an out-of-place update of phi3-mini-3.8b's tree would
allocate another 15.3 GB). It returns the same parameter dict and a new
``AdamWState`` holding the same moment tensors.

The step counter is a 0-d int32 CPU tensor, and so are the learning rate
and the bias corrections computed from it: 0-d CPU tensors combine with
tensors on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.linalg import sqrt_f32


class AdamWState(NamedTuple):
    step: torch.Tensor                   # () int32, on the CPU
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: torch.dtype = torch.float32   # bf16 halves optimizer memory

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)
        return AdamWState(torch.zeros((), dtype=torch.int32),
                          {n: zeros(p) for n, p in params.items()},
                          {n: zeros(p) for n, p in params.items()})

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        return self.lr(step) if callable(self.lr) else \
            torch.tensor(self.lr, dtype=torch.float32)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor]):
        """One step: ``(params, new_state)``, both written in place."""
        step = state.step + 1
        scale = None
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), stepf)
        lr = self._lr(step)
        for name, p in params.items():
            g = grads[name]
            m, v = state.mu[name], state.nu[name]
            # cast, then scale: the reference multiplies in float32 (JAX
            # promotes a bf16 gradient times the float32 scale)
            g32 = g.to(torch.float32)
            if scale is not None:
                g32 = g32 * scale
            # m32 = b1 m + (1 - b1) g and v32 = b2 v + (1 - b2) g g, each
            # product rounded before the sum, as the reference's
            if m.dtype == torch.float32:
                m32 = m.mul_(b1).add_(g32 * (1 - b1))
                v32 = v.mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
            else:
                m32 = (m.to(torch.float32) * b1).add_(g32 * (1 - b1))
                v32 = (v.to(torch.float32) * b2).add_(
                    (g32 * (1 - b2)).mul_(g32))
                m.copy_(m32)
                v.copy_(v32)
            delta = (m32 / bc1).div_(sqrt_f32(v32 / bc2).add_(self.eps))
            if p.ndim >= 2 and self.weight_decay:
                delta.add_(p.to(torch.float32) * self.weight_decay)
            if p.dtype == torch.float32:
                p.sub_(delta.mul_(lr))
            else:
                p.copy_(p.to(torch.float32) - delta.mul_(lr))
        return params, AdamWState(step, state.mu, state.nu)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared entries, in float32 (a dict
    is read by its values)."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    total = torch.zeros((), dtype=torch.float32)
    for leaf in leaves:
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return sqrt_f32(total)
