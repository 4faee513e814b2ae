"""LR schedules: pure functions of the step counter.

The port of ``repro.optim.schedule``. A schedule takes a 0-d integer step
tensor and returns a 0-d float32 tensor on the step's device; the
arithmetic runs in float32 tensors, as in JAX, so the learning rate is the
reference's to the bit (Python floats would compute in float64). The
cosine is the C library's float32 ``cosf``, the function XLA calls on the
CPU (torch's float32 cos is an ulp off now and then, and so is float64's
rounded); a schedule is read once a step, on the host.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@functools.lru_cache(maxsize=None)
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def _cos(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``cosf`` of a float32 tensor, on its device."""
    flat = [_cosf()(v) for v in x.reshape(-1).tolist()]
    return torch.tensor(flat, dtype=torch.float32,
                        device=x.device).reshape(x.shape)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``final_frac * peak_lr`` at ``total_steps``."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = _f32(peak_lr, step) * step / _f32(max(warmup_steps, 1), step)
        prog = torch.clamp((step - _f32(warmup_steps, step))
                           / _f32(max(total_steps - warmup_steps, 1), step),
                           0.0, 1.0)
        cos = _f32(peak_lr, step) * (
            _f32(final_frac, step) + _f32((1 - final_frac) * 0.5, step)
            * (_f32(1.0, step) + _cos(_f32(math.pi, step) * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def constant(lr: float):
    """``lr`` at every step, as a 0-d float32 tensor."""
    return lambda step: _f32(lr, torch.as_tensor(step))
