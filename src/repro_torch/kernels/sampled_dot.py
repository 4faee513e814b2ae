"""Sampled rescaled-JL dot products (paper step 2, the O(m k) term).

Hopper counterpart of the Pallas TPU kernel
``repro.kernels.sampled_dot.sampled_rescaled_dot`` (``src/repro/kernels/
sampled_dot.py``): CUDA C++ for ``sm_90a`` in ``csrc/sampled_dot.cu``.
For each sampled pair ``(rows[t], cols[t])`` it gathers the two row-major
sketch rows and returns Eq. 2,
``nA[r] nB[c] <As[r], Bs[c]> / max(|As[r]| |Bs[c]|, 1e-12)``.

Bound on an H100: counted once, the inputs are small and the bound is the
function's ``2 m k`` FLOP of dot products (the row norms depend on the row
alone: ``2 (n1 + n2) k`` more); but every sample gathers ``2 k`` floats from
sketches larger than the 50 MB L2, so the gather's memory traffic sets the
time. The kernel recomputes both row norms per sample, ``6 m k`` FLOP in
all, which costs nothing while the gathers dominate.

Design: the TPU kernel's scalar-prefetched indices and one-row-per-grid-step
DMA have no counterpart to copy. One warp owns one sample: coalesced loads
of both rows, the dot product and both squared norms accumulated in float32
and reduced with warp shuffles, the same ``max(., 1e-12)`` guard.

``plain`` is the PyTorch version of the same function; ``kernels/ops.py``
chooses between the two and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import sampled_rescaled_dot_ref as plain

SOURCE = "sampled_dot.cu"
REPLACES = "src/repro/kernels/sampled_dot.py:46"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ENTRY = {torch.float32: "sampled_dot_f32", torch.bfloat16: "sampled_dot_bf16"}


def bind(lib: ctypes.CDLL) -> None:
    """Declare the argument and result types of the library's entry points."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _P]
        fn.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, As_rows: torch.Tensor, Bs_rows: torch.Tensor,
           norm_A: torch.Tensor, norm_B: torch.Tensor, rows: torch.Tensor,
           cols: torch.Tensor) -> torch.Tensor:
    """Run the kernel on contiguous CUDA tensors: sketches (n, k) of one
    dtype (float32 or bfloat16), float32 norms, int32 indices (m,) with
    m > 0, all in range. Returns (m,) float32 on the current stream without
    synchronising."""
    m, k = rows.shape[0], As_rows.shape[1]
    out = torch.empty((m,), dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = getattr(lib, _ENTRY[As_rows.dtype])(
        As_rows.data_ptr(), Bs_rows.data_ptr(), norm_A.data_ptr(),
        norm_B.data_ptr(), rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
        m, k, stream)
    if err:
        raise RuntimeError(f"sampled_rescaled_dot: kernel launch failed with "
                           f"CUDA error {err}")
    return out


__all__ = ["plain", "bind", "launch", "SOURCE", "REPLACES"]
