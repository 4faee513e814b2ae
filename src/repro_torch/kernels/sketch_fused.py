"""Fused sketch kernel: ``Pi @ A`` and the column norms of A in one read of A.

Hopper counterpart of the Pallas TPU kernel
``repro.kernels.sketch_fused.sketch_fused`` (``src/repro/kernels/
sketch_fused.py``): CUDA C++ for ``sm_90a`` in ``csrc/sketch_fused.cu``.

Bound on an H100: operations. The product costs ``2 k d n`` float32 FMA
FLOP (67 TFLOP/s without the tensor cores), about four times the time its
``(k d + d n + k n) * 4`` bytes take at 3.35 TB/s when k = 512.

Design (see the source for more): the Pallas kernel accumulates into an
output block it revisits along a sequential d grid axis, which would race on
a GPU, whose blocks run in parallel. Here each CTA owns one 128 x 128 tile
of the output and loops over all of d itself, a register-tiled SIMT GEMM
with double-buffered shared-memory tiles of Pi and A, two CTAs per SM; the
CTAs of k-tile 0 also add up the squared column norms from the A tile they
already hold. One write per
output element, no atomics, deterministic; ragged edges are masked.

``plain`` is the PyTorch version of the same function; ``kernels/ops.py``
chooses between the two and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import sketch_fused_ref as plain

SOURCE = "sketch_fused.cu"
REPLACES = "src/repro/kernels/sketch_fused.py:50"

#: The one tile ``csrc/sketch_fused.cu`` compiles, as the tuner names it:
#: (bn, bd) = (BN columns of A per CTA, BK rows of d per step). A CTA also
#: covers BM = 128 rows of Pi, with 256 threads and two shared-memory stages
#: of a (BK, BM + 4) Pi tile and a (BK, BN) A tile.
TILE = (128, 16)
THREADS = 256
SMEM_BYTES = 4 * 2 * (16 * (128 + 4) + 16 * 128)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ENTRY = {torch.float32: "sketch_fused_f32", torch.bfloat16: "sketch_fused_bf16"}


def bind(lib: ctypes.CDLL) -> None:
    """Declare the argument and result types of the library's entry points."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64, _P]
        fn.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, Pi: torch.Tensor, A: torch.Tensor):
    """Run the kernel on CUDA tensors Pi (k, d) and A (d, n) of one dtype,
    float32 or bfloat16, both contiguous, with k, d and n all positive.
    Returns (Pi @ A, squared norms), float32, on the current stream without
    synchronising."""
    k, d = Pi.shape
    n = A.shape[1]
    out = torch.empty((k, n), dtype=torch.float32, device=A.device)
    norm2 = torch.empty((n,), dtype=torch.float32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = getattr(lib, _ENTRY[A.dtype])(
        Pi.data_ptr(), A.data_ptr(), out.data_ptr(), norm2.data_ptr(),
        k, d, n, stream)
    if err:
        raise RuntimeError(f"sketch_fused: kernel launch failed with CUDA "
                           f"error {err}")
    return out, norm2


__all__ = ["plain", "bind", "launch", "SOURCE", "REPLACES", "TILE", "THREADS",
           "SMEM_BYTES"]
