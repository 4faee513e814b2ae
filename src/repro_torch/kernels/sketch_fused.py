"""Fused sketch kernel: ``Pi @ A`` and the column norms of A in one read of A.

Hopper counterpart of the Pallas TPU kernel
``repro.kernels.sketch_fused.sketch_fused`` (``src/repro/kernels/
sketch_fused.py:50``): CUDA C++ for ``sm_90a`` in ``csrc/sketch_fused.cu``,
on the TF32 tensor cores.

Bound on an H100: operations. A float32-accurate product takes three TF32
passes, ``3 * 2 k d n`` FLOP at 495 TFLOP/s (31.03 ms at k = 512, d =
50,000, n = 100,000); its ``(k d + d n + k n + n) * 4`` bytes take 6.06 ms
at 3.35 TB/s, and the float32 FMA units would take 76.57 ms.

Design (see the source for more): each CTA owns one 128 x 128 tile of the
output at a time and loops over all of d itself (the Pallas kernel's
sequential d grid axis would race on a GPU), so every output element is
written once, with no atomics, deterministically. ``mma.sync`` m16n8k8 TF32
products on a ring of three ``cp.async`` shared-memory stages, 256 threads,
one persistent CTA per SM. float32 values are split into a TF32 big and
small part, and small*big, big*small and big*big are summed (about 2^-21
relative, float32 class); a bf16 value is exact in TF32, so bf16 takes one
pass. Each stage's products go into a fresh fragment that is added to the
float32 sum with an ordinary add, since the tensor cores truncate inside an
MMA. The CTAs of k-tile 0 also add up the squared
column norms from the exact A tile they hold. Not ``wgmma`` yet: its TF32
form reads B only K-major, and a tile of row-major A is N-major.

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
#: (bn, bd) = (BN columns of A per CTA, BK rows of d per stage). A CTA also
#: covers BM rows of Pi, with 256 threads and three shared-memory stages of
#: a (BM, BK + 8) Pi tile and a (BK, BN + 16 bytes) A tile.
BM = 128
TILE = (128, 64)
THREADS = 256
STAGES = 3
#: One CTA per SM: a thread may use up to 255 registers.
CTAS_PER_SM = 1
#: float32 does three TF32 tensor-core passes, bf16 one.
PASSES = {4: 3, 2: 1}


def smem_bytes(dtype_bytes: int = 4) -> int:
    """Dynamic shared memory of one CTA for inputs of ``dtype_bytes``."""
    bn, bk = TILE
    a_pitch = bn + 16 // dtype_bytes
    return STAGES * dtype_bytes * (BM * (bk + 8) + bk * a_pitch)


SMEM_BYTES = smem_bytes(4)

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


__all__ = ["plain", "bind", "launch", "smem_bytes", "SOURCE", "REPLACES",
           "BM", "TILE", "THREADS", "STAGES", "CTAS_PER_SM", "PASSES",
           "SMEM_BYTES"]
