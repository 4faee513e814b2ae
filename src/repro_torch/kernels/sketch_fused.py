"""Fused sketch kernel: ``Pi @ A`` and the column norms of A in one read of A.

Hopper counterpart of the Pallas TPU kernel
``repro.kernels.sketch_fused.sketch_fused`` (``src/repro/kernels/
sketch_fused.py:50``): CUDA C++ for ``sm_90a`` in ``csrc/sketch_fused.cu``,
with one design per input type. Each CTA owns one 128 x 128 tile of the
output at a time and loops over all of d itself (the Pallas kernel's
sequential d grid axis would race on a GPU), so every output element is
written once, with no atomics, deterministically. Each stage's products go
into a fresh accumulator that is added to the float32 sum with an ordinary
add, since the tensor cores truncate inside an MMA; the CTAs of row block 0
also add up the squared column norms from the exact A tile they hold.

* float32: ``mma.sync`` m16n8k8 TF32 products on a ring of three
  ``cp.async`` stages, 256 threads, one persistent CTA per SM; each value
  split into a TF32 big and small part, and small*big, big*small and
  big*big summed (about 2^-21 relative). Bound: operations, ``3 * 2 k d n``
  FLOP at 495 TFLOP/s (31.03 ms at k = 512, d = 50,000, n = 100,000).
* bf16: ``wgmma`` m64n128k16 on the bf16 tensor cores, both tiles read by
  TMA into a ring of six stages with the 128-byte swizzle, a producer warp,
  two norm warps and two consumer warpgroups (384 threads; the product's
  fresh accumulators cover four stages); the CTAs whose row blocks share a
  column tile of A form a thread block cluster of up to four along k, and
  each loads a share of the A tile multicast into all of them.
  Bound: operations, ``2 k d n`` FLOP at 989 TFLOP/s (5.18 ms).

TMA reads rows from 16-byte aligned bases at pitches that are multiples of
16 bytes: the bf16 entry reads Pi's rows at a pitch of d rounded up to 8
elements and A's at n rounded up to 8. ``launch`` makes a zero-padded copy
of an input that is not so, and counts it in ``ALIGNED_COPIES``.

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
#: covers BM rows of Pi. float32: 256 threads and three shared-memory stages
#: of a (BM, BK + 8) Pi tile and a (BK, BN + 4) A tile.
BM = 128
TILE = (128, 64)
THREADS = 256
STAGES = 3
#: One CTA per SM: a thread may use up to 255 registers (float32; the bf16
#: instance's 384 threads 168).
CTAS_PER_SM = 1
#: float32 does three TF32 tensor-core passes, bf16 one on the bf16 ones.
PASSES = {4: 3, 2: 1}
#: The bf16 instance: a producer warp, two norm warps, an idle warp and two
#: consumer warpgroups, six stages of a (BM, BK) Pi tile and a (BK, BN) A
#: tile, clusters of up to four CTAs along k.
BF16_THREADS = 384
BF16_STAGES = 6
BF16_CLUSTER_MAX = 4


def smem_bytes(dtype_bytes: int = 4) -> int:
    """Dynamic shared memory of one CTA for inputs of ``dtype_bytes``."""
    bn, bk = TILE
    if dtype_bytes == 2:
        # 1,024 bytes to align the ring, the stages, the full and empty
        # barriers
        return 1024 + BF16_STAGES * 2 * (BM * bk + bk * bn) + 16 * BF16_STAGES
    a_pitch = bn + 16 // dtype_bytes
    return STAGES * dtype_bytes * (BM * (bk + 8) + bk * a_pitch)


def threads(dtype_bytes: int = 4) -> int:
    """Threads of one CTA for inputs of ``dtype_bytes``."""
    return BF16_THREADS if dtype_bytes == 2 else THREADS


def cluster_size(k: int) -> int:
    """CTAs a cluster of the bf16 instance: the row blocks of Pi that share
    a column tile of A, at most four."""
    return max(1, min(-(-k // BM), BF16_CLUSTER_MAX))


SMEM_BYTES = smem_bytes(4)

#: Inputs that ``launch`` copied for the bf16 instance's TMA (each copied
#: tensor counts one).
ALIGNED_COPIES = 0

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ENTRY = {torch.float32: "sketch_fused_f32", torch.bfloat16: "sketch_fused_bf16"}


def bind(lib: ctypes.CDLL) -> None:
    """Declare the argument and result types of the library's entry points."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64, _P]
        fn.restype = ctypes.c_int
    lib.sketch_fused_bf16_clusters.argtypes = [_I64]
    lib.sketch_fused_bf16_clusters.restype = ctypes.c_int


def cluster_slots(lib: ctypes.CDLL, k: int) -> int:
    """Clusters of the bf16 instance (``cluster_size(k)`` CTAs each) that
    the current card holds at once."""
    slots = lib.sketch_fused_bf16_clusters(k)
    if slots < 0:
        raise RuntimeError(f"sketch_fused: cluster occupancy query failed "
                           f"with CUDA error {-slots}")
    return slots


def _tma_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its base is 16-byte aligned and its rows are a
    multiple of 8 bf16 long, else a zero-padded copy whose rows are
    rounded up to 8 elements (the pitch the bf16 entry reads)."""
    global ALIGNED_COPIES
    cols = x.shape[1]
    if x.data_ptr() % 16 == 0 and cols % 8 == 0:
        return x
    ALIGNED_COPIES += 1
    padded = torch.zeros((x.shape[0], -(-cols // 8) * 8), dtype=x.dtype,
                         device=x.device)
    padded[:, :cols] = x
    return padded


def launch(lib: ctypes.CDLL, Pi: torch.Tensor, A: torch.Tensor):
    """Run the kernel on CUDA tensors Pi (k, d) and A (d, n) of one dtype,
    float32 or bfloat16, both contiguous, with k, d and n all positive.
    Returns (Pi @ A, squared norms), float32, on the current stream without
    synchronising. bf16 inputs that TMA cannot read in place are copied
    first (``ALIGNED_COPIES``)."""
    k, d = Pi.shape
    n = A.shape[1]
    if A.dtype == torch.bfloat16:
        Pi, A = _tma_rows(Pi), _tma_rows(A)
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


__all__ = ["plain", "bind", "launch", "smem_bytes", "threads", "cluster_size",
           "cluster_slots", "SOURCE", "REPLACES", "BM", "TILE", "THREADS",
           "STAGES", "CTAS_PER_SM", "PASSES", "SMEM_BYTES", "BF16_THREADS",
           "BF16_STAGES", "BF16_CLUSTER_MAX", "ALIGNED_COPIES"]
