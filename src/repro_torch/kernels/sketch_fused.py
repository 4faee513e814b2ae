"""Fused sketch kernel: ``Pi @ A`` and the column norms of A in one read of A.

Hopper counterpart of the Pallas TPU kernel
``repro.kernels.sketch_fused.sketch_fused`` (``src/repro/kernels/
sketch_fused.py:50``): CUDA C++ for ``sm_90a`` in ``csrc/sketch_fused.cu``,
with one design per input type, both on ``wgmma`` fed by TMA. Each CTA owns
one 128 x 128 tile of the output at a time and loops over all of d itself
(the Pallas kernel's sequential d grid axis would race on a GPU), so every
output element is written once, with no atomics, deterministically. A chain
of stages' products goes into a fresh accumulator that is added to the
float32 sum with an ordinary add, since the tensor cores truncate inside an
MMA; the squared column norms are summed from the exact A tile the CTAs
hold. CTAs that share tiles form thread block clusters, in which each loads
a share of the shared tiles, multicast into all of them.

* float32: the transposed product on the TF32 tensor cores, ``wgmma``
  m64n128k8 with A's fragments loaded into registers from A's tile and
  Pi's tile read K-major from shared memory; each value split into its raw
  value (the tensor core truncates it to TF32) and ``small = x - trunc(x)``,
  and A small x Pi big, A big x Pi big and A big x Pi small summed (about
  2^-20 relative). Pi's small parts come from a prologue that writes them
  once a call into scratch ``launch`` allocates (``pi_small_plain`` is its
  plain version). A ring of four stages, a producer warp and two consumer
  warpgroups (288 threads); chains of eight 32-row stages, whose fresh
  accumulators are added into float32 sums half in registers, half in
  shared memory. The CTAs of two neighbouring column tiles form a thread
  block cluster, and each loads half the rows of Pi's tiles, multicast
  into both. Bound: operations, ``3 * 2 k d n`` FLOP at 495 TFLOP/s
  (31.03 ms at k = 512, d = 50,000, n = 100,000).
* bf16: ``wgmma`` m64n128k16 on the bf16 tensor cores, both tiles read by
  TMA into a ring of six stages with the 128-byte swizzle, a producer warp,
  two norm warps and two consumer warpgroups (384 threads; the product's
  fresh accumulators cover four 64-row stages); the CTAs of up to four row
  blocks that share a column tile of A form a cluster along k, and each
  loads a share of A's tile, multicast into all of them.
  Bound: operations, ``2 k d n`` FLOP at 989 TFLOP/s (5.18 ms).

TMA reads rows from 16-byte aligned bases at pitches that are multiples of
16 bytes: the entries read Pi's rows at a pitch of d rounded up to 16 bytes
(4 float32, 8 bf16) and A's at n rounded up alike. ``launch`` makes a
zero-padded copy of an input that is not so, and counts it in
``ALIGNED_COPIES``.

``plain`` is the PyTorch version of the same function; ``kernels/ops.py``
chooses between the two and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import sketch_fused_ref as plain

SOURCE = "sketch_fused.cu"
REPLACES = "src/repro/kernels/sketch_fused.py:50"

#: The tile of ``csrc/sketch_fused.cu``'s float32 instance, as the tuner
#: names it: (bn, bd) = (BN columns of A per CTA, F32_BK rows of d per
#: stage); the tuner's one label for the kernel (the bf16 instance runs
#: BF16_TILE's 64-row stages under it). A CTA also covers BM rows of Pi.
#: float32: two consumer warpgroups and a producer warp, four stages of a
#: (BM, bd) Pi tile, its small part's and a (bd, BN) A tile, and half the
#: CTA's (BM, BN) float32 sums (the other half in registers).
BM = 128
TILE = (128, 32)
BF16_TILE = (128, 64)
THREADS = 288
STAGES = 4
#: One CTA per SM (at most 168 registers a thread).
CTAS_PER_SM = 1
#: float32 does three TF32 tensor-core passes, bf16 one on the bf16 ones.
PASSES = {4: 3, 2: 1}
#: The bf16 instance: a producer warp, two norm warps, an idle warp and two
#: consumer warpgroups, six stages of a (BM, 64) Pi tile and a (64, BN) A
#: tile.
BF16_THREADS = 384
BF16_STAGES = 6
#: CTAs a cluster, at most (along k, along n): the float32 instance's
#: CTAs that share a row block multicast Pi's tiles along n, the bf16
#: instance's that share a column tile multicast A's along k.
F32_CLUSTER = (1, 2)
BF16_CLUSTER = (4, 1)


def smem_bytes(dtype_bytes: int = 4) -> int:
    """Dynamic shared memory of one CTA for inputs of ``dtype_bytes``: 1,024
    bytes to align the ring, the stages, in float32 half the CTA's float32
    sums, the full and empty barriers."""
    if dtype_bytes == 2:
        bn, bk = BF16_TILE
        return 1024 + BF16_STAGES * 2 * (BM * bk + bk * bn) + 16 * BF16_STAGES
    bn, bk = TILE
    return (1024 + STAGES * 4 * (2 * BM * bk + bk * bn) + 2 * BM * bn
            + 16 * STAGES)


def threads(dtype_bytes: int = 4) -> int:
    """Threads of one CTA for inputs of ``dtype_bytes``."""
    return BF16_THREADS if dtype_bytes == 2 else THREADS


def cluster_shape(k: int, n: int, dtype_bytes: int = 4) -> tuple:
    """(ck, cn): a cluster's CTAs along k (the row blocks of Pi that share
    a column tile of A) and along n (the column tiles of A that share a
    row block of Pi) for Pi (k, d) and A (d, n)."""
    most_k, most_n = BF16_CLUSTER if dtype_bytes == 2 else F32_CLUSTER
    return (max(1, min(-(-k // BM), most_k)),
            max(1, min(-(-n // TILE[0]), most_n)))


SMEM_BYTES = smem_bytes(4)

#: Inputs that ``launch`` copied for TMA (each copied tensor counts one).
ALIGNED_COPIES = 0

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def bind(lib: ctypes.CDLL) -> None:
    """Declare the argument and result types of the library's entry points."""
    lib.sketch_fused_f32.argtypes = [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P]
    lib.sketch_fused_bf16.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64, _P]
    lib.sketch_fused_pi_small.argtypes = [_P, _P, _I64, _P]
    lib.sketch_fused_clusters.argtypes = [_I64, ctypes.c_int]
    for fn in (lib.sketch_fused_f32, lib.sketch_fused_bf16,
               lib.sketch_fused_pi_small, lib.sketch_fused_clusters):
        fn.restype = ctypes.c_int


def cluster_slots(lib: ctypes.CDLL, k: int, dtype_bytes: int = 4) -> int:
    """Clusters of the instance for ``dtype_bytes`` (``cluster_shape(k, n)``
    CTAs each, n at least two column tiles) that the current card holds at
    once."""
    slots = lib.sketch_fused_clusters(k, dtype_bytes)
    if slots < 0:
        raise RuntimeError(f"sketch_fused: cluster occupancy query failed "
                           f"with CUDA error {-slots}")
    return slots


def _tma_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its base is 16-byte aligned and its rows are a
    multiple of 16 bytes long, else a zero-padded copy whose rows are
    rounded up to 16 bytes (the pitch the entries read)."""
    global ALIGNED_COPIES
    cols, per = x.shape[1], 16 // x.element_size()
    if x.data_ptr() % 16 == 0 and cols % per == 0:
        return x
    ALIGNED_COPIES += 1
    padded = torch.zeros((x.shape[0], -(-cols // per) * per), dtype=x.dtype,
                         device=x.device)
    padded[:, :cols] = x
    return padded


def pi_small_plain(Pi: torch.Tensor) -> torch.Tensor:
    """The float32 prologue's function in PyTorch: ``Pi - trunc(Pi)``, with
    trunc keeping the top 19 bits of each float32 (what the TF32 tensor
    core reads)."""
    trunc = (Pi.view(torch.int32) & -0x2000).view(torch.float32)
    return Pi - trunc


def pi_small_launch(lib: ctypes.CDLL, Pi: torch.Tensor) -> torch.Tensor:
    """The float32 prologue alone on a CUDA float32 Pi, contiguous, 16-byte
    aligned, its size a multiple of 4: ``pi_small_plain(Pi)`` on the
    current stream without synchronising."""
    small = torch.empty_like(Pi)
    err = lib.sketch_fused_pi_small(
        Pi.data_ptr(), small.data_ptr(), Pi.numel(),
        torch.cuda.current_stream(Pi.device).cuda_stream)
    if err:
        raise RuntimeError(f"sketch_fused prologue: launch failed with CUDA "
                           f"error {err}")
    return small


def launch(lib: ctypes.CDLL, Pi: torch.Tensor, A: torch.Tensor):
    """Run the kernel on CUDA tensors Pi (k, d) and A (d, n) of one dtype,
    float32 or bfloat16, both contiguous, with k, d and n all positive.
    Returns (Pi @ A, squared norms), float32, on the current stream without
    synchronising. Inputs that TMA cannot read in place are copied first
    (``ALIGNED_COPIES``). float32 also allocates the prologue's scratch for
    Pi's small parts: the prologue and the kernel are one call here."""
    k, d = Pi.shape
    n = A.shape[1]
    Pi, A = _tma_rows(Pi), _tma_rows(A)
    out = torch.empty((k, n), dtype=torch.float32, device=A.device)
    norm2 = torch.empty((n,), dtype=torch.float32, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    if A.dtype == torch.bfloat16:
        err = lib.sketch_fused_bf16(Pi.data_ptr(), A.data_ptr(),
                                    out.data_ptr(), norm2.data_ptr(), k, d,
                                    n, stream)
    else:
        small = torch.empty_like(Pi)
        err = lib.sketch_fused_f32(Pi.data_ptr(), A.data_ptr(),
                                   small.data_ptr(), out.data_ptr(),
                                   norm2.data_ptr(), k, d, n, stream)
    if err:
        raise RuntimeError(f"sketch_fused: kernel launch failed with CUDA "
                           f"error {err}")
    return out, norm2


__all__ = ["plain", "pi_small_plain", "pi_small_launch", "bind", "launch",
           "smem_bytes", "threads", "cluster_shape", "cluster_slots", "SOURCE",
           "REPLACES", "BM", "TILE", "BF16_TILE", "THREADS", "STAGES",
           "CTAS_PER_SM", "PASSES", "SMEM_BYTES", "BF16_THREADS",
           "BF16_STAGES", "F32_CLUSTER", "BF16_CLUSTER", "ALIGNED_COPIES"]
