"""Sampled rescaled-JL dot products (paper step 2, the O(m k) term).

Hopper counterpart of the Pallas TPU kernel
``repro.kernels.sampled_dot.sampled_rescaled_dot`` (``src/repro/kernels/
sampled_dot.py``): CUDA C++ for ``sm_90a`` in ``csrc/sampled_dot.cu``.
For each sampled pair ``(rows[t], cols[t])`` it takes the two row-major
sketch rows and returns Eq. 2,
``nA[r] nB[c] <As[r], Bs[c]> / max(|As[r]| |Bs[c]|, 1e-12)``, in sample
order.

Bound on an H100: counted once, the inputs are small and the bound is the
function's ``2 m k`` FLOP of dot products (the row norms depend on the row
alone: ``2 (n1 + n2) k`` more). But every sample needs a row of each
sketch, and the sketches are larger than the 50 MB L2; fetched from device
memory per sample, as the first design did, the rows cost ``2 k`` floats a
sample and set the time.

Design: the samples are put in bucket order, bucket (column block of
``cols[t]``, ``rows[t]``), by a radix sort of the bucket ids (8 bits a
pass: per-tile histograms, an integer scan, stable scatters staged in
shared memory), ``column_block`` sizing a column block of Bs to
``L2_BLOCK_BYTES`` so that it stays in L2; each sketch row's squared norm
is computed once. A warp then takes 32 bucket-ordered samples, holds its A
row in registers, and gathers the B rows from L2. Each sample's arithmetic
is the first design's (lane-strided FMAs, the same shuffle tree), so the
values do not depend on the bucketing: the same bits on every run.

``plain`` is the PyTorch version of the same function; ``kernels/ops.py``
chooses between the two and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import sampled_rescaled_dot_ref as plain

SOURCE = "sampled_dot.cu"
REPLACES = "src/repro/kernels/sampled_dot.py:46"

#: ``csrc/sampled_dot.cu``'s gather CTA: WARPS = 8 warps of SEG = 32
#: bucket-ordered samples each, no shared memory; it has no tile to tune.
SAMPLES_PER_CTA = 8 * 32
GATHER_THREADS = 8 * 32

#: The scan's tile: SCAN_THREADS x SCAN_ITEMS counts a CTA.
SCAN_TILE = 1024 * 4

#: The radix sort into bucket order: 8 bits a pass (BINS digits), a tile of
#: SORT_THREADS x SORT_ITEMS samples a CTA.
BINS = 256
SORT_TILE = 256 * 8

#: The bytes of Bs one column block may take: a third of the H100's 50 MB
#: L2, which also carries the A rows and the sample lists passing through.
L2_BLOCK_BYTES = 16 << 20

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ENTRY = {torch.float32: "sampled_dot_f32", torch.bfloat16: "sampled_dot_bf16"}


def bind(lib: ctypes.CDLL) -> None:
    """Declare the argument and result types of the library's entry points."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                       _I64, _P, _P, _P, _P, _P, _P, _P, _P]
        fn.restype = ctypes.c_int


def column_block(k: int, itemsize: int, n2: int) -> int:
    """Rows of Bs in one column block: the largest power of two whose rows
    (``k * itemsize`` bytes each) fit in ``L2_BLOCK_BYTES``, at least 1 and
    no more than n2 needs (8,192 at k = 512 float32, 16,384 in bf16)."""
    rows = max(1, L2_BLOCK_BYTES // max(1, k * itemsize))
    block = 1 << (rows.bit_length() - 1)
    return max(1, min(block, 1 << max(0, (n2 - 1).bit_length())))


def buckets(n1: int, n2: int, cblock: int) -> int:
    """Number of (column block, row) buckets."""
    return -(-n2 // cblock) * n1


def launch(lib: ctypes.CDLL, As_rows: torch.Tensor, Bs_rows: torch.Tensor,
           norm_A: torch.Tensor, norm_B: torch.Tensor, rows: torch.Tensor,
           cols: torch.Tensor):
    """Run the kernel on contiguous CUDA tensors: sketches (n, k) of one
    dtype (float32 or bfloat16), float32 norms, int32 indices (m,) with
    0 < m < 2**31. Returns ((m,) float32, flag) on the current stream
    without synchronising; the int32 ``flag`` holds 1 once the kernels ran
    if an index was out of range (that sample's value is not written)."""
    m = rows.shape[0]
    (n1, k), n2 = As_rows.shape, Bs_rows.shape[0]
    dev = rows.device
    cblock = column_block(k, As_rows.element_size(), n2)
    if buckets(n1, n2, cblock) >= 2 ** 32 - 1:
        raise ValueError(f"sampled_rescaled_dot: {n1} x {n2} entries make "
                         f"too many buckets for 32-bit ids")
    counts = BINS * -(-m // SORT_TILE)         # digit counts of one pass
    i32 = dict(dtype=torch.int32, device=dev)
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    keys = torch.empty((2, m), **i32)          # two buffers, back and forth
    vals = torch.empty((2, m, 2), **i32)       # (t, col) of each sample
    hist = torch.empty((counts,), **i32)
    offs = torch.empty((counts,), **i32)
    tsum = torch.empty((-(-counts // SCAN_TILE),), **i32)
    sq = torch.empty((n1 + n2,), dtype=torch.float32, device=dev)
    flag = torch.empty((1,), **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, _ENTRY[As_rows.dtype])(
        As_rows.data_ptr(), Bs_rows.data_ptr(), norm_A.data_ptr(),
        norm_B.data_ptr(), rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
        m, k, n1, n2, cblock, keys.data_ptr(), vals.data_ptr(),
        hist.data_ptr(), offs.data_ptr(), tsum.data_ptr(), sq.data_ptr(),
        flag.data_ptr(), stream)
    if err:
        raise RuntimeError(f"sampled_rescaled_dot: kernel launch failed with "
                           f"CUDA error {err}")
    return out, flag


__all__ = ["plain", "bind", "launch", "column_block", "buckets", "SOURCE",
           "REPLACES", "SAMPLES_PER_CTA", "GATHER_THREADS", "SCAN_TILE",
           "BINS", "SORT_TILE", "L2_BLOCK_BYTES"]
