"""Blocked fast Walsh-Hadamard transform: the SRHT sketch's ``H D X``.

Hopper counterpart of the Pallas TPU kernel
``repro.kernels.hadamard.blocked_fwht`` (``src/repro/kernels/hadamard.py``):
CUDA C++ for ``sm_90a`` in ``csrc/blocked_fwht.cu``, with two entry points.

* Full mode (``launch``): the TPU kernel's function, the unnormalized
  ``H_dp (signs * X)`` in float32 from float32 or bf16 input, H the
  Sylvester Hadamard matrix. Bound on an H100: bytes, one read of X and one
  write of the (dp, n) float32 output; the butterfly's ``dp log2(dp) n``
  adds take about a tenth of that time at 67 TFLOP/s.
* SRHT block mode (``launch_block``): what the SRHT pass keeps of one
  column block, the k sampled rows ``H (signs * X)[rows] / sqrt(dp) *
  sqrt(dp / k)`` written straight into the (k, n) sketch at a column
  offset, and X's column norms. Bound: bytes, X and signs read once, k rows
  and n norms written once (0.494 ms at d = 50,000, 8,192 columns, k =
  512).

Design (see the source for more): the TPU kernel's dense products against
Hadamard tiles would cost ``2 d (a + b) n`` FMAs on SIMT cores; here the
transform is a butterfly in passes of radix at most 256 (two passes at dp
= 65,536), each CTA transforming 32 columns of one group of rows in
registers with one exchange through shared memory. The first pass fuses
the sign flip and reads rows past d as zero, so a caller transforms a column
slice of an unpadded matrix without a padded copy; later passes run in
place. Every element is written once per pass, with no atomics, and the
butterfly spans run in the plain version's order, so the two agree bit for
bit. The block mode's last pass stores only the sampled rows, rescaled with
the plain composition's two float32 roundings (bit for bit again), and
skips a group that holds none; its first pass adds the squares of X into
per-CTA partials (float32 within a thread, float64 beyond), reduced in a
fixed order (deterministic). Its intermediate goes through a (dp, n)
scratch buffer. Every pass skips the blocks of rows that are zero (rows
past d, and what earlier passes made of them alone).

``plain`` and ``plain_block`` are the PyTorch versions of the two
functions; ``kernels/ops.py`` chooses between kernel and plain version and
counts launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.ref import blocked_fwht_ref as plain
from repro_torch.kernels.ref import srht_block_ref as plain_block

SOURCE = "blocked_fwht.cu"
REPLACES = "src/repro/kernels/hadamard.py:59"

#: The one tile ``csrc/blocked_fwht.cu`` compiles, as the tuner names it:
#: (b, bn) = (the largest radix of a pass, 2**MAX_LOG_RADIX, and the COLS
#: columns a CTA transforms). A CTA of radix L holds a (L, 32) float32
#: exchange tile in shared memory.
TILE = (256, 32)

#: The largest radix of a pass, as ``csrc/blocked_fwht.cu`` splits dp.
MAX_LOG_RADIX = 8

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_ENTRY = {torch.float32: "blocked_fwht_f32", torch.bfloat16: "blocked_fwht_bf16"}
_BLOCK_ENTRY = {torch.float32: "srht_block_f32",
                torch.bfloat16: "srht_block_bf16"}


def radices(d_pad: int) -> list:
    """log2 of each pass's radix, as the source's ``split`` cuts a length
    d_pad transform: as evenly as passes of at most 2**MAX_LOG_RADIX allow,
    larger radices first."""
    log_dp = d_pad.bit_length() - 1
    passes = max(1, -(-log_dp // MAX_LOG_RADIX))
    out, done = [], 0
    for p in range(passes):
        left = passes - p
        out.append((log_dp - done + left - 1) // left)
        done += out[-1]
    return out


def hadamard_matrix(n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sylvester Hadamard matrix H_n (n a power of two), unnormalized."""
    if n < 1 or n & (n - 1):
        raise ValueError(
            f"Hadamard matrix size must be a power of two, got n={n}")
    H = np.array([[1.0]], dtype=np.float32)
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return torch.from_numpy(H).to(dtype)


def bind(lib: ctypes.CDLL) -> None:
    """Declare the argument and result types of the library's entry points."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _I64, _P, _I64, _I64, _P, _I64, _P]
        fn.restype = ctypes.c_int
    for name in _BLOCK_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _I64, _P, _I64, _I64, _P, _I64, _F32, _F32, _P,
                       _I64, _P, _I64, _P, _P, _P]
        fn.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, X: torch.Tensor, signs: torch.Tensor,
           d_pad: int) -> torch.Tensor:
    """Run the kernel on CUDA tensors: X (d, n) float32 or bfloat16 with
    unit column stride (any row stride), signs (d,) float32 contiguous, d
    and n positive, d_pad a power of two >= d. Returns H (signs * X) as
    (d_pad, n) float32 on the current stream without synchronising."""
    d, n = X.shape
    out = torch.empty((d_pad, n), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = getattr(lib, _ENTRY[X.dtype])(
        X.data_ptr(), X.stride(0), signs.data_ptr(), d,
        d_pad.bit_length() - 1, out.data_ptr(), n, stream)
    if err:
        raise RuntimeError(f"blocked_fwht: kernel launch failed with CUDA "
                           f"error {err}")
    return out


def launch_block(lib: ctypes.CDLL, X: torch.Tensor, signs: torch.Tensor,
                 rows: torch.Tensor, d_pad: int, root_dp: float,
                 root_dp_k: float, sketch: torch.Tensor,
                 norms: torch.Tensor) -> None:
    """Run the block mode on CUDA tensors: X (d, n) as for ``launch``,
    signs (d,) float32 and rows (k,) int32 contiguous, each row in [0,
    d_pad); sketch a (k, n) float32 view with unit column stride, norms (n,)
    float32 contiguous. Writes ``(H (signs * X))[rows] / root_dp *
    root_dp_k`` into sketch and X's column norms into norms on the current
    stream, without synchronising; the scratch buffers come from PyTorch's
    allocator."""
    d, n = X.shape
    k = rows.shape[0]
    logs = radices(d_pad)
    scratch = (torch.empty((d_pad, n), dtype=torch.float32, device=X.device)
               if len(logs) > 1 else None)
    partial = torch.empty((d_pad >> logs[0], n), dtype=torch.float64,
                          device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = getattr(lib, _BLOCK_ENTRY[X.dtype])(
        X.data_ptr(), X.stride(0), signs.data_ptr(), d,
        d_pad.bit_length() - 1, rows.data_ptr(), k, root_dp, root_dp_k,
        sketch.data_ptr(), sketch.stride(0), norms.data_ptr(), n,
        None if scratch is None else scratch.data_ptr(), partial.data_ptr(),
        stream)
    if err:
        raise RuntimeError(f"srht_block: kernel launch failed with CUDA "
                           f"error {err}")


__all__ = ["plain", "plain_block", "bind", "launch", "launch_block",
           "radices", "hadamard_matrix", "SOURCE", "REPLACES", "TILE",
           "MAX_LOG_RADIX"]
