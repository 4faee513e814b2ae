"""Blocked fast Walsh-Hadamard transform: the SRHT sketch's ``H D X``.

Hopper counterpart of the Pallas TPU kernel
``repro.kernels.hadamard.blocked_fwht`` (``src/repro/kernels/hadamard.py``):
CUDA C++ for ``sm_90a`` in ``csrc/blocked_fwht.cu``. It computes the
unnormalized ``H_dp (signs * X)`` in float32 from float32 or bf16 input,
H the Sylvester Hadamard matrix.

Bound on an H100: bytes. One read of X and one write of the (dp, n) float32
output; the butterfly's ``dp log2(dp) n`` adds take about a tenth of that
time at 67 TFLOP/s.

Design (see the source for more): the TPU kernel's dense products against
Hadamard tiles would cost ``2 d (a + b) n`` FMAs on SIMT cores; here the
transform is a butterfly in passes of radix at most 256 (two passes at dp
= 65,536), each CTA transforming 32 columns of one group of rows in
registers with one exchange through shared memory. The first pass fuses
the sign flip and reads rows past d as zero, so a caller transforms a column
slice of an unpadded matrix without a padded copy; later passes run in
place. Every element is written once per pass, with no atomics, and the
butterfly spans run in the plain version's order, so the two agree bit for
bit.

``plain`` is the PyTorch version of the same function; ``kernels/ops.py``
chooses between the two and counts launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.ref import blocked_fwht_ref as plain

SOURCE = "blocked_fwht.cu"
REPLACES = "src/repro/kernels/hadamard.py:59"

#: The one tile ``csrc/blocked_fwht.cu`` compiles, as the tuner names it:
#: (b, bn) = (the largest radix of a pass, 2**MAX_LOG_RADIX, and the COLS
#: columns a CTA transforms). A CTA of radix L holds a (L, 32) float32
#: exchange tile in shared memory.
TILE = (256, 32)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ENTRY = {torch.float32: "blocked_fwht_f32", torch.bfloat16: "blocked_fwht_bf16"}


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


__all__ = ["plain", "bind", "launch", "hadamard_matrix", "SOURCE", "REPLACES",
           "TILE"]
