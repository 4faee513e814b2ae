"""Flash attention, forward: softmax attention with the online softmax.

Hopper counterpart of the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention`` (``src/repro/kernels/
flash_attention.py``) and of the head expansion in its wrapper: CUDA C++
for ``sm_90a`` in ``csrc/flash_attention.cu``. q (B, S, H, Dh) and k, v
(B, S, Hkv, Dh), float32 or bf16; query head h reads KV head
``h // (H // Hkv)``; the scale 1/sqrt(Dh) goes on q before the product;
causal keys past the query are masked to -1e30; float32 running max,
denominator and accumulator; the output (B, S, H, Dh) in the input dtype.

Bound on an H100: operations. Causal attention does ``2 S^2 Dh`` float32
FLOP per head on the FMA units (67 TFLOP/s): 131 ms for granite-3-8b's 32
heads of 128 at S = 32,768, against 0.4 ms for its bytes.

Design (see the source for more): the TPU kernel carries its running
softmax state across a sequential grid axis of k-blocks; here one CTA owns
one (bq, Dh) query tile of one (b, h), loops over k-tiles of bk keys staged
in shared memory and keeps the state in registers, register-tiled float32
FMAs with no tensor cores. It reads q, k and v in place through their
strides, so GQA costs no repeated copy, and under ``causal`` stops at the
diagonal tile, which is exact.

``plain`` is the PyTorch version of the same function; ``kernels/ops.py``
chooses between the two and counts launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.ref import flash_attention_ref

SOURCE = "flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:78"

#: The tiles ``csrc/flash_attention.cu`` compiles (its ``run`` and
#: ``launch_*`` switches).
BLOCK_Q = (64, 128)
BLOCK_K = (32, 64, 128)
HEAD_DIMS = (32, 64, 128)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def smem_bytes(bq: int, bk: int, dh: int) -> int:
    """Dynamic shared memory of one CTA, as ``Tile`` in the source lays it
    out: the scaled Q tile and the K tile at a pitch of Dh + 4 floats, P
    (bq, bk + 16) in the K tile's space, and the V tile."""
    ldq, ldp = dh + 4, bk + 16
    return 4 * (bq * ldq + max(bk * ldq, bq * ldp) + bk * dh)


def threads(bq: int) -> int:
    """Threads per CTA: 16 for each 8 query rows."""
    return 2 * bq


def check_tile(bq: int, bk: int, dh: int) -> None:
    """ValueError unless the source compiles this (bq, bk) for head width
    dh."""
    if bq not in BLOCK_Q or bk not in BLOCK_K or dh not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: no kernel compiled for bq={bq}, bk={bk}, "
            f"Dh={dh} (compiled: bq in {BLOCK_Q}, bk in {BLOCK_K}, Dh in "
            f"{HEAD_DIMS})")


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool = True) -> torch.Tensor:
    """The plain version on the kernel's layout: repeat the KV heads for
    GQA, fold (B, H), ``ref.flash_attention_ref``, unfold."""
    B, S, H, Dh = q.shape
    rep = H // k.shape[2]
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, Dh)
    out = flash_attention_ref(fold(q), fold(k.repeat_interleave(rep, dim=2)),
                              fold(v.repeat_interleave(rep, dim=2)),
                              causal=causal)
    return out.reshape(B, H, S, Dh).transpose(1, 2)


def bind(lib: ctypes.CDLL) -> None:
    """Declare the argument and result types of the library's entry points."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P,
                       ctypes.c_float, _I64, _I64, _I64, _P]
        fn.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, causal: bool, bq: int, bk: int) -> torch.Tensor:
    """Run the kernel on CUDA tensors of one dtype (float32 or bfloat16):
    q (B, S, H, Dh), k and v (B, S, Hkv, Dh), unit stride along Dh, every
    other stride a multiple of 4 elements and every pointer 16-byte aligned;
    H % Hkv == 0, S divisible by bq and bk, and the tile compiled. Returns o
    (B, S, H, Dh), contiguous, in q's dtype, on the current stream without
    synchronising."""
    B, S, H, Dh = q.shape
    o = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
        k.shape[2], Dh, ctypes.cast(strides, ctypes.c_void_p),
        1.0 / math.sqrt(Dh), int(causal), bq, bk, stream)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    return o


__all__ = ["plain", "bind", "launch", "check_tile", "smem_bytes", "threads",
           "BLOCK_Q", "BLOCK_K", "HEAD_DIMS", "SOURCE", "REPLACES"]
