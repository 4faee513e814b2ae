"""Flash attention, forward: softmax attention with the online softmax.

Hopper counterpart of the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention`` (``src/repro/kernels/
flash_attention.py``) and of the head expansion in its wrapper: CUDA C++
for ``sm_90a`` in ``csrc/flash_attention.cu``. q (B, S, H, Dh) and k, v
(B, S, Hkv, Dh), float32 or bf16; query head h reads KV head
``h // (H // Hkv)``; the scale 1/sqrt(Dh) goes on q before the product;
causal keys past the query are masked to -1e30; float32 running max,
denominator and accumulator; the output (B, S, H, Dh) in the input dtype.

Bound on an H100: operations. Causal attention does ``2 S^2 Dh`` FLOP per
head: 8.80e12 for granite-3-8b's 32 heads of 128 at S = 32,768. On the
TF32 tensor cores a float32-accurate product takes three split passes
(``PASSES``): 26.4e12 FLOP, 53.3 ms at 495 TFLOP/s; the float32 FMA units
alone would take 131 ms. bf16 inputs are bound by the bf16 tensor cores,
8.9 ms at 989 TFLOP/s; this design's two TF32 passes take 35.6 ms there.
The bytes take 0.4 ms in float32.

Design (see the source for more): the TPU kernel carries its running
softmax state across a sequential grid axis of k-blocks; here one CTA owns
one (bq, Dh) query tile of one (b, h) and loops over k-tiles of bk keys,
with the state in registers. Both products are ``mma.sync`` m16n8k8 TF32
MMAs, 16 query rows a warp: float32 operands split into a TF32 big and
small part (small*big, big*small, big*big), bf16 k and v exact in TF32 (two
passes). P stays in registers: the PV MMA takes each k8 step's keys in the
order of the score fragment. Each k-tile's PV products go into a fresh
fragment added to O with an ordinary FFMA, since the tensor cores truncate
inside an MMA. K and V tiles come through a ring of two ``cp.async``
stages. It reads q, k and v in place through their strides, so GQA costs
no repeated copy, and under ``causal`` stops at the diagonal tile, which is
exact.

``plain`` is the PyTorch version of the same function; ``kernels/ops.py``
chooses between the two and counts launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.roofline.analysis import REGISTERS_PER_SM

SOURCE = "flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:78"

#: The tiles ``csrc/flash_attention.cu`` compiles (its ``run`` and
#: ``launch_*`` switches).
BLOCK_Q = (64, 128)
BLOCK_K = (32, 64)
HEAD_DIMS = (32, 64, 96, 112, 128)
#: K/V tiles in the ``cp.async`` ring.
STAGES = 2
#: TF32 tensor-core passes per product, by input itemsize: float32 three
#: (small*big, big*small, big*big), bf16 two (k and v are exact in TF32).
PASSES = {4: 3, 2: 2}
#: Registers a thread holds, by head width: the most that ptxas gave any
#: instance of that width (``__launch_bounds__(THREADS, 1)`` allows 255;
#: ``chip_smoke.py``'s build phase prints each instance's count and holds
#: it to this table).
REGISTERS = {32: 166, 64: 255, 96: 255, 112: 255, 128: 255}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def smem_bytes(bq: int, bk: int, dh: int, dtype_bytes: int = 4) -> int:
    """Dynamic shared memory of one CTA for inputs of ``dtype_bytes``, as
    ``Tile`` in the source lays it out: the scaled float32 Q tile at a
    pitch of Dh + 8, and ``STAGES`` K/V tiles in the input dtype, K rows at
    Dh + 8 elements, V rows at Dh + 16 bytes."""
    ldk, ldv = dh + 8, dh + 16 // dtype_bytes
    return 4 * bq * (dh + 8) + STAGES * bk * (ldk + ldv) * dtype_bytes


def threads(bq: int) -> int:
    """Threads per CTA: one warp for each 16 query rows."""
    return 2 * bq


def ctas_per_sm(bq: int, dh: int) -> int:
    """CTAs of ``bq`` query rows that an SM's register file holds at head
    width ``dh``: a warp's registers are allocated 256 at a time, so a
    thread's count rounds up to a multiple of 8."""
    return REGISTERS_PER_SM // (threads(bq) * -(-REGISTERS[dh] // 8) * 8)


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


@torch.library.custom_op("repro_torch::flash_attention_trace",
                         mutates_args=())
def trace(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool) -> torch.Tensor:
    """The kernel's output, shape and dtype only, for a trace on ``meta``
    tensors (the dry run): it computes nothing, and
    ``roofline.trace_analyzer`` counts the kernel's work from its
    operands."""
    if q.device.type != "meta":
        raise ValueError("flash_attention trace: meta tensors only")
    return torch.empty_like(q)


@trace.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


def trace_cost(q, k, v, causal: bool):
    """(FLOPs, bytes) of one launch: the two products, ``2 S^2 Dh`` a head
    each (half of that under ``causal``, where the kernel stops at the
    diagonal tile), and q, k, v read and the output written once."""
    B, S, H, Dh = q.shape
    flops = 4.0 * B * H * S * k.shape[1] * Dh * (0.5 if causal else 1.0)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    return flops, nbytes


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
           "ctas_per_sm", "BLOCK_Q", "BLOCK_K", "HEAD_DIMS", "STAGES",
           "PASSES", "REGISTERS", "SOURCE", "REPLACES"]
