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
8.9 ms at 989 TFLOP/s; the bf16 ``wgmma`` design's one pass on QK^T and
two on PV take 13.3 ms there. The bytes take 0.4 ms in float32.

Design (see the source for more): the TPU kernel carries its running
softmax state across a sequential grid axis of k-blocks; here one CTA owns
one (bq, Dh) query tile of one (b, h) and loops over k-tiles of bk keys,
with the state in registers. On TF32, float32 operands are split into a
big and a small part (small*big, big*small, big*big), and bf16 k and v are
exact (two passes). P stays in registers: the PV product takes each k
step's keys from the score fragment as it lies. Each k-tile's PV products
go into a fresh accumulator added to O with an ordinary FFMA, since the
tensor cores truncate inside a product. It reads q, k and v in place
through their strides, so GQA costs no repeated copy, and under ``causal``
stops at the diagonal tile, which is exact.

Two designs. Dh 64, 96 and 128 (``WGMMA_DH``, ``on_wgmma``: every Dh 128
LM prefill, phi3-mini-3.8b's at Dh 96, whisper-small's at Dh 64, and the
widths that pad to them), float32 and bf16, run Hopper's ``wgmma`` fed by
TMA, one (128, bk) tile a dtype and width (``WGMMA_FORMS``): a producer
warpgroup and two consumer warpgroups of 64 query rows. float32 runs
m64nNk8 TF32 in three passes a product: the producer's first thread
issues the loads of K's tile and of V^T's into a ring of stages, three
warps split each landed tile once a CTA into one of its sets of small
parts; TF32 ``wgmma`` reads B from shared memory K-major only, so a
prologue in the same launch writes V^T (B, Hkv, Dh, S), each group of 8
keys in the P fragment's order, into scratch that ``launch`` allocates.
bf16 runs m64nNk16 bf16: QK^T in one pass with Q's tile loaded once by
TMA, PV in two on P's bf16 parts (hi = bf16(p), lo = bf16(p - hi)), V's
row-major tile read MN-major as it lands: one launch, no scratch. Every
other instance (float32 and bf16 at Dh 16, 32, 112 and 256) runs
``mma.sync`` m16n8k8 TF32, 16 query rows a warp, K and V tiles through a
ring of two ``cp.async`` stages.

Head widths: instances are compiled at ``HEAD_DIMS`` (16 to 256); any
width 1 <= Dh <= ``MAX_HEAD_DIM`` runs on the instance of
``tile_width(Dh)``, the smallest compiled width at least Dh, on a copy of
q, k and v that ``kernels/ops.py`` zero-pads to that width, with the scale
of the true Dh and the output sliced back. Dh 256 splits each 16
query rows over a pair of warps, one for each half of d and of O, which
add their partial scores through shared memory; it compiles the tile
(64, 32) only (``tiles``).

Sequence lengths: an S the tile divides runs as it is. An S below
``SHORT_S``, which the reference runs as one block of S rows, runs on a
copy zero-padded along S (``seq_padding``) with ``kv_len`` = S: every
design stops its key loop at the tile holding key S - 1 and masks the keys
from S on to -1e30 on that tile, as the causal mask does (the ``wgmma``
designs in a masked twin of each instance, so that the full-length ones
keep their code).

``plain`` is the PyTorch version of the same function; ``kernels/ops.py``
chooses between the two and counts launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.roofline.analysis import REGISTERS_PER_SM

SOURCE = "flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:78"

#: The tiles ``csrc/flash_attention.cu`` compiles (its ``run`` and
#: ``launch_*`` switches): every (bq, bk) at the widths up to 128, and
#: ``WIDE_TILES`` at 256 (``tiles``).
BLOCK_Q = (64, 128)
BLOCK_K = (32, 64)
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)
#: Below this S the reference runs one block of S rows (its default block,
#: (128, 128), clamped to S), and the card a copy zero-padded along S.
SHORT_S = 128
#: The widest head the kernel takes; ``tile_width`` maps a width to the
#: smallest compiled one at least as wide.
MAX_HEAD_DIM = 256
#: The tiles of the Dh 256 instance (``WIDE_BQ``, ``WIDE_BK``): (64, 64)
#: and bq 128 exceed shared memory or the registers (the source's header).
WIDE_TILES = ((64, 32),)
#: Above this width two warps share each 16 query rows (``Tile::SPLIT``).
SPLIT_ABOVE = 128
#: K/V tiles in the ``cp.async`` ring.
STAGES = 2
#: Tensor-core passes of each product, (QK^T, PV, the type they run in),
#: by design (``design``) and input itemsize. ``mma.sync``: float32
#: operands split into TF32 big and small parts (small*big, big*small,
#: big*big), bf16 two (k and v are exact in TF32). float32 ``wgmma``: the
#: same three TF32 passes. bf16 ``wgmma``: QK^T in one bf16 pass (products
#: of bf16 values are exact in float32), PV in two, one on each of P's
#: bf16 parts.
PASSES = {("mma.sync", 4): (3, 3, "tf32"), ("mma.sync", 2): (2, 2, "tf32"),
          ("wgmma", 4): (3, 3, "tf32"), ("wgmma", 2): (1, 2, "bf16")}
#: Registers a thread holds, by head width: the most that ptxas gave any
#: ``mma.sync`` instance of that width (``__launch_bounds__(THREADS, 1)``
#: allows 255; ``chip_smoke.py``'s build phase prints each instance's count
#: and holds it to this table). Dh 64, 96 and 128 have none: ``wgmma``.
REGISTERS = {16: 128, 32: 166, 112: 255, 256: 255}


class WForm(NamedTuple):
    """A ``wgmma`` instance's form (``WForm`` and ``BForm`` in the
    source): the keys of its k-tile, the stages of its TMA ring, its sets
    of small parts (float32; bf16 has none) and the bytes of a row of the
    swizzle its tiles lie in."""
    bk: int
    stages: int
    sets: int
    swizzle: int


#: The ``wgmma`` instances by (input itemsize, Dh), each one's form; their
#: query tile (``WGMMA_BQ``), threads (a producer and two consumer
#: warpgroups) and the registers a thread has at launch
#: (``__launch_bounds__(384, 1)``: 65,536 / 384 rounded down to 8), which
#: ``setmaxnreg`` then moves from the producer to the consumers (float32
#: 56 and 224, bf16 40 and 232). bf16 at Dh 96 lies in the 64-byte swizzle,
#: three chunks of 32 columns a row.
WGMMA_FORMS = {(4, 64): WForm(32, 3, 1, 128), (4, 96): WForm(32, 2, 2, 128),
               (4, 128): WForm(32, 2, 1, 128),
               (2, 64): WForm(128, 4, 0, 128), (2, 96): WForm(128, 3, 0, 64),
               (2, 128): WForm(128, 3, 0, 128)}
WGMMA_DH = (64, 96, 128)
WGMMA_BQ = 128
WGMMA_THREADS = 384
WGMMA_REGISTERS = 168

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_WGMMA_ENTRY = {torch.float32: "flash_attention_f32_wgmma",
                torch.bfloat16: "flash_attention_bf16_wgmma"}
#: The order of each group of 8 keys in V^T: slot p holds key ``VT_ORDER[p]``
#: (2p, then 2p + 1), the order in which the score accumulator's registers
#: feed the PV product's A fragment (slots t and t + 4 of a k8 step are
#: keys 2t and 2t + 1).
VT_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tile_width(dh: int) -> int:
    """The compiled head width whose instance runs width ``dh``: the
    smallest in ``HEAD_DIMS`` at least ``dh``. ValueError outside 1 to
    ``MAX_HEAD_DIM``."""
    for width in HEAD_DIMS:
        if 1 <= dh <= width:
            return width
    raise ValueError(f"flash_attention: no kernel compiled for Dh={dh} "
                     f"(compiled: 1 <= Dh <= {MAX_HEAD_DIM})")


def on_wgmma(dh: int, dtype_bytes: int = 4) -> bool:
    """Whether width ``dh`` with inputs of ``dtype_bytes`` (float32 or
    bf16) runs a ``wgmma`` instance: its compiled width is in
    ``WGMMA_DH``."""
    return 1 <= dh <= MAX_HEAD_DIM and \
        (dtype_bytes, tile_width(dh)) in WGMMA_FORMS


def design(dh: int, dtype_bytes: int = 4) -> str:
    """The design that runs width ``dh``: "wgmma" or "mma.sync"."""
    return "wgmma" if on_wgmma(dh, dtype_bytes) else "mma.sync"


def wgmma_form(dh: int, dtype_bytes: int = 4) -> WForm:
    """The form of the ``wgmma`` instance that runs width ``dh``."""
    return WGMMA_FORMS[dtype_bytes, tile_width(dh)]


def tiles(dh: int, dtype_bytes: int = 4) -> tuple:
    """The (bq, bk) tiles compiled at the width that runs ``dh`` for
    inputs of ``dtype_bytes``; none outside 1 to ``MAX_HEAD_DIM``."""
    if not 1 <= dh <= MAX_HEAD_DIM:
        return ()
    if on_wgmma(dh, dtype_bytes):
        return ((WGMMA_BQ, wgmma_form(dh, dtype_bytes).bk),)
    if split(dh) > 1:
        return WIDE_TILES
    return tuple((bq, bk) for bq in BLOCK_Q for bk in BLOCK_K)


def split(dh: int) -> int:
    """Warps that share each 16 query rows at width ``dh``."""
    return 2 if tile_width(dh) > SPLIT_ABOVE else 1


def smem_bytes(bq: int, bk: int, dh: int, dtype_bytes: int = 4) -> int:
    """Dynamic shared memory of one CTA for inputs of ``dtype_bytes``, as
    the source lays it out at the compiled width D that runs ``dh``. The
    ``mma.sync`` instances (``Tile``): the scaled float32 Q tile at a
    pitch of D + 8, ``STAGES`` K/V tiles in the input dtype, K rows at
    D + 8 elements, V rows at D + 16 bytes, and at D 256 the warp pairs'
    exchange, a 16 x bk float32 fragment a warp. The float32 ``wgmma``
    instances (``WTile::SMEM``): 1,024 bytes to align the swizzle, Q's big
    and small parts, and by its form its stages of raw K and V^T tiles,
    its sets of K and V^T small parts and their ``mbarrier``s, two a stage
    and three a set. The bf16 ones (``BTile::SMEM``): 1,024 bytes, Q's
    tile, its stages of K and V tiles and two ``mbarrier``s a stage and
    Q's one."""
    d = tile_width(dh)
    if on_wgmma(dh, dtype_bytes):
        form = wgmma_form(dh, dtype_bytes)
        if dtype_bytes == 2:
            return 1024 + 2 * bq * d + form.stages * 2 * 2 * bk * d + \
                8 * (2 * form.stages + 1)
        return 1024 + 2 * 4 * bq * d + (form.stages + form.sets) * 2 * 4 * \
            bk * d + 8 * (2 * form.stages + 3 * form.sets)
    ldk, ldv = d + 8, d + 16 // dtype_bytes
    xch = 4 * (threads(bq, dh) // 32) * 16 * bk if split(dh) > 1 else 0
    return 4 * bq * (d + 8) + STAGES * bk * (ldk + ldv) * dtype_bytes + xch


def threads(bq: int, dh: int, dtype_bytes: int = 4) -> int:
    """Threads per CTA: one warp for each 16 query rows, two at the widths
    above ``SPLIT_ABOVE``; ``WGMMA_THREADS`` on the ``wgmma`` instance."""
    if on_wgmma(dh, dtype_bytes):
        return WGMMA_THREADS
    return 2 * bq * split(dh)


def ctas_per_sm(bq: int, dh: int, dtype_bytes: int = 4) -> int:
    """CTAs of ``bq`` query rows that an SM's register file holds at head
    width ``dh``: a warp's registers are allocated 256 at a time, so a
    thread's count rounds up to a multiple of 8."""
    regs = WGMMA_REGISTERS if on_wgmma(dh, dtype_bytes) else \
        REGISTERS[tile_width(dh)]
    regs = -(-regs // 8) * 8
    return REGISTERS_PER_SM // (threads(bq, dh, dtype_bytes) * regs)


def check_tile(bq: int, bk: int, dh: int, dtype_bytes: int = 4) -> None:
    """ValueError unless the source compiles this (bq, bk) at the width
    that runs head width dh (any 1 <= dh <= ``MAX_HEAD_DIM``) for inputs
    of ``dtype_bytes``."""
    if (bq, bk) not in tiles(dh, dtype_bytes):
        raise ValueError(
            f"flash_attention: no kernel compiled for bq={bq}, bk={bk}, "
            f"Dh={dh}, {8 * dtype_bytes}-bit inputs (compiled: 1 <= Dh <= "
            f"{MAX_HEAD_DIM}; at this width and dtype (bq, bk) in "
            f"{tiles(dh, dtype_bytes)})")


def seq_padding(S: int, block: tuple) -> int:
    """Zero rows the card's path adds along S to a call at S with the
    tile ``block`` (bq, bk): up to the next multiple of its larger block
    where S is below ``SHORT_S`` (128 on a ``wgmma`` instance, 64 or 128 on
    an ``mma.sync`` one), none from there on, where the tile divides S."""
    return -S % max(block) if S < SHORT_S else 0


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool = True, kv_len: int | None = None) -> torch.Tensor:
    """The plain version on the kernel's layout: repeat the KV heads for
    GQA, fold (B, H), ``ref.flash_attention_ref`` (keys from ``kv_len`` on,
    default S, take no weight), unfold."""
    B, S, H, Dh = q.shape
    rep = H // k.shape[2]
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, Dh)
    out = flash_attention_ref(fold(q), fold(k.repeat_interleave(rep, dim=2)),
                              fold(v.repeat_interleave(rep, dim=2)),
                              causal=causal, kv_len=kv_len)
    return out.reshape(B, H, S, Dh).transpose(1, 2)


#: The largest share of a bf16 ``wgmma`` output's entries that may differ
#: from the plain version's bf16 output on the same inputs. The design's
#: float32 sums, rounded once, differ on about 0.25% (the CPU emulation in
#: tests/test_torch_flash_attention.py; tools/flash_attention_probe.py on
#: an H100); P rounded once to bf16 differs on about 40%.
BF16_DIFFER_MAX = 0.01


def bf16_agreement(out: torch.Tensor, ref: torch.Tensor,
                   tol: float) -> tuple:
    """How a bf16 output ``out`` agrees with ``ref``, the plain version's
    output on the same bf16 inputs (its float32 result rounded once):
    (the share of entries that differ, the largest of |out - ref| - ulp -
    tol - tol |ref|, ulp the bf16 spacing at the larger of |out| and
    |ref|). The second is at most 0 wherever ``out`` is a float32 value
    within ``tol + tol |ref|`` of the plain version's, rounded once to
    bf16."""
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    big = torch.maximum(o.abs(), r.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return (float((diff > 0).float().mean()),
            float((diff - ulp - tol - tol * r.abs()).max()))


def vt_plain(v: torch.Tensor) -> torch.Tensor:
    """The prologue's function in PyTorch: v (B, S, Hkv, Dh) as V^T
    (B, Hkv, Dh, S), contiguous, each group of 8 keys in ``VT_ORDER``."""
    B, S, Hkv, Dh = v.shape
    order = torch.tensor(VT_ORDER, device=v.device)
    keys = (torch.arange(0, S, 8, device=v.device)[:, None]
            + order).reshape(-1)
    return v[:, keys].permute(0, 2, 3, 1).contiguous()


def vt_launch(lib: ctypes.CDLL, v: torch.Tensor) -> torch.Tensor:
    """The prologue alone on a CUDA float32 v (B, S, Hkv, Dh), Dh in
    ``WGMMA_DH``, S a multiple of 64, strides multiples of 4 elements: V^T
    as ``vt_plain`` gives it, on the current stream without
    synchronising."""
    B, S, Hkv, Dh = v.shape
    vt = torch.empty((B, Hkv, Dh, S), dtype=torch.float32, device=v.device)
    strides = (ctypes.c_int64 * 3)(*v.stride()[:3])
    err = lib.flash_attention_vt(
        v.data_ptr(), vt.data_ptr(), B, S, Hkv, Dh,
        ctypes.cast(strides, ctypes.c_void_p),
        torch.cuda.current_stream(v.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention prologue: launch failed with "
                           f"CUDA error {err}")
    return vt


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
    # B, S, kv_len, H, Hkv, Dh, strides, scale, causal, bq, bk, stream
    rest = [_I64, _I64, _I64, _I64, _I64, _I64, _P, ctypes.c_float, _I64,
            _I64, _I64, _P]
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, *rest]
        fn.restype = ctypes.c_int
    fn = getattr(lib, _WGMMA_ENTRY[torch.float32])
    fn.argtypes = [_P, _P, _P, _P, _P, *rest]      # q, k, v, vt, o, ...
    fn.restype = ctypes.c_int
    fn = getattr(lib, _WGMMA_ENTRY[torch.bfloat16])
    fn.argtypes = [_P, _P, _P, _P, *rest]          # q, k, v, o, ...
    fn.restype = ctypes.c_int
    lib.flash_attention_vt.argtypes = [_P, _P, _I64, _I64, _I64, _I64, _P,
                                       _P]
    lib.flash_attention_vt.restype = ctypes.c_int


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, causal: bool, bq: int, bk: int,
           scale_dh: int | None = None,
           kv_len: int | None = None) -> torch.Tensor:
    """Run the kernel on CUDA tensors of one dtype (float32 or bfloat16):
    q (B, S, H, Dh), k and v (B, S, Hkv, Dh), Dh in ``HEAD_DIMS``, unit
    stride along Dh, every other stride a multiple of 16 bytes and every
    pointer 16-byte aligned; H % Hkv == 0, S divisible by bq and bk, and
    the tile compiled at Dh. The scale is 1/sqrt(``scale_dh``), the width
    before any zero padding (default Dh); every query sees keys 0 to
    ``kv_len`` - 1 (1 <= kv_len <= S, default S), the rest masked. Returns
    o (B, S, H, Dh), contiguous, in q's dtype, on the current stream
    without synchronising.
    On a float32 ``wgmma`` instance it also allocates the prologue's V^T
    scratch, (B, Hkv, Dh, S) float32: the prologue and the kernel are one
    call here. A bf16 ``wgmma`` instance is one launch and takes no
    scratch."""
    B, S, H, Dh = q.shape
    o = torch.empty((B, S, H, Dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (B, S, S if kv_len is None else kv_len, H, k.shape[2], Dh,
            ctypes.cast(strides, ctypes.c_void_p),
            1.0 / math.sqrt(scale_dh or Dh), int(causal), bq, bk, stream)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    entry = _ENTRY[q.dtype]
    if on_wgmma(Dh, q.element_size()):
        entry = _WGMMA_ENTRY[q.dtype]
        if q.dtype == torch.float32:
            vt = torch.empty((B, k.shape[2], Dh, S), dtype=torch.float32,
                             device=q.device)
            ptrs.append(vt.data_ptr())
    err = getattr(lib, entry)(*ptrs, o.data_ptr(), *tail)
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    return o


__all__ = ["plain", "seq_padding", "bf16_agreement", "vt_plain", "vt_launch",
           "bind", "launch", "check_tile", "tile_width", "tiles", "on_wgmma",
           "design", "wgmma_form", "split", "smem_bytes", "threads",
           "ctas_per_sm", "BLOCK_Q", "BLOCK_K", "HEAD_DIMS", "SHORT_S",
           "MAX_HEAD_DIM", "WIDE_TILES", "SPLIT_ABOVE", "STAGES", "PASSES",
           "REGISTERS", "WForm", "WGMMA_FORMS", "WGMMA_DH", "WGMMA_BQ",
           "WGMMA_THREADS", "WGMMA_REGISTERS", "BF16_DIFFER_MAX", "VT_ORDER",
           "SOURCE", "REPLACES"]
