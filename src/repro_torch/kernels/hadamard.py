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
  512). ``block_plan`` picks one of its two forms from the shape alone.

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
fixed order (deterministic). Every pass skips the blocks of rows that are
zero (rows past d, and what earlier passes made of them alone).

The block mode has two forms. The cluster form, where dp takes two passes
(512 <= dp <= 65,536) and a strip's live intermediate fits on chip, is one
launch and keeps the intermediate off device memory: a thread block cluster
of CLUSTER_CTAS CTAs owns CLUSTER_COLS columns, and a persistent grid of as
many clusters as the card holds walks the strips. Each CTA streams its
pass-1 blocks of X by TMA, does pass 1's first spans, and stores each row
into the shared memory of the CTA that owns it (distributed shared memory);
after a cluster barrier each CTA finishes pass 1 and does pass 2 on chip,
the last spans for the sampled rows alone, and stores those rows. The norms
add up inside the cluster in a fixed order. X is read once and nothing else
goes to device memory but the k rows and the norms. The two-pass form, for
every other shape, sends its intermediate through a (dp, n) scratch buffer
and ends with a launch that adds the norms' float64 partials.

``plain`` and ``plain_block`` are the PyTorch versions of the two
functions; ``kernels/ops.py`` chooses between kernel and plain version and
counts launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

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

#: The block mode's cluster form as ``csrc/blocked_fwht.cu`` compiles it:
#: a strip's columns, CTAs a cluster, threads a CTA, TMA tiles a CTA's ring
#: holds, and the dynamic shared memory a CTA may take (227 KB).
CLUSTER_COLS = 8
CLUSTER_CTAS = 8
CLUSTER_THREADS = 512
CLUSTER_STAGES = 3
#: log2 of the most rows a thread of the cluster form's first phase holds
CLUSTER_LOG_RUN = 3
SMEM_MAX = 232_448

#: Block-mode launches by form since the last ``ops.reset_launch_counts``.
BLOCK_FORMS = {"cluster": 0, "two_pass": 0}


class BlockPlan(NamedTuple):
    """The block mode's form at one shape: ``cluster`` or ``two_pass``,
    the columns a CTA (cluster) owns, the CTAs that share them, and the
    shared memory a CTA takes in bytes (the two-pass form's first pass)."""
    form: str
    cols: int
    ctas: int
    smem: int

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


def _radix_split(log_l: int) -> int:
    """R, the elements a thread holds in a radix-2**log_l transform."""
    return 1 << (log_l + 1) // 2


def block_plan(d: int, d_pad: int, dtype: torch.dtype, k: int) -> BlockPlan:
    """The form of the block mode at X (d, .) of ``dtype`` padded to d_pad
    with k sampled rows, as ``csrc/blocked_fwht.cu`` lays out its shared
    memory: the cluster form where d_pad takes two passes and a CTA holds
    the strip's live blocks and a table of the k rows, else the two-pass
    form. Depends on the shapes alone."""
    logs = radices(d_pad)
    l1 = logs[0]
    if len(logs) == 2:
        size = 2 if dtype == torch.bfloat16 else 4
        L1 = 1 << l1
        C, N, S = CLUSTER_COLS, CLUSTER_CTAS, CLUSTER_STAGES
        lo = L1 // N
        w1 = L1 // min(_radix_split(l1), 1 << CLUSTER_LOG_RUN) * C // 32
        live = -(-d // L1)
        small = 16 * S + 8 * C + 8 * w1 * C + 4 * (3 * lo + 2)
        smem = S * L1 * C * size + live * lo * C * 4 + small + 4 * k
        if smem <= SMEM_MAX:
            return BlockPlan("cluster", C, N, smem)
    return BlockPlan("two_pass", 32, 1, 4 * (1 << l1) * 32)


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
                       _I64, _P, _I64, _I64, _P, _P, _P]
        fn.restype = ctypes.c_int
    lib.srht_cluster_slots.argtypes = [_I64, _I64, _I64, _I64]
    lib.srht_cluster_slots.restype = ctypes.c_int


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


def cluster_slots(lib: ctypes.CDLL, d: int, d_pad: int, dtype: torch.dtype,
                  k: int) -> int:
    """The cluster form's clusters that the current card holds at once at
    X (d, .) of ``dtype`` padded to d_pad with k sampled rows (the
    occupancy API's count)."""
    got = lib.srht_cluster_slots(d, d_pad.bit_length() - 1, k,
                                 int(dtype == torch.bfloat16))
    if got < 0:
        raise RuntimeError(f"srht_cluster_slots: CUDA error {-got}")
    return got


def launch_block(lib: ctypes.CDLL, X: torch.Tensor, signs: torch.Tensor,
                 rows: torch.Tensor, d_pad: int, root_dp: float,
                 root_dp_k: float, sketch: torch.Tensor, norms: torch.Tensor,
                 form: str | None = None) -> str:
    """Run the block mode on CUDA tensors: X (d, n) as for ``launch``,
    signs (d,) float32 and rows (k,) int32 contiguous, each row in [0,
    d_pad); sketch a (k, n) float32 view with unit column stride, norms (n,)
    float32 contiguous. Writes ``(H (signs * X))[rows] / root_dp *
    root_dp_k`` into sketch and X's column norms into norms on the current
    stream, without synchronising, in ``block_plan``'s form (or ``form``,
    which the source refuses where it does not fit), counts it in
    BLOCK_FORMS and returns it. The two-pass form's scratch buffers come
    from PyTorch's allocator; the cluster form takes none."""
    d, n = X.shape
    k = rows.shape[0]
    form = block_plan(d, d_pad, X.dtype, k).form if form is None else form
    scratch = partial = None
    if form == "two_pass":
        logs = radices(d_pad)
        if len(logs) > 1:
            scratch = torch.empty((d_pad, n), dtype=torch.float32,
                                  device=X.device)
        partial = torch.empty((d_pad >> logs[0], n), dtype=torch.float64,
                              device=X.device)
    elif form != "cluster":
        raise ValueError(f"srht_block: no form {form!r}")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = getattr(lib, _BLOCK_ENTRY[X.dtype])(
        X.data_ptr(), X.stride(0), signs.data_ptr(), d,
        d_pad.bit_length() - 1, rows.data_ptr(), k, root_dp, root_dp_k,
        sketch.data_ptr(), sketch.stride(0), norms.data_ptr(), n,
        int(form == "cluster"),
        None if scratch is None else scratch.data_ptr(),
        None if partial is None else partial.data_ptr(), stream)
    if err:
        raise RuntimeError(f"srht_block: {form} kernel launch failed with "
                           f"CUDA error {err}")
    BLOCK_FORMS[form] += 1
    return form


__all__ = ["plain", "plain_block", "bind", "launch", "launch_block",
           "radices", "block_plan", "BlockPlan", "BLOCK_FORMS", "cluster_slots",
           "hadamard_matrix", "SOURCE", "REPLACES", "TILE", "MAX_LOG_RADIX",
           "CLUSTER_COLS", "CLUSTER_CTAS", "CLUSTER_THREADS",
           "CLUSTER_STAGES", "CLUSTER_LOG_RUN", "SMEM_MAX"]
