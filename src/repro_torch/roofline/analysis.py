"""Roofline terms for NVIDIA H100 SXM GPUs: the peaks the kernel tuner and
``chip_smoke.py`` measure kernels against, and the step-level roofline of
a traced program.

The port of ``repro.roofline.analysis``. The constants are the H100 SXM
data sheet's (dense, at the full 700 W), not the TPU's. ``sketch_fused``
and ``flash_attention`` run on the TF32 tensor cores (``PEAK_TF32_FLOPS``,
three split passes for float32 inputs; bf16 one and two); the other
kernels do float32 arithmetic on the FMA units, whose rate without the
tensor cores is ``PEAK_F32_FLOPS``.

A step's terms (``Roofline``), per device:

    compute    = FLOPs / 989e12                  [bf16 tensor cores, dense]
    memory     = bytes / 3.35e12                 [HBM3]
    collective = sum over mesh axes of that axis's collective bytes over
                 its link rate (``LINK_BW``)

The FLOPs, bytes and collective bytes come from
``roofline.trace_analyzer``, which counts a traced step per device (the
JAX package parses compiled HLO instead; there is none here). The
collectives are the ones the trace recorded (``collective_bytes``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

#: float32 on the FMA units, no tensor cores (H100 SXM data sheet: 67
#: TFLOP/s).
PEAK_F32_FLOPS = 67e12
#: TF32 tensor cores, dense (data sheet: 989 TFLOP/s with sparsity, half
#: without).
PEAK_TF32_FLOPS = 495e12
#: bf16 tensor cores, dense (data sheet: 1,979 TFLOP/s with sparsity, half
#: without): the compute term's peak.
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth in bytes/s (data sheet: 3.35 TB/s).
HBM_BW = 3.35e12
#: NVLink 4 in bytes/s a direction a GPU (data sheet: 900 GB/s
#: bidirectional): the ``model`` axis, one 8-GPU NVLink node.
NVLINK_BW = 450e9
#: InfiniBand in bytes/s a GPU: one 400 Gb/s ConnectX-7 NIC a GPU (the DGX
#: H100 layout), the ``data`` and ``pod`` axes, which cross nodes.
IB_BW = 50e9
#: The link rate of each mesh axis; an axis not named here (or a
#: collective over no known axis) is charged the slower link.
LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}

SMS = 132                    # streaming multiprocessors
SMEM_PER_SM = 233_472        # bytes of shared memory an SM hands out (228 KB)
SMEM_PER_BLOCK = 232_448     # bytes one CTA may opt into (227 KB)
SMEM_RESERVED = 1_024        # bytes the runtime keeps per resident CTA
THREADS_PER_SM = 2_048
REGISTERS_PER_SM = 65_536    # 32-bit registers


def kernel_time_lb(flops: float, hbm_bytes: float, *,
                   peak_flops: float = PEAK_F32_FLOPS, hbm_bw: float = HBM_BW,
                   ctas: int = 1, slots: int | None = None) -> float:
    """Roofline lower bound for ONE kernel call in seconds: perfect overlap
    of compute and memory (the larger of the two terms), stretched by the
    tail wave when ``slots`` CTAs fit on the card at once: ``ctas`` CTAs run
    in ``ceil(ctas / slots)`` waves and the last one leaves SMs idle. This
    is the scalar the kernel tuner (``repro_torch.kernels.tuning``) ranks
    tiles on."""
    t = max(flops / peak_flops, hbm_bytes / hbm_bw)
    if slots:
        ctas = max(int(ctas), 1)
        waves = -(-ctas // slots)
        t *= waves * slots / ctas
    return t


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int
    by_op: Dict[str, int]
    count: int
    by_axis: Dict[str, int] = dataclasses.field(default_factory=dict)

    def as_dict(self):
        return {"total_bytes": self.total_bytes, "by_op": self.by_op,
                "count": self.count, "by_axis": self.by_axis}


def collective_bytes(records: Iterable[Tuple[str, int, Optional[str]]]
                     ) -> CollectiveStats:
    """Sum the collectives a trace recorded: ``(op, bytes, axis)`` triples
    (``trace_analyzer.Cost.collectives``), ``op`` in the JAX package's HLO
    names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``), ``bytes`` the output's bytes
    on one device (the moved payload, as the JAX parser counts it from
    the output shape), ``axis`` the mesh axis it ran over (None when it
    was over none that the trace knows)."""
    by_op: Dict[str, int] = {}
    by_axis: Dict[str, int] = {}
    count = 0
    for op, nbytes, axis in records:
        by_op[op] = by_op.get(op, 0) + int(nbytes)
        if axis is not None:
            by_axis[axis] = by_axis.get(axis, 0) + int(nbytes)
        count += 1
    return CollectiveStats(sum(by_op.values()), by_op, count, by_axis)


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device
    bytes_accessed: float        # per-device
    coll_bytes: float            # per-device
    model_flops_per_device: float
    chips: int
    #: per-device collective bytes by mesh axis; bytes of ``coll_bytes``
    #: on no axis here are charged the slowest link
    coll_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_BF16_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        slow = min(LINK_BW.values())
        t = sum(b / LINK_BW.get(a, slow) for a, b in self.coll_by_axis.items())
        rest = self.coll_bytes - sum(self.coll_by_axis.values())
        return t + max(rest, 0.0) / slow

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def step_time(self) -> float:
        """Lower-bound step time assuming perfect overlap: max of terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (remat and padding waste show up
        here)."""
        return self.model_flops_per_device / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful compute time / step time."""
        t_useful = self.model_flops_per_device / PEAK_BF16_FLOPS
        return t_useful / max(self.step_time, 1e-30)

    def as_dict(self):
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "coll_bytes_per_device": self.coll_bytes,
            "model_flops_per_device": self.model_flops_per_device,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_lb_s": self.step_time,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(kind: str, n_active_params: int, tokens: int,
                enc_extra: int = 0) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D inference (per step)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens + enc_extra
