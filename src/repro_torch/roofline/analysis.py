"""Roofline terms for one NVIDIA H100 SXM: the peaks the kernel tuner and
``chip_smoke.py`` measure kernels against.

The port of ``repro.roofline.analysis`` as far as the tuner needs it: the
peak constants and ``kernel_time_lb``. The constants are the H100 SXM data
sheet's (dense, at the full 700 W), not the TPU's. ``sketch_fused`` and
``flash_attention`` run on the TF32 tensor cores (``PEAK_TF32_FLOPS``,
three split passes for float32 inputs; bf16 one and two); the other
kernels do float32 arithmetic on the FMA units, whose rate without the
tensor cores is ``PEAK_F32_FLOPS``. Parsing compiled
programs for their FLOPs and bytes waits for the LM stack.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12       # float32 FMA units, no tensor cores
PEAK_TF32_FLOPS = 495e12     # TF32 tensor cores, dense
PEAK_BF16_FLOPS = 989e12     # bf16 tensor cores, dense
HBM_BW = 3.35e12             # bytes/s, HBM3

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
