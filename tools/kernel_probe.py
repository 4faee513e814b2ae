"""Helpers the kernel probes share: edit a CUDA source's text into a
variant, build the variants side by side, time a call on the card, and
measure the card's L2 read rate.

Used by the probes in ``tools/`` (``*_probe.py``); imports nothing that
needs a card until ``build``, ``cuda_ms`` or ``l2_read_gbps`` runs.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import ops  # noqa: E402


def edit(text: str, old: str, new: str, *, source: str) -> str:
    """``text`` with ``old`` replaced by ``new``; RuntimeError naming
    ``source`` when ``old`` is no longer there."""
    if old not in text:
        raise RuntimeError(f"{source} no longer contains {old!r}")
    return text.replace(old, new)


def build(variants: dict, prefix: str) -> dict:
    """Compile each variant's source text, one ``nvcc`` each, all started
    together, into ``build/repro_torch/probe/<prefix><name>.so``, the
    compiler's report (``-Xptxas -v``) beside it as ``<prefix><name>.log``;
    return the loaded libraries by name."""
    out = ops.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        src = out / f"{prefix}{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [ops._nvcc(), *ops.NVCC_FLAGS, "-o",
             str(out / f"{prefix}{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (out / f"{prefix}{name}.log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{prefix}{name}.so"))
    return libs


def relabelled(text: str) -> str:
    """SASS with its branch labels (``.L_x_<i>``, numbered across the
    file) renumbered in the order they first appear in the function."""
    order: dict = {}
    return re.sub(r"\.L_x_\d+",
                  lambda m: f".L{order.setdefault(m[0], len(order))}", text)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


# Every CTA reads its share of a buffer that stays in L2, with loads that
# skip L1 (ld.global.cg), reps times over.
L2_READ_SOURCE = r'''
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) l2_read(const float4* __restrict__ x,
                                               long long n4, int reps,
                                               float* out) {
  float acc = 0.f;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (int r = 0; r < reps; ++r)
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n4; i += step) {
      const float4 v = __ldcg(x + i);
      acc += v.x + v.y + v.z + v.w;
    }
  if (acc == 0.12345f) out[0] = acc;  // keeps the loads
}
extern "C" int l2_read_launch(const void* x, long long n4, int reps,
                              void* out, int ctas, void* stream) {
  l2_read<<<ctas, 256, 0, (cudaStream_t)stream>>>((const float4*)x, n4, reps,
                                                  (float*)out);
  return (int)cudaGetLastError();
}
'''


def l2_read_gbps(mbytes: int = 16, reps: int = 200) -> float:
    """GB/s at which all SMs read a ``mbytes`` MB buffer that stays in L2
    (loads that bypass L1), from one launch of ``reps`` passes over it."""
    import torch
    lib = build({"l2_read": L2_READ_SOURCE}, prefix="")["l2_read"]
    lib.l2_read_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
    x = torch.ones((mbytes << 20) // 4, device="cuda")
    out = torch.zeros(1, device="cuda")
    ctas = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.l2_read_launch(x.data_ptr(), x.numel() // 4, reps,
                                 out.data_ptr(), ctas, stream)
        if err:
            raise RuntimeError(f"l2_read: launch failed with CUDA error {err}")
    ms = cuda_ms(call, 3)
    return reps * (mbytes << 20) / (ms * 1e-3) / 1e9
