#!/usr/bin/env python3
"""What holds ``flash_attention.cu`` back on the card: the kernel beside
variants of itself, each made by editing the source's text, and the rate of
the card's ``mma.sync`` TF32 instruction alone.

    python3 tools/flash_attention_probe.py [--seed 0] [--tile 128 32]
        [--layout 32 8 128] [--baseline OTHER/flash_attention.cu]

Each variant edits both designs: the ``mma.sync`` instances and the
``wgmma`` one (float32 at Dh 128, ``flash_fwd_wgmma``).

* ``kernel``: the source as committed;
* ``no_copies``: the K/V stages after the first are never refilled
  (``mma.sync``: no ``cp.async``; ``wgmma``: no TMA load past the first
  ``W_STAGES`` tiles, whose barriers complete on the producer's arrival
  alone), so the kernel works on stale tiles: its time without the loads;
* ``no_mma``: each ``mma.sync`` becomes one float add of its operands'
  bits, each ``wgmma`` nothing (its accumulator keeps what it held): its
  time without the tensor cores;
* ``no_split``: big = small = x, with no rounding or subtraction: its time
  without the split's integer and float work (the MMAs stay; the
  ``wgmma`` instance's splitters still load and store their tiles, and
  its Q and P small parts are still written).

Each variant is checked against the plain version at S = 4,096 and timed
at one attention layer of S = 32,768, causal, float32 and bf16, at the
tile given (default: the one ``tuning.lookup`` resolves). The layout
(query heads, KV heads, Dh) defaults to granite-3-8b's 32 over 8 of 128;
``--layout 16 1 256`` is recurrentgemma-9b's. ``--baseline`` builds
another copy of the source (say the parent commit's, unpacked with ``git
archive``) and times it in turns with the kernel (baseline, kernel,
kernel, baseline; its own line), at the same layout and tile: the cost of
a change to the source, within one call on one card; its
``sass_vs_baseline`` line names the ``flash_fwd`` instances (bq, bk, Dh,
dtype) whose SASS differs from the baseline's, instruction for
instruction (``cuobjdump -sass``). A baseline without the ``wgmma`` entry
(the ``mma.sync`` design at float32 Dh 128) is called through
``flash_attention_f32``, as that source took it. ``mma_sync_peak``
times a kernel of independent ``mma.sync.m16n8k8`` TF32 MMAs on every SM,
the rate this design can reach at most. One JSON line per variant; needs
a CUDA card and ``nvcc``. Builds go to ``build/repro_torch/probe/``.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tools")]

from kernel_probe import build, card, cuda_ms, edit as _edit  # noqa: E402
from repro_torch.kernels import flash_attention, ops, tuning  # noqa: E402

REFILL = "if (kt + 1 < n_kt) load_stage("
MMA_ASM = '''  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
SPLIT = '''    big = (x + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));'''
TMA_EXPECT = "          mbar_expect(&full[slot], W_STAGE);\n"
SMALL_PART = "  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);"
WGMMA_OPS = ('"wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "',
             '"wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "')

# Independent MMAs, 8 accumulators a warp, operands kept in registers.
PEAK_SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) peak(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (seed * (threadIdx.x + 7 * i)) & 0x3f7fe000u;
  for (int i = 0; i < 2; ++i) b[i] = (seed * (threadIdx.x + 3 * i)) & 0x3f7fe000u;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(float* out, int blocks, int iters, void* stream) {
  peak<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, 12345u);
  return (int)cudaGetLastError();
}
'''


edit = functools.partial(_edit, source=flash_attention.SOURCE)


def no_copies(text: str) -> str:
    text = edit(text, REFILL, "if (kt + 1 < 0) load_stage(")
    return edit(text, TMA_EXPECT,
                "          mbar_expect(&full[slot], kt < W_STAGES ? W_STAGE "
                ": 0);\n          if (kt >= W_STAGES) continue;\n")


def no_mma(text: str) -> str:
    text = edit(text, MMA_ASM, "  c[0] += __uint_as_float(a[0] ^ a[1] ^ "
                               "a[2] ^ a[3] ^ b0 ^ b1);")
    for op in WGMMA_OPS:
        text = edit(text, op, '"// "')     # a PTX comment to the line's end
    return text


def no_split(text: str) -> str:
    text = edit(text, SPLIT, "    big = x;\n    small = x;")
    return edit(text, SMALL_PART, "  return x;")


def sass_by_instance(lib) -> dict:
    """{(bq, bk, Dh, dtype): SASS text} of each ``flash_fwd`` instance in
    the loaded library, from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(ops._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], check=True,
                          capture_output=True, text=True).stdout
    out, inst = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_fwdILi(\d+)ELi(\d+)ELi(\d+)E"
                          r"(f|13__nv_bfloat16)E", line)
            inst = None if m is None else (
                int(m[1]), int(m[2]), int(m[3]),
                "float32" if m[4] == "f" else "bfloat16")
            if inst is not None:
                out[inst] = []
        elif inst is not None:
            out[inst].append(line.strip())
    return {i: "\n".join(lines) for i, lines in out.items()}


def legacy_launch(lib, q, k, v, causal, bq, bk):
    """``flash_attention.launch`` of a source without the ``wgmma`` entry:
    its own entry for the dtype, at any compiled width."""
    B, S, H, Dh = q.shape
    o = torch.empty_like(q)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    err = getattr(lib, flash_attention._ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
        k.shape[2], Dh, ctypes.cast(strides, ctypes.c_void_p),
        1.0 / Dh ** 0.5, int(causal), bq, bk,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"baseline flash_attention: CUDA error {err}")
    return o


def bind_any(lib):
    """Bind a library's entry points, those of a source without the
    ``wgmma`` entry too; returns its launch function."""
    if hasattr(lib, "flash_attention_f32_wgmma"):
        flash_attention.bind(lib)
        return functools.partial(flash_attention.launch, lib)
    for name in flash_attention._ENTRY.values():
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64] * 5 + [ctypes.c_void_p, ctypes.c_float] + [
            ctypes.c_int64] * 3 + [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    return functools.partial(legacy_launch, lib)


def mma_peak_tflops(lib, dev) -> float:
    """FLOP/s of independent m16n8k8 TF32 MMAs, 8 warps a CTA, 8 CTAs per
    SM worth of work in flight."""
    lib.mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    lib.mma_peak.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, iters = 8 * sms, 4096
    out = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        if lib.mma_peak(out.data_ptr(), blocks, iters, stream):
            raise RuntimeError("mma_peak launch failed")
    ms = cuda_ms(call, 5)
    mmas = blocks * 8 * iters * 8          # warps x iterations x accumulators
    return mmas * 2.0 * 16 * 8 * 8 / (ms * 1e-3) / 1e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tile", type=int, nargs=2, default=None)
    ap.add_argument("--layout", type=int, nargs=3, default=(32, 8, 128),
                    metavar=("HEADS", "KV_HEADS", "DH"))
    ap.add_argument("--baseline", default=None,
                    help="another flash_attention.cu, timed in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_attention_probe: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    text = (ops.CSRC / flash_attention.SOURCE).read_text()
    variants = {"kernel": text, "no_copies": no_copies(text),
                "no_mma": no_mma(text), "no_split": no_split(text),
                "peak": PEAK_SOURCE}
    if args.baseline:
        with open(args.baseline) as f:
            variants["baseline"] = f.read()
    libs = build(variants, prefix="flash_")
    peak_lib = libs.pop("peak")
    base_lib = libs.pop("baseline", None)
    base_launch = None if base_lib is None else bind_any(base_lib)
    launches = {name: bind_any(lib) for name, lib in libs.items()}
    print(f"card: {card()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    heads, kv_heads, dh = args.layout
    bq, bk = args.tile or tuning.lookup(
        "flash_attention", (heads, 32768, dh), backend="cuda").block

    def inputs(S):
        return (torch.randn(1, S, heads, dh, generator=gen, device=dev),
                torch.randn(1, S, kv_heads, dh, generator=gen, device=dev),
                torch.randn(1, S, kv_heads, dh, generator=gen, device=dev))

    q, k, v = inputs(4096)
    errs = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        qd, kd, vd = (x.to(dtype) for x in (q, k, v))
        ref = flash_attention.plain(qd, kd, vd, True).float()
        for name, launch in launches.items():
            out = launch(qd, kd, vd, True, bq, bk)
            errs.setdefault(name, {})[f"max_abs_err_{tag}"] = float(
                (out.float() - ref).abs().max())
    q, k, v = inputs(32768)
    for name, launch in launches.items():
        times = {}
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            times[f"{tag}_ms"] = cuda_ms(
                lambda: launch(qd, kd, vd, True, bq, bk), 2)
        print(json.dumps({"variant": name, "tile": [bq, bk],
                          "layout": [heads, kv_heads, dh], **errs[name],
                          **times}), flush=True)
    if base_lib is not None:
        mine, base = sass_by_instance(libs["kernel"]), sass_by_instance(base_lib)
        shared = sorted(set(mine) & set(base))
        print(json.dumps({
            "variant": "sass_vs_baseline", "instances": len(mine),
            "baseline_instances": len(base),
            "identical": sum(mine[i] == base[i] for i in shared),
            "differ": [list(i) for i in shared if mine[i] != base[i]],
            "new": [list(i) for i in sorted(set(mine) - set(base))]}),
            flush=True)
        turns = {}
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            calls = {name: functools.partial(launch, qd, kd, vd, True, bq, bk)
                     for name, launch in (("baseline", base_launch),
                                          ("kernel", launches["kernel"]))}
            got = {name: [] for name in calls}
            for name in ("baseline", "kernel", "kernel", "baseline"):
                got[name].append(cuda_ms(calls[name], 2))
            for name, ms in got.items():
                turns[f"{name}_{tag}_ms"] = ms
        print(json.dumps({"variant": "baseline_turns", "tile": [bq, bk],
                          "layout": [heads, kv_heads, dh],
                          "baseline": args.baseline, **turns}), flush=True)
    print(json.dumps({"variant": "mma_sync_peak",
                      "tf32_tflops": mma_peak_tflops(peak_lib, dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
