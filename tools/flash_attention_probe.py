#!/usr/bin/env python3
"""What holds ``flash_attention.cu`` back on the card: the kernel beside
variants of itself, each made by editing the source's text, and the rate of
the card's ``mma.sync`` TF32 instruction alone.

    python3 tools/flash_attention_probe.py [--seed 0] [--tile 128 32]
        [--layout 32 8 128 [--layout 32 32 96 ...]]
        [--baseline OTHER/flash_attention.cu]

Each variant edits both designs: the ``mma.sync`` instances and the
``wgmma`` ones (float32 at Dh 64, 96 and 128, ``flash_fwd_wgmma``).

* ``kernel``: the source as committed;
* ``no_copies``: the K/V stages after the first are never refilled
  (``mma.sync``: no ``cp.async``; ``wgmma``: no TMA load past the first
  ``STAGES`` tiles, whose barriers complete on the producer's arrival
  alone), so the kernel works on stale tiles: its time without the loads;
* ``no_mma``: each ``mma.sync`` becomes one float add of its operands'
  bits, each ``wgmma`` nothing (its accumulator keeps what it held): its
  time without the tensor cores;
* ``no_split``: big = small = x, with no rounding or subtraction: its time
  without the split's integer and float work (the MMAs stay; the
  ``wgmma`` instances' splitters still load and store their tiles, and
  their Q and P small parts are still written);
* ``stages<s>_sets<t>``: the ``wgmma`` instances at Dh 64 and 96 with
  ``s`` stages in their TMA ring and ``t`` sets of small parts (their
  ``WForm``), each form that fits and is not the source's (Dh 128 keeps
  its own: a third stage does not fit there).

Each build's ``wgmma_ptxas`` line gives each ``flash_fwd_wgmma``
instance's registers, spilled bytes and ptxas's notes that it serialised
the ``wgmma`` (C7511, C7512, C7518) or injected a wait (C7517).

Each variant is checked against the plain version at S = 4,096 and timed
at one attention layer of S = 32,768, causal, float32 and bf16, at the
tile given (default: the one ``tuning.lookup`` resolves), at each layout
(query heads, KV heads, Dh; ``--layout`` again for another, all on one
build). The layout defaults to granite-3-8b's 32 over 8 of 128; ``--layout
32 32 96`` is phi3-mini-3.8b's, ``12 12 64`` whisper-small's, ``16 1 256``
recurrentgemma-9b's. ``--baseline`` builds another copy of the source
(say the parent commit's, unpacked with ``git archive``) and times it in
turns with the kernel and the form variants (baseline, kernel, forms,
then the same backwards; its own line a layout), at the same layout and
tile: the cost of a change to the source, within one call on one card; its
``sass_vs_baseline`` line names the ``flash_fwd`` instances (bq, bk, Dh,
dtype) and the ``flash_fwd_wgmma`` ones ("wgmma", Dh) whose SASS differs
from the baseline's, instruction for instruction (``cuobjdump -sass``,
branch labels renumbered). The baseline is called through its ``wgmma``
entry at the float32 widths its source runs there (its ``wgmma_width``,
or its one ``W_DH``), and through ``flash_attention_f32`` or
``flash_attention_bf16`` at every other width and dtype, as that source
took them. ``mma_sync_peak`` times a kernel of independent
``mma.sync.m16n8k8`` TF32 MMAs on every SM, the rate the ``mma.sync``
design can reach at most. One JSON line per variant; needs a CUDA card
and ``nvcc``. Builds go to ``build/repro_torch/probe/``.
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

from kernel_probe import (build, card, cuda_ms, edit as _edit,  # noqa: E402
                          relabelled)
from repro_torch.kernels import flash_attention, ops, tuning  # noqa: E402

REFILL = "if (kt + 1 < n_kt) load_stage("
MMA_ASM = '''  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
SPLIT = '''    big = (x + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));'''
TMA_EXPECT = "          mbar_expect(&full[slot], STAGE);\n"
SMALL_PART = "  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);"
WGMMA_OPS = tuple(f'"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "'
                  for n in (32, 128, 96, 64))
# a wgmma width's form: stages of its TMA ring, sets of small parts
FORM = ("template <> struct WForm<{dh}> {{ static constexpr int STAGES = "
        "{stages}, SETS = {sets}; }};")
FORM_RE = (r"template <> struct WForm<{dh}> \{{ static constexpr int "
           r"STAGES = \d+, SETS = \d+; \}};")
# the forms tried at Dh 64 and 96, each where it fits (WTile's static_assert)
FORMS = ((2, 1), (3, 1), (4, 1), (2, 2), (3, 2))

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
                "          mbar_expect(&full[slot], kt < STAGES ? STAGE : "
                "0);\n          if (kt >= STAGES) continue;\n")


def no_mma(text: str) -> str:
    text = edit(text, MMA_ASM, "  c[0] += __uint_as_float(a[0] ^ a[1] ^ "
                               "a[2] ^ a[3] ^ b0 ^ b1);")
    for op in WGMMA_OPS:
        text = edit(text, op, '"// "')     # a PTX comment to the line's end
    return text


def no_split(text: str) -> str:
    text = edit(text, SPLIT, "    big = x;\n    small = x;")
    return edit(text, SMALL_PART, "  return x;")


def with_form(text: str, stages: int, sets: int) -> str:
    """The source with its Dh 64 and 96 ``wgmma`` instances in the form
    (stages, sets)."""
    for dh in (64, 96):
        new = FORM.format(dh=dh, stages=stages, sets=sets)
        text, n = re.subn(FORM_RE.format(dh=dh), new, text)
        if n != 1:
            raise RuntimeError(f"{flash_attention.SOURCE} has no WForm<{dh}>")
    return text


def fits(stages: int, sets: int, dh: int) -> bool:
    """Whether the form fits one CTA's shared memory at width dh (the
    source's ``WTile::SMEM``)."""
    return 1024 + 8 * 128 * dh + (stages + sets) * 8 * 32 * dh + \
        8 * (2 * stages + 3 * sets) <= 232_448


def form_variants(text: str) -> dict:
    """{"stages<s>_sets<t>": source} for each form that fits at Dh 96 (and
    so at 64) and differs from the source's."""
    return {f"stages{s}_sets{n}": with_form(text, s, n)
            for s, n in FORMS if fits(s, n, 96)
            and with_form(text, s, n) != text}


def wgmma_widths(text: str) -> tuple:
    """The float32 widths a source runs on its ``wgmma`` entry: its
    ``wgmma_width``, or the one ``W_DH`` of a source from before the other
    widths; none without the entry."""
    if "flash_attention_f32_wgmma" not in text:
        return ()
    m = re.search(r"bool wgmma_width\(int DH\) \{\s*return ([^;]*);", text)
    if m:
        return tuple(int(w) for w in re.findall(r"DH == (\d+)", m[1]))
    return (int(re.search(r"constexpr int W_DH = (\d+)", text)[1]),)


def wgmma_report(lib) -> dict:
    """{Dh: {"registers", "spill_bytes", "notes"}} of each ``flash_fwd_wgmma``
    instance, from the ``-Xptxas -v`` report kept beside the library:
    ptxas's notes that it serialised ``wgmma`` (C7511, C7512, C7518) or
    injected a wait (C7517)."""
    log = open(re.sub(r"\.so$", ".log", lib._name)).read()
    out, dh = {}, None
    for m in re.finditer(r"\((C751[1278])\).*?flash_fwd_wgmma(?:ILi(\d+)E)?",
                         log):
        out.setdefault(int(m[2] or 128), {}).setdefault("notes", []).append(
            m[1])
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_fwd_wgmma(?:ILi(\d+)E)?", line)
            dh = None if m is None else int(m[1] or 128)
        elif dh is not None and "spill stores" in line:
            out.setdefault(dh, {})["spill_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", line)[1])
        elif dh is not None and "Used" in line:
            out[dh]["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
            out[dh].setdefault("notes", [])
    return out


def sass_by_instance(lib) -> dict:
    """{(bq, bk, Dh, dtype): SASS text} of each ``flash_fwd`` instance in
    the loaded library and {("wgmma", Dh): SASS text} of each
    ``flash_fwd_wgmma`` one (a source's untemplated one is its Dh 128),
    from ``cuobjdump -sass``, branch labels renumbered."""
    cuobjdump = os.path.join(os.path.dirname(ops._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], check=True,
                          capture_output=True, text=True).stdout
    out, inst = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_fwdILi(\d+)ELi(\d+)ELi(\d+)E"
                          r"(f|13__nv_bfloat16)E", line)
            w = re.search(r"flash_fwd_wgmma(?:ILi(\d+)E)?", line)
            inst = (int(m[1]), int(m[2]), int(m[3]),
                    "float32" if m[4] == "f" else "bfloat16") if m else \
                ("wgmma", int(w[1] or 128)) if w else None
            if inst is not None:
                out[inst] = []
        elif inst is not None:
            out[inst].append(" ".join(line.split()))
    return {i: relabelled("\n".join(lines)) for i, lines in out.items()}


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


def bind_any(lib, text: str):
    """Bind the entry points of a library built from source ``text``, one
    from before the ``wgmma`` widths it has too; returns its launch
    function: the ``wgmma`` entry (through ``flash_attention.launch``) at
    the float32 widths the source runs there, its entry for the dtype at
    every other width and dtype."""
    for name in flash_attention._ENTRY.values():
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64] * 5 + [ctypes.c_void_p, ctypes.c_float] + [
            ctypes.c_int64] * 3 + [ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    widths = wgmma_widths(text)
    if widths:
        fn = getattr(lib, flash_attention._WGMMA_ENTRY)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [
            ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def launch(q, k, v, causal, bq, bk):
        if q.dtype == torch.float32 and \
                flash_attention.tile_width(q.shape[3]) in widths:
            return flash_attention.launch(lib, q, k, v, causal, bq, bk)
        return legacy_launch(lib, q, k, v, causal, bq, bk)
    return launch


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
    ap.add_argument("--layout", type=int, nargs=3, action="append",
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
                **form_variants(text), "peak": PEAK_SOURCE}
    sources = dict(variants)
    if args.baseline:
        with open(args.baseline) as f:
            sources["baseline"] = variants["baseline"] = f.read()
    libs = build(variants, prefix="flash_")
    peak_lib = libs.pop("peak")
    base_lib = libs.pop("baseline", None)
    launches = {name: bind_any(lib, sources[name])
                for name, lib in libs.items()}
    base_launch = None if base_lib is None else \
        bind_any(base_lib, sources["baseline"])
    print(f"card: {card()}", flush=True)
    for name, lib in [*libs.items(), ("baseline", base_lib)]:
        if lib is not None:
            print(json.dumps({"variant": name, "wgmma_ptxas": wgmma_report(
                lib)}), flush=True)
    if base_lib is not None:
        mine, base = sass_by_instance(libs["kernel"]), sass_by_instance(base_lib)
        shared = sorted(set(mine) & set(base), key=str)
        print(json.dumps({
            "variant": "sass_vs_baseline", "instances": len(mine),
            "baseline_instances": len(base),
            "identical": sum(mine[i] == base[i] for i in shared),
            "differ": [list(i) for i in shared if mine[i] != base[i]],
            "new": [list(i) for i in sorted(set(mine) - set(base), key=str)],
            "gone": [list(i) for i in sorted(set(base) - set(mine),
                                             key=str)]}),
            flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    forms = [n for n in launches if n.startswith("stages")]
    for heads, kv_heads, dh in args.layout or [(32, 8, 128)]:
        bq, bk = args.tile or tuning.lookup(
            "flash_attention", (heads, 32768, dh), backend="cuda").block

        def inputs(S):
            return (torch.randn(1, S, heads, dh, generator=gen, device=dev),
                    torch.randn(1, S, kv_heads, dh, generator=gen,
                                device=dev),
                    torch.randn(1, S, kv_heads, dh, generator=gen,
                                device=dev))

        q, k, v = inputs(4096)
        errs = {}
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            qd, kd, vd = (x.to(dtype) for x in (q, k, v))
            ref = flash_attention.plain(qd, kd, vd, True).float()
            for name, launch in launches.items():
                out = launch(qd, kd, vd, True, bq, bk)
                errs.setdefault(name, {})[f"max_abs_err_{tag}"] = float(
                    (out.float() - ref).abs().max())
            del ref
        q, k, v = inputs(32768)
        for name, launch in launches.items():
            times = {}
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                qd, kd, vd = (x.to(dtype) for x in (q, k, v))
                times[f"{tag}_ms"] = cuda_ms(
                    lambda: launch(qd, kd, vd, True, bq, bk), 2)
            print(json.dumps({"variant": name, "tile": [bq, bk],
                              "layout": [heads, kv_heads, dh], **errs[name],
                              **times}), flush=True)
        if base_launch is not None:
            # baseline, kernel, forms, then backwards: each one's two turns
            order = ["baseline", "kernel", *forms]
            turns = {}
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                qd, kd, vd = (x.to(dtype) for x in (q, k, v))
                calls = {name: functools.partial(
                    base_launch if name == "baseline" else launches[name],
                    qd, kd, vd, True, bq, bk) for name in order}
                got = {name: [] for name in order}
                for name in order + order[::-1]:
                    got[name].append(cuda_ms(calls[name], 2))
                for name, ms in got.items():
                    turns[f"{name}_{tag}_ms"] = ms
            print(json.dumps({"variant": "baseline_turns", "tile": [bq, bk],
                              "layout": [heads, kv_heads, dh],
                              "baseline": args.baseline, **turns}),
                  flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({"variant": "mma_sync_peak",
                      "tf32_tflops": mma_peak_tflops(peak_lib, dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
