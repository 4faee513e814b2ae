#!/usr/bin/env python3
"""What holds ``sketch_fused.cu`` back on the card: the kernel beside
variants of itself, each made by editing the source's text.

    python3 tools/sketch_fused_probe.py [--seed 0]
        [--baseline OTHER/sketch_fused.cu]

* ``kernel``: the source as committed;
* ``one_level``: the float32 instance's chains never end before the unit
  does (one fresh accumulator a column tile), which shows what the tensor
  cores' truncating adds do to a sum over d = 50,000;
* ``no_copies``: both instances' producers arrive on each stage without
  loading it, the float32 one past the first ring of stages, the bf16 one
  from the start, so both multiply stale tiles: their time without the
  loads (the clusters still hand their stages round);
* ``no_mma``: the float32 instance's wgmma become one float add of its
  fragments' bits, and the bf16 instance's wgmma chain is left out: their
  time without the tensor cores;
* ``along_k``: the float32 instance's clusters of up to four CTAs along k
  multicasting A's tile (the bf16 instance's layout; 30 of them fit an
  H100), in place of two along n multicasting Pi's (66); ``n4``: four
  along n; ``k4n2``: four along k by two along n;
* ``stages3``: the float32 instance's ring of three stages, not four;
* ``no_small``: the float32 instance loads no small parts of Pi (its third
  pass reads stale ones): its time with a third less traffic from L2;
* ``mma_sync``: ``tools/sketch_fused_mma_sync.cu``, the earlier float32
  design (TF32 ``mma.sync`` fed by ``cp.async``), float32 only.

Each variant is checked against the plain version at k = 512, d = 50,000 on
a 4,096-column slice of a planted matrix (columns scaled 1/i), in float32
and bf16, and timed at the slice's shape (k = 512, d = 50,000, n = 100,000)
beside ``torch.matmul`` and, for bf16, ``torch.mm(..., out_dtype=float32)``
(the same function as the kernel: float32 out); ``mma_sync_turns`` times
``mma_sync`` and the kernel in turns (mma_sync, kernel, kernel, mma_sync),
and ``small_turns`` does so at the smaller float32 shapes the port runs:
a serving pair's (128, 4,096, 128), a stream chunk's (512, 4,096,
100,000) and the gradient taps' (128, 8,192, 4,096), 20 calls a turn.
One JSON line per variant (with the float32 clusters the card holds at
k = 512); needs a CUDA card and ``nvcc``. Builds go to
``build/repro_torch/probe/``.

``--baseline`` builds another ``sketch_fused.cu`` (say the parent commit's,
from ``git show``) beside this one: the ``sass_vs_baseline`` line names
the kernel functions whose SASS differs from the baseline's, instruction for
instruction (``cuobjdump -sass``), and ``baseline_turns`` times the two in
turns (baseline, kernel, kernel, baseline) in each dtype.
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
from repro_torch.kernels import ops, sketch_fused  # noqa: E402

MMA_SYNC_SOURCE = os.path.join(ROOT, "tools", "sketch_fused_mma_sync.cu")

# the float32 instance
CHAIN_END = "        fresh = --left == 0 || step + 1 == n_steps;"
CLUSTER_K = "constexpr int F32_CLUSTER_MAX = 1;"
CLUSTER_N = "constexpr int F32_CLUSTER_N = 2;"
STAGES = "constexpr int F32_STAGES = 4;"
STAGE_D0 = "          const int d0 = (int)(step * F32_BK);\n"
SMALL_LOAD = """            tma_multicast(&small_map, &full[slot],
                          stage + F32_PI_BYTES + rows, d0, k0 + rn * pi_rows,
                          pi_mask);
"""
EXPECT = "(active ? 2 * F32_PI_BYTES : 0) + F32_A_BYTES"
WGMMA_PASSES = """          wgmma_tf32_n128(part, small, sw128_desc(pi_big + 32 * j, 16, 1024),
                          j > 0 || !fresh);
          wgmma_tf32_n128(part, big, sw128_desc(pi_big + 32 * j, 16, 1024),
                          1);
          wgmma_tf32_n128(part, big, sw128_desc(pi_small + 32 * j, 16, 1024),
                          1);"""
# the bf16 instance
WGMMA_CALL = """        wgmma_m64n128k16(part, sw128_desc(pi_s + 32 * kk, 16, 1024),
                         sw128_desc(a_s + 16 * 128 * kk, A_HALF_BYTES, 1024),
                         kk > 0 || !first);"""
ISSUE = "issue(slot, (int)(step * BK));"
ARRIVE_FULL = ('asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: '
               '"r"(smem_addr(&full[slot])) : "memory");')


edit = functools.partial(_edit, source=sketch_fused.SOURCE)


def one_level(text: str) -> str:
    return edit(text, CHAIN_END, "        fresh = step + 1 == n_steps;")


def no_copies(text: str) -> str:
    text = edit(text, STAGE_D0, STAGE_D0 +
                "          if (u != special_clusterid() || step >= F32_STAGES) "
                "{\n            " + ARRIVE_FULL + "\n            advance();\n"
                "            continue;\n          }\n")
    return edit(text, ISSUE, ARRIVE_FULL)


def no_mma(text: str) -> str:
    text = edit(text, WGMMA_PASSES,
                "          part[j] += __uint_as_float(big[0] ^ big[3] ^ "
                "small[0] ^ small[3]);\n          (void)pi_small;")
    return edit(text, WGMMA_CALL, "        (void)pi_s, (void)a_s;")


def along_k(text: str) -> str:
    text = edit(text, CLUSTER_K, "constexpr int F32_CLUSTER_MAX = 4;")
    return edit(text, CLUSTER_N, "constexpr int F32_CLUSTER_N = 1;")


def n4(text: str) -> str:
    return edit(text, CLUSTER_N, "constexpr int F32_CLUSTER_N = 4;")


def k4n2(text: str) -> str:
    return edit(text, CLUSTER_K, "constexpr int F32_CLUSTER_MAX = 4;")


def stages3(text: str) -> str:
    return edit(text, STAGES, "constexpr int F32_STAGES = 3;")


def no_small(text: str) -> str:
    text = edit(text, SMALL_LOAD, "")
    return edit(text, EXPECT, "(active ? F32_PI_BYTES : 0) + F32_A_BYTES")


def launch_mma_sync(lib, Pi, A):
    """(Pi @ A, squared norms) by a float32 ``sketch_fused_f32`` of the
    earlier design (no scratch argument), on the current stream."""
    k, d = Pi.shape
    n = A.shape[1]
    out = torch.empty((k, n), dtype=torch.float32, device=A.device)
    norm2 = torch.empty((n,), dtype=torch.float32, device=A.device)
    err = lib.sketch_fused_f32(Pi.data_ptr(), A.data_ptr(), out.data_ptr(),
                               norm2.data_ptr(), k, d, n,
                               torch.cuda.current_stream(A.device).cuda_stream)
    if err:
        raise RuntimeError(f"sketch_fused (mma.sync): launch failed with "
                           f"CUDA error {err}")
    return out, norm2


def bind_mma_sync(lib, entries=("sketch_fused_f32",)) -> None:
    """The earlier design's launch entries: Pi, A, out, norm2, k, d, n,
    stream."""
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int


def build_mma_sync():
    """The yardstick ``tools/sketch_fused_mma_sync.cu``, built and bound."""
    with open(MMA_SYNC_SOURCE) as f:
        lib = build({"mma_sync": f.read()}, prefix="sketch_")["mma_sync"]
    bind_mma_sync(lib)
    return lib


def column_err(launch, Pi, A) -> float:
    out, _ = launch(Pi, A)
    ref, _ = sketch_fused.plain(Pi, A)
    torch.cuda.synchronize()
    return float(((out - ref).abs().amax(dim=0)
                  / ref.abs().amax(dim=0).clamp(min=1e-30)).max())


def sass_by_function(lib) -> dict:
    """{kernel function: SASS text} of the loaded library, from
    ``cuobjdump -sass``, the functions named without the anonymous
    namespace (whose mangled name carries the source file's)."""
    cuobjdump = os.path.join(os.path.dirname(ops._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "",
                        line.split("Function :", 1)[1].strip())
            out[fn] = []
        elif fn is not None:
            out[fn].append(" ".join(line.split()))   # the dump's padding
    return {f: relabelled("\n".join(lines)) for f, lines in out.items()}


def in_turns(first, second, reps: int = 3) -> dict:
    """first, second, second, first: each one's mean ms of its two turns."""
    ms = {"first": [], "second": []}
    for name, fn in (("first", first), ("second", second),
                     ("second", second), ("first", first)):
        ms[name].append(cuda_ms(fn, reps))
    return {name: sum(v) / 2 for name, v in ms.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="another sketch_fused.cu to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sketch_fused_probe: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    text = (ops.CSRC / sketch_fused.SOURCE).read_text()
    variants = {"kernel": text, "one_level": one_level(text),
                "no_copies": no_copies(text), "no_mma": no_mma(text),
                "along_k": along_k(text), "n4": n4(text), "k4n2": k4n2(text),
                "stages3": stages3(text), "no_small": no_small(text)}
    with open(MMA_SYNC_SOURCE) as f:
        variants["mma_sync"] = f.read()
    base_text = None
    if args.baseline:
        with open(args.baseline) as f:
            base_text = variants["baseline"] = f.read()
    libs = build(variants, prefix="sketch_")
    mma_lib = libs.pop("mma_sync")
    bind_mma_sync(mma_lib)
    base_lib = libs.pop("baseline", None)
    for lib in libs.values():
        sketch_fused.bind(lib)
    launches = {name: functools.partial(sketch_fused.launch, lib)
                for name, lib in libs.items()}
    base_f32 = None
    if base_lib is not None:
        # a baseline of the earlier design takes no scratch argument
        if "sketch_fused_pi_small" in base_text:
            sketch_fused.bind(base_lib)
            base_f32 = base_bf16 = functools.partial(sketch_fused.launch,
                                                     base_lib)
        else:
            bind_mma_sync(base_lib, ("sketch_fused_f32", "sketch_fused_bf16"))
            base_f32 = functools.partial(launch_mma_sync, base_lib)
            base_bf16 = functools.partial(sketch_fused.launch, base_lib)
    print(f"card: {card()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k, d, n = 512, 50_000, 100_000
    Pi = torch.randn(k, d, generator=gen, device=dev)
    scale = 1.0 / torch.arange(1, 4097, device=dev, dtype=torch.float32)
    S = torch.randn(d, 4096, generator=gen, device=dev) * scale
    errs = {name: {"f32": column_err(fn, Pi, S),
                   "bf16": column_err(fn, Pi.bfloat16(), S.bfloat16())}
            for name, fn in launches.items()}
    mma = functools.partial(launch_mma_sync, mma_lib)
    errs["mma_sync"] = {"f32": column_err(mma, Pi, S), "bf16": None}
    del S
    A = torch.randn(d, n, generator=gen, device=dev)
    Pi16, A16 = Pi.bfloat16(), A.bfloat16()
    times = {name: {"f32_ms": cuda_ms(lambda: fn(Pi, A), 3),
                    "bf16_ms": cuda_ms(lambda: fn(Pi16, A16), 3),
                    "f32_clusters": sketch_fused.cluster_slots(libs[name], k)}
             for name, fn in launches.items()}
    times["mma_sync"] = {"f32_ms": cuda_ms(lambda: mma(Pi, A), 3),
                         "bf16_ms": None}
    for name in times:
        print(json.dumps({"variant": name,
                          "column_err_f32": errs[name]["f32"],
                          "column_err_bf16": errs[name]["bf16"],
                          **times[name]}), flush=True)
    print(json.dumps({
        "variant": "torch.matmul",
        "f32_ms": cuda_ms(lambda: torch.matmul(Pi, A), 3),
        "bf16_ms": cuda_ms(lambda: torch.matmul(Pi16, A16), 3),
        "bf16_mm_out_f32_ms": cuda_ms(
            lambda: torch.mm(Pi16, A16, out_dtype=torch.float32), 3)}),
        flush=True)
    kernel = launches["kernel"]
    turns = in_turns(lambda: mma(Pi, A), lambda: kernel(Pi, A))
    print(json.dumps({"variant": "mma_sync_turns", "f32_ms": {
        "mma_sync": turns["first"], "kernel": turns["second"]}}), flush=True)
    small = {}
    for ks, ds, ns in ((128, 4096, 128), (512, 4096, 100_000),
                       (128, 8192, 4096)):
        p, a = Pi[:ks, :ds].contiguous(), A[:ds, :ns].contiguous()
        got = in_turns(lambda: mma(p, a), lambda: kernel(p, a), reps=20)
        small[f"{ks}x{ds}x{ns}"] = {"mma_sync": got["first"],
                                    "kernel": got["second"]}
    print(json.dumps({"variant": "small_turns", "f32_ms": small}),
          flush=True)
    if base_lib is not None:
        mine, base = sass_by_function(libs["kernel"]), sass_by_function(base_lib)
        shared = sorted(set(mine) & set(base))
        print(json.dumps({
            "variant": "sass_vs_baseline", "functions": len(mine),
            "baseline_functions": len(base),
            "identical": [f for f in shared if mine[f] == base[f]],
            "differ": [f for f in shared if mine[f] != base[f]],
            "new": sorted(set(mine) - set(base)),
            "gone": sorted(set(base) - set(mine))}), flush=True)
        rec = {}
        for tag, base_fn, (p, a) in (("f32", base_f32, (Pi, A)),
                                     ("bf16", base_bf16, (Pi16, A16))):
            got = in_turns(lambda: base_fn(p, a), lambda: kernel(p, a))
            rec[f"{tag}_ms"] = {"baseline": got["first"],
                                "kernel": got["second"]}
        print(json.dumps({"variant": "baseline_turns",
                          "baseline": args.baseline, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
