#!/usr/bin/env python3
"""What holds ``sketch_fused.cu`` back on the card: the kernel beside
variants of itself, each made by editing the source's text.

    python3 tools/sketch_fused_probe.py [--seed 0]
        [--baseline OTHER/sketch_fused.cu]

* ``kernel``: the source as committed;
* ``one_level``: the float32 instance's MMAs add straight into the float32
  sum (no fresh fragment per stage), which shows what the tensor cores'
  truncating adds do to a sum over d = 50,000;
* ``no_copies``: the float32 instance never refills the stages after the
  first, and the bf16 instance's producer arrives on each stage without
  loading it, so both multiply stale tiles: their time without the loads
  (the bf16 instance's cluster still hands its stages round);
* ``no_mma``: each float32 MMA becomes one float add of its operands' bits
  and the bf16 instance's wgmma chain is left out: their time without the
  tensor cores.

Each variant is checked against the plain version at k = 512, d = 50,000 on
a 4,096-column slice of a planted matrix (columns scaled 1/i), in float32
and bf16, and timed at the slice's shape (k = 512, d = 50,000, n = 100,000)
beside ``torch.matmul`` and, for bf16, ``torch.mm(..., out_dtype=float32)``
(the same function as the kernel: float32 out). One JSON line per variant;
needs a CUDA card and ``nvcc``. Builds go to ``build/repro_torch/probe/``.

``--baseline`` builds another ``sketch_fused.cu`` (say the parent commit's,
from ``git archive``) beside this one: the ``sass_vs_baseline`` line names
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

from kernel_probe import build, card, cuda_ms, edit as _edit  # noqa: E402
from repro_torch.kernels import ops, sketch_fused  # noqa: E402

MMA_CALLS = ("mma(part[i][j], a_small, b_big[j][0], b_big[j][1]);",
             "mma(part[i][j], a_big, b_small[j][0], b_small[j][1]);",
             "mma(part[i][j], a_big, b_big[j][0], b_big[j][1]);")
STAGE_ADD = "for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];"
REFILL = "if (ahead < n_steps)"
# the bf16 instance
WGMMA_CALL = """        wgmma_m64n128k16(part, sw128_desc(pi_s + 32 * kk, 16, 1024),
                         sw128_desc(a_s + 16 * 128 * kk, A_HALF_BYTES, 1024),
                         kk > 0 || !first);"""
ISSUE = "issue(slot, (int)(step * BK));"


edit = functools.partial(_edit, source=sketch_fused.SOURCE)


def one_level(text: str) -> str:
    for call in MMA_CALLS:
        text = edit(text, call,
                    call.replace("mma(part[i][j]", "mma(acc[i][j]"))
    return edit(text, STAGE_ADD, "(void)part;")


def no_copies(text: str) -> str:
    text = edit(text, REFILL, "if (ahead < 0)")
    return edit(text, ISSUE, 'asm volatile("mbarrier.arrive.shared::cta.b64 '
                             '_, [%0];" :: "r"(smem_addr(&full[slot])) : '
                             '"memory");')


def no_mma(text: str) -> str:
    for call in MMA_CALLS:
        a, b0, b1 = call[len("mma(part[i][j], "):-2].split(", ")
        text = edit(text, call, f"part[i][j][0] += __uint_as_float("
                                f"{a}[0] ^ {a}[3] ^ {b0} ^ {b1});")
    return edit(text, WGMMA_CALL, "        (void)pi_s, (void)a_s;")


def column_err(lib, Pi, A) -> float:
    out, _ = sketch_fused.launch(lib, Pi, A)
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
    return {f: _relabelled("\n".join(lines)) for f, lines in out.items()}


def _relabelled(text: str) -> str:
    """SASS with its branch labels (``.L_x_<i>``, numbered across the
    file) renumbered in the order they first appear in the function."""
    order: dict = {}
    return re.sub(r"\.L_x_\d+",
                  lambda m: f".L{order.setdefault(m[0], len(order))}", text)


def bind_entries(lib) -> None:
    """The two launch entries' types only: a baseline source may lack the
    cluster query ``sketch_fused.bind`` also declares."""
    for name in ("sketch_fused_f32", "sketch_fused_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int


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
                "no_copies": no_copies(text), "no_mma": no_mma(text)}
    if args.baseline:
        with open(args.baseline) as f:
            variants["baseline"] = f.read()
    libs = build(variants, prefix="sketch_")
    for lib in libs.values():
        bind_entries(lib)
    base_lib = libs.pop("baseline", None)
    print(f"card: {card()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k, d, n = 512, 50_000, 100_000
    Pi = torch.randn(k, d, generator=gen, device=dev)
    scale = 1.0 / torch.arange(1, 4097, device=dev, dtype=torch.float32)
    S = torch.randn(d, 4096, generator=gen, device=dev) * scale
    errs = {name: {"f32": column_err(lib, Pi, S),
                   "bf16": column_err(lib, Pi.bfloat16(), S.bfloat16())}
            for name, lib in libs.items()}
    del S
    A = torch.randn(d, n, generator=gen, device=dev)
    Pi16, A16 = Pi.bfloat16(), A.bfloat16()
    times = {name: {"f32_ms": cuda_ms(lambda: sketch_fused.launch(lib, Pi, A),
                                      3),
                    "bf16_ms": cuda_ms(
                        lambda: sketch_fused.launch(lib, Pi16, A16), 3)}
             for name, lib in libs.items()}
    for name in libs:
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
        turns = {}
        for tag, (p, a) in (("f32", (Pi, A)), ("bf16", (Pi16, A16))):
            calls = {name: functools.partial(sketch_fused.launch, lib, p, a)
                     for name, lib in (("baseline", base_lib),
                                       ("kernel", libs["kernel"]))}
            ms = {"baseline": [], "kernel": []}
            for name in ("baseline", "kernel", "kernel", "baseline"):
                ms[name].append(cuda_ms(calls[name], 3))
            turns[f"{tag}_ms"] = {name: sum(v) / 2 for name, v in ms.items()}
        print(json.dumps({"variant": "baseline_turns",
                          "baseline": args.baseline, **turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
