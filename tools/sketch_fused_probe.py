#!/usr/bin/env python3
"""What holds ``sketch_fused.cu`` back on the card: the kernel beside three
variants of itself, each made by editing the source's text.

    python3 tools/sketch_fused_probe.py [--seed 0]

* ``kernel``: the source as committed;
* ``one_level``: the MMAs add straight into the float32 sum (no fresh
  fragment per stage), which shows what the tensor cores' truncating adds
  do to a sum over d = 50,000;
* ``no_copies``: the stages after the first are never refilled, so the
  kernel multiplies stale tiles: its time without the loads;
* ``no_mma``: each MMA becomes one float add of its operands' bits: its
  time without the tensor cores.

Each variant is checked against the plain version at k = 512, d = 50,000 on
a 4,096-column slice of a planted matrix (columns scaled 1/i), in float32
and bf16, and timed at the slice's shape (k = 512, d = 50,000, n = 100,000)
beside ``torch.matmul``. One JSON line per variant; needs a CUDA card and
``nvcc``. Builds go to ``build/repro_torch/probe/``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
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


edit = functools.partial(_edit, source=sketch_fused.SOURCE)


def one_level(text: str) -> str:
    for call in MMA_CALLS:
        text = edit(text, call,
                    call.replace("mma(part[i][j]", "mma(acc[i][j]"))
    return edit(text, STAGE_ADD, "(void)part;")


def no_copies(text: str) -> str:
    return edit(text, REFILL, "if (ahead < 0)")


def no_mma(text: str) -> str:
    for call in MMA_CALLS:
        a, b0, b1 = call[len("mma(part[i][j], "):-2].split(", ")
        text = edit(text, call, f"part[i][j][0] += __uint_as_float("
                                f"{a}[0] ^ {a}[3] ^ {b0} ^ {b1});")
    return text


def column_err(lib, Pi, A) -> float:
    out, _ = sketch_fused.launch(lib, Pi, A)
    ref, _ = sketch_fused.plain(Pi, A)
    torch.cuda.synchronize()
    return float(((out - ref).abs().amax(dim=0)
                  / ref.abs().amax(dim=0).clamp(min=1e-30)).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sketch_fused_probe: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    text = (ops.CSRC / sketch_fused.SOURCE).read_text()
    libs = build({"kernel": text, "one_level": one_level(text),
                  "no_copies": no_copies(text), "no_mma": no_mma(text)},
                 prefix="sketch_")
    for lib in libs.values():
        sketch_fused.bind(lib)
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
    print(json.dumps({"variant": "torch.matmul",
                      "f32_ms": cuda_ms(lambda: torch.matmul(Pi, A), 3),
                      "bf16_ms": cuda_ms(lambda: torch.matmul(Pi16, A16), 3)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
