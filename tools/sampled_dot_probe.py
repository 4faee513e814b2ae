#!/usr/bin/env python3
"""Where the time of ``sampled_dot.cu`` goes on the card, by timing in
place of the L2 counters that no profiler reads there: the kernel beside
variants of itself, on sketches that fit in L2 and on the slice's, on
the slice's draw and on uniform draws.

    python3 tools/sampled_dot_probe.py [--seed 0]

* ``kernel``: the source as committed (bucketed by column block and row);
* ``unbucketed``: the radix sort's passes left out, so warps take the
  samples in sample order and reload both rows for nearly every sample:
  the first design's traffic (one warp per sample, both rows from wherever
  they lie), plus the packing of the keys;
* ``out_in_place``: each value stored at its bucket-order position, not
  at t: the gather without its scattered stores (a wrong output);
* ``sort_only``, ``pack_only``: the work before the gather (keys packed
  and sorted into bucket order), and the packing alone;
* ``ops_wrapper``: the committed kernel through ``ops.sampled_rescaled_dot``,
  which reads the range flag back (one synchronisation a call).

Sketches (n, k = 512) float32 with n = 100,000 (the slice, 205 MB each)
and n = 8,192 (16 MB each: both stay in the 50 MB L2); m = 57,564,627
samples drawn as ``sampling.sample_entries`` draws them from column norms
1/i (the planted pair's shape: 61% of norm-weighted draws on column 1) or
uniform on both sides. The full variants' outputs are compared bit for
bit with the kernel's. Also printed: the card's L2 read rate
(``kernel_probe.l2_read_gbps``, all SMs reading a 16 MB buffer with loads
that skip L1), and the time one B-row read per sample takes at that rate.
One JSON line per measurement, with the card's name and power limit first;
needs a CUDA card and ``nvcc``. Builds go to ``build/repro_torch/probe/``.
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
from kernel_probe import l2_read_gbps  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import estimation_engine, sampling  # noqa: E402
from repro_torch.kernels import ops, sampled_dot  # noqa: E402

edit = functools.partial(_edit, source=sampled_dot.SOURCE)

PASSES = "  for (int shift = 0; shift < bits;"
GATHER = "  float* sqA = sq;\n"
SORT = "  int bits = 0;"


def unbucketed(text: str) -> str:
    return edit(text, PASSES, PASSES.replace("shift < bits", "shift < 0"))


def sort_only(text: str) -> str:
    return edit(text, GATHER, "  return 0;\n" + GATHER)


def pack_only(text: str) -> str:
    return edit(text, SORT, "  return 0;\n" + SORT)


def out_in_place(text: str) -> str:
    """Each value written at its bucket-order position: the gather without
    its scattered stores into ``out``."""
    return edit(text, "      out[t] = dot", "      out[p0 + s] = dot")


VARIANTS = {"kernel": lambda t: t, "unbucketed": unbucketed,
            "out_in_place": out_in_place, "sort_only": sort_only,
            "pack_only": pack_only}
# variants whose output is the full function, held equal to the kernel's
FULL = ("unbucketed",)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sampled_dot_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    text = (ops.CSRC / sampled_dot.SOURCE).read_text()
    libs = build({name: fn(text) for name, fn in VARIANTS.items()},
                 prefix="sampled_")
    for lib in libs.values():
        sampled_dot.bind(lib)
    print(f"card: {card()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k = 512
    m = estimation_engine.default_m(100_000, 100_000, 5)
    gbps = l2_read_gbps()
    print(json.dumps({"l2_read_gbps_16MB": gbps,
                      "one_B_row_per_sample_ms": 1e3 * m * k * 4 / (gbps * 1e9),
                      "m": m, "k": k}), flush=True)
    for n in (100_000, 8192):
        As = torch.randn(n, k, generator=gen, device=dev)
        Bs = torch.randn(n, k, generator=gen, device=dev)
        norms = 1.0 / torch.arange(1, n + 1, device=dev, dtype=torch.float32)
        drawn = sampling.sample_entries(prng.PRNGKey(args.seed, device=dev),
                                        norms, norms, m)
        draws = {"slice": (drawn.rows, drawn.cols),
                 "uniform": tuple(torch.randint(0, n, (m,), generator=gen,
                                                device=dev, dtype=torch.int32)
                                  for _ in range(2))}
        for draw, (rows, cols) in draws.items():
            outs = {}
            for name, lib in libs.items():
                call = lambda: sampled_dot.launch(lib, As, Bs, norms, norms,
                                                  rows, cols)
                ms = cuda_ms(call, 3)
                outs[name] = call()[0]
                print(json.dumps({"variant": name, "n": n, "draw": draw,
                                  "ms": ms}), flush=True)
            ms = cuda_ms(lambda: ops.sampled_rescaled_dot(
                As, Bs, norms, norms, rows, cols), 3)
            print(json.dumps({"variant": "ops_wrapper", "n": n, "draw": draw,
                              "ms": ms}), flush=True)
            torch.cuda.synchronize()
            print(json.dumps({"n": n, "draw": draw, "equal_to_kernel": {
                name: bool(torch.equal(outs["kernel"], outs[name]))
                for name in FULL}}), flush=True)
            del outs
        del As, Bs, draws, drawn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
