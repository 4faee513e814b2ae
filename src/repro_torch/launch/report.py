"""Render the dry-run / roofline results (JSONL) as markdown tables.

The port of ``repro.launch.report``. Its hints name the port's levers.
The terms are predictions from the H100 SXM data sheet's rates
(``roofline.analysis``), not measurements.

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun.jsonl
"""
from __future__ import annotations

import json
import sys

HINTS = {
    ("memory", "train"): "fuse the eager elementwise chains (norms, RoPE, "
                         "chunked softmax) into kernels / save_attn_out "
                         "remat / bf16 scores",
    ("memory", "prefill"): "fuse the projections' casts and norms; bf16 KV",
    ("memory", "decode"): "KV-cache quantization; larger per-GPU batch",
    ("collective", "train"): "overlap FSDP all-gathers and reduce-scatters "
                             "with compute; SMP-PCA gradient compression "
                             "(--compression taps); --constrain-acts",
    ("collective", "prefill"): "row-parallel down projections (one "
                               "all-reduce a block, not an activation "
                               "all-gather a matmul)",
    ("collective", "decode"): "weight-stationary tp_only sharding (no "
                              "per-step FSDP all-gather)",
    ("compute", "train"): "near roofline: raise the per-GPU batch",
    ("compute", "prefill"): "near roofline",
    ("compute", "decode"): "near roofline",
}


def _kind(shape: str) -> str:
    return ("train" if shape.startswith("train") else
            "prefill" if shape.startswith("prefill") else "decode")


def fmt(rows):
    out = ["| arch | shape | mesh | policy | t_compute (s) | t_memory (s)"
           " | t_collective (s) | bottleneck | MODEL/counted flops |"
           " roofline frac | would move the dominant term |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "SKIP":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — |"
                       f" — | — | SKIP | — | — | {r['reason'][:60]} |")
            continue
        if r["status"] != "OK":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
                       f" {r['status']} | | | | | | | |")
            continue
        rl = r["roofline"]
        hint = HINTS.get((rl["bottleneck"], _kind(r["shape"])), "")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('policy','')} "
            f"| {rl['t_compute_s']:.3g} | {rl['t_memory_s']:.3g} "
            f"| {rl['t_collective_s']:.3g} | **{rl['bottleneck']}** "
            f"| {min(rl['useful_flops_fraction'], 9.99):.3f} "
            f"| {rl['roofline_fraction']:.4f} | {hint} |")
    return "\n".join(out)


def memory_table(rows):
    out = ["| arch | shape | mesh | args (GB/dev) | temps (GB/dev) |"
           " collective GB/dev (by op) |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "OK":
            continue
        m = r.get("memory") or {}
        arg = m.get("argument_size_in_bytes", 0) / 2**30
        tmp = m.get("temp_size_in_bytes", 0) / 2**30
        by = r["collectives"]["by_op"]
        bys = " ".join(f"{k.replace('all-','a').replace('collective-','c')}:"
                       f"{v/2**30:.1f}" for k, v in sorted(by.items()))
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {arg:.1f} "
                   f"| {tmp:.1f} | {bys} |")
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "results/dryrun.jsonl"
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    print("## Roofline table (predicted from H100 SXM data-sheet rates)\n")
    print(fmt(rows))
    print("\n## Memory / collective detail\n")
    print(memory_table(rows))


if __name__ == "__main__":
    main()
