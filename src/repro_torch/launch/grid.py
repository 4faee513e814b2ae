"""Dry-run grid driver: every (arch x shape x mesh) cell as a subprocess
(a fresh interpreter and fake process group per cell), resumable through
the JSONL output.

The port of ``repro.launch.grid``. It needs no card:

    PYTHONPATH=src python -m repro_torch.launch.grid --out results/dryrun.jsonl

``--jobs`` runs that many cells at once (each is one CPU-bound process).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS = [
    "xlstm-350m", "whisper-small", "phi3-mini-3.8b", "granite-3-8b",
    "recurrentgemma-9b", "llama-3.2-vision-11b", "starcoder2-15b",
    "moonshot-v1-16b-a3b", "mistral-large-123b", "kimi-k2-1t-a32b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def done_cells(path):
    out = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    out.add((r["arch"], r["shape"], r["mesh"]))
                except Exception:   # noqa: BLE001
                    pass
    return out


def _run(cell, out, timeout):
    arch, shape, mesh = cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if mesh != "32x8":
        cmd.append("--multi-pod")
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        ok = p.returncode == 0
        if not ok:
            tail = (p.stdout + p.stderr)[-2000:]
            with open(out, "a") as f:
                f.write(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "status": "FAIL", "error": tail}) + "\n")
    except subprocess.TimeoutExpired:
        with open(out, "a") as f:
            f.write(json.dumps({"arch": arch, "shape": shape,
                                "mesh": mesh, "status": "TIMEOUT"}) + "\n")
        ok = False
    print(f"{arch} {shape} {mesh} -> {'ok' if ok else 'FAIL'} "
          f"({time.time()-t0:.0f}s)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--archs", default=None, help="comma list subset")
    ap.add_argument("--meshes", default="32x8,2x32x8")
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)

    archs = args.archs.split(",") if args.archs else ARCHS
    meshes = args.meshes.split(",")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = done_cells(args.out)
    cells = [(a, s, m) for a in archs for s in SHAPES for m in meshes]
    todo = [c for c in cells if c not in done]
    print(f"{len(todo)}/{len(cells)} cells to run", flush=True)
    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        list(pool.map(lambda c: _run(c, args.out, args.timeout), todo))


if __name__ == "__main__":
    main()
