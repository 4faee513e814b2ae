#!/usr/bin/env python3
"""Why a tapped layer's SMP-PCA completion can differ between the card and
the CPU: one phi3-mini-3.8b training step with taps on the card
(``chip_smoke.py`` phase 20's ``train_run``, full width, 1 step), then, for
its first tapped layer (by name):

    python3 tools/tap_parity_probe.py [--seed 0]

* ``check``: phase 20's own comparison (the CPU's completion of the
  summary finalized on the card, and under a wrong key);
* ``card_repeat``: the card's completion of the captured taps, again;
* ``cpu_from_taps``: ``decompress_tap`` on the CPU from the taps alone
  (the summary finalized there too), with ``rows_differ`` and
  ``cols_differ``, its draws that differ from the card's;
* ``sqrt_ulp_off``: the norms (of ``n1 + n2``) where the CPU's
  ``torch.sqrt`` differs from the card's;
* ``cpu_ulp_sketch``: the CPU's completion after every sketch entry moves
  one ulp up or down at random, against the unmoved one;
* ``top_sv``: the 9 largest singular values of the CPU's completion.

Errors are the largest difference over the step dW's largest entry. One
JSON line, with the card's name and power limit first; needs a CUDA card
and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tap_parity_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import streaming
    from repro_torch.core.smppca import smppca_from_summary
    from repro_torch.kernels import ops
    from repro_torch.train import sketched_dense as sd

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.build()
    out = {}
    check = cs.tapped_vs_cpu

    def probe(grads, cap):
        res = check(grads, cap)
        cfg, taps = cap["cfg"], cap["taps"]
        k = sd.tap_keys(cap["key"], cap["names"])[cap["prefix"]]
        got = grads[cap["prefix"] + ".w"].cpu()
        scale = float(got.abs().max())

        def complete(dev, t):
            summary = streaming.finalize_state(sd.tap_state(
                {f: v.to(dev) for f, v in t.items()}))
            m = int(cfg.sample_factor * (summary.n1 + summary.n2) * cfg.rank)
            r = smppca_from_summary(k.to(dev), summary, r=cfg.rank, m=m,
                                    T=cfg.als_iters, device=dev)
            return r.samples, (r.factors.U @ r.factors.V.T).cpu()

        def err(a, b):
            return float((a - b).abs().max()) / scale
        s_card, w_card = complete("cuda", taps)
        s_cpu, w_cpu = complete("cpu", taps)
        gen = torch.Generator().manual_seed(args.seed)
        moved = dict(taps)
        for f in ("a", "b"):
            v = taps[f]
            up = torch.nextafter(v, torch.full_like(v, float("inf")))
            down = torch.nextafter(v, torch.full_like(v, -float("inf")))
            moved[f] = torch.where(torch.rand(v.shape, generator=gen) < 0.5,
                                   up, down)
        _, w_moved = complete("cpu", moved)
        norms = torch.cat([taps["na2"], taps["nb2"]]).clamp(min=0.0)
        out.update(
            layer=cap["prefix"], check=res, card_repeat=err(w_card, got),
            cpu_from_taps=err(w_cpu, got),
            m=int(s_cpu.rows.numel()),
            rows_differ=int((s_card.rows.cpu() != s_cpu.rows).sum()),
            cols_differ=int((s_card.cols.cpu() != s_cpu.cols).sum()),
            sqrt_ulp_off=int((torch.sqrt(norms.cuda()).cpu()
                              != torch.sqrt(norms)).sum()),
            n_norms=int(norms.numel()),
            cpu_ulp_sketch=err(w_moved, w_cpu),
            top_sv=torch.linalg.svdvals(w_cpu)[:9].tolist())
        return res

    cs.tapped_vs_cpu = probe
    cs.train_run(ops, "b", "taps", args.seed, torch.device("cuda"), card, 1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
