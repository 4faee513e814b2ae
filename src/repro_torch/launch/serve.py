"""Serving entry points: LM generation with the Engine, and sketch serving on
the continuously batched ``ServingLoop``.

The port of ``repro.launch.serve``, with ``--device`` (the card by
default) and ``--seed``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
        --reduced --device cpu

    python -m repro_torch.launch.serve --arch granite-3-8b \\
        --batch 4 --prompt-len 4096 --new-tokens 32

    PYTHONPATH=src python -m repro_torch.launch.serve --mode sketch \\
        --requests 32 --max-batch 8 --deadline-ms 200 --tenants acme,globex

Without ``--reduced`` the arch runs at its full width, parameters drawn on
the device from ``PRNGKey(seed)`` (granite-3-8b: 8.37e9 float32
parameters, 33.5 GB). The prompts are ``randint(PRNGKey(seed), (batch,
prompt_len), 0, vocab)``, as the JAX package's ``launch.serve`` draws them. ``--mode sketch``
runs the asynchronous serving stack end to end: a ServingLoop on its
background pump, requests submitted as futures, the caller waiting on
them; its JSON line carries the loop's stats.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.serve.engine import Engine, ServeConfig


def init_model(arch: str, *, reduced: bool = False, seed: int = 0,
               device="cuda", param_dtype: str | None = None):
    """(model, params, seconds): ``models.build(arch)`` (reduced on
    request, its ``param_dtype`` replaced when given: "bfloat16" serves
    moonshot-v1-16b-a3b's 28.4e9 parameters in 56.8 GB) on ``device`` and
    its parameters from ``PRNGKey(seed)``, timed to a synchronize."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    model = build(cfg, device=device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = model.init_params(prng.PRNGKey(seed, device=model.device))
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return model, params, time.perf_counter() - t0


def prompt_batch(model, batch: int, prompt_len: int, seed: int = 0) -> dict:
    """Prompts ``randint(PRNGKey(seed), (batch, prompt_len), 0, vocab)`` on
    the model's device, and zero stub-frontend inputs."""
    cfg = model.cfg
    key = prng.PRNGKey(seed, device=model.device)
    out = {"tokens": prng.randint(key, (batch, prompt_len), 0, cfg.vocab_size)}
    for name, t in model.aux_input_shapes(batch).items():
        out[name] = torch.zeros(t.shape, dtype=t.dtype, device=model.device)
    return out


def run_generate(args) -> dict:
    model, params, init_s = init_model(args.arch, reduced=args.reduced,
                                       seed=args.seed, device=args.device)
    batch = prompt_batch(model, args.batch, args.prompt_len, args.seed)
    eng = Engine(model, params,
                 ServeConfig(max_new_tokens=args.new_tokens,
                             temperature=args.temperature, seed=args.seed))
    out = eng.generate(batch)
    t = eng.timings
    return {"arch": model.cfg.name, "device": str(model.device),
            "output_shape": list(out.shape),
            "sample_row": out[0].tolist()[:24],
            "init_s": init_s, "prefill_s": t["prefill_s"],
            "prefill_tokens_per_s": args.batch * args.prompt_len
            / t["prefill_s"],
            "decode_ms_per_token": (1e3 * t["decode_s"] / t["decode_steps"]
                                    if t["decode_steps"] else None)}


def run_sketch(args) -> dict:
    from repro_torch.core import pipeline
    from repro_torch.serve.scheduler import LoopConfig, PipelineWork, ServingLoop

    dev = _device.resolve(args.device)
    plan = pipeline.PipelinePlan(
        sketch=pipeline.SketchSpec(k=args.k, backend="scan", block=1024),
        estimation=pipeline.EstimationSpec(m=args.m, T=args.T),
        rank=pipeline.RankPolicy(r=args.r),
        key_layout="service")
    loop = ServingLoop(config=LoopConfig(
        max_batch=args.max_batch,
        max_queue=args.max_queue,
        default_deadline=args.deadline_ms / 1e3,
        pad="pow2"))
    tenants = [t or None for t in args.tenants.split(",")] if args.tenants \
        else [None]
    key = prng.PRNGKey(args.seed)
    A = prng.normal(key, (args.d, args.n)).to(dev)
    B = prng.normal(prng.fold_in(key, 1), (args.d, args.n)).to(dev)

    loop.start()
    try:
        futures = [
            loop.submit(prng.fold_in(key, i), A, B,
                        work=PipelineWork(plan),
                        tenant=tenants[i % len(tenants)])
            for i in range(args.requests)]
        ranks = sorted({f.result(timeout=600).estimate.factors.U.shape[-1]
                        for f in futures})
    finally:
        loop.stop()
    stats = loop.stats
    return {"mode": "sketch", "device": str(dev), "requests": args.requests,
            "completed": stats.completed,
            "dispatches": stats.dispatches,
            "occupancy": round(stats.occupancy, 3),
            "shed": dict(stats.shed),
            "dispatch_triggers": dict(stats.dispatched),
            "served_ranks": ranks}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("generate", "sketch"),
                    default="generate")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    # generate mode
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    # sketch mode
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--deadline-ms", type=float, default=200.0)
    ap.add_argument("--tenants", default="",
                    help="comma-separated tenant ids cycled over requests")
    ap.add_argument("--d", type=int, default=512)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--r", type=int, default=4)
    ap.add_argument("--m", type=int, default=800)
    ap.add_argument("--T", type=int, default=3)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    out = run_sketch(args) if args.mode == "sketch" else run_generate(args)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
