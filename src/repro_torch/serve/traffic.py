"""Synthetic traffic: measured requests per second through ServingLoop.

The port of ``repro.serve.traffic``. Drives the continuously batched
serving stack with an open-loop arrival process (Poisson inter-arrival
times, a shape mix and a tenant mix) and measures requests/s, p50/p99
latency, batch occupancy (requests per batched call) and shed rate, in a
warm steady state that builds no new ``PipelineEngine`` entry.

The generator is calibrated by service time: it first warms every
power-of-two batch width per shape bucket (the loop runs ``pad='pow2'``, so
variable occupancy maps onto a bounded set of cache entries), times one
warm full batch, and offers load at ``rate = target_occupancy /
batch_service_time``: while one batch runs, about ``target_occupancy`` new
requests arrive. Deadlines and the wait limit are likewise multiples of the
service time (``deadline_x``, ``max_wait_x``), so one config describes the
same relative regime on any machine.

The drive loop is single-threaded and open-loop: arrivals that are due are
submitted (never waiting on earlier results), then the loop is polled;
between events it sleeps to the next arrival. A request's latency is its
future's ``completed_at`` (stamped once its batch's results are computed)
minus its submit time, on the loop's clock.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core import pipeline
from repro_torch.serve.scheduler import (
    LoopConfig, PipelineWork, Rejected, ServingLoop)

Shape = Tuple[int, int, int]          # (d, n1, n2): A is (d, n1), B is (d, n2)
Tenant = Optional[Union[int, str]]


class TrafficConfig(NamedTuple):
    """One traffic cell: an arrival process against one serving config.

    ``target_occupancy`` (requests arriving per batch service time) and the
    ``*_x`` knobs are in units of the measured warm full-batch service
    time, so the cell describes a load regime, not a wall-clock rate.
    ``rate_x`` scales the calibrated offered rate (above 1 with a bounded
    queue: overload and shedding). ``pairs_per_shape`` distinct payloads
    per shape are cycled, so the device sees varied data without the
    generator drawing a pair per request.
    """

    name: str = "traffic"
    n_requests: int = 128
    shapes: Tuple[Shape, ...] = ((512, 32, 24),)
    tenants: Tuple[Tenant, ...] = (None,)
    target_occupancy: float = 4.0
    rate_x: float = 1.0
    max_batch: int = 8
    max_queue: Optional[int] = None
    deadline_x: Optional[float] = 8.0   # deadline budget, x batch service
    max_wait_x: Optional[float] = None  # shed limit, x batch service
    k: int = 64
    backend: str = "scan"
    block: int = 1024
    r: int = 4
    m: int = 800
    T: int = 3
    pairs_per_shape: int = 4
    seed: int = 0


def _plan(cfg: TrafficConfig) -> pipeline.PipelinePlan:
    return pipeline.PipelinePlan(
        sketch=pipeline.SketchSpec(k=cfg.k, backend=cfg.backend,
                                   block=cfg.block),
        estimation=pipeline.EstimationSpec(m=cfg.m, T=cfg.T),
        rank=pipeline.RankPolicy(r=cfg.r),
        key_layout="service")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _payloads(cfg: TrafficConfig, dev: torch.device):
    """Per-shape pools of (A, B) pairs on ``dev``, drawn from the keys the
    JAX package's generator uses, before the clock starts."""
    pools = []
    base = prng.PRNGKey(cfg.seed, device=dev)
    for s, (d, n1, n2) in enumerate(cfg.shapes):
        pool = []
        for p in range(cfg.pairs_per_shape):
            kp = prng.fold_in(prng.fold_in(base, s), p)
            pool.append((prng.normal(kp, (d, n1)),
                         prng.normal(prng.fold_in(kp, 1), (d, n2))))
        pools.append(pool)
    _sync(dev)
    return pools


def _warmup(cfg: TrafficConfig, engine, plan, pools,
            dev: torch.device) -> float:
    """Build every pow2 batch width per shape; return the measured warm
    service time (seconds) of one full-width batch."""
    loop = ServingLoop(engine=engine, config=LoopConfig(pad="pow2"))
    widths = []
    w = 1
    full = 1 << (cfg.max_batch - 1).bit_length()
    while w <= full:
        widths.append(w)
        w <<= 1
    base = prng.PRNGKey(cfg.seed + 1)
    for s in range(len(cfg.shapes)):
        A, B = pools[s][0]
        for width in widths:
            for i in range(width):
                loop.submit(prng.fold_in(base, i), A, B,
                            work=PipelineWork(plan))
            loop.drain()
    # a warm full batch on the first shape is the calibration unit
    A, B = pools[0][0]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(full):
        loop.submit(prng.fold_in(base, i), A, B, work=PipelineWork(plan))
    loop.drain()
    _sync(dev)
    return time.perf_counter() - t0


def run_traffic(cfg: TrafficConfig, *, engine=None, device="cuda") -> dict:
    """Run one traffic cell on ``device``; returns its record (a JSON
    dict). The device's name rides the record: a CPU run's times are the
    CPU's, never the card's."""
    dev = _device.resolve(device)
    engine = engine if engine is not None else pipeline.PipelineEngine()
    plan = _plan(cfg)
    pools = _payloads(cfg, dev)

    service_s = _warmup(cfg, engine, plan, pools, dev)
    traces_after_warmup = engine.stats.traces

    deadline = None if cfg.deadline_x is None else cfg.deadline_x * service_s
    max_wait = None if cfg.max_wait_x is None else cfg.max_wait_x * service_s
    loop = ServingLoop(engine=engine, clock=time.perf_counter,
                       config=LoopConfig(
                           max_batch=cfg.max_batch,
                           max_queue=cfg.max_queue,
                           max_wait=max_wait,
                           default_deadline=deadline,
                           dispatch_margin=0.1 * service_s,
                           pad="pow2"))

    n = cfg.n_requests
    rng = np.random.default_rng(cfg.seed)
    offered_rps = cfg.rate_x * cfg.target_occupancy / service_s
    arrivals = np.cumsum(rng.exponential(1.0 / offered_rps, n))
    shape_of = rng.integers(0, len(cfg.shapes), n)
    pair_of = rng.integers(0, cfg.pairs_per_shape, n)
    tenant_of = rng.integers(0, len(cfg.tenants), n)
    keys = prng.split(prng.PRNGKey(cfg.seed + 2), n)

    futures, submit_at = [], {}
    i = 0
    t0 = time.perf_counter()
    while i < n or loop.depth > 0:
        now = time.perf_counter() - t0
        while i < n and arrivals[i] <= now:
            A, B = pools[shape_of[i]][pair_of[i]]
            try:
                f = loop.submit(keys[i], A, B, work=PipelineWork(plan),
                                tenant=cfg.tenants[tenant_of[i]])
                submit_at[f.seq] = time.perf_counter()
                futures.append(f)
            except Rejected:
                pass                  # counted in loop.stats.shed
            i += 1
        dispatched = loop.poll()
        if i >= n and loop.depth and deadline is None:
            loop.drain()              # no deadline to force the tail out
        elif not dispatched:
            sleep = min(arrivals[i] - (time.perf_counter() - t0), 2e-3) \
                if i < n else 5e-4
            if sleep > 0:
                time.sleep(sleep)
    wall_s = time.perf_counter() - t0

    stats = loop.stats
    lat_ms = sorted(
        (f.completed_at - submit_at[f.seq]) * 1e3
        for f in futures if f.done and f.shed_reason is None)

    def pct(q):
        return float(np.percentile(lat_ms, q)) if lat_ms else float("nan")
    return {
        "name": cfg.name,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "n_requests": n,
        "offered_rps": offered_rps,
        "measured_rps": stats.completed / wall_s if wall_s > 0 else 0.0,
        "p50_ms": pct(50),
        "p99_ms": pct(99),
        "mean_ms": float(np.mean(lat_ms)) if lat_ms else float("nan"),
        "occupancy": stats.occupancy,
        "shed_rate": stats.shed_total / n,
        "shed": dict(stats.shed),
        "dispatch_triggers": dict(stats.dispatched),
        "completed": stats.completed,
        "dispatches": stats.dispatches,
        "service_us_per_request": service_s / max(
            1 << (cfg.max_batch - 1).bit_length(), 1) * 1e6,
        "traces_warmup": traces_after_warmup,
        "traces_steady": engine.stats.traces - traces_after_warmup,
        "config": {
            "shapes": [list(s) for s in cfg.shapes],
            "tenants": [str(t) for t in cfg.tenants],
            "target_occupancy": cfg.target_occupancy,
            "rate_x": cfg.rate_x,
            "max_batch": cfg.max_batch,
            "max_queue": cfg.max_queue,
            "deadline_x": cfg.deadline_x,
            "max_wait_x": cfg.max_wait_x,
            "k": cfg.k, "r": cfg.r, "m": cfg.m, "T": cfg.T,
            "backend": cfg.backend, "seed": cfg.seed,
        },
    }
