#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each failing the script (non-zero exit, no final line) when it
fails; nothing is caught:

1. card: the card's name and power limit, from nvidia-smi;
2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc``, one nvcc
   per source, started together, with each kernel's register report;
3. kernel 1 (``sketch_fused``) against its plain PyTorch version at d =
   50,000 and k = 512 on a column slice, in float32 and bf16, and on a
   ragged shape;
4. the slice at full width: SMP-PCA (``repro_torch.core.smppca.smppca``)
   of a planted pair with d = 50,000, n1 = n2 = 100,000, k = 512, r = 5,
   m = default_m(1e5, 1e5, 5) = 57,564,627, T = 10, through both kernels
   (launch counters read around the run); per-stage times from a second,
   staged run, with the cost of the sampler's host-side CDF; a
   probe-estimated relative residual against its threshold; and the same
   SMP-PCA on card and CPU at a small size, which must agree;
5. kernel 2 (``sampled_rescaled_dot``) against its plain version on the
   first 2**20 of the slice's samples, with m = 0 and with duplicates;
6. timings of each kernel at the slice's shapes beside its plain version,
   one PyTorch library call where one computes the same function, and its
   bound on an H100 SXM;
7. a ``kernels`` JSON line, then the final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet: float32 without the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel against plain version, float32 sums over d = 50,000 taken in
# another order: each sketch column within 1e-4 of its own largest entry
# (the planted pair's columns decay as 1/i, so one scale for all columns
# would hide a wrong small column; float32 rounding alone gives a few 1e-6
# of a column's largest entry), squared norms within 1e-4 relative
# (positive terms, summed in one thread).
SKETCH_TOL = 1e-4
# Eq. 2 values are bounded by nA[r] * nB[c]; measured against that scale,
# float32 dot products of k = 512 terms agree to well under 1e-5.
SAMPLED_TOL = 1e-5
# Probe-estimated relative residual ||(A^T B - U V^T) W||_F / ||A^T B W||_F.
# The JAX package gives 0.0587 at the CPU test size (numpy planted pair,
# seed 0, d=2000, n=200, k=512, r=5, T=8); tests/test_torch_smppca.py holds
# it below half this bound. About three times that, rounded up, leaves room
# for other seeds and sizes, while a broken path gives a residual near 1.
PROBE_RESIDUAL_MAX = 0.2
# Card against CPU at the small size: same keys, but float32 sums in other
# orders and CUDA atomics in WAltMin move U V^T by ~1e-5 relative.
SMALL_UVT_TOL = 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def turns(plain, kernel, reps: int):
    """Time plain, kernel, kernel, plain (after one warm-up each) and
    return (kernel_ms, plain_ms), each the mean of its two turns."""
    plain()
    kernel()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(flops: float, nbytes: float):
    """Least time on an H100 SXM in ms, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def planted_pair(gen, d, n, device, decay=1.0, corr=0.3):
    """The paper's generator (tests/conftest.py::planted_pair): A = G D,
    B = A + corr * G' D with D_ii = 1/i^decay, drawn on ``device``."""
    D = 1.0 / torch.arange(1, n + 1, dtype=torch.float32, device=device) ** decay
    A = torch.randn(d, n, generator=gen, device=device).mul_(D)
    B = torch.randn(d, n, generator=gen, device=device).mul_(D * corr).add_(A)
    return A, B


def probe_residual(A, B, factors, gen) -> float:
    W = torch.randn(B.shape[1], 8, generator=gen, device=B.device)
    AtBW = A.T @ (B @ W)
    UVtW = factors.U @ (factors.V.T @ W)
    return float(torch.linalg.norm(AtBW - UVtW) / torch.linalg.norm(AtBW))


def sketch_check(ops, Pi, A, precision=None):
    """Kernel 1 against its plain version; returns the sketch's max abs
    err. Fails unless every column's error is within SKETCH_TOL of that
    column's largest entry and the squared norms within SKETCH_TOL
    relative."""
    if precision == "bf16":
        Pi, A = Pi.to(torch.bfloat16), A.to(torch.bfloat16)
    out, norm = ops.sketch_fused(Pi, A)
    ref_out, ref_norm2 = ops.KERNELS["sketch_fused"].plain(Pi, A)
    torch.cuda.synchronize()
    diff = (out - ref_out).abs()
    err = float(diff.max())
    col_err = float((diff.amax(dim=0)
                     / ref_out.abs().amax(dim=0).clamp(min=1e-30)).max())
    rel_n = float(((norm ** 2 - ref_norm2).abs() / ref_norm2).max())
    shape = tuple(Pi.shape) + (A.shape[1],)
    print(f"sketch_fused check k,d,n={shape} {precision or 'f32'}: "
          f"max_abs_err={err:.3e} column_err={col_err:.3e} "
          f"norm2_rel_err={rel_n:.3e} (tol {SKETCH_TOL:.0e})", flush=True)
    check(col_err <= SKETCH_TOL,
          f"sketch_fused {shape} {precision}: column err {col_err}")
    check(rel_n <= SKETCH_TOL, f"sketch_fused norms {shape}: {rel_n}")
    return err


def sampled_check(ops, As, Bs, na, nb, rows, cols, label):
    out = ops.sampled_rescaled_dot(As, Bs, na, nb, rows, cols)
    ref = ops.KERNELS["sampled_rescaled_dot"].plain(As, Bs, na, nb, rows,
                                                    cols)
    torch.cuda.synchronize()
    check(out.shape == ref.shape, f"sampled_dot {label} shape")
    if out.numel() == 0:
        print(f"sampled_rescaled_dot check {label}: empty", flush=True)
        return 0.0
    err = float((out - ref).abs().max())
    scaled = float(((out - ref).abs()
                    / (na[rows.long()] * nb[cols.long()]).clamp(min=1e-30)
                    ).max())
    print(f"sampled_rescaled_dot check {label}: max_abs_err={err:.3e} "
          f"scaled_err={scaled:.3e} (tol {SAMPLED_TOL:.0e})", flush=True)
    check(scaled <= SAMPLED_TOL, f"sampled_dot {label}: {scaled}")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import prng
    from repro_torch.core import estimation_engine, sampling, summary_engine
    from repro_torch.core.smppca import smppca, spectral_error_vs_optimal
    from repro_torch.core.waltmin import waltmin
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    d, n, k, r, T = 50_000, 100_000, 512, 5, 10
    m = estimation_engine.default_m(n, n, r)

    # 1. card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card}", flush=True)

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    paths = ops.build()
    build_s = time.perf_counter() - t0
    print(f"build: {len(paths)} kernels in {build_s:.1f} s", flush=True)
    for name, path in paths.items():
        log = path.with_name(path.name + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    key = prng.PRNGKey(args.seed, device=dev)

    # 3. kernel 1 against its plain version ---------------------------------
    A, B = planted_pair(gen, d, n, dev)
    k_sketch = prng.split(key, 3)[0]
    Pi = summary_engine.projection_rows(
        k_sketch, torch.arange(d, device=dev), k).T.contiguous()
    err_sketch = sketch_check(ops, Pi, A[:, :4096])
    sketch_check(ops, Pi, A[:, :4096], precision="bf16")
    sketch_check(ops, torch.randn(33, 517, generator=gen, device=dev),
                 torch.randn(517, 259, generator=gen, device=dev))

    # 4. the slice at full width --------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = smppca(key, A, B, r=r, k=k, m=m, T=T, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"smppca d={d} n1=n2={n} k={k} r={r} m={m} T={T}: {wall_s:.3f} s "
          f"wall, launches {launches}, peak memory {peak_gb:.1f} GB",
          flush=True)
    check(launches == {"sketch_fused": 2, "sampled_rescaled_dot": 1},
          f"launches per smppca call: {launches}")
    U, V = res.factors
    check(tuple(U.shape) == (n, r) and tuple(V.shape) == (n, r),
          "factor shapes")
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all()),
          "factors finite")
    resid = probe_residual(A, B, res.factors, gen)
    print(f"probe residual: {resid:.4f} (threshold {PROBE_RESIDUAL_MAX})",
          flush=True)
    check(resid < PROBE_RESIDUAL_MAX, f"probe residual {resid}")

    # the same path again, stage by stage, timed with CUDA events
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    k_sk, k_samp, _ = prng.split(key, 3)
    k_est = prng.fold_in(k_samp, 0)
    k_omega, k_als = prng.split(k_est)
    events[0].record()
    summary = summary_engine.build_summary(k_sk, A, B, k, backend="cuda",
                                           device=dev)
    events[1].record()
    samples = sampling.sample_entries(k_omega, summary.norm_A,
                                      summary.norm_B, m)
    events[2].record()
    values = estimation_engine._cuda_values(summary, samples.rows,
                                            samples.cols)
    events[3].record()
    staged = waltmin(k_als, samples, values, n, n, r, T,
                     norm_A=summary.norm_A, use_splits=False)
    events[4].record()
    events[4].synchronize()
    stages = {name: events[i].elapsed_time(events[i + 1]) for i, name in
              enumerate(("sketch", "sample", "values", "waltmin"))}
    check(bool(torch.equal(samples.rows, res.samples.rows)),
          "staged run draws the main path's sample")
    del staged
    print("stages_ms " + json.dumps(stages), flush=True)

    # the sampler sums its two CDFs on the host: their cost, and whether
    # the card's own scan gives the same bits on every run
    w = summary.norm_A.float() ** 2
    cdf = {"host_cdf_ms": cuda_ms(lambda: sampling._cdf(w), reps=10),
           "card_cumsum_ms": cuda_ms(lambda: torch.cumsum(w, 0), reps=10)}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        first = torch.cumsum(w.to(dtype), 0)
        cdf[f"card_cumsum_{name}_reruns_differing_of_20"] = sum(
            not torch.equal(torch.cumsum(w.to(dtype), 0), first)
            for _ in range(20))
    print("sample_cdf " + json.dumps(cdf), flush=True)

    # card against CPU at a small size, and the test's error bound
    rng = np.random.default_rng(args.seed)
    ds, ns = 2000, 200
    Dn = (1.0 / np.arange(1, ns + 1)).astype(np.float32)
    As_ = (rng.standard_normal((ds, ns)).astype(np.float32) * Dn)
    Bs_ = As_ + 0.3 * rng.standard_normal((ds, ns)).astype(np.float32) * Dn
    As_, Bs_ = torch.from_numpy(As_), torch.from_numpy(Bs_)
    ms = estimation_engine.default_m(ns, ns, r)
    small = {where: smppca(prng.PRNGKey(args.seed), As_, Bs_, r=r, k=512,
                           m=ms, T=8, device=where).factors
             for where in ("cuda", "cpu")}
    uvt = {where: (f.U @ f.V.T).cpu() for where, f in small.items()}
    rel = float(torch.linalg.norm(uvt["cuda"] - uvt["cpu"])
                / torch.linalg.norm(uvt["cpu"]))
    err, opt = spectral_error_vs_optimal(As_.to(dev), Bs_.to(dev), r,
                                         small["cuda"])
    print(f"small pair d={ds} n={ns}: card vs CPU U V^T rel diff {rel:.2e} "
          f"(tol {SMALL_UVT_TOL:.0e}); spectral err {float(err):.4f} vs "
          f"3*opt+0.05 = {3 * float(opt) + 0.05:.4f}", flush=True)
    check(rel < SMALL_UVT_TOL, f"card vs CPU at the small size: {rel}")
    check(float(err) < 3 * float(opt) + 0.05, "small-size error bound")

    # 5. kernel 2 against its plain version ---------------------------------
    As_rows = summary.A_sketch.T.contiguous()
    Bs_rows = summary.B_sketch.T.contiguous()
    na, nb = summary.norm_A, summary.norm_B
    head = min(m, 1 << 20)
    err_sampled = sampled_check(ops, As_rows, Bs_rows, na, nb,
                                samples.rows[:head], samples.cols[:head],
                                f"first {head} samples")
    empty = samples.rows[:0]
    sampled_check(ops, As_rows, Bs_rows, na, nb, empty, empty, "m=0")
    dup_r = samples.rows[:64].repeat(4)
    dup_c = samples.cols[:64].repeat(4)
    sampled_check(ops, As_rows, Bs_rows, na, nb, dup_r, dup_c, "duplicates")

    # 6. timings at the slice's shapes --------------------------------------
    sk = ops.KERNELS["sketch_fused"]
    k1_ms, k1_plain = turns(lambda: sk.plain(Pi, A),
                            lambda: ops.sketch_fused(Pi, A), reps=2)
    k1_lib = cuda_ms(lambda: torch.matmul(Pi, A), reps=2)
    k1_bound, k1_by = bound(2.0 * k * d * n + 2.0 * d * n,
                            4.0 * (k * d + d * n + k * n + n))
    sd = ops.KERNELS["sampled_rescaled_dot"]
    rows, cols = samples.rows, samples.cols
    k2_ms, k2_plain = turns(
        lambda: sd.plain(As_rows, Bs_rows, na, nb, rows, cols),
        lambda: ops.sampled_rescaled_dot(As_rows, Bs_rows, na, nb, rows,
                                         cols), reps=2)
    # the function's least work: one k-term dot product and five scalar
    # operations per sample, and each sketch row's squared norm once
    k2_bound, k2_by = bound(m * (2.0 * k + 5.0) + 2.0 * (2 * n) * k,
                            4.0 * (2 * n * k + 2 * n) + 12.0 * m)
    timing = {
        "sketch_fused": dict(kernel_ms=k1_ms, plain_ms=k1_plain,
                             library_ms=k1_lib, bound_ms=k1_bound,
                             bound_by=k1_by),
        "sampled_rescaled_dot": dict(kernel_ms=k2_ms, plain_ms=k2_plain,
                                     library_ms=None, bound_ms=k2_bound,
                                     bound_by=k2_by),
    }
    for name, t in timing.items():
        print(f"timing {name} " + json.dumps(t), flush=True)

    # 7. the kernels line and the last line ---------------------------------
    errs = {"sketch_fused": err_sketch, "sampled_rescaled_dot": err_sampled}
    kernels = []
    for name, mod in ops.KERNELS.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{mod.SOURCE}",
            "replaces": mod.REPLACES, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
