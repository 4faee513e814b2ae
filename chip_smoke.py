#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each failing the script (non-zero exit, no final line) when it
fails; nothing is caught:

1. card: the card's name and power limit, from nvidia-smi;
2. build: the four CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   nvcc per source, started together, with each kernel's register report,
   the count of tensor-core (``HMMA``) instructions in each instance of
   kernels 1 and 4 (``sketch_fused`` and ``flash_attention``), which must be
   positive, kernel 4's registers and spills per instance, the registers
   within the tuner's ``flash_attention.REGISTERS`` and no spill at its
   default tile, and the tile each kernel resolves to through
   ``tuning.lookup``;
3. kernel 1 (``sketch_fused``) against its plain PyTorch version at d =
   50,000 and k = 512 on a column slice, in float32 and bf16, and on a
   ragged shape; kernel 3 (``blocked_fwht``) against its plain version at
   the SRHT pass's call shape (d = 50,000 padded to 65,536 on an
   8,192-column slice), in float32 and bf16, in one pass (d <= 256) and on
   a ragged n, in its full mode and in the SRHT block mode that the SRHT
   path launches (the k = 512 plan rows, equal bit for bit; the norms
   within ``NORM_RTOL``; a second call equal to the first);
4. the Gaussian path at full width: SMP-PCA
   (``repro_torch.core.smppca.smppca``) of a planted pair with d = 50,000,
   n1 = n2 = 100,000, k = 512, r = 5, m = default_m(1e5, 1e5, 5) =
   57,564,627, T = 10, through kernels 1 and 2 (launch counters set to 0
   before the run and read after it); per-stage times from a second,
   staged run, with the cost of the sampler's host-side CDF; a
   probe-estimated relative residual against its threshold; and the same
   SMP-PCA on card and CPU at a small size, which must agree;
5. kernel 2 (``sampled_rescaled_dot``) against its plain version on all
   of the slice's samples and on the same m drawn uniform on both sides,
   with m = 0 and with duplicates, each call made twice and equal bit for
   bit;
6. timings of kernels 1 and 2 at the slice's shapes beside their plain
   versions, one PyTorch library call where one computes the same
   function, and their bounds on an H100 SXM; kernel 1 in float32 and with
   bf16 inputs; kernel 2 on both draws, with the time one B row a sample
   takes from L2 at the card's L2 read rate (``tools/kernel_probe.py``);
7. the SRHT path (``method='srht'``) at the same full width, through
   kernels 3 and 2: launch counts, peak memory, probe residual, per-stage
   times of a staged run, SRHT step 1 split into the plan and the block
   calls (CUDA events) with the memory it adds, beside the composition the
   block mode replaced, and card against CPU at the small size;
8. the timing of kernel 3's block mode at its call shape (float32 and
   bf16), beside its plain version, its bound, the full mode and the
   composition it replaced;
9. kernel 4 (``flash_attention``, on the TF32 tensor cores) against its
   plain version on the JAX test shapes (causal and not, float32 and bf16,
   every compiled tile) and at S = 4,096 with granite-3-8b's 32 query and 8
   KV heads of 128, all at ``FLASH_TOL``;
10. the attention path at full width: one granite-3-8b attention layer at
    ``prefill_32k``'s S = 32,768 (one sequence), causal, float32, through
    ``ops.flash_attention`` (launch counters set to 0 before the call and
    read after it), against the plain version on every row, then bf16 and
    non-causal the same way;
11. kernel 4's timings: every compiled tile at S = 32,768, float32 and
    bf16; at S = 32,768 and 4,096, float32 and bf16, beside its plain
    version, ``scaled_dot_product_attention`` and its bound: float32 on the
    TF32 tensor cores (three split passes per product), with the float32
    FMA units' figure beside it; bf16 at the bf16 tensor cores' rate, with
    this design's two TF32 passes beside it;
12. the kernel tuner: ``tuning.autotune(..., measure_top=3)`` on the card
    for all four kernels at ``benchmarks/run.py::kernel_sweep``'s shapes and
    the attention's full width, launch counters set to 0 before and read
    after;
13. a ``kernels`` JSON line, then the final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

sys.path.insert(0, os.path.join(ROOT, "tools"))

import kernel_probe  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_BW, PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_TF32_FLOPS)


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
# Kernel 3 against its plain version: the kernel does the plain butterfly's
# float32 adds in the same order and should agree bit for bit; each column
# is held to 1e-4 of its own largest entry, the JAX suite's tolerance for
# the blocked FWHT against its butterfly.
FWHT_TOL = 1e-4
# Kernel 3's SRHT block mode against its plain version: the sketch rows are
# the full transform's, rescaled with the same two float32 roundings, and
# must be equal bit for bit; the kernel adds the norms' squares in its own
# order (float64 beyond a thread's float32 sum), the plain version in
# float32 (torch.sum), so they differ by float32 rounding: within 1e-6
# relative, the tolerance the CPU tests give two float32 orders
# (tests/test_torch_srht.py).
NORM_RTOL = 1e-6
# Peak device memory of the SRHT path: A and B take 40 GB, the Gaussian
# path peaked at 51.2 GB (PERF.md), and the SRHT pass must add no (dp, n)
# copy of A or B (26.2 GB each).
SRHT_PEAK_GB_MAX = 60.0
# Kernel 4 against its plain version: the JAX suite's tolerances for its
# kernel against its oracle (tests/kernels/test_flash_attention.py), also at
# S = 32,768: the kernel's and the plain version's float32 sums of 32,768
# terms differ by a few ulps of outputs that are at most max |v|.
FLASH_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# granite-3-8b's attention (src/repro/configs/granite_3_8b.py: 32 heads, 8
# KV heads, d_model 4096) and the sequence lengths of prefill_32k and
# train_4k (src/repro/configs/shapes.py).
HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
S_FULL, S_TRAIN = 32_768, 4_096
# benchmarks/run.py::kernel_sweep's shapes (not the smoke ones), and the
# attention's full width as (B * H, S, Dh).
TUNE_SHAPES = {
    "sketch_fused": [(128, 4096, 512), (256, 8192, 512)],
    "blocked_fwht": [(2048, 512)],
    "sampled_dot": [(1024, 1024, 128, 4096)],
    "flash_attention": [(8, 1024, 128), (HEADS, S_FULL, HEAD_DIM)],
}


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


def bound(flops: float, nbytes: float, peak: float):
    """Least time on an H100 SXM in ms, with the operations at ``peak``
    FLOP/s, and what bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BW
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def hmma_counts(ops, lib) -> dict:
    """Tensor-core MMA instructions (``HMMA``) in each kernel function of
    the library's SASS, from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(ops._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def flash_resources(lib) -> dict:
    """{(bq, bk, Dh, dtype): (registers, spilled bytes)} of each
    ``flash_fwd`` instance, from the ``-Xptxas -v`` report kept beside the
    library."""
    log = lib.with_name(lib.name + ".log").read_text()
    out, inst = {}, None
    for line in log.splitlines():
        m = re.search(r"flash_fwdILi(\d+)ELi(\d+)ELi(\d+)E(f|13__nv_bfloat16)E",
                      line)
        if "Compiling entry function" in line:
            inst = None if m is None else (
                int(m[1]), int(m[2]), int(m[3]),
                "float32" if m[4] == "f" else "bfloat16")
        elif inst is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line)[1])
            out[inst] = (None, spill)
        elif inst is not None and "Used" in line and inst in out:
            regs = int(re.search(r"Used (\d+) registers", line)[1])
            out[inst] = (regs, out[inst][1])
    return out


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


def fwht_check(ops, X, signs, d_pad, label):
    """Kernel 3 against its plain version; returns the max abs err. Fails
    unless every column's error is within FWHT_TOL of that column's
    largest entry."""
    out = ops.blocked_fwht(X, signs, d_pad=d_pad)
    ref = ops.KERNELS["blocked_fwht"].plain(X, signs, d_pad)
    torch.cuda.synchronize()
    check(out.shape == ref.shape, f"blocked_fwht {label} shape")
    diff = (out - ref).abs()
    err = float(diff.max())
    col_err = float((diff.amax(dim=0)
                     / ref.abs().amax(dim=0).clamp(min=1e-30)).max())
    print(f"blocked_fwht check {label} d={X.shape[0]} d_pad={d_pad} "
          f"n={X.shape[1]} {str(X.dtype).split('.')[-1]}: max_abs_err="
          f"{err:.3e} column_err={col_err:.3e} (tol {FWHT_TOL:.0e})",
          flush=True)
    check(col_err <= FWHT_TOL, f"blocked_fwht {label}: column err {col_err}")
    return err


def srht_block_check(ops, X, signs, rows, dp, label):
    """Kernel 3's SRHT block mode against its plain version (the full
    transform's sampled rows, rescaled, and ``column_norms``): the sketch
    equal bit for bit, the norms within NORM_RTOL, and a second call equal
    to the first. Returns (the sketch's max abs err, the norms' max
    relative err)."""
    got_s, got_n = ops.srht_block(X, signs, rows, d_pad=dp)
    again_s, again_n = ops.srht_block(X, signs, rows, d_pad=dp)
    ref_s, ref_n = ops.KERNELS["blocked_fwht"].plain_block(X, signs, rows, dp)
    torch.cuda.synchronize()
    err = float((got_s - ref_s).abs().max())
    rel = float(((got_n - ref_n).abs() / ref_n.clamp(min=1e-30)).max())
    equal = bool(torch.equal(got_s, ref_s))
    rerun = bool(torch.equal(got_s, again_s) and torch.equal(got_n, again_n))
    print(f"srht_block check {label} d={X.shape[0]} d_pad={dp} "
          f"n={X.shape[1]} k={rows.shape[0]} "
          f"{str(X.dtype).split('.')[-1]}: sketch equal={equal} "
          f"(max_abs_err={err:.3e}), norms max_rel_err={rel:.3e} (tol "
          f"{NORM_RTOL:.0e}), second call equal={rerun}", flush=True)
    check(equal, f"srht_block {label}: sketch differs from the plain version")
    check(rel <= NORM_RTOL, f"srht_block {label}: norms rel err {rel}")
    check(rerun, f"srht_block {label}: a second call gave other bits")
    return err, rel


def srht_composition(ops, X, signs, rows, dp, k, width):
    """What the SRHT pass ran per column block before the block mode: the
    full transform, the k-row gather and rescale, and ``column_norms``."""
    from repro_torch.core.sketch import _sqrt_f32, column_norms
    n = X.shape[1]
    sketch = torch.empty((k, n), device=X.device)
    norms = torch.empty((n,), device=X.device)
    root_dp = _sqrt_f32(dp).to(X.device)
    root_dp_k = _sqrt_f32(dp / k).to(X.device)
    for c0 in range(0, n, width):
        Xb = X[:, c0:c0 + width]
        HX = ops.blocked_fwht(Xb, signs, d_pad=dp)
        sketch[:, c0:c0 + width] = (HX[rows.long()] / root_dp) * root_dp_k
        norms[c0:c0 + width] = column_norms(Xb)
    return sketch, norms


def srht_step1_split(ops, summary_engine, key, A, B, k, dev):
    """SRHT step 1 as the cuda backend runs it, in stages timed with CUDA
    events: the plan, then the block calls over A and B; the peak memory
    the step adds; and the same for the composition it replaced (the full
    transform, gather, rescale and ``column_norms`` per block). The two
    must give the same sketches (bit for bit) and norms (NORM_RTOL)."""
    from repro_torch import prng
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    k_sk = prng.split(key, 3)[0]
    d = A.shape[0]
    width = summary_engine.SRHT_COLUMN_BLOCK
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    events[0].record()
    signs, rows, dp = summary_engine.srht_plan(k_sk, d, k)
    events[1].record()
    new = [summary_engine._srht_blocked(X, signs, rows, dp, k, None)
           for X in (A, B)]
    events[2].record()
    events[2].synchronize()
    peak_new = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    events[3].record()
    old = [srht_composition(ops, X, signs, rows, dp, k, width)
           for X in (A, B)]
    events[4].record()
    events[4].synchronize()
    peak_old = (torch.cuda.max_memory_allocated() - base) / 1e9
    for (s_new, n_new), (s_old, n_old) in zip(new, old):
        check(bool(torch.equal(s_new, s_old)),
              "srht step 1: block mode and composition sketches differ")
        check(bool(((n_new - n_old).abs() <= NORM_RTOL * n_old).all()),
              "srht step 1: block mode and composition norms differ")
    calls = 2 * -(-A.shape[1] // width)
    return {"plan_ms": events[0].elapsed_time(events[1]),
            "block_calls_ms": events[1].elapsed_time(events[2]),
            "block_calls": calls,
            "step1_added_peak_gb": peak_new,
            "composition_ms": events[3].elapsed_time(events[4]),
            "composition_added_peak_gb": peak_old}


def staged_run(key, A, B, k, m, r, T, n, method, dev):
    """The main path once more, stage by stage, timed with CUDA events.
    Returns (stages_ms, summary, samples, values)."""
    from repro_torch import prng
    from repro_torch.core import estimation_engine, sampling, summary_engine
    from repro_torch.core.waltmin import waltmin
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    k_sk, k_samp, _ = prng.split(key, 3)
    k_omega, k_als = prng.split(prng.fold_in(k_samp, 0))
    events[0].record()
    summary = summary_engine.build_summary(k_sk, A, B, k, method=method,
                                           backend="cuda", device=dev)
    events[1].record()
    samples = sampling.sample_entries(k_omega, summary.norm_A,
                                      summary.norm_B, m)
    events[2].record()
    values = estimation_engine._cuda_values(summary, samples.rows,
                                            samples.cols)
    events[3].record()
    waltmin(k_als, samples, values, n, n, r, T, norm_A=summary.norm_A,
            use_splits=False)
    events[4].record()
    events[4].synchronize()
    stages = {name: events[i].elapsed_time(events[i + 1]) for i, name in
              enumerate(("sketch", "sample", "values", "waltmin"))}
    return stages, summary, samples, values


def small_pair_check(smppca, spectral_error_vs_optimal, seed, r, dev,
                     method):
    """The same SMP-PCA on card and CPU at d = 2000, n = 200: U V^T must
    agree within SMALL_UVT_TOL, and the card's error meet the JAX suite's
    3 opt + 0.05 bound."""
    from repro_torch import prng
    from repro_torch.core import estimation_engine
    rng = np.random.default_rng(seed)
    ds, ns = 2000, 200
    Dn = (1.0 / np.arange(1, ns + 1)).astype(np.float32)
    As_ = (rng.standard_normal((ds, ns)).astype(np.float32) * Dn)
    Bs_ = As_ + 0.3 * rng.standard_normal((ds, ns)).astype(np.float32) * Dn
    As_, Bs_ = torch.from_numpy(As_), torch.from_numpy(Bs_)
    ms = estimation_engine.default_m(ns, ns, r)
    small = {where: smppca(prng.PRNGKey(seed), As_, Bs_, r=r, k=512, m=ms,
                           T=8, method=method, device=where).factors
             for where in ("cuda", "cpu")}
    uvt = {where: (f.U @ f.V.T).cpu() for where, f in small.items()}
    rel = float(torch.linalg.norm(uvt["cuda"] - uvt["cpu"])
                / torch.linalg.norm(uvt["cpu"]))
    err, opt = spectral_error_vs_optimal(As_.to(dev), Bs_.to(dev), r,
                                         small["cuda"])
    print(f"small pair {method} d={ds} n={ns}: card vs CPU U V^T rel diff "
          f"{rel:.2e} (tol {SMALL_UVT_TOL:.0e}); spectral err "
          f"{float(err):.4f} vs 3*opt+0.05 = {3 * float(opt) + 0.05:.4f}",
          flush=True)
    check(rel < SMALL_UVT_TOL, f"{method} card vs CPU at the small size: "
          f"{rel}")
    check(float(err) < 3 * float(opt) + 0.05,
          f"{method} small-size error bound")


def sampled_check(ops, As, Bs, na, nb, rows, cols, label):
    """Kernel 2 against its plain version: every value within SAMPLED_TOL
    of its nA * nB scale, in sample order, and a second call equal to the
    first bit for bit. Returns the max abs err."""
    out = ops.sampled_rescaled_dot(As, Bs, na, nb, rows, cols)
    again = ops.sampled_rescaled_dot(As, Bs, na, nb, rows, cols)
    ref = ops.KERNELS["sampled_rescaled_dot"].plain(As, Bs, na, nb, rows,
                                                    cols)
    torch.cuda.synchronize()
    check(out.shape == ref.shape, f"sampled_dot {label} shape")
    check(bool(torch.equal(out, again)),
          f"sampled_dot {label}: a second call gave other bits")
    if out.numel() == 0:
        print(f"sampled_rescaled_dot check {label}: empty", flush=True)
        return 0.0
    err = float((out - ref).abs().max())
    scaled = float(((out - ref).abs()
                    / (na[rows.long()] * nb[cols.long()]).clamp(min=1e-30)
                    ).max())
    print(f"sampled_rescaled_dot check {label}: max_abs_err={err:.3e} "
          f"scaled_err={scaled:.3e} (tol {SAMPLED_TOL:.0e}), second call "
          f"equal", flush=True)
    check(scaled <= SAMPLED_TOL, f"sampled_dot {label}: {scaled}")
    return err


def flash_check(ops, q, k, v, causal, label, config=None, out=None):
    """Kernel 4 against its plain version on every row (``out``: the
    kernel's output if it ran already); returns the max abs err. Fails
    unless |out - ref| <= tol + tol |ref| everywhere, the JAX test's
    ``assert_allclose(rtol=tol, atol=tol)``."""
    if out is None:
        out = ops.flash_attention(q, k, v, causal=causal, config=config)
    ref = ops.KERNELS["flash_attention"].plain(q, k, v, causal)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"flash_attention {label} shape/dtype")
    tol = FLASH_TOL[q.dtype]
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    excess = float((diff - tol * ref.float().abs()).max())
    print(f"flash_attention check {label} {tuple(q.shape)}/{tuple(k.shape)} "
          f"{str(q.dtype).split('.')[-1]} causal={causal}: max_abs_err="
          f"{err:.3e} (tol {tol:.0e} + {tol:.0e} |ref|)", flush=True)
    check(excess <= tol, f"flash_attention {label}: err {err}")
    return err


def attention_inputs(gen, S, heads, kv_heads, dh, dev, batch=1):
    q = torch.randn(batch, S, heads, dh, generator=gen, device=dev)
    k = torch.randn(batch, S, kv_heads, dh, generator=gen, device=dev)
    v = torch.randn(batch, S, kv_heads, dh, generator=gen, device=dev)
    return q, k, v


def sdpa_call(q, k, v):
    """The library yardstick, never on the port's path: one call of
    PyTorch's fused causal attention on the same tensors in its (B, H, S,
    Dh) layout, restricted to fused backends so that it never forms the
    S x S scores. For bf16 that is the flash backend with GQA. PyTorch has
    no fused float32 kernel for GQA heads (its memory-efficient backend
    needs equal head counts, its math backend would form 137 GB of scores
    at S = 32,768), so for float32 the KV heads are repeated to H once,
    outside the timed call, and the memory-efficient backend reads them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        backend, gqa = SDPBackend.FLASH_ATTENTION, True
    else:
        rep = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
        backend, gqa = SDPBackend.EFFICIENT_ATTENTION, False

    def call():
        with sdpa_kernel([backend]):
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=gqa)
    return call


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
    from repro_torch.kernels import ops, tuning

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
        if name == "flash_attention":
            continue                  # per instance below
        log = path.with_name(path.name + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    for name in ("sketch_fused", "flash_attention"):
        hmma = hmma_counts(ops, paths[name])
        for fn, count in hmma.items():
            print(f"  {name} SASS {fn}: {count} HMMA", flush=True)
        check(len(hmma) > 0 and all(c > 0 for c in hmma.values()),
              f"{name} runs on the tensor cores: HMMA counts {hmma}")
    flash_default = tuning.DEFAULTS["flash_attention"].block
    spills = flash_resources(paths["flash_attention"])
    for inst, (regs, spill) in spills.items():
        print(f"  flash_attention instance bq,bk,Dh,dtype={inst}: {regs} "
              f"registers, {spill} bytes spilled", flush=True)
    table = ops.KERNELS["flash_attention"].REGISTERS
    check(all(regs <= table[inst[2]] for inst, (regs, _) in spills.items()),
          f"flash_attention: registers within the tuner's table {table}")
    default_insts = [i for i in spills if i[:2] == flash_default]
    check(len(spills) == 2 * len(tuning.TILE_MENUS["flash_attention"])
          * len(ops.KERNELS["flash_attention"].HEAD_DIMS) and default_insts
          and all(spills[i][1] == 0 for i in default_insts),
          f"flash_attention: no spill at the default tile {flash_default}")
    # with no committed table every wrapper resolves to the tile it had
    backend = tuning.backend_of(dev)
    for kernel, shape in (("sketch_fused", (k, d, n)),
                          ("blocked_fwht", (65_536, 8_192)),
                          ("sampled_dot", (n, n, k, m)),
                          ("flash_attention", (HEADS, S_FULL, HEAD_DIM))):
        cfg = tuning.lookup(kernel, shape, backend=backend)
        print(f"tuning.lookup {kernel} {shape} on {backend}: {cfg.block} "
              f"(table {os.path.relpath(tuning.table_path(backend), ROOT)}"
              f"{'' if os.path.exists(tuning.table_path(backend)) else ', absent'})",
              flush=True)
        check(cfg == tuning.DEFAULTS[kernel]
              and cfg.block in tuning.TILE_MENUS[kernel],
              f"{kernel} resolves to its compiled default tile")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # draws for the block-mode and uniform-draw checks, apart so that gen's
    # stream (A, B and the probes' W) is the same with or without them
    aux = torch.Generator(device=dev)
    aux.manual_seed(args.seed + 1)
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

    # kernel 3 against its plain version, at the SRHT pass's call shape
    width = summary_engine.SRHT_COLUMN_BLOCK
    signs, plan_rows, dp = summary_engine.srht_plan(k_sketch, d, k)
    X3 = A[:, :width]                      # a column slice of A, row stride n
    fwht_check(ops, X3, signs, dp, "call shape")
    fwht_check(ops, X3.to(torch.bfloat16), signs, dp, "call shape")
    fwht_check(ops, A[:200, :4096], signs[:200], 256, "one pass")
    fwht_check(ops, A[:777, :1001], signs[:777], 1024, "ragged n")
    # its SRHT block mode, which the SRHT path launches
    err_fwht, _ = srht_block_check(ops, X3, signs, plan_rows, dp,
                                   "call shape")
    srht_block_check(ops, X3.to(torch.bfloat16), signs, plan_rows, dp,
                     "call shape")
    few = torch.randperm(256, generator=aux, device=dev)[:128].int()
    srht_block_check(ops, A[:200, :4096], signs[:200], few, 256, "one pass")
    few = torch.randperm(1024, generator=aux, device=dev)[:k].int()
    srht_block_check(ops, A[:777, :1001], signs[:777], few, 1024, "ragged n")

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
          f"wall, launches {launches}, peak memory {peak_gb:.3f} GB",
          flush=True)
    check(launches == {"sketch_fused": 2, "sampled_rescaled_dot": 1,
                       "blocked_fwht": 0, "flash_attention": 0},
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
    stages, summary, samples, values = staged_run(key, A, B, k, m, r, T, n,
                                                  "gaussian", dev)
    check(bool(torch.equal(samples.rows, res.samples.rows)),
          "staged run draws the main path's sample")
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
    small_pair_check(smppca, spectral_error_vs_optimal, args.seed, r, dev,
                     "gaussian")

    # 5. kernel 2 against its plain version ---------------------------------
    As_rows = summary.A_sketch.T.contiguous()
    Bs_rows = summary.B_sketch.T.contiguous()
    na, nb = summary.norm_A, summary.norm_B
    err_sampled = sampled_check(ops, As_rows, Bs_rows, na, nb,
                                samples.rows, samples.cols,
                                f"the slice's draw, m={m}")
    uni_rows, uni_cols = (torch.randint(0, n, (m,), generator=aux,
                                        device=dev, dtype=torch.int32)
                          for _ in range(2))
    sampled_check(ops, As_rows, Bs_rows, na, nb, uni_rows, uni_cols,
                  f"uniform rows and cols, m={m}")
    empty = samples.rows[:0]
    sampled_check(ops, As_rows, Bs_rows, na, nb, empty, empty, "m=0")
    dup_r = samples.rows[:64].repeat(4)
    dup_c = samples.cols[:64].repeat(4)
    sampled_check(ops, As_rows, Bs_rows, na, nb, dup_r, dup_c, "duplicates")

    # 6. timings at the slice's shapes --------------------------------------
    sk = ops.KERNELS["sketch_fused"]
    k1_ms, k1_plain = turns(lambda: sk.plain(Pi, A),
                            lambda: ops.sketch_fused(Pi, A), reps=2)
    torch.matmul(Pi, A)                   # the library's first call
    k1_lib = cuda_ms(lambda: torch.matmul(Pi, A), reps=2)
    # float32 inputs: three TF32 tensor-core passes of 2kdn FLOP (the 2dn
    # of the norms run beside them on the FMA units); bytes: Pi and A read
    # once, the sketch and norms written once
    k1_bytes = 4.0 * (k * d + d * n + k * n + n)
    k1_bound, k1_by = bound(3 * 2.0 * k * d * n, k1_bytes, PEAK_TF32_FLOPS)
    k1_fma = bound(2.0 * k * d * n + 2.0 * d * n, k1_bytes,
                   PEAK_F32_FLOPS)[0]
    print(f"sketch_fused bounds: {k1_bound:.3f} ms on the TF32 tensor cores "
          f"(three passes, {k1_by}); {k1_fma:.3f} ms on the float32 FMA "
          f"units; {1e3 * k1_bytes / HBM_BW:.3f} ms for the bytes",
          flush=True)
    sd = ops.KERNELS["sampled_rescaled_dot"]
    rows, cols = samples.rows, samples.cols
    k2_ms, k2_plain = turns(
        lambda: sd.plain(As_rows, Bs_rows, na, nb, rows, cols),
        lambda: ops.sampled_rescaled_dot(As_rows, Bs_rows, na, nb, rows,
                                         cols), reps=2)
    # the function's least work: one k-term dot product and five scalar
    # operations per sample, and each sketch row's squared norm once
    k2_bound, k2_by = bound(m * (2.0 * k + 5.0) + 2.0 * (2 * n) * k,
                            4.0 * (2 * n * k + 2 * n) + 12.0 * m,
                            PEAK_F32_FLOPS)
    # the same m drawn uniform on both sides, on the same sketches
    k2u_ms, k2u_plain = turns(
        lambda: sd.plain(As_rows, Bs_rows, na, nb, uni_rows, uni_cols),
        lambda: ops.sampled_rescaled_dot(As_rows, Bs_rows, na, nb, uni_rows,
                                         uni_cols), reps=2)
    # one B row a sample read from L2, at the card's L2 read rate measured
    # here (all SMs reading a 16 MB buffer with loads that skip L1)
    l2_gbps = kernel_probe.l2_read_gbps()
    k2_l2 = 1e3 * m * k * 4.0 / (l2_gbps * 1e9)
    print("timing sampled_rescaled_dot draws " + json.dumps({
        "slice_ms": k2_ms, "uniform_ms": k2u_ms, "uniform_plain_ms": k2u_plain,
        "bound_ms": k2_bound, "l2_read_gbps": l2_gbps,
        "one_B_row_per_sample_from_L2_ms": k2_l2}), flush=True)
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
    del res, summary, samples, values, rows, cols, As_rows, Bs_rows
    del uni_rows, uni_cols

    # kernel 1 with bf16 inputs: one TF32 pass; the least time is the bf16
    # tensor cores' (this design's TF32 instruction has half their rate)
    Pi16, A16 = Pi.to(torch.bfloat16), A.to(torch.bfloat16)
    k1b_ms, k1b_plain = turns(lambda: sk.plain(Pi16, A16),
                              lambda: ops.sketch_fused(Pi16, A16), reps=2)
    k1b_bytes = 2.0 * (k * d + d * n) + 4.0 * (k * n + n)
    k1b_bound, k1b_by = bound(2.0 * k * d * n, k1b_bytes, PEAK_BF16_FLOPS)
    torch.matmul(Pi16, A16)
    t = dict(kernel_ms=k1b_ms, plain_ms=k1b_plain,
             library_ms=cuda_ms(lambda: torch.matmul(Pi16, A16), reps=2),
             bound_ms=k1b_bound, bound_by=k1b_by,
             tf32_one_pass_ms=bound(2.0 * k * d * n, k1b_bytes,
                                    PEAK_TF32_FLOPS)[0])
    print("timing sketch_fused bf16 " + json.dumps(t), flush=True)
    del Pi, Pi16, A16
    torch.cuda.empty_cache()

    # 7. the SRHT path at full width ----------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = smppca(key, A, B, r=r, k=k, m=m, T=T, method="srht", device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches_srht = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    blocks = -(-n // width)
    print(f"smppca srht d={d} (dp={dp}) n1=n2={n} k={k} r={r} m={m} T={T}: "
          f"{wall_s:.3f} s wall, launches {launches_srht} ({blocks} column "
          f"blocks of {width} per matrix), peak memory {peak_gb:.3f} GB",
          flush=True)
    check(launches_srht == {"sketch_fused": 0, "sampled_rescaled_dot": 1,
                            "blocked_fwht": 2 * blocks, "flash_attention": 0},
          f"launches per smppca(method='srht') call: {launches_srht}")
    check(peak_gb < SRHT_PEAK_GB_MAX, f"srht peak memory {peak_gb} GB")
    U, V = res.factors
    check(tuple(U.shape) == (n, r) and tuple(V.shape) == (n, r),
          "srht factor shapes")
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all()),
          "srht factors finite")
    resid = probe_residual(A, B, res.factors, gen)
    print(f"srht probe residual: {resid:.4f} (threshold "
          f"{PROBE_RESIDUAL_MAX})", flush=True)
    check(resid < PROBE_RESIDUAL_MAX, f"srht probe residual {resid}")
    stages, _, samples, _ = staged_run(key, A, B, k, m, r, T, n, "srht", dev)
    check(bool(torch.equal(samples.rows, res.samples.rows)),
          "staged srht run draws the main path's sample")
    print("stages_ms_srht " + json.dumps(stages), flush=True)
    del res, samples
    split = srht_step1_split(ops, summary_engine, key, A, B, k, dev)
    split["rest_ms"] = stages["sketch"] - split["plan_ms"] \
        - split["block_calls_ms"]
    print("srht_step1_split " + json.dumps(split), flush=True)
    small_pair_check(smppca, spectral_error_vs_optimal, args.seed, r, dev,
                     "srht")

    # 8. kernel 3's timing at its call shape --------------------------------
    # the SRHT block mode, which the SRHT path launches, beside its plain
    # version, the full mode and the composition the block mode replaced
    fw = ops.KERNELS["blocked_fwht"]
    k3_ms, k3_plain = turns(
        lambda: fw.plain_block(X3, signs, plan_rows, dp),
        lambda: ops.srht_block(X3, signs, plan_rows, d_pad=dp), reps=3)
    X3b = X3.to(torch.bfloat16)
    ops.srht_block(X3b, signs, plan_rows, d_pad=dp)
    k3b_ms = cuda_ms(lambda: ops.srht_block(X3b, signs, plan_rows, d_pad=dp),
                     3)
    full = lambda: ops.blocked_fwht(X3, signs, d_pad=dp)
    full()
    full_ms = cuda_ms(full, 3)
    comp = lambda: srht_composition(ops, X3, signs, plan_rows, dp, k, width)
    comp()
    comp_ms = cuda_ms(comp, 3)
    # the block mode's least work: each valid input row and sign read once,
    # the k sampled rows and the norms written once, dp log2(dp) adds a
    # column (the full mode writes all dp rows)
    adds = dp * math.log2(dp) * width
    k3_bound, k3_by = bound(adds, 4.0 * (d * width + d + k * width + width),
                            PEAK_F32_FLOPS)
    k3b_bound = bound(adds, 2.0 * d * width + 4.0 * (d + k * width + width),
                      PEAK_F32_FLOPS)[0]
    full_bound = bound(adds, 4.0 * (d * width + d + dp * width),
                       PEAK_F32_FLOPS)[0]
    # no single PyTorch call computes a Walsh-Hadamard transform
    timing["blocked_fwht"] = dict(kernel_ms=k3_ms, plain_ms=k3_plain,
                                  library_ms=None, bound_ms=k3_bound,
                                  bound_by=k3_by, bf16_ms=k3b_ms,
                                  bf16_bound_ms=k3b_bound, full_mode_ms=full_ms,
                                  full_mode_bound_ms=full_bound,
                                  composition_ms=comp_ms)
    print("timing blocked_fwht " + json.dumps(timing["blocked_fwht"]),
          flush=True)
    del X3b

    del A, B, X3, signs, plan_rows
    torch.cuda.empty_cache()

    # 9. kernel 4 against its plain version ---------------------------------
    fa = ops.KERNELS["flash_attention"]
    for shape in ((1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 512, 2, 1, 128),
                  (1, 384, 3, 3, 64)):       # tests/kernels/test_flash_attention.py
        B_, S_, H_, Hkv_, Dh_ = shape
        q, kk, v = attention_inputs(gen, S_, H_, Hkv_, Dh_, dev, batch=B_)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for block in tuning.TILE_MENUS["flash_attention"]:
                    flash_check(ops, q.to(dtype), kk.to(dtype), v.to(dtype),
                                causal, f"JAX test shape, tile {block}",
                                config=tuning.KernelConfig("flash_attention",
                                                           block))
    q, kk, v = attention_inputs(gen, S_TRAIN, HEADS, KV_HEADS, HEAD_DIM, dev)
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            flash_check(ops, q.to(dtype), kk.to(dtype), v.to(dtype), causal,
                        f"S={S_TRAIN}")

    # 10. the attention path at full width ----------------------------------
    q, kk, v = attention_inputs(gen, S_FULL, HEADS, KV_HEADS, HEAD_DIM, dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = ops.flash_attention(q, kk, v, causal=True)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches_flash = dict(ops.LAUNCHES)
    print(f"flash_attention granite-3-8b layer, S={S_FULL}, {HEADS}/{KV_HEADS} "
          f"heads of {HEAD_DIM}, causal, float32: {wall_s:.3f} s wall (first "
          f"call), launches {launches_flash}", flush=True)
    check(launches_flash == {"sketch_fused": 0, "sampled_rescaled_dot": 0,
                             "blocked_fwht": 0, "flash_attention": 1},
          f"launches per attention call: {launches_flash}")
    check(tuple(out.shape) == tuple(q.shape) and bool(torch.isfinite(out).all()),
          "attention output shape and finite")
    err_flash = flash_check(ops, q, kk, v, True, "full width", out=out)
    del out
    flash_check(ops, q.to(torch.bfloat16), kk.to(torch.bfloat16),
                v.to(torch.bfloat16), True, "full width")
    flash_check(ops, q, kk, v, False, "full width")
    flash_check(ops, q.to(torch.bfloat16), kk.to(torch.bfloat16),
                v.to(torch.bfloat16), False, "full width")

    # 11. kernel 4's timings ------------------------------------------------
    # every compiled tile at the full width, float32 and bf16, one call each
    # after a warm-up (the tuner below measures only its model's best three)
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dtype) for x in (q, kk, v))
        for block in tuning.TILE_MENUS["flash_attention"]:
            cfg = tuning.KernelConfig("flash_attention", block)
            ops.flash_attention(qd, kd, vd, config=cfg)
            ms = cuda_ms(lambda: ops.flash_attention(qd, kd, vd, config=cfg), 1)
            print(f"tile flash_attention S={S_FULL} {block} "
                  f"{str(dtype).split('.')[-1]}: {ms:.3f} ms", flush=True)
        del qd, kd, vd
    for S_, reps in ((S_FULL, 1), (S_TRAIN, 5)):
        if S_ != S_FULL:
            q, kk, v = attention_inputs(gen, S_, HEADS, KV_HEADS, HEAD_DIM, dev)
        # causal: half the S x S scores of each head, two products each;
        # q, k, v read once and o written once
        flops = 2.0 * HEADS * S_ * S_ * HEAD_DIM
        elems = (2 * S_ * HEADS + 2 * S_ * KV_HEADS) * HEAD_DIM
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (x.to(dtype) for x in (q, kk, v))
            size = qd.element_size()
            k4_ms, k4_plain = turns(lambda: fa.plain(qd, kd, vd, True),
                                    lambda: ops.flash_attention(qd, kd, vd),
                                    reps=reps)
            lib = sdpa_call(qd, kd, vd)
            lib()
            tf32_ms = bound(fa.PASSES[size] * flops, size * elems,
                            PEAK_TF32_FLOPS)
            if size == 4:
                # float32-accurate: three split passes on the TF32 tensor
                # cores; the FMA units alone beside it
                (k4_bound, k4_by), extra = tf32_ms, dict(
                    tf32_passes=fa.PASSES[4],
                    fma_units_ms=bound(flops, size * elems,
                                       PEAK_F32_FLOPS)[0])
            else:
                # bf16 inputs: the bf16 tensor cores' rate; this design's
                # two TF32 passes beside it
                k4_bound, k4_by = bound(flops, size * elems, PEAK_BF16_FLOPS)
                extra = dict(tf32_two_pass_ms=tf32_ms[0])
            t = dict(S=S_, kernel_ms=k4_ms, plain_ms=k4_plain,
                     library_ms=cuda_ms(lib, reps=reps), bound_ms=k4_bound,
                     bound_by=k4_by, **extra)
            tag = "" if dtype == torch.float32 else " bf16"
            print(f"timing flash_attention{tag} " + json.dumps(t), flush=True)
            if S_ == S_FULL and dtype == torch.float32:
                timing["flash_attention"] = t
            del qd, kd, vd, lib
    del q, kk, v
    torch.cuda.empty_cache()

    # 12. the kernel tuner --------------------------------------------------
    ops.reset_launch_counts()
    for kernel, shapes in TUNE_SHAPES.items():
        for shape in shapes:
            winner, records = tuning.autotune(kernel, shape, measure_top=3,
                                              device=dev)
            for rec in records:
                print(f"tune {kernel} {shape} {rec['config']}: us_per_call="
                      f"{rec['us_per_call']:.2f} achieved_gbps="
                      f"{rec['achieved_gbps']:.2f} model_us="
                      f"{rec['t_total'] * 1e6:.2f}", flush=True)
            print(f"tune {kernel} {shape} winner {winner.tag()}", flush=True)
    launches_tune = dict(ops.LAUNCHES)
    print(f"tuner launches {launches_tune}", flush=True)
    check(all(launches_tune[name] > 0 for name in ops.KERNELS),
          f"the tuner launched every kernel: {launches_tune}")

    # 13. the kernels line and the last line --------------------------------
    errs = {"sketch_fused": err_sketch, "sampled_rescaled_dot": err_sampled,
            "blocked_fwht": err_fwht, "flash_attention": err_flash}
    # each kernel's launches on the path that runs it: the Gaussian path
    # for kernels 1 and 2, the SRHT path for kernel 3, the attention call
    # for kernel 4
    path_launches = dict(launches, blocked_fwht=launches_srht["blocked_fwht"],
                         flash_attention=launches_flash["flash_attention"])
    kernels = []
    for name, mod in ops.KERNELS.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{mod.SOURCE}",
            "replaces": mod.REPLACES, "launches": path_launches[name],
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
