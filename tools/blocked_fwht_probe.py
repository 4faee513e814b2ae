#!/usr/bin/env python3
"""Where the time of ``blocked_fwht.cu`` goes on the card: the full mode,
the SRHT block mode in its two forms, and variants of each made by editing
the source's text, at the SRHT pass's call shape.

    python3 tools/blocked_fwht_probe.py [--seed 0] [--variants a,b,...]

The call shape: an 8,192-column slice of a (50,000, 100,000) float32
matrix (row stride 100,000), dp = 65,536, k = 512 sampled rows.

* ``full``: ``hadamard.launch``, the (dp, 8,192) transform;
* ``full+gather+norms``: what the SRHT pass ran per block before the block
  mode: the full transform, the k-row gather and rescale, ``column_norms``;
* ``cluster`` and ``two_pass``: the block mode's two forms as committed,
  timed in turns (two_pass, cluster, cluster, two_pass); ``cluster`` is
  the form the call shape takes: a thread block cluster a strip of
  columns, the intermediate in the cluster's shared memory; ``two_pass``
  sends it through device memory;
* variants of the cluster form, the source's constants edited (committed:
  8 columns a strip, clusters of 8, 512 threads, runs of 8 rows, 3 TMA
  stages, a persistent grid, 256-byte L2 promotion): ``one_wave`` (one
  cluster a strip, all launched at once), ``run16`` (runs of 16 rows:
  half the phase-1 threads, one span more in phase 1), ``run16_256``
  (that at 256 threads and one cluster a strip), ``threads384``,
  ``stages2``, ``c4n8`` (4 columns a strip: 16-byte rows), ``c8n16``
  (clusters of 16, non-portable: half the intermediate a CTA, 12 TMA
  stages, runs of 16), ``promo_none`` and ``promo_128`` (the tensor map's
  L2 promotion); and, not checked, ``phase1_only`` (no phase 2),
  ``no_z`` (phase 1's results not stored to their owners), ``p1_no_z``
  (both) and ``stream_only`` (phase 1's TMA stream and the tiles' reads
  alone); a cluster variant's line gives the clusters the card holds at
  once (``slots``);
* variants of the two-pass form, as the earlier design was probed
  (``kernel`` below is ``two_pass``):
* ``chunkC``: the columns taken C at a time through all passes, through
  one reused (dp, C) scratch buffer (C = 128 is 32 MB, which L2 holds);
* ``l2window``, ``l2window_chunkC``: the same with a persisting-L2 access
  window (``cudaAccessPolicyWindow``) over the scratch for the call;
* ``no_skip``: last-pass groups without a sampled row are transformed
  too; ``no_norms``: pass 1 without the norms; ``double_sums``: a
  thread's squares summed in float64 too (the source sums them in float32,
  the CTA's and the groups' sums in float64); ``pass1_only``: the block
  mode's first pass alone (and the norms' last step);
* ``cta_any``, ``cta4``: launch bounds that ask for no minimum of CTAs an
  SM (the compiler's own register count) or for 4 (32 registers a thread),
  in place of the source's 3 (40);
* ``loads_first``: the last pass issues its loads before it looks for the
  group's sampled rows (and reads every group);
* ``last_pass_cta4``: launch bounds that ask for 4 CTAs an SM in the last
  pass only.

The variants that compute the full function are checked against the plain
composition (the sketch bit for bit; the norms' largest relative error
printed). Float32, and bf16 input for the forms, the chunks and the
windows. One JSON line per variant (its time, the bound, the bound's bytes
and the rate they make), with the card's name and power limit first; needs
a CUDA card and ``nvcc``. Builds go to ``build/repro_torch/probe/``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tools")]

from kernel_probe import build, card, cuda_ms, edit as _edit  # noqa: E402
from repro_torch.core.sketch import _sqrt_f32, column_norms  # noqa: E402
from repro_torch.kernels import hadamard, ops  # noqa: E402
from repro_torch.roofline.analysis import HBM_BW  # noqa: E402

edit = functools.partial(_edit, source=hadamard.SOURCE)

WINDOW_ON = r'''  {
    int max_window = 0, max_persist = 0;
    cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, 0);
    cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize, 0);
    const size_t bytes = ((size_t)(chunk < ncols ? chunk : ncols) * 4) << log_dp;
    const size_t win = bytes < (size_t)max_window ? bytes : (size_t)max_window;
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, (size_t)max_persist);
    cudaStreamAttrValue attr = {};
    attr.accessPolicyWindow.base_ptr = scratch;
    attr.accessPolicyWindow.num_bytes = win;
    attr.accessPolicyWindow.hitRatio =
        win <= (size_t)max_persist ? 1.0f : (float)max_persist / (float)win;
    attr.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &attr);
  }
'''
WINDOW_OFF_AT = "  norms_finish<<<"
WINDOW_OFF = r'''  {
    cudaStreamAttrValue attr = {};
    attr.accessPolicyWindow.num_bytes = 0;
    cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &attr);
    cudaCtxResetPersistingL2Cache();
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);  // L2 whole again
  }
'''


# run_block taking the columns CHUNK at a time through all passes, one
# reused (dp, CHUNK) scratch buffer (the caller's scratch is larger)
CHUNKED = r'''template <typename Tin>
int run_block(const Tin* X, int64_t ld, const float* signs, int64_t d_valid,
              int64_t log_dp, const int32_t* rows, int64_t k, float root_dp,
              float root_dp_k, float* sketch, int64_t ld_sketch, float* norms,
              int64_t ncols, float* scratch, double* partial, void* stream) {
  const int64_t chunk = CHUNK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int log_l[8];
  const int passes = split(log_dp, log_l);
  const int64_t groups1 = (d_valid + (1 << log_l[0]) - 1) >> log_l[0];
  for (int64_t c0 = 0; c0 < ncols; c0 += chunk) {
    PassArgs a = {};
    a.signs = signs;
    a.d_valid = d_valid;
    a.ncols = ncols - c0 < chunk ? ncols - c0 : chunk;
    a.out = scratch;
    a.ld_out = a.ncols;
    a.partial = partial + c0;
    a.ld_partial = ncols;
    a.rows = rows;
    a.k = k;
    a.root_dp = root_dp;
    a.root_dp_k = root_dp_k;
    a.sketch = sketch + c0;
    a.ld_sketch = ld_sketch;
    a.stride = 1;
    for (int p = 0; p < passes; ++p) {
      const int64_t groups = (int64_t)1 << (log_dp - log_l[p]);
      const bool last = p == passes - 1;
      int err;
      if (p == 0) {
        a.in = X + c0;
        a.ld_in = ld;
        err = last ? launch_pass<READ_X | NORMS | SAMPLED, Tin>(log_l[p], a,
                                                                groups, s)
                   : launch_pass<READ_X | NORMS, Tin>(log_l[p], a, groups, s);
      } else {
        a.in = scratch;
        a.ld_in = a.ncols;
        err = last ? launch_pass<SAMPLED, float>(log_l[p], a, groups, s)
                   : launch_pass<0, float>(log_l[p], a, groups, s);
      }
      if (err) return err;
      a.stride <<= log_l[p];
    }
  }
WINDOW  norms_finish<<<(unsigned)((ncols + 255) / 256), 256, 0, s>>>(
      partial, groups1, ncols, norms);
  return (int)cudaGetLastError();
}
'''


def chunked(n: int, window: bool = False):
    """run_block replaced by CHUNKED with CHUNK = n, and with a
    persisting-L2 window on the scratch when ``window``."""
    def variant(text: str) -> str:
        start = text.index("template <typename Tin>\nint run_block(")
        end = text.index("\n}\n", start) + 3
        body = CHUNKED.replace("CHUNK;", f"{n};").replace(
            "WINDOW", WINDOW_OFF if window else "")
        if window:
            body = body.replace("  for (int64_t c0 = 0;",
                                WINDOW_ON + "  for (int64_t c0 = 0;")
        return text[:start] + body + text[end:]
    return variant


def pass1_only(text: str) -> str:
    return edit(text, "    const bool last = p == passes - 1;\n",
                "    if (p > 0) break;\n    const bool last = p == passes - 1;\n")


def no_norms(text: str) -> str:
    return edit(text, "(MODE & NORMS) != 0", "false")


def ctas_per_sm(n: int):
    """Launch bounds that ask for n CTAs an SM (the registers a thread may
    use shrink to fit); 0: no minimum."""
    bounds = "__launch_bounds__(Radix<LOG_L>::THREADS, MIN_CTAS)"
    return lambda text: edit(text, bounds, bounds.replace(
        "MIN_CTAS", str(n)) if n else bounds.replace(", MIN_CTAS", ""))


SAMPLED_SCAN = """  if constexpr ((MODE & SAMPLED) != 0 && (MODE & NORMS) == 0) {
    bool mine = false;  // does this group hold a sampled row?
    for (int64_t j = threadIdx.x; j < a.k; j += Rd::THREADS)
      mine |= (a.rows[j] & (a.stride - 1)) == group;
    if (!__syncthreads_or(mine)) return;  // uniform across the CTA
  }
"""
NORM_SUMS = "  if constexpr ((MODE & NORMS) != 0) {\n    // a thread's"


def loads_first(text: str) -> str:
    """The last pass issues its loads before it looks for sampled rows."""
    text = edit(text, SAMPLED_SCAN, "")
    return edit(text, NORM_SUMS, SAMPLED_SCAN + NORM_SUMS)


def double_sums(text: str) -> str:
    """A thread's squares summed in float64 too."""
    text = edit(text, "  float ss = 0.f;", "  double ss = 0.0;")
    return edit(text, "ss = fmaf(xi, xi, ss);", "ss += (double)xi * (double)xi;")


def sampled_ctas(n: int):
    """Launch bounds that ask for n CTAs an SM in the last pass only."""
    bounds = "__launch_bounds__(Radix<LOG_L>::THREADS, MIN_CTAS)"
    return lambda text: edit(text, bounds, bounds.replace(
        "MIN_CTAS", f"MODE == SAMPLED ? {n} : MIN_CTAS"))


def no_skip(text: str) -> str:
    return edit(text, "if (!__syncthreads_or(mine)) return;",
                "(void)__syncthreads_or(mine);")


def constants(**values):
    """The cluster form's constants set to ``values`` (name: C++ literal)."""
    def variant(text: str) -> str:
        for name, value in values.items():
            text = re.sub(rf"(constexpr \w+ {name} =)[^;]*;",
                          rf"\g<1> {value};", text, count=1)
        return text
    return variant


def phase1_only(text: str) -> str:
    for loop in ("e < E; e += CT)", "const int nm = *n_m;",
                 "i < off[LO]; i += CT)"):
        text = edit(text, loop, {"e < E; e += CT)": "e < 0; e += CT)",
                                 "const int nm = *n_m;": "const int nm = 0;",
                                 "i < off[LO]; i += CT)": "i < 0; i += CT)",
                                 }[loop])
    return text


def no_z(text: str) -> str:
    """Phase 1's results not stored to their owners."""
    return edit(text, "st_cluster(zr[i % N] + at + 16u * (i / N) * C, v[i]);",
                "(void)at;")


def stream_only(text: str) -> str:
    """Phase 1's TMA stream and the consumers' reads of the tiles, and
    nothing else."""
    return phase1_only(edit(text, "      float ss = 0.f;\n",
                            "      return;\n      float ss = 0.f;\n"))


# variant: (source edit, form, checked against the plain composition)
VARIANTS = {
    "two_pass": (lambda t: t, "two_pass", True),
    "cluster": (lambda t: t, "cluster", True),
    "one_wave": (constants(CLUSTER_PERSISTENT="false"), "cluster", True),
    "run16": (constants(CLUSTER_LOG_RUN=4), "cluster", True),
    "run16_256": (constants(CLUSTER_LOG_RUN=4, CLUSTER_THREADS=256,
                            CLUSTER_PERSISTENT="false"), "cluster", True),
    "threads384": (constants(CLUSTER_THREADS=384), "cluster", True),
    "stages2": (constants(CLUSTER_STAGES=2), "cluster", True),
    "c4n8": (constants(CLUSTER_COLS=4), "cluster", True),
    "c8n16": (constants(CLUSTER_CTAS=16, CLUSTER_STAGES=12,
                        CLUSTER_LOG_RUN=4), "cluster", True),
    "promo_none": (constants(
        TMA_PROMOTION="CU_TENSOR_MAP_L2_PROMOTION_NONE"), "cluster", True),
    "promo_128": (constants(
        TMA_PROMOTION="CU_TENSOR_MAP_L2_PROMOTION_L2_128B"), "cluster", True),
    "phase1_only": (phase1_only, "cluster", False),
    "no_z": (no_z, "cluster", False),
    "p1_no_z": (lambda t: phase1_only(no_z(t)), "cluster", False),
    "stream_only": (stream_only, "cluster", False),
    **{f"chunk{n}": (chunked(n), "two_pass", True)
       for n in (1024, 256, 128, 64)},
    "loads_first": (loads_first, "two_pass", True),
    "last_pass_cta4": (sampled_ctas(4), "two_pass", True),
    "cta_any": (ctas_per_sm(0), "two_pass", True),
    "cta4": (ctas_per_sm(4), "two_pass", True),
    "no_skip": (no_skip, "two_pass", True),
    "no_norms": (no_norms, "two_pass", False),
    "double_sums": (double_sums, "two_pass", True),
    "pass1_only": (pass1_only, "two_pass", False),
    # last: a window's persisting carve-out slows whatever runs while it
    # is set
    "l2window": (chunked(8192, window=True), "two_pass", True),
    **{f"l2window_chunk{n}": (chunked(n, window=True), "two_pass", True)
       for n in (256, 128)},
}
# the variants also timed with bf16 input (c4n8's 8-byte bf16 rows take
# element copies: TMA wants 16)
BF16 = ("two_pass", "cluster", "one_wave", "run16", "c8n16",
        "chunk1024", "chunk256", "chunk128", "chunk64", "l2window",
        "l2window_chunk256", "l2window_chunk128")
# timed in turns against each other: two_pass, cluster, cluster, two_pass
TURNS = ("two_pass", "cluster")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to build and time "
                         "(default: all)")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("blocked_fwht_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    text = (ops.CSRC / hadamard.SOURCE).read_text()
    libs = build({name: VARIANTS[name][0](text) for name in names},
                 prefix="fwht_")
    for lib in libs.values():
        hadamard.bind(lib)
    print(f"card: {card()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    d, n, w, k = 50_000, 100_000, 8192, 512
    dp = 65_536
    A = torch.randn(d, n, generator=gen, device=dev)
    signs = torch.randint(0, 2, (d,), generator=gen, device=dev) * 2.0 - 1
    rows = torch.randperm(dp, generator=gen, device=dev)[:k].int()
    root_dp, root_dp_k = _sqrt_f32(dp), _sqrt_f32(dp / k)
    print(json.dumps({"call_shape": {"d": d, "dp": dp, "columns": w, "k": k,
                                     "row_stride": n}}), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        X = A.to(dtype)[:, :w]                 # row stride n in either type
        tag = str(dtype).split(".")[-1]
        # X and signs read once, k rows and w norms written once
        nbytes = X.element_size() * d * w + 4.0 * (d + k * w + w)
        bound_ms = 1e3 * nbytes / HBM_BW
        lib = libs[names[0]]
        rdp, rdpk = root_dp.to(dev), root_dp_k.to(dev)

        def composition():
            HX = hadamard.launch(lib, X, signs, dp)
            return (HX[rows.long()] / rdp) * rdpk, column_norms(X)
        want_s, _ = hadamard.plain_block(X, signs, rows, dp)
        ref_n = column_norms(X)
        print(json.dumps({"variant": "full", "dtype": tag, "ms": cuda_ms(
            lambda: hadamard.launch(lib, X, signs, dp), 5)}), flush=True)
        print(json.dumps({"variant": "full+gather+norms", "dtype": tag,
                          "ms": cuda_ms(composition, 5)}), flush=True)
        def caller(name, sketch, norms):
            form = VARIANTS[name][1]
            return lambda: hadamard.launch_block(
                libs[name], X, signs, rows, dp, float(root_dp),
                float(root_dp_k), sketch, norms, form=form)
        turns = [v for v in TURNS if v in names]
        times = {}
        if len(turns) == 2:
            calls = {v: caller(v, torch.empty((k, w), device=dev),
                               torch.empty((w,), device=dev)) for v in turns}
            for v in turns:
                calls[v]()
            for v in turns + turns[::-1]:
                times.setdefault(v, []).append(cuda_ms(calls[v], 5))
        for name in names:
            checked = VARIANTS[name][2]
            if dtype != torch.float32 and name not in BF16:
                continue
            sketch = torch.empty((k, w), device=dev)
            norms = torch.empty((w,), device=dev)
            call = caller(name, sketch, norms)
            call()
            torch.cuda.synchronize()
            ms = (sum(times[name]) / len(times[name]) if name in times
                  else cuda_ms(call, 5))
            rec = {"variant": name, "form": VARIANTS[name][1], "dtype": tag,
                   "ms": ms, "bound_ms": bound_ms, "bound_bytes": nbytes,
                   "bound_gbps": nbytes / ms / 1e6}
            if name in times:
                rec["turns_ms"] = times[name]
            if VARIANTS[name][1] == "cluster":
                rec["slots"] = hadamard.cluster_slots(libs[name], d, dp,
                                                      dtype, k)
            if checked:
                rec["sketch_equal"] = bool(torch.equal(sketch, want_s))
                rec["norm_rel_err"] = float(
                    ((norms - ref_n).abs() / ref_n).max())
            print(json.dumps(rec), flush=True)
        del X, want_s, ref_n
    return 0


if __name__ == "__main__":
    sys.exit(main())
