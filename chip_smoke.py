#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases, each failing the script (non-zero exit, no final line) when it
fails; nothing is caught:

1. card: the card's name and power limit, from nvidia-smi;
2. build: the four CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   nvcc per source, started together, with each kernel's register report,
   the count of tensor-core instructions in each instance of kernels 1 and
   4 (``sketch_fused`` and ``flash_attention``): ``HMMA`` (``mma.sync``),
   which must be positive in kernel 4's ``mma.sync`` instances and absent
   from kernel 1, ``HGMMA`` (``wgmma``) and ``UTMALDG`` (TMA loads), which
   must be positive in both of kernel 1's instances and in kernel 4's
   float32 and bf16 Dh 64, 96 and 128 ones (``flash_fwd_wgmma<Dh, M>``
   and ``flash_fwd_wgmma_bf16<Dh, M>``, M true for the masked twin that
   a call with ``kv_len`` below S runs; the prologues
   ``sketch_pi_small`` and ``flash_vt<Dh>`` have neither), kernel 1's
   float32 instance's registers, spills and shared memory beside the
   clusters of each of its instances the card holds, kernel 4's
   registers and spills per instance, the registers within the tuner's
   ``flash_attention.REGISTERS``, no spill at its
   default tile nor in any Dh 16 or 256 instance (26 ``mma.sync``
   instances: 2 bq x 2 bk x Dh 16, 32 and 112, and (64, 32) at Dh 256, x
   2 dtypes), each wgmma instance (and each float32 one's prologue) at
   ``flash_attention.WGMMA_REGISTERS`` and without a spill, with its form
   and shared memory, no ``wgmma`` serialised (ptxas's C7511, C7512,
   C7517, C7518), the build's seconds,
   and the tile each kernel resolves to through ``tuning.lookup`` (Dh 256:
   its own (64, 32));
3. kernel 1 (``sketch_fused``) against its plain PyTorch version at d =
   50,000 and k = 512 on a column slice, in float32 and bf16, and on a
   ragged shape, and kernel 1's float32 prologue (Pi's small parts) equal
   to its plain version; kernel 3 (``blocked_fwht``) against its plain version at
   the SRHT pass's call shape (d = 50,000 padded to 65,536 on an
   8,192-column slice), in float32 and bf16, in one pass (d <= 256) and on
   a ragged n, in its full mode and in the SRHT block mode that the SRHT
   path launches (the k = 512 plan rows, equal bit for bit; the norms
   within ``NORM_RTOL``; a second call equal to the first);
4. the Gaussian path at full width: SMP-PCA
   (``repro_torch.core.smppca.smppca``, a plan run through the shared
   ``PipelineEngine``) of a planted pair with d = 50,000, n1 = n2 =
   100,000, k = 512, r = 5, m = default_m(1e5, 1e5, 5) = 57,564,627, T =
   10, through kernels 1 and 2 (launch counters set to 0 before the run and
   read after it); the first call builds one cache entry, a second
   identical call is a hit that builds nothing, with its wall time, its
   factors within ``WARM_UVT_TOL`` of the first's and both peaks within
   ``PHASE4_PEAK_GB_MAX``; per-stage times from a staged run, with the cost of the
   sampler's host-side CDF; a probe-estimated relative residual against
   its threshold; and the same SMP-PCA on card and CPU at a small size,
   which must agree; the first run makes no aligned copy, and both
   ``sketch_fused`` calls of the staged run are held against the plain
   version on their first ``BF16_HELD_COLUMNS`` columns (``sketch_fused
   held f32 path`` lines);
4b. the distributed path at the same full width on one NCCL rank
   (``repro_torch.core.distributed``; a TCPStore on localhost, as
   ``dist.multihost.initialize`` makes one): ``distributed_smppca`` (wall
   time, launches 2 and 1, the memory it adds against phase 4's warm
   call's, its probe residual beside phase 4's on the same W, its factors
   against steps 2 and 3 run alone on the ``cuda`` backend's summary under
   the same key), its summary
   against the ``cuda`` backend's within ``SKETCH_TOL`` a column, the
   all-reduce of its blocks (CUDA events), and
   ``distributed_streaming_summary`` in 16,384-row slabs with probes and
   co-sketch against a single-process ``StreamingSummarizer`` fed the same
   slabs (bit for bit where the one-rank all-reduce leaves the bits alone;
   held within ``SKETCH_TOL`` a column); ``distributed ...`` lines;
4c. the Gaussian path with ``precision='bf16'`` at the same full width on
   phase 4's pair (``smppca bf16`` line): wall time, launches 2 and 1, peak
   memory under ``BF16_PEAK_GB_MAX``, no aligned copy, the probe residual
   under its threshold beside phase 4's, both ``sketch_fused`` calls held
   against the plain version on their first ``BF16_HELD_COLUMNS`` columns
   (``sketch_fused held bf16 path`` lines), and step 1 staged with CUDA
   events (the casts and the two launches);
5. kernel 2 (``sampled_rescaled_dot``) against its plain version on all
   of the slice's samples and on the same m drawn uniform on both sides,
   with m = 0 and with duplicates, each call made twice and equal bit for
   bit;
6. timings of kernels 1 and 2 at the slice's shapes beside their plain
   versions, one PyTorch library call where one computes the same
   function, and their bounds on an H100 SXM; kernel 1 in float32 (also in
   turns with ``tools/sketch_fused_mma_sync.cu``, its earlier ``mma.sync``
   design, built in phase 2) and with
   bf16 inputs (beside ``torch.mm(..., out_dtype=float32)``, the same
   function, and ``torch.matmul``, whose output is bf16); kernel 2 on both
   draws, with the time one B row a sample
   takes from L2 at the card's L2 read rate (``tools/kernel_probe.py``);
7. the SRHT path (``method='srht'``) at the same full width, through
   kernels 3 and 2: launch counts, every block-mode call in the cluster
   form (``hadamard.BLOCK_FORMS``), peak memory, probe residual, per-stage
   times of a staged run, SRHT step 1 split into the plan and the block
   calls (CUDA events) with the memory it adds, beside the composition the
   block mode replaced, and card against CPU at the small size;
8. the timing of kernel 3's block mode at its call shape (float32 and
   bf16), beside its plain version, its bound, the bytes it moves and
   their rate, its two-pass form in turns with its cluster form, the
   cluster kernel's registers, shared memory and spills (``-Xptxas -v``)
   and the clusters the card holds, the full mode and the composition it
   replaced;
9. the rest of the estimation engine at the same full width, on the same A
   and B: ``build_summary(..., backend='cuda', probes=16, cosketch=10)``
   (launches, time split into sketch, probes and co-sketch with CUDA
   events, the memory it adds; the probe block and Y against one unblocked
   float32 product each, within ``BLOCK_TOL``, W within ``W_TOL``); the
   rescaled-JL estimate with ``with_error=True``, whose ``rel_est`` must be
   under ``PROBE_RESIDUAL_MAX`` and within a factor 2 of the 8-column probe
   residual; ``direct_svd``, ``power`` with Tropp's reconstruction,
   ``adaptive_rank`` refined by it and ``product_of_pcas`` (time, launches,
   probe residual, ``rel_est``); LELA, whose exact-entry rate on the first
   2^20 samples decides whether it runs whole or on the first 4,096 rows;
   then card against CPU at d = 2,000, n = 200: every method on both
   backends, both gates, a batched L = 3 summary and estimate against the
   looped ones, and the Bernoulli sampler;
10. the streaming path at the same full width, on the same A and B, with
    16 probes and a co-sketch of 10 (``repro_torch.core.streaming``, two
    ``sketch_fused`` launches a chunk): sequential ingestion, Gaussian and
    SRHT, at chunks of 1,024, 4,096 and 16,384 rows (time per chunk, rows
    per second, launches, added memory), each against the one-shot
    ``cuda`` summary (``SKETCH_TOL`` per column) and bit for bit against
    the ``scan`` backend at ``block`` = chunk; the rescaled-JL estimate
    from the streamed summary (probe residual under ``PROBE_RESIDUAL_MAX``
    and within 5% of the one-shot summary's); ``tree_merge`` of per-chunk
    partial states; shuffled arrival (``update_rows``, 1,024-row chunks);
    ``ingest`` from host memory (as many rows as the host's free memory
    holds) with prefetch 0 and 2, bit for bit against the update loop, with
    rows per second and host-to-device GB/s; decay 0.9 (one tick a chunk,
    ``decay(merge) == merge(decay)`` bit for bit) and a 4-bucket window
    (bit for bit against its rebuilt live buckets, and its estimate); the
    wire format (bytes, ``wire_error``, the gate at 1e-2, the f32 round
    trip bit for bit); checkpoints after 6 of 13 chunks, plain (resumed bit
    for bit) and int8 (within its ``wire_error``), timed; ``stream ...``
    lines;
11. serving (``repro_torch.serve``): a ``SketchService`` stream session
    over the same full-width pair in 4,096-row ``append``s, its summary bit
    for bit against phase 10's state and ``stream_factors(r=5)`` under
    ``PROBE_RESIDUAL_MAX``; a ``torch.profiler`` trace of one warm
    full-width ``smppca`` call (the device's idle share, the five device
    operations that took the most time, WAltMin's split between
    ``index_add_``, the (m, r, r) product, the solves and QR, and its
    atomic adds a second); ``benchmarks/run.py::serving_sweep`` at its full
    size, with 1 warm flush (not 10), on the ``cuda`` and ``scan``
    backends (cold and warm us per request, no build on a warm flush,
    estimation calls per flush, each bucket's summaries bit for bit against
    its requests served alone) and ``traffic_sweep``'s four cells at 16
    requests each (not 256; requests/s, p50/p99 latency, occupancy above 1
    in the steady cells, shed rate, no build in the steady state);
    a trace of one warm serving flush; ``serve ...`` and ``trace ...``
    lines;
12. kernel 4 (``flash_attention``: at Dh 64, 96 and 128 on ``wgmma`` fed
    by TMA, TF32 for float32, bf16 for bf16; at the other widths on
    ``mma.sync`` TF32) against its
    plain version on the JAX test shapes and the CPU tests' Dh 96, 112, 16
    and 256 shapes (causal and not, float32 and bf16, every tile compiled
    at the width) and at S = 4,096 with granite-3-8b's 32 query and 8 KV
    heads of 128, phi3-mini-3.8b's (4, 4,096, 32 heads of 96),
    kimi-k2-1t-a32b's 64 query and 8 KV heads of 112, recurrentgemma-9b's
    16 query heads over 1 KV head of 256 and the reduced configs' 4 heads
    of 16, and at Dh 48, 200 and 50 (8 over 2 heads; widths between
    compiled ones, on a copy zero-padded to the next) with one launch a
    call, all at ``FLASH_TOL``; each bf16 call on a ``wgmma`` instance
    also within one bf16 ulp (plus the float32 ``FLASH_TOL``) of the plain
    version's bf16 output and equal to it on all but
    ``flash_attention.BF16_DIFFER_MAX`` of the entries; Dh 264 and 320
    refused before a launch; the short sequences (``flash_short_s``): S =
    1, 48, 100 and 127 at every compiled width, float32 and bf16, causal
    and not, one launch a call on a copy zero-padded along S, held as
    above against the plain version at S, direct launches with ``kv_len``
    below S at every tile against the plain version with the same
    ``kv_len``, and S = 160 refused before a launch (``flash_attention
    short S`` line); with phase 13, the largest bf16 and float32 errors
    and the bf16 ``wgmma`` calls' largest share of entries that differ;
13. the attention path at full width: one granite-3-8b attention layer at
    ``prefill_32k``'s S = 32,768 (one sequence), causal, float32, through
    ``ops.flash_attention`` (launch counters set to 0 before the call and
    read after it), against the plain version on every row, then bf16 and
    non-causal the same way;
14. kernel 4's timings: every compiled tile at S = 32,768, float32 and
    bf16 (at Dh 128 each dtype's ``wgmma`` instance's one tile); the
    float32 instance's prologue alone (V^T, equal to
    ``flash_attention.vt_plain``), its time and bytes, and the instance's
    shared memory; at S = 32,768 and 4,096, float32 and bf16, beside its
    plain version, ``scaled_dot_product_attention`` and its bound: float32
    on the TF32 tensor cores (three split passes per product), with the
    float32 FMA units' figure beside it; bf16 at the bf16 tensor cores'
    rate, with its design's floor beside it (the bf16 ``wgmma`` instance's
    one bf16 pass on QK^T and two on PV; ``mma.sync``'s two TF32 passes a
    product); the same at S = 32,768 at the tile ``tuning.lookup``
    resolves for phi3-mini-3.8b's 32 heads of 96, kimi-k2-1t-a32b's 64
    query and 8 KV heads of 112, recurrentgemma-9b's 16 over 1 of 256
    (tile (64, 32)), the reduced configs' 4 heads of 16, 4 heads of 32
    over 4 and whisper-small's 12 of 64; at phi3's and whisper's widths (the
    ``wgmma`` instances at Dh 96 and 64) the float32 prologue alone too,
    equal to ``vt_plain``, its time and the float32 instance's shared
    memory, and the bf16 instance's form and shared memory;
15. the kernel tuner: ``tuning.autotune(..., measure_top=3)`` on the card
    for all four kernels at ``benchmarks/run.py::kernel_sweep``'s shapes and
    the attention's full width, launch counters set to 0 before and read
    after;
16. the multi-host cell: this script started twice more
    (``--multihost-child``), two processes on the one card joined through
    a TCPStore on localhost (``dist.multihost.initialize`` from the REPRO_*
    environment; gloo, which the exchange does not use), each
    ``sharded_ingest``-ing its host shard of a d = 50,000, n = 100,000
    pair that it makes on the card chunk by chunk from the seed, then
    merging through the store with the f32 wire and with the gate's vote:
    ingest time and rows/s a rank (one rank on the card at a time), the
    ``sharded_ingest`` time (both at once), each merge timed alone after a
    barrier, wire bytes, both ranks'
    merged states equal (sha256), the f32 merge equal to the local
    ``tree_merge`` of both partial states; a ``multihost`` line;
17. gradient compression and the gradient tap at one granite-3-8b MLP
    layer's widths (n_in = 4,096, n_out = 12,800, T = 8,192 tokens, the
    JAX benchmark's construction): ``sketched_dense`` forward and backward
    and ``decompress_tap`` (launches 2 and 1), ``compress_grads`` of the
    true dW (1 and 1), each of these launches held against its plain
    version on its own inputs afterwards (``SKETCH_TOL`` a column,
    ``SAMPLED_TOL`` of the scale), ``cos_taps``, ``cos_AeqI``, the communication
    fraction and times (CUDA events); dx within 1e-4 of the uncompressed
    layer's and ``cos_taps > cos_AeqI``; a ``gradient layer`` line;
18. the LM path at full width: granite-3-8b (8.37e9 float32 parameters,
    drawn on the card from the seed) through
    ``repro_torch.launch.serve.init_model`` and ``serve.engine.Engine``,
    three requests: (a) 4 prompts of 4,096 tokens and 32 greedy tokens,
    twice (the same tokens both times), (b) 1 prompt of 32,768 tokens and
    16 greedy tokens, (c) 2 prompts of 1,000 tokens (the padded route) and
    8 tokens at temperature 0.8; each with its prefill time and tokens per
    second, decode ms a token, peak memory, launches (counters set to 0
    before each request and read after it: 40 ``flash_attention``
    launches, nothing else) and attention routes (40 flash, 0 plain);
    prefill plus step-by-step decode against the full-sequence forward
    (4,096-token prompt, 16 steps, ``LM_DECODE_TOL``); layer 0's attention
    on the model's weights at each request's shapes through the path's
    call against the plain version within ``FLASH_TOL``, and its time; one
    layer (block 0) at S = 1,024 on the card against the CPU; each
    request's bounds on the card; ``lm ...`` lines;
19. the MoE and recurrent families at full width, one model at a time,
    each freed before the next, through the same entry points:
    moonshot-v1-16b-a3b in bf16 parameters (28.4e9, 56.8 GB; 47 MoE layers
    of 64 experts, top 6), requests (a) and (c) of phase 18, 48
    ``flash_attention`` launches and no plain route a prefill, two runs of
    (a) the same tokens, prefill plus decode against the forward and layer
    1 (attn_moe) card against CPU, both in float32 compute at a capacity
    that drops nothing on the same parameter tensors; recurrentgemma-9b
    (float32, 41.8 GB) with 2 prompts of 4,096 (12 windowed attentions a
    prefill on the plain route), prefill plus decode against the forward,
    layer 0's RG-LRU scan against its step loop; xlstm-350m with 4 prompts
    of 4,096 (the chunked mLSTM) and 2 of 1,000 (the single chunk),
    prefill plus decode against the forward, layer 0's chunked mLSTM
    against its step loop, one sLSTM layer's time loop timed and traced
    (device events a step); each request's bounds; ``lm <arch> ...``
    lines;
20. training at full width: phi3-mini-3.8b (3.82e9 float32 parameters,
    drawn on the card from the seed by ``Trainer``'s own init; bf16
    compute, remat) through ``train.Trainer`` on ``SyntheticLM`` batches of
    2 x 4,096 tokens in 2 microbatches, AdamW as ``launch/train.py``
    builds it: (a) no compression, 2 steps; (b) SMP-PCA taps on the MLP,
    3 steps, the last under ``device_trace`` (idle share, top device
    operations, WAltMin's split); (a) freed before (b). Each step's wall
    time, tokens/s, loss, ``grad_norm``, launches (``sketch_fused`` 256
    and ``sampled_rescaled_dot`` 64 a taps step), attention routes (no
    flash under grad), the share spent in ``decompress_tapped_params``,
    peak memory; step 1's loss against the same parameters' no_grad loss,
    every gradient nonzero (the taps' zeroed ones aside), every tapped dW
    of rank 8, the first tapped layer's dW against the completion on the
    CPU of the same taps (finalized on the card) and key within 1e-3, the
    parameters changed, and (b)'s first two kernel calls of each kind held
    against their plain versions (``Trainer`` with ``max_retries=0``: a
    failed check is never retried); (c) granite-3-8b reduced
    at its head width 16 (the flash route without grad) in float32: one train
    step on the card against the CPU, loss, ``grad_norm`` and every
    gradient within 1e-4; (d) ``launch.train --reduced`` on the card: the
    loss falls over 20 steps, a fault at step 12 recovers from step 10's
    checkpoint, a second Trainer resumes at 20; ``train ...`` lines;
21. ``save_attn_out`` remat and the step's roofline (``remat ...``
    lines): (a) phase 20 (a)'s first step again, on the same parameters
    and batch, with ``remat_policy="save_attn_out"``: its loss equal to
    (a)'s, its gradients at ``TRAIN_PROBE`` within ``REMAT_GRAD_TOL`` of
    (a)'s, its time and peak beside (a)'s; (b) ``roofline.trace_analyzer``
    on (a)'s step on one device (traced on ``meta``, the card's route):
    counted FLOPs and bytes, ``model_flops``, the ``Roofline`` terms, and
    the share of its step time that (a)'s measured warm step reaches;
22. four more archs served at full width, one at a time, each freed
    before the next, in their configured float32 parameters drawn on the
    card from the seed, through the same entry points: phi3-mini-3.8b,
    starcoder2-15b, llama-3.2-vision-11b and whisper-small, phase 18's
    requests (a) twice (the same tokens) and (c), each prefill's
    ``flash_attention`` launches and attention routes checked (phi3 32
    flash; starcoder2 40 flash; llama 32 flash, 8 plain
    cross-attentions; whisper 12 flash, 24 plain: the encoder's and the
    cross-attentions), prefill plus decode against the forward within
    ``LM_DECODE_TOL``, the kernel on layer 0's weights at each request's
    shapes against its plain version (phi3's 32 heads of 96, starcoder2's
    GQA 12:1 at Dh 128, llama's (32, 8), whisper's Dh 64), layer 0 card
    against CPU, and
    llama's first cross-attention layer and whisper's first encoder
    layer, each within ``LM_LAYER_TOL``; the stub inputs drawn from the
    seed for the checks; each request's bounds; ``lm <arch> ...`` lines;
23. the examples on the card: the twins of the five ``examples/*.py``
    (``examples/*_torch.py``) called in process through their ``main`` on
    ``cuda`` at the originals' defaults, each with its launches (counters
    set to 0 before and read after each) and wall time:
    ``quickstart_torch`` (d = 20,000, n = 400; its spectral errors within
    ``EXAMPLE_ERR_RTOL`` of the same twin on the CPU, SMP-PCA's at or
    above the optimal, at least one ``sampled_rescaled_dot`` launch);
    ``streaming_cooccurrence_torch`` (the restored checkpoint equal to the
    saved state bit for bit, the summary within ``SKETCH_TOL`` and the
    spectral error within ``EXAMPLE_ERR_RTOL`` of the CPU run, launches of
    ``sketch_fused`` and ``sampled_rescaled_dot``);
    ``gradient_compression_torch`` (``EXAMPLE_GC_STEPS`` = 30 steps of
    each mode, the one cut: every loss falls, the three first losses
    within ``EXAMPLE_FIRST_LOSS_TOL``, the taps launch both kernels); ``train_lm_torch`` (300 steps into a fresh
    checkpoint directory: the loss falls, checkpoints at 100, 200 and
    300); ``serve_lm_torch`` for each of the ten archs (reduced: (4, 64)
    tokens in the vocabulary; the default arch with ``--sketch-demo``:
    2,048 rows, U and V (96, 4); each arch's attention routes, its
    prefill's causal, unwindowed self-attentions on the kernel at the
    reduced width 16, one launch a flash route, none for
    ``EXAMPLE_NO_FLASH``); each twin's every ``sketch_fused``,
    ``sampled_rescaled_dot`` and ``flash_attention`` call, copied at the
    call, held against the plain version on its own inputs afterwards
    (``example held ...`` lines; their errors go into the kernels line),
    and no other kernel launched; the Trainers run with
    ``max_retries=0``; then ``python examples/quickstart_torch.py`` with no
    arguments as a subprocess;
    ``example ...`` and ``examples phase`` lines;
24. a ``kernels`` JSON line, then the final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

sys.path.insert(0, os.path.join(ROOT, "tools"))

import kernel_probe  # noqa: E402
import sketch_fused_probe  # noqa: E402
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
# Phase 4c, smppca(precision='bf16') on phase 4's pair: its peak must stay
# under the card's 80 GB (A and B take 40 GB, each sketch call adds a bf16
# copy of its input, 10 GB); each of its two sketch_fused calls held against
# the plain version on the first BF16_HELD_COLUMNS columns, as phase 3
# holds the kernel.
BF16_PEAK_GB_MAX = 80.0
BF16_HELD_COLUMNS = 4096
# Kernel 4 against its plain version: the JAX suite's tolerances for its
# kernel against its oracle (tests/kernels/test_flash_attention.py), also at
# S = 32,768: the kernel's and the plain version's float32 sums of 32,768
# terms differ by a few ulps of outputs that are at most max |v|.
FLASH_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# flash_check's largest error by dtype since phase 12 began, and its bf16
# wgmma calls' largest share of entries that differ from the plain
# version's and largest excess over one bf16 ulp (flash_attention.
# bf16_agreement)
FLASH_MAX_ERR: dict = {}
FLASH_BF16_AGREEMENT = {"share": 0.0, "excess": float("-inf")}
# The estimation-engine phase at full width: 16 held-out probes (the middle
# probe count of benchmarks/run.py::error_sweep: 4, 16, 64) and a co-sketch
# of s = 2r = 10, the value of the JAX benchmark's refinement sweep
# (benchmarks/run.py:405).
PROBES, COSKETCH = 16, 10
# The probe and co-sketch blocks (float32 sums over 1,024-row blocks)
# against one unblocked float32 product: each column within 1e-4 of its own
# largest entry, the sketch's tolerance.
BLOCK_TOL = 1e-4
# W = (Psi_c A^T) B sums n1 = 100,000 terms of mixed sign, then d = 50,000:
# float32 rounding of either order reaches ~1e-4 of a column's largest
# entry (7.3e-5 measured on an H100), so W is held to 1e-3.
W_TOL = 1e-3
# adaptive_rank at full width: the gate's tolerance (the residual limit
# above) and its largest candidate rank (= the co-sketch width).
GATE_TOL, GATE_R_MAX = 0.2, 10
# LELA's exact second pass: its rate on the first 2^20 samples of the draw
# decides whether the whole call runs (under 60 s), or LELA on the first
# 4,096 rows of A and B at the full n and m.
LELA_PROBE, LELA_FULL_S, LELA_ROWS = 1 << 20, 60.0, 4096
# The streaming phase at full width: the JAX benchmark's streaming_sweep
# chunk sizes (benchmarks/run.py:457) with 4,096 the default; the streamed
# estimate's probe residual within 5% of the one-shot summary's; shuffled
# arrival at the sweep's shuffled_rows/chunk1024; ingest's copy ring two
# chunks deep; decay 0.9 with one tick a chunk; a window of 4 epochs of
# 12,500 rows, filled with all d rows, then slid twice (the two oldest
# epochs expire); the wire gate at 1e-2; checkpoints after 6 of the 13
# chunks.
STREAM_CHUNKS, STREAM_CHUNK = (1024, 4096, 16384), 4096
STREAM_RESID_REL = 0.05
STREAM_SHUFFLE_CHUNK, STREAM_SHUFFLE_SEED = 1024, 19
STREAM_PREFETCH = 2
STREAM_DECAY = 0.9
STREAM_BUCKETS, STREAM_EPOCH, STREAM_SLIDES = 4, 12_500, 2
WIRE_TOL = 1e-2
STREAM_CKPT_CHUNKS = 6
# Host memory left free beside the host copy of A and B and the pinned
# staging ring (the process, the allocator and the page cache).
HOST_SPARE_BYTES = 8 * 10 ** 9
# Two identical full-width smppca calls through the pipeline engine (phase
# 4): the second is a cache hit; WAltMin's index_add_ atomics add in no
# fixed order, so its factors equal the first call's to float32 rounding,
# held on an 8-column probe to 1e-4 relative (tests/test_torch_cuda.py's
# RERUN_UVT_TOL). Neither call's peak may exceed 51.213 GB, the peak of
# the same call with its stages composed by hand, before the engine (NVIDIA
# H100 80GB HBM3): a cache entry must keep no tensor alive.
WARM_UVT_TOL = 1e-4
PHASE4_PEAK_GB_MAX = 51.213 + 5e-4      # that peak, as printed (3 decimals)
# The serving phase at the JAX benchmark's full (non-smoke) sizes:
# benchmarks/run.py::serving_sweep (d, n, k, L requests a flush, probes,
# m, T; :670-739) on both serving summary backends, and ::traffic_sweep's
# base and shapes (:741-783).
SERVE_D, SERVE_N, SERVE_K, SERVE_L = 4096, 128, 128, 16
SERVE_PROBES, SERVE_M, SERVE_T = 16, 6000, 4
# Cuts that keep this phase near 70 s (the rest of the script takes about
# 160 s on an H100 80GB HBM3 at 700 W): on that card a
# request of these cells takes 50 to 150 ms (about 4,700 launches, most of
# them the threefry key draws), so the sweep times 1 warm flush (the
# benchmark's 10) and each traffic cell offers 16 requests (its 256).
SERVE_WARM = 1
SERVE_PLANS = (
    ("fixed_r", dict(r=5, m=SERVE_M, T=SERVE_T)),
    ("fixed_r_with_error", dict(r=5, m=SERVE_M, T=SERVE_T, with_error=True)),
    ("auto_rank", dict(r="auto", tol=0.5, m=SERVE_M, T=SERVE_T)))
SERVE_BACKENDS = ("cuda", "scan")
TRAFFIC_BASE = dict(n_requests=16, k=64, m=1200, T=3, max_batch=8,
                    target_occupancy=4.0, pairs_per_shape=4)
TRAFFIC_SHAPES = ((2048, 64, 48), (2048, 96, 64), (3072, 64, 64))
# The distributed phase (4b): the phase-4 pair through
# core/distributed.py on one NCCL rank; the stream in slabs of 16,384 rows
# with phase 9's probes and co-sketch. The summary against the cuda
# backend's: each column within 1e-4 of its largest entry (SKETCH_TOL). Its
# factors against steps 2 and 3 run alone on the cuda backend's summary
# under the same key, to WARM_UVT_TOL on an 8-column probe (WAltMin's
# atomics); its probe residual under PROBE_RESIDUAL_MAX, printed beside
# phase 4's on the same W but not held to it: distributed_smppca splits its
# key as the JAX package's does (split(key) against smppca's split(key,
# 3)), so it draws another sample, and residuals of this pair spread from
# 0.061 to 0.078 across draws (this phase and phase 4 on an NVIDIA H100
# 80GB HBM3). The memory its call adds to what is live before it within 0.25
# GB of what phase 4's warm call added (NCCL's buffers lie outside torch's
# allocator; the two paths each form one (d, k) projection and its
# transposed copy).
DIST_SLAB = 16_384
DIST_ADDED_GB_SLACK = 0.25
# The multi-host phase (16): two processes, each ingesting its host shard
# of a d = 50,000, n = 100,000 planted pair made on the card per chunk from
# the seed and the chunk's first row (no process holds the whole pair),
# with 16 probes, in 4,096-row chunks, then merging through the store:
# with wire='f32' and with the gate's vote at WIRE_TOL. Each child runs
# under MULTIHOST_TIMEOUT seconds.
MULTIHOST_D, MULTIHOST_N, MULTIHOST_CHUNK = 50_000, 100_000, 4096
MULTIHOST_TIMEOUT = 300
# The gradient phase (17): one granite-3-8b MLP layer's widths
# (src/repro/configs/granite_3_8b.py: d_model 4,096, d_ff 12,800) under
# benchmarks/run.py::grad_compression's construction (T = 8,192 tokens,
# x of rank 16 plus noise, w with a planted rank-6 perturbation), the taps
# with TapConfig(sketch_k=128, rank=8), the compressor with
# CompressionConfig() (rank 8, k 128, m = 8 (n_in + n_out) 8, 4 ALS
# iterations). dx is the uncompressed layer's: within 1e-4 relative.
GRAD_N_IN, GRAD_N_OUT, GRAD_T, GRAD_K, GRAD_R = 4096, 12_800, 8192, 128, 8
GRAD_DX_TOL = 1e-4
# The LM phase (18): granite-3-8b at full width through
# repro_torch.launch.serve, three requests (batch, prompt, new tokens,
# temperature): train_4k's and prefill_32k's sequence lengths
# (src/repro/configs/shapes.py) and a ragged prompt that takes the padded
# route. Prefill plus decode against the full forward within the JAX
# suite's bf16 tolerance (tests/models/test_archs.py::
# test_prefill_decode_matches_forward: 0.15) at a 4,096-token prompt and
# 16 steps. One layer on the card against the CPU at S = 1,024: bf16
# compute on both, float32 sums in another order, so a value near a bf16
# rounding edge rounds the other way now and then and moves what follows
# by a bf16 ulp (0.4%); held within 1e-2 of the output's largest entry.
LM_ARCH = "granite-3-8b"
LM_REQUESTS = (("a", 4, 4096, 32, 0.0), ("b", 1, 32_768, 16, 0.0),
               ("c", 2, 1000, 8, 0.8))
LM_CHECK_PROMPT, LM_CHECK_STEPS, LM_DECODE_TOL = 4096, 16, 0.15
LM_LAYER_S, LM_LAYER_TOL = 1024, 1e-2
# The MoE and recurrent phase (19), one model at a time at full width.
# moonshot-v1-16b-a3b (src/repro/configs/moonshot_v1_16b_a3b.py) in bf16
# parameters (28.4e9 in 56.8 GB; 113.6 GB in float32 does not fit):
# request (a) of phase 18 and its ragged (c); prefill_32k's 12.9 GB cache
# and the MoE buffers at T = 32,768 do not fit beside the weights. Its
# forward check runs in float32 compute at a capacity of n_experts / top_k
# (C = T: nothing dropped; the JAX test's 8 leaves C = 0.75 T at 64
# experts and top 6) on the same parameter tensors, batch 1, a 1,024-token
# prompt and 8 steps. With random weights the deep layers' routers are
# near ties (the smallest top-6 margins 1e-7 to 1e-6 of probability), so
# float32 noise between the two paths routes some tokens to other
# experts: tens a layer in the prompt, which reach the compared logits
# through attention (1.5e-3 to 1.9e-3 at logits of scale 5.8 on the card,
# where tests/models/test_archs.py's MoE test holds 2e-3 at one token of
# two layers), and now and then a decoded token, from which on the steps
# compute another branch (0.13): those are reported, the rest held within
# 4e-3. Layer 1 (attn_moe) card against CPU in the same setting: float32
# sums of 2,048 terms in other orders, the flash kernel's three split TF32
# passes: within 1e-4 of the largest output on the tokens both devices
# route alike, and at most 1% routed otherwise.
# recurrentgemma-9b in float32 parameters: 2 prompts of 4,096 (a multiple
# of the window, as the ring cache needs), 16 greedy tokens; layer 0's
# scan against its step loop within test_archs.py's 1e-4. xlstm-350m: 4
# prompts of 4,096 (the chunked mLSTM) and 2 of 1,000 (the single-chunk
# form); layer 0's chunked mLSTM against its step loop within
# test_archs.py's 5e-3 (plus 5e-3 of the value). Their forward checks
# (recurrentgemma a 4,096-token prompt; xlstm a 1,024-token prompt, the
# chunked form, against a 1,040-token single-chunk forward; 16 steps) are
# held in float32 compute on the same parameter tensors, as moonshot's:
# in bf16 compute a float32 difference between the two paths tips bf16
# roundings that 38 and 24 layers of recurrences carry on (0.05 to 0.11
# and 0.08 to 0.23 at logits of scale 6 on the card, where the JAX suite
# holds 0.15 at two layers; reported beside). In float32 compute the
# reference's bf16 gate products remain (the RG-LRU's gates, the mLSTM's
# w_if, the sLSTM's recurrence): 2.0e-3 to 2.6e-3 and 6.6e-3 to 1.75e-2
# measured, held within 1e-2 and 5e-2.
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_REQUESTS = (("a", 4, 4096, 32, 0.0), ("c", 2, 1000, 8, 0.8))
MOE_CHECK_PROMPT, MOE_CHECK_STEPS, MOE_CHECK_TOL = 1024, 8, 4e-3
MOE_LAYER_TOL = 1e-4
RG_ARCH = "recurrentgemma-9b"
RG_REQUESTS = (("a", 2, 4096, 16, 0.0),)
RG_CHECK_PROMPT, RG_CHECK_STEPS, RG_DECODE_TOL = 4096, 16, 1e-2
RG_SCAN_TOL = 1e-4
XL_ARCH = "xlstm-350m"
XL_REQUESTS = (("a", 4, 4096, 16, 0.0), ("c", 2, 1000, 16, 0.0))
XL_CHECK_PROMPT, XL_CHECK_STEPS, XL_DECODE_TOL = 1024, 16, 5e-2
XL_MLSTM_TOL = 5e-3
# The four archs served at full width (phase 22), one at a time, each in
# its configured float32 parameters (phi3-mini-3.8b 15.3 GB,
# starcoder2-15b 63.8, llama-3.2-vision-11b 39.2, whisper-small 1.1) and
# freed before the next: phase 18's requests (a) twice and (c), with the
# flash and plain attention calls a prefill routes (phi3's 32 at Dh 96 on
# the kernel; llama's 8 cross-attentions, whisper's 12 encoder and 12
# cross-attentions are bidirectional: the plain route).
# Prefill plus decode against the forward and the layers card against CPU
# at phase 18's tolerances, the stub inputs (whisper's 1,500 frames,
# llama's 1,600 image tokens) drawn from the seed and llama's
# cross-attention gates opened (at the parity tests' 0.7 and -0.4: at 0
# they erase the block) for the checks.
SERVE_ARCHS = (("phi3-mini-3.8b", 32, 0), ("starcoder2-15b", 40, 0),
               ("llama-3.2-vision-11b", 32, 8), ("whisper-small", 12, 24))
SERVE_REQUESTS = (("a", 4, 4096, 32, 0.0), ("c", 2, 1000, 8, 0.8))
XATTN_GATES = (("gate_attn", 0.7), ("gate_mlp", -0.4))
# The training phase (20): phi3-mini-3.8b (src/repro/configs/
# phi3_mini_3_8b.py, arXiv:2404.14219: 32 layers, d 3,072, 32 heads of 96,
# d_ff 8,192, vocab 32,064) at full width and depth, float32 parameters,
# bf16 compute, remat; B = 2 sequences of phi3-mini-4k's 4,096 tokens in 2
# microbatches; AdamW as launch/train.py builds it (warmup_cosine(1e-3,
# 1, steps), weight decay 0.01, float32 moments). (a) no compression, 2
# steps (cut from 3 to keep the phase near its budget: the trace of (b)'s
# last step takes 48 to 59 s on an H100), and (b) SMP-PCA taps on the MLP
# (TapConfig(): k 64, rank 8, T 4), 3 steps. Step 1's loss against the
# same parameters' no_grad loss: a mean of 8,192 log-probabilities in bf16
# compute on both sides, float32 sums in other orders (the loss chunks and
# remat change none of the arithmetic): within 1e-3. A tapped dW is rank
# 8: the 9th singular value of dW Omega (Omega 16 Gaussian columns) within
# TRAIN_RANK_TOL of the first. One tapped layer's dW is the reconstruction
# under its key: against decompress_tap on the CPU from the same taps and
# key within TRAIN_TAP_TOL of the leaf's largest entry. The taps go over bit
# for bit, the summary's norms are the card's and the draws are the same
# (the CDF is summed on the host, the uniform bits are jax-exact), so only
# float32 sums in other orders differ, and 1e-3 is the bound the CPU tests
# hold the port's taps to against JAX's. One moved draw of 720,896 moves
# this layer's rank-8 completion by 2.6% of that entry (its top singular
# values are close), and a wrong key by 0.70, printed beside it.
# Trainer runs with max_retries=0, so a failed check ends the script.
# (c) granite-3-8b reduced (4 heads of 16, on the flash kernel without
# grad), float32 compute: one train step on the card against the CPU,
# loss, grad_norm and each gradient within 1e-4 relative (float32 sums in
# other orders).
# (d) launch.train --reduced on the card: 20 steps, a fault at step 12
# with checkpoints every 10, then a second Trainer resumes at 20.
TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_B, TRAIN_S, TRAIN_MB = 2, 4096, 2
TRAIN_STEPS_A, TRAIN_STEPS_B = 2, 3
TRAIN_LOSS_TOL, TRAIN_RANK_TOL, TRAIN_CPU_TOL = 1e-3, 1e-4, 1e-4
TRAIN_TAP_TOL = 1e-3
# phase 21 (a): the gradients' first rows compared with phase 20 (a)'s, at
# the embedding, the head, and the first, middle and last layers
TRAIN_PROBE = ("embed.table", "head.w", "final_norm.scale") + tuple(
    f"groups.0.{c}.0.{p}" for c in (0, 15, 31)
    for p in ("attn.wq.w", "attn.wo.w", "mlp.down.w", "norm1.scale"))
# the same forward and backward, save_attn_out's saved attention output in
# place of its recompute: equal in exact arithmetic; held to 1e-6 of each
# probe's largest entry
REMAT_GRAD_TOL = 1e-6
# Phase 23, the examples' twins (examples/*_torch.py) at the originals'
# defaults. Card against the same twin on the CPU (same keys; float32 sums
# in other orders, WAltMin's atomic adds): the spectral errors within 1e-3
# relative; the stream's sketches within SKETCH_TOL a column, its norms
# within SKETCH_TOL relative. gradient_compression's three modes start from
# one initialisation on one batch: their first losses within 1e-4.
EXAMPLE_ERR_RTOL = 1e-3
EXAMPLE_FIRST_LOSS_TOL = 1e-4
# gradient_compression_torch's --steps: its default 60 took 78.9 s of a
# 151.4 s phase (NVIDIA H100 80GB HBM3, 700 W; lowrank 54.0 s, host-bound);
# 30 keep the phase near 120 s, and every mode's loss still falls (on the
# CPU lowrank goes from 6.693 to 6.442 in 30 steps). The cut is here and
# not on train_lm's 300 host-bound steps, whose check names its checkpoints
# at 100, 200 and 300; the 30 steps repeat the 60's shapes, and each of
# their launches is held against the plain version.
EXAMPLE_GC_STEPS = 30
# the examples' default arch, run once with --sketch-demo
EXAMPLE_SERVE_DEMO_ARCH = "phi3-mini-3.8b"
# the bare `python examples/quickstart_torch.py` (about 20 s on an H100)
EXAMPLE_SUBPROCESS_TIMEOUT = 300
# granite-3-8b's attention (src/repro/configs/granite_3_8b.py: 32 heads, 8
# KV heads, d_model 4096) and the sequence lengths of prefill_32k and
# train_4k (src/repro/configs/shapes.py).
HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
S_FULL, S_TRAIN = 32_768, 4_096
# the kernel's other head widths as the repo's configs use them, (query
# heads, KV heads, Dh): phi3-mini-3.8b (src/repro/configs/phi3_mini_3_8b.py:
# 32 heads of 96, MHA), kimi-k2-1t-a32b (kimi_k2_1t_a32b.py: 64 heads of
# 112 over 8 KV heads), recurrentgemma-9b (recurrentgemma_9b.py: 16 query
# heads over 1 KV head of 256; unwindowed here, as neither kernel has a
# window), the reduced configs (src/repro/configs/base.py: 4 heads of
# 16) and whisper-small (whisper_small.py: 12 heads of 64, MHA), checked at
# S_TRAIN (phi3 and whisper at batch 4, request (a)'s) and timed at S_FULL
WIDTH_LAYOUTS = (("phi3-mini-3.8b", 32, 32, 96, 4),
                 ("kimi-k2-1t-a32b", 64, 8, 112, 1),
                 ("recurrentgemma-9b", 16, 1, 256, 1),
                 ("reduced", 4, 4, 16, 1),
                 ("4-over-4", 4, 4, 32, 1),
                 ("whisper-small", 12, 12, 64, 4))
# widths between compiled ones, which ops.flash_attention zero-pads in a
# copy to the next compiled one (64, 256 and 64), 8 query heads over 2,
# checked at S_TRAIN
BETWEEN_WIDTHS = (48, 200, 50)
# widths past 256, which no instance runs: refused before a launch
REFUSED_WIDTHS = (264, 320)
# S below 128, which the JAX wrapper runs as one block of S rows and the
# card on a copy zero-padded along S with the keys past S masked; key
# lengths of direct launches on 128 rows; one on 256 rows, whose mask falls
# past the first tile; an S from 128 on that the reference refuses
SHORT_S = (1, 48, 100, 127)
DIRECT_KV = ((128, 1), (128, 100), (256, 200))
REFUSED_S = 160
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


SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")


def sass_counts(ops, lib) -> dict:
    """{kernel function: {op: count}} of the tensor-core instructions in the
    library's SASS (``cuobjdump -sass``): ``HMMA`` (``mma.sync``),
    ``HGMMA`` (``wgmma``) and ``UTMALDG`` (TMA loads)."""
    cuobjdump = os.path.join(os.path.dirname(ops._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            words = line.replace(".", " ").split()
            for op in SASS_OPS:
                counts[fn][op] += op in words
    return counts


def flash_resources(lib) -> dict:
    """{(bq, bk, Dh, dtype): (registers, spilled bytes)} of each
    ``flash_fwd`` instance, under ("wgmma", Dh) and ("vt", Dh) those of
    each float32 ``flash_fwd_wgmma`` instance and its prologue
    ``flash_vt``, under ("wgmma_bf16", Dh) those of each
    ``flash_fwd_wgmma_bf16`` instance ("wgmma_kv" and "wgmma_bf16_kv" the
    masked instances that a call with ``kv_len`` below S runs), and under
    "serialised" ptxas's notes that it serialised ``wgmma`` (C7511, C7512,
    C7518) or injected a wait (C7517), from the ``-Xptxas -v`` report kept
    beside the library."""
    log = lib.with_name(lib.name + ".log").read_text()
    notes = re.findall(r"\((C751[1278])\).*?function '\w*?"
                       r"(flash_\w+?E(?:Lb[01]E)?)", log)
    out, inst = {"serialised": [" ".join(n) for n in notes]}, None
    for line in log.splitlines():
        m = re.search(r"flash_fwdILi(\d+)ELi(\d+)ELi(\d+)E(f|13__nv_bfloat16)E",
                      line)
        w = re.search(r"(flash_fwd_wgmma_bf16|flash_fwd_wgmma|flash_vt)"
                      r"ILi(\d+)E(Lb1E)?", line)
        if "Compiling entry function" in line:
            inst = None if m is None else (
                int(m[1]), int(m[2]), int(m[3]),
                "float32" if m[4] == "f" else "bfloat16")
            if w is not None:
                inst = ({"flash_fwd_wgmma": "wgmma", "flash_vt": "vt",
                         "flash_fwd_wgmma_bf16": "wgmma_bf16"}[w[1]]
                        + ("_kv" if w[3] else ""), int(w[2]))
        elif inst is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line)[1])
            out[inst] = (None, spill)
        elif inst is not None and "Used" in line and inst in out:
            regs = int(re.search(r"Used (\d+) registers", line)[1])
            out[inst] = (regs, out[inst][1])
    return out


def sketch_resources(lib) -> dict:
    """Registers and spilled bytes of ``sketch_fused``'s kernel functions
    (``sketch_fused_f32_kernel``, ``sketch_fused_bf16_kernel`` and the
    prologue ``sketch_pi_small``), and ptxas's notes that it serialised
    ``wgmma`` (C7512, C7518) or injected a wait (C7517), from the ``-Xptxas
    -v`` report kept beside the library."""
    log = lib.with_name(lib.name + ".log").read_text()
    out, fn = {"serialised": [line.strip()[:160] for line in log.splitlines()
                              if re.search(r"\(C751[278]\)", line)]}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = next((f for f in ("sketch_fused_f32_kernel",
                                   "sketch_fused_bf16_kernel",
                                   "sketch_pi_small") if f in line), None)
        elif fn is not None and "spill stores" in line:
            out[fn] = {"spill_bytes": int(
                re.search(r"(\d+) bytes spill stores", line)[1])}
        elif fn is not None and "Used" in line and fn in out:
            out[fn]["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
    return out


def cluster_resources(lib, log_l1: int = 8, log_l2: int = 8) -> dict:
    """Registers, static shared memory and spilled bytes of the block
    mode's cluster-form kernel ``srht_cluster<float, log_l1, log_l2>``,
    from the ``-Xptxas -v`` report kept beside the library."""
    log = lib.with_name(lib.name + ".log").read_text()
    out, inst = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inst = f"srht_clusterIfLi{log_l1}ELi{log_l2}E" in line
        elif inst and "spill stores" in line:
            out["spill_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", line)[1])
        elif inst and "Used" in line:
            out["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
            m = re.search(r"(\d+) bytes smem", line)
            out["static_smem_bytes"] = int(m[1]) if m else 0
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
    fw = ops.KERNELS["blocked_fwht"]
    form = fw.block_plan(X.shape[0], dp, X.dtype, rows.shape[0]).form
    before = dict(fw.BLOCK_FORMS)
    got_s, got_n = ops.srht_block(X, signs, rows, d_pad=dp)
    again_s, again_n = ops.srht_block(X, signs, rows, d_pad=dp)
    check(fw.BLOCK_FORMS[form] == before[form] + 2,
          f"srht_block {label}: two launches in the {form} form")
    ref_s, ref_n = fw.plain_block(X, signs, rows, dp)
    torch.cuda.synchronize()
    err = float((got_s - ref_s).abs().max())
    rel = float(((got_n - ref_n).abs() / ref_n.clamp(min=1e-30)).max())
    equal = bool(torch.equal(got_s, ref_s))
    rerun = bool(torch.equal(got_s, again_s) and torch.equal(got_n, again_n))
    print(f"srht_block check {label} d={X.shape[0]} d_pad={dp} "
          f"n={X.shape[1]} k={rows.shape[0]} form={form} "
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


@torch.no_grad()
def bf16_full_width(ops, smppca, key, A, B, k, r, m, T, phase4_resid, seed,
                    dev, card):
    """Phase 4c: the Gaussian path with ``precision='bf16'`` at full width
    on phase 4's pair: wall time, launches (2 and 1), peak memory, the
    probe residual beside phase 4's, each sketch_fused call held against
    the plain version on a column slice, and step 1 staged with CUDA events
    (the casts of Pi and A, the launch on A, the cast of B, the launch on
    B). Returns the path's launch counts and the held max abs err."""
    from repro_torch.core import summary_engine
    from repro_torch import prng
    phase_t0 = time.perf_counter()
    sk = ops.KERNELS["sketch_fused"]
    copies = sk.ALIGNED_COPIES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with recording(ops, "sketch_fused") as calls:
        t0 = time.perf_counter()
        res = smppca(key, A, B, r=r, k=k, m=m, T=T, precision="bf16",
                     device=dev)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches == {"sketch_fused": 2, "sampled_rescaled_dot": 1,
                       "blocked_fwht": 0, "flash_attention": 0},
          f"launches per smppca(precision='bf16') call: {launches}")
    check(sk.ALIGNED_COPIES == copies,
          "the bf16 path's inputs are read by TMA in place")
    check(peak_gb < BF16_PEAK_GB_MAX, f"bf16 path peak memory {peak_gb} GB")
    U, V = res.factors
    check(tuple(U.shape) == (A.shape[1], r) and bool(torch.isfinite(U).all())
          and bool(torch.isfinite(V).all()), "bf16 factors finite")
    # W from a generator of its own: the later phases' draws stay as they
    # were without this phase
    resid = probe_residual(A, B, res.factors,
                           torch.Generator(device=dev).manual_seed(seed + 3))
    check(resid < PROBE_RESIDUAL_MAX, f"bf16 probe residual {resid}")
    del res, U, V
    cols = BF16_HELD_COLUMNS
    err = held_sketch(ops, [((Pi, X[:, :cols]), kw, (out[:, :cols],
                                                     norm[:cols]))
                            for (Pi, X), kw, (out, norm)
                            in calls["sketch_fused"]],
                      "bf16 path")
    del calls
    # step 1 staged: what ops.sketch_fused does for each input
    lib = ops._library("sketch_fused")
    P = summary_engine.projection_rows(prng.split(key, 3)[0],
                                       torch.arange(A.shape[0], device=dev),
                                       k).T
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    events[0].record()
    P16 = P.to(torch.bfloat16).contiguous()
    X16 = A.to(torch.bfloat16)
    events[1].record()
    sk.launch(lib, P16, X16)
    events[2].record()
    del X16
    X16 = B.to(torch.bfloat16)
    events[3].record()
    sk.launch(lib, P16, X16)
    events[4].record()
    events[4].synchronize()
    del X16, P16, P
    step1 = {name: events[i].elapsed_time(events[i + 1]) for i, name in
             enumerate(("cast_pi_and_a_ms", "launch_a_ms", "cast_b_ms",
                        "launch_b_ms"))}
    print("smppca bf16 " + json.dumps({
        "d": A.shape[0], "n1": A.shape[1], "n2": B.shape[1], "k": k, "r": r,
        "m": m, "T": T, "wall_s": wall_s, "launches": launches,
        "peak_gb": peak_gb, "probe_residual": resid,
        "phase4_probe_residual": phase4_resid, "held_max_abs_err": err,
        "step1_ms": step1, "phase_s": time.perf_counter() - phase_t0,
        "card": card}), flush=True)
    return launches, err


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


@contextlib.contextmanager
def recording(ops, *names, limit=None, copy=False):
    """Keep each call of the named ``ops`` wrappers made while the block
    runs (the first ``limit`` of each, when given), as (arguments,
    keywords, result), so that a path's own launches can be held against
    the plain versions afterwards. With ``copy``, the tensors are kept as
    copies made at the call, for a path that may later change its inputs
    or results in place. The wrappers run and count their launches as
    before."""
    calls = {name: [] for name in names}
    saved = {name: getattr(ops, name) for name in names}

    def kept(x):
        if torch.is_tensor(x):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(kept(v) for v in x)
        return x

    def keep(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if limit is None or len(calls[name]) < limit:
                calls[name].append((kept(args), kw, kept(out)) if copy
                                   else (args, kw, out))
            return out
        return call
    for name in names:
        setattr(ops, name, keep(name, saved[name]))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@torch.no_grad()
def held_sketch(ops, calls, label):
    """Each recorded ``sketch_fused`` call against the plain version on its
    own inputs, held as ``sketch_check`` holds the kernel: every column
    within SKETCH_TOL of its largest entry, the squared norms within
    SKETCH_TOL relative. Returns the max abs err."""
    errs = []
    for (Pi, A), kw, (out, norm) in calls:
        if kw.get("precision") == "bf16":
            Pi, A = Pi.to(torch.bfloat16), A.to(torch.bfloat16)
        ref_out, ref_norm2 = ops.KERNELS["sketch_fused"].plain(Pi, A)
        norm2 = norm if kw.get("squared") else norm ** 2
        diff = (out - ref_out).abs()
        col_err = float((diff.amax(dim=0) / ref_out.abs().amax(dim=0)
                         .clamp(min=1e-30)).max())
        rel_n = float(((norm2 - ref_norm2).abs()
                       / ref_norm2.clamp(min=1e-30)).max())
        errs.append(float(diff.max()))
        shape = tuple(Pi.shape) + (A.shape[1],)
        print(f"sketch_fused held {label} k,d,n={shape}: max_abs_err="
              f"{errs[-1]:.3e} column_err={col_err:.3e} norm2_rel_err="
              f"{rel_n:.3e} (tol {SKETCH_TOL:.0e})", flush=True)
        check(col_err <= SKETCH_TOL, f"sketch_fused {label} {shape}: "
              f"column err {col_err}")
        check(rel_n <= SKETCH_TOL, f"sketch_fused {label} norms {shape}: "
              f"{rel_n}")
    return max(errs, default=0.0)


@torch.no_grad()
def held_sampled(ops, calls, label):
    """Each recorded ``sampled_rescaled_dot`` call against the plain
    version on its own inputs, held as ``sampled_check`` holds the kernel:
    every value within SAMPLED_TOL of its nA * nB scale. Returns the max
    abs err."""
    errs = []
    for (As, Bs, na, nb, rows, cols), kw, out in calls:
        if kw.get("precision") == "bf16":
            As, Bs = As.to(torch.bfloat16), Bs.to(torch.bfloat16)
        ref = ops.KERNELS["sampled_rescaled_dot"].plain(
            As, Bs, na.float(), nb.float(), rows, cols)
        diff = (out - ref).abs()
        scaled = float((diff / (na[rows.long()] * nb[cols.long()])
                        .clamp(min=1e-30)).max()) if out.numel() else 0.0
        errs.append(float(diff.max()) if out.numel() else 0.0)
        print(f"sampled_rescaled_dot held {label} n1,n2,k,m="
              f"{(As.shape[0], Bs.shape[0], As.shape[1], rows.shape[0])}: "
              f"max_abs_err={errs[-1]:.3e} scaled_err={scaled:.3e} "
              f"(tol {SAMPLED_TOL:.0e})", flush=True)
        check(scaled <= SAMPLED_TOL, f"sampled_dot {label}: {scaled}")
    return max(errs, default=0.0)


@torch.no_grad()
def held_flash(ops, calls, label):
    """Each recorded ``flash_attention`` call against the plain version on
    its own inputs, in the dtype the kernel read them (``flash_check``'s
    tolerance). Returns the max abs err."""
    errs = []
    for (q, k, v), kw, out in calls:
        cfg = kw.get("config")
        dtype = ops._kernel_dtype(q, k, v, precision=cfg and cfg.precision)
        ref = ops.KERNELS["flash_attention"].plain(
            q.to(dtype), k.to(dtype), v.to(dtype), kw.get("causal", True))
        tol = FLASH_TOL[dtype]
        diff = (out.float() - ref.float()).abs()
        errs.append(float(diff.max()))
        excess = float((diff - tol * ref.float().abs()).max())
        print(f"flash_attention held {label} {tuple(q.shape)}/"
              f"{tuple(k.shape)}: max_abs_err={errs[-1]:.3e} (tol "
              f"{tol:.0e} + {tol:.0e} |ref|)", flush=True)
        check(excess <= tol, f"flash_attention {label}: err {errs[-1]}")
    return max(errs, default=0.0)


def flash_check(ops, q, k, v, causal, label, config=None, out=None,
                kv_len=None, verbose=True):
    """Kernel 4 against its plain version on every row (``out``: the
    kernel's output if it ran already; ``kv_len``: the keys it saw, the
    plain version's too); returns the max abs err. Fails unless |out -
    ref| <= tol + tol |ref| everywhere, the JAX test's
    ``assert_allclose(rtol=tol, atol=tol)``. ``verbose``: print a line."""
    if out is None:
        out = ops.flash_attention(q, k, v, causal=causal, config=config)
    ref = ops.KERNELS["flash_attention"].plain(q, k, v, causal, kv_len)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"flash_attention {label} shape/dtype")
    tol = FLASH_TOL[q.dtype]
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    FLASH_MAX_ERR[q.dtype] = max(FLASH_MAX_ERR.get(q.dtype, 0.0), err)
    excess = float((diff - tol * ref.float().abs()).max())
    del diff
    fa = ops.KERNELS["flash_attention"]
    rounded = ""
    if q.dtype == torch.bfloat16 and fa.design(q.shape[3], 2) == "wgmma":
        # the design's float32 result rounded once: the plain version's
        # bf16 output but for a few entries, each within one bf16 ulp
        share, ulp_excess = fa.bf16_agreement(out, ref,
                                              FLASH_TOL[torch.float32])
        FLASH_BF16_AGREEMENT["share"] = max(FLASH_BF16_AGREEMENT["share"],
                                            share)
        FLASH_BF16_AGREEMENT["excess"] = max(
            FLASH_BF16_AGREEMENT["excess"], ulp_excess)
        rounded = (f"; differs from the plain version's bf16 on {share:.3e}"
                   f" of entries (at most {fa.BF16_DIFFER_MAX}), excess "
                   f"over 1 ulp + {FLASH_TOL[torch.float32]:.0e} "
                   f"{ulp_excess:.3e} (at most 0)")
        check(share <= fa.BF16_DIFFER_MAX and ulp_excess <= 0,
              f"flash_attention {label}: bf16 differs on {share} of "
              f"entries, {ulp_excess} past one ulp")
    if verbose:
        print(f"flash_attention check {label} {tuple(q.shape)}/"
              f"{tuple(k.shape)} {str(q.dtype).split('.')[-1]} causal="
              f"{causal}: max_abs_err={err:.3e} (tol {tol:.0e} + {tol:.0e} "
              f"|ref|){rounded}", flush=True)
    check(excess <= tol, f"flash_attention {label} {tuple(q.shape)} "
          f"{q.dtype} causal={causal} kv_len={kv_len}: err {err}")
    return err


def flash_short_s(ops, gen, dev, card) -> None:
    """Phase 12's short sequences. ``ops.flash_attention`` at each S of
    ``SHORT_S`` (B = 2, 4 query heads over 2), every compiled width,
    float32 and bf16, causal and not: one launch a call, held by
    ``flash_check`` against the plain version at S (the bf16 ``wgmma``
    calls also by ``bf16_agreement``). Then ``flash_attention.launch``
    itself with ``kv_len`` below S (``DIRECT_KV``) at every tile compiled
    at each width, on inputs random in every row, against the plain
    version with the same ``kv_len``; and S = ``REFUSED_S`` refused before
    a launch at every width. One ``flash_attention short S`` line."""
    from repro_torch.kernels import tuning
    fa = ops.KERNELS["flash_attention"]
    lib = ops._library("flash_attention")
    t0 = time.perf_counter()
    calls = direct = 0
    errs: dict = {}
    # the bf16 wgmma calls' agreement over this block alone, merged back
    # into the phase's after
    before_block = dict(FLASH_BF16_AGREEMENT)
    FLASH_BF16_AGREEMENT.update(share=0.0, excess=float("-inf"))
    for dh in fa.HEAD_DIMS:
        for S in SHORT_S:
            q, kk, v = attention_inputs(gen, S, 4, 2, dh, dev, batch=2)
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd = (x.to(dtype) for x in (q, kk, v))
                for causal in (True, False):
                    before = ops.LAUNCHES["flash_attention"]
                    out = ops.flash_attention(qd, kd, vd, causal=causal)
                    check(ops.LAUNCHES["flash_attention"] == before + 1,
                          f"flash_attention S={S} Dh {dh}: one launch")
                    err = flash_check(ops, qd, kd, vd, causal, f"S={S}",
                                      out=out, verbose=False)
                    errs[dtype] = max(errs.get(dtype, 0.0), err)
                    calls += 1
        for S, kv_len in DIRECT_KV:
            q, kk, v = attention_inputs(gen, S, 4, 2, dh, dev, batch=2)
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd = (x.to(dtype) for x in (q, kk, v))
                for bq, bk in fa.tiles(dh, dtype.itemsize):
                    for causal in (True, False):
                        out = fa.launch(lib, qd, kd, vd, causal, bq, bk,
                                        kv_len=kv_len)
                        err = flash_check(
                            ops, qd, kd, vd, causal, f"kv_len={kv_len} tile "
                            f"{(bq, bk)}", out=out, kv_len=kv_len,
                            verbose=False)
                        errs["direct"] = max(errs.get("direct", 0.0), err)
                        direct += 1
        q = torch.randn(1, REFUSED_S, 2, dh, generator=gen, device=dev)
        before = ops.LAUNCHES["flash_attention"]
        try:
            ops.flash_attention(q, q, q)
        except ValueError:
            pass
        else:
            check(False, f"flash_attention refuses S={REFUSED_S} at Dh {dh}")
        check(ops.LAUNCHES["flash_attention"] == before,
              f"flash_attention S={REFUSED_S} Dh {dh}: no launch")
    torch.cuda.synchronize()
    tiles = {str(dtype).split(".")[-1]: {
        dh: tuning.lookup("flash_attention", (8, SHORT_S[1], dh),
                          dtype_bytes=dtype.itemsize,
                          backend=tuning.backend_of(dev)).block
        for dh in fa.HEAD_DIMS} for dtype in (torch.float32, torch.bfloat16)}
    print(f"flash_attention short S [{card}] " + json.dumps(dict(
        S=list(SHORT_S), widths=list(fa.HEAD_DIMS), calls=calls,
        launches_a_call=1, tiles=tiles,
        max_abs_err_f32=errs[torch.float32],
        max_abs_err_bf16=errs[torch.bfloat16],
        bf16_differ_share_max=FLASH_BF16_AGREEMENT["share"],
        bf16_ulp_excess_max=FLASH_BF16_AGREEMENT["excess"],
        direct_launches=direct, direct_kv=[list(x) for x in DIRECT_KV],
        direct_max_abs_err=errs["direct"],
        refused_S=REFUSED_S, refused_widths=list(fa.HEAD_DIMS),
        phase_s=time.perf_counter() - t0)), flush=True)
    for key in ("share", "excess"):
        FLASH_BF16_AGREEMENT[key] = max(FLASH_BF16_AGREEMENT[key],
                                        before_block[key])


def flash_timings(ops, q, kk, v, reps, label) -> dict:
    """Kernel 4 on (q, kk, v), causal at the tile ``tuning.lookup``
    resolves, in float32 and bf16: its time in turns with its plain
    version, the library's (``sdpa_call``) in turns with it
    (``kernel_ms_beside_library``: the kernel's in those turns), its
    bound and its design's
    floor (its tensor-core passes, ``flash_attention.PASSES``); a ``timing
    flash_attention{label}`` line a dtype. Returns the float32 record."""
    from repro_torch.kernels import tuning
    fa = ops.KERNELS["flash_attention"]
    B, S, H, Dh = q.shape
    # causal: half the S x S scores of each head, two products each; q, k,
    # v read once and o written once
    flops = 2.0 * B * H * S * S * Dh
    elems = B * (2 * S * H + 2 * S * kk.shape[2]) * Dh
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dtype) for x in (q, kk, v))
        size = qd.element_size()
        k4_ms, k4_plain = turns(lambda: fa.plain(qd, kd, vd, True),
                                lambda: ops.flash_attention(qd, kd, vd),
                                reps=reps)
        # the library in turns with the kernel, after a warm-up each, at
        # least two calls a turn
        lib = sdpa_call(qd, kd, vd)
        k4_beside_lib, library_ms = turns(
            lib, lambda: ops.flash_attention(qd, kd, vd), reps=max(reps, 2))
        # the design's floor: its passes of each product at their type's
        # rate
        design = fa.design(Dh, size)
        qk, pv, kind = fa.PASSES[design, size]
        floor = bound((qk + pv) / 2 * flops, size * elems,
                      PEAK_BF16_FLOPS if kind == "bf16" else PEAK_TF32_FLOPS)
        if size == 4:
            # float32-accurate: three split passes on the TF32 tensor
            # cores; the FMA units alone beside it
            (k4_bound, k4_by), extra = floor, dict(
                tf32_passes=qk,
                fma_units_ms=bound(flops, size * elems, PEAK_F32_FLOPS)[0])
        else:
            # bf16 inputs: the bf16 tensor cores' rate; this design's
            # floor beside it (wgmma: one bf16 pass on QK^T and two on PV;
            # mma.sync: two TF32 passes a product)
            k4_bound, k4_by = bound(flops, size * elems, PEAK_BF16_FLOPS)
            extra = dict(design=design, passes=[qk, pv, kind],
                         floor_ms=floor[0])
        tile = tuning.lookup("flash_attention", (B * H, S, Dh),
                             dtype_bytes=size,
                             backend=tuning.backend_of(q.device)).block
        t = dict(S=S, heads=H, kv_heads=kk.shape[2], head_dim=Dh,
                 tile=list(tile), kernel_ms=k4_ms, plain_ms=k4_plain,
                 library_ms=library_ms, kernel_ms_beside_library=k4_beside_lib,
                 bound_ms=k4_bound, bound_by=k4_by, **extra)
        tag = label if dtype == torch.float32 else label + " bf16"
        print(f"timing flash_attention{tag} " + json.dumps(t), flush=True)
        if dtype == torch.float32:
            out = t
        del qd, kd, vd, lib
    return out


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


def timed(fn):
    """(fn(), wall ms) on the host clock, the card synchronized before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def timed_host(fn) -> float:
    """Wall ms of ``fn`` on the host clock (host-only work)."""
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def host_copy(X, rows: int, chunk: int) -> np.ndarray:
    """The first ``rows`` rows of a card tensor as a pageable numpy array,
    copied ``chunk`` rows at a time through one pinned buffer (a copy
    straight to pageable memory runs at a fraction of the rate)."""
    out = np.empty((rows, X.shape[1]), dtype=np.float32)
    bounce = torch.empty((chunk, X.shape[1]), pin_memory=True)
    for lo in range(0, rows, chunk):
        hi = min(rows, lo + chunk)
        bounce[:hi - lo].copy_(X[lo:hi])
        torch.from_numpy(out[lo:hi]).copy_(bounce[:hi - lo])
    return out


def host_mem_available() -> int:
    """The host's available memory in bytes (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def column_err(got, want) -> float:
    """Largest error of any column relative to that column's largest
    entry."""
    return float(((got - want).abs().amax(dim=0)
                  / want.abs().amax(dim=0).clamp(min=1e-30)).max())


def error_fields(err) -> dict:
    return {name: float(x) for name, x in zip(err._fields, err)}


def engine_full_width(ops, key, A, B, k, r, m, T, gen, waltmin_ms, dev):
    """The estimation engine beyond rescaled_jl at the slice's full width:
    a summary with probes and co-sketch (launches, time split with CUDA
    events, memory; the blocks against one unblocked product), the
    rescaled-JL estimate with its ErrorEstimate, direct_svd, power
    (Tropp), the Tropp-refined adaptive_rank, the product of PCAs and LELA
    (whole if the measured exact-entry rate puts it under LELA_FULL_S,
    else on the first LELA_ROWS rows). Returns the numbers it printed."""
    from repro_torch import prng
    from repro_torch.core import (
        baselines, error_engine, estimation_engine, refinement, sampling,
        summary_engine)
    from repro_torch.core.lela import lela
    out = {}
    k_sketch, k_sample, _ = prng.split(key, 3)
    k_est = prng.fold_in(k_sample, 0)

    # the summary, through the entry point, launch counters set to 0 first
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    summary, wall_ms = timed(lambda: summary_engine.build_summary(
        k_sketch, A, B, k, backend="cuda", probes=PROBES, cosketch=COSKETCH,
        device=dev))
    launches = dict(ops.LAUNCHES)
    added_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(launches == {"sketch_fused": 2, "sampled_rescaled_dot": 0,
                       "blocked_fwht": 0, "flash_attention": 0},
          f"launches per build_summary(probes, cosketch): {launches}")
    # the same stages one by one, timed with CUDA events
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    events[0].record()
    staged = summary_engine._cuda_backend(k_sketch, A, B, k,
                                          method="gaussian", block=1024,
                                          precision=None)
    events[1].record()
    staged = error_engine.attach_probes(staged, k_sketch, A, B, PROBES)
    events[2].record()
    staged = refinement.attach_cosketch(staged, k_sketch, A, B, COSKETCH)
    events[3].record()
    events[3].synchronize()
    check(all(bool(torch.equal(x, y)) for x, y in zip(staged, summary)
              if x is not None and y is not None),
          "the staged summary is the entry point's")
    del staged
    out["summary"] = {
        "wall_ms": wall_ms, "launches": launches, "added_peak_gb": added_gb,
        **{f"{name}_ms": events[i].elapsed_time(events[i + 1])
           for i, name in enumerate(("sketch", "probes", "cosketch"))}}
    print("engine summary d,n,k,p,s=" + f"{A.shape[0]},{A.shape[1]},{k},"
          f"{PROBES},{COSKETCH} " + json.dumps(out["summary"]), flush=True)
    # the blocks against one unblocked float32 product each
    errs = {
        "probes": column_err(summary.probes,
                             A.T @ (B @ summary.probe_omega)),
        "cosketch_Y": column_err(summary.cosketch_Y,
                                 A.T @ (B @ summary.cosketch_omega)),
        "cosketch_W": column_err(summary.cosketch_W,
                                 (summary.cosketch_psi @ A.T) @ B)}
    tols = {"probes": BLOCK_TOL, "cosketch_Y": BLOCK_TOL,
            "cosketch_W": W_TOL}
    print(f"engine blocks against one unblocked product: "
          + json.dumps(errs) + " (tol, of each column's largest entry: "
          + json.dumps(tols) + ")", flush=True)
    for name, err in errs.items():
        check(err <= tols[name],
              f"{name} against the unblocked product: {err}")

    # rescaled_jl with its ErrorEstimate (the main path's factors)
    ops.reset_launch_counts()
    res, ms = timed(lambda: estimation_engine.estimate_product(
        k_est, summary, r, m=m, T=T, backend="cuda", with_error=True,
        device=dev))
    launches = dict(ops.LAUNCHES)
    check(launches == {"sketch_fused": 0, "sampled_rescaled_dot": 1,
                       "blocked_fwht": 0, "flash_attention": 0},
          f"launches per estimate_product(with_error=True): {launches}")
    resid = probe_residual(A, B, res.factors, gen)
    est = error_fields(res.error)
    out["rescaled_jl"] = dict(ms=ms, launches=launches, probe_residual=resid,
                              error=est)
    print("engine rescaled_jl with_error " + json.dumps(out["rescaled_jl"]),
          flush=True)
    check(est["rel_est"] < PROBE_RESIDUAL_MAX,
          f"rescaled_jl rel_est {est['rel_est']}")
    check(0.5 * resid <= est["rel_est"] <= 2.0 * resid,
          f"rel_est {est['rel_est']} not within a factor 2 of the probe "
          f"residual {resid}")
    del res

    # the other methods, the gate and the product of PCAs
    k_pow = prng.split(key)[1]
    tropp = refinement.RefineSpec(0, "tropp")
    runs = {
        "direct_svd": lambda: estimation_engine.estimate_product(
            k_pow, summary, r, method="direct_svd", backend="cuda",
            with_error=True, device=dev),
        "power_tropp": lambda: estimation_engine.estimate_product(
            k_pow, summary, r, method="power", backend="cuda", refine=tropp,
            with_error=True, device=dev),
        "adaptive_rank_tropp": lambda: error_engine.adaptive_rank(
            summary, tol=GATE_TOL, r_max=GATE_R_MAX, refine=tropp),
        "product_of_pcas": lambda: baselines.product_of_pcas(
            key, A, B, r, device=dev)}
    for name, run in runs.items():
        ops.reset_launch_counts()
        got, ms = timed(run)
        launches = dict(ops.LAUNCHES)
        factors = got if name == "product_of_pcas" else got.factors
        err = (error_engine.estimate_error(summary, factors)
               if name == "product_of_pcas" else got.error)
        check(all(bool(torch.isfinite(x).all()) for x in factors),
              f"{name} factors finite")
        out[name] = dict(ms=ms, launches=launches,
                         probe_residual=probe_residual(A, B, factors, gen),
                         rel_est=float(err.rel_est))
        if name == "adaptive_rank_tropp":
            out[name].update(r=got.r, curve=got.curve.tolist())
        print(f"engine {name} " + json.dumps(out[name]), flush=True)
        del got, factors

    # LELA: the exact-entry rate on the first LELA_PROBE samples of the
    # full-width draw decides whether the whole call runs
    na, nb = summary.norm_A, summary.norm_B
    samples = sampling.sample_entries(prng.split(key)[0], na, nb, m)
    rows, cols = samples.rows[:LELA_PROBE], samples.cols[:LELA_PROBE]
    estimation_engine.exact_entries(A, B, rows[:2048], cols[:2048])
    _, ms = timed(lambda: estimation_engine.exact_entries(A, B, rows, cols))
    rate = LELA_PROBE / (ms / 1e3)
    exact_s = m / rate
    predicted_s = exact_s + waltmin_ms / 1e3
    del samples, rows, cols
    full = predicted_s <= LELA_FULL_S
    d_run = A.shape[0] if full else LELA_ROWS
    reason = ("the whole call" if full else
              f"cut to the first {LELA_ROWS} rows of A and B (full n and m):"
              f" the measured rate puts the exact pass alone at "
              f"{exact_s:.1f} s, the call at {predicted_s:.1f} s, over "
              f"{LELA_FULL_S} s")
    print(f"engine lela exact_entries rate {rate:.4e} samples/s on the "
          f"first {LELA_PROBE} samples of m={m} at d={A.shape[0]}: "
          f"{exact_s:.1f} s for the exact pass; {reason}", flush=True)
    Ar, Br = A[:d_run], B[:d_run]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    factors, ms = timed(lambda: lela(key, Ar, Br, r=r, m=m, T=T,
                                          device=dev))
    launches = dict(ops.LAUNCHES)
    check(all(bool(torch.isfinite(x).all()) for x in factors),
          "lela factors finite")
    out["lela"] = dict(d=d_run, n=A.shape[1], m=m, ms=ms, launches=launches,
                       exact_rate_per_s=rate, exact_full_width_s=exact_s,
                       probe_residual=probe_residual(Ar, Br, factors, gen),
                       added_peak_gb=(torch.cuda.max_memory_allocated()
                                      - base) / 1e9,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("engine lela " + json.dumps(out["lela"]), flush=True)
    return out


def _fields_equal(x, y) -> dict:
    """{field: torch.equal} over the non-None fields of two NamedTuples."""
    return {name: bool(torch.equal(a, b))
            for name, a, b in zip(x._fields, x, y) if a is not None}


def stream_full_width(ops, key, A, B, k, r, m, T, gen, dev, card):
    """The streaming path at the slice's full width, on the same A and B
    (the module docstring's phase 10). Returns the launch counts of the
    default pass (Gaussian, STREAM_CHUNK rows a chunk)."""
    from repro_torch import prng
    from repro_torch.ckpt import checkpoint
    from repro_torch.core import (
        error_engine, estimation_engine, refinement, streaming,
        summary_engine)
    phase_t0 = time.perf_counter()
    d, n = A.shape
    k_sketch, k_sample, _ = prng.split(key, 3)
    k_est = prng.fold_in(k_sample, 0)
    W = torch.randn(n, 8, generator=gen, device=dev)   # one probe set here

    def resid(A_, B_, factors):
        AtBW = A_.T @ (B_ @ W)
        return float(torch.linalg.norm(AtBW - factors.U @ (factors.V.T @ W))
                     / torch.linalg.norm(AtBW))

    def summarizer(method="gaussian", **kw):
        return streaming.StreamingSummarizer(k, method=method, probes=PROBES,
                                             cosketch=COSKETCH, **kw)

    def chunks(lo, hi, c):
        return [(off, min(hi, off + c)) for off in range(lo, hi, c)]

    def emit(name, rec):
        print(f"stream {name} [{card}] " + json.dumps(rec), flush=True)

    # 1. sequential ingestion, both methods, every chunk size: the kernel
    # twice a chunk, against the one-shot cuda summary (tolerance) and the
    # scan backend at block = c on the card (bit for bit)
    one_shot, seq_4096 = {}, None
    for method in ("gaussian", "srht"):
        one = summary_engine.build_summary(
            k_sketch, A, B, k, method=method, backend="cuda", probes=PROBES,
            cosketch=COSKETCH, device=dev)
        one_shot[method] = one
        for c in STREAM_CHUNKS:
            summ = summarizer(method)
            spans = chunks(0, d, c)
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(len(spans) + 1)]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            state = summ.init(k_sketch, (d, n, n))
            for i, (lo, hi) in enumerate(spans):
                events[i].record()
                state = summ.update(state, A[lo:hi], B[lo:hi], lo)
            events[-1].record()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            launches = dict(ops.LAUNCHES)
            added_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
            check(launches == {"sketch_fused": 2 * len(spans),
                               "sampled_rescaled_dot": 0, "blocked_fwht": 0,
                               "flash_attention": 0},
                  f"stream {method} c={c}: launches {launches}")
            chunk_ms = [events[i].elapsed_time(events[i + 1])
                        for i in range(len(spans))]
            fin = summ.finalize(state)
            errs = {"A_sketch": column_err(fin.A_sketch, one.A_sketch),
                    "B_sketch": column_err(fin.B_sketch, one.B_sketch),
                    "norm2": float(((fin.norm_A ** 2 - one.norm_A ** 2).abs()
                                    / one.norm_A ** 2).max()),
                    "probes": column_err(fin.probes, one.probes),
                    "cosketch_Y": column_err(fin.cosketch_Y, one.cosketch_Y),
                    "cosketch_W": column_err(fin.cosketch_W, one.cosketch_W)}
            tols = {"A_sketch": SKETCH_TOL, "B_sketch": SKETCH_TOL,
                    "norm2": SKETCH_TOL, "probes": BLOCK_TOL,
                    "cosketch_Y": BLOCK_TOL, "cosketch_W": W_TOL}
            for name, err in errs.items():
                check(err <= tols[name], f"stream {method} c={c} {name} "
                      f"against the one-shot cuda summary: {err}")
            scan = summary_engine.build_summary(
                k_sketch, A, B, k, method=method, backend="scan", block=c,
                probes=PROBES, cosketch=COSKETCH, device=dev)
            equal = _fields_equal(fin, scan)
            check(all(equal[f] for f in ("A_sketch", "B_sketch", "norm_A",
                                         "norm_B")),
                  f"stream {method} c={c} bit-identical to scan: {equal}")
            for f in ("probes", "cosketch_Y", "cosketch_W"):
                check(column_err(getattr(fin, f), getattr(scan, f))
                      <= tols[f], f"stream {method} c={c} {f} against scan")
            del scan
            emit(f"{method} c={c}", dict(
                d=d, n=n, k=k, chunks=len(spans), launches=launches,
                total_ms=wall_ms, chunk_ms_mean=sum(chunk_ms) / len(chunk_ms),
                chunk_ms_min=min(chunk_ms), chunk_ms_max=max(chunk_ms),
                rows_per_s=d / (wall_ms / 1e3), added_peak_gb=added_gb,
                err_vs_one_shot=errs, bitwise_vs_scan=equal))
            if method == "gaussian" and c == STREAM_CHUNK:
                seq_4096, seq_fin = state, fin
                main_launches = launches
            del state, fin
    del one_shot["srht"]
    torch.cuda.empty_cache()

    # each chunk's work apart (CUDA events): the projection rows, one
    # sketch_fused launch, the probe and co-sketch products, and one
    # (k, n) accumulator add, the traffic an accumulating kernel would save
    omega, c_omega, c_psi = (seq_4096.omega, seq_4096.cosketch_omega,
                             seq_4096.cosketch_psi)
    acc_add_ms = cuda_ms(lambda: seq_4096.A_acc + seq_4096.B_acc, 5)
    for c in STREAM_CHUNKS:
        gids = torch.arange(c, device=dev)
        P = summary_engine.projection_rows(k_sketch, gids, k).T.contiguous()
        Ac, Bc = A[:c], B[:c]
        split = {
            "projection_ms": cuda_ms(lambda: summary_engine.projection_rows(
                k_sketch, gids, k), 3),
            "sketch_fused_ms": cuda_ms(lambda: ops.sketch_fused(
                P, Ac, squared=True), 3),
            "probes_ms": cuda_ms(lambda: error_engine.probe_contribution(
                omega, Ac, Bc), 3),
            "cosketch_ms": cuda_ms(lambda: refinement.cosketch_contribution(
                c_omega, c_psi, Ac, Bc), 3),
            "acc_add_ms": acc_add_ms}
        split["two_adds_over_two_launches"] = \
            acc_add_ms / split["sketch_fused_ms"]
        emit(f"chunk_split c={c}", split)
        del P

    # 2. the estimate from the streamed summary against the one-shot one
    ests = {}
    for name, summary in (("stream", seq_fin), ("one_shot",
                                                one_shot["gaussian"])):
        res, ms = timed(lambda: estimation_engine.estimate_product(
            k_est, summary, r, m=m, T=T, backend="cuda", with_error=True,
            device=dev))
        ests[name] = dict(ms=ms, probe_residual=resid(A, B, res.factors),
                          rel_est=float(res.error.rel_est))
        del res
    rs, ro = ests["stream"]["probe_residual"], ests["one_shot"]["probe_residual"]
    emit("estimate", dict(chunk=STREAM_CHUNK, **ests))
    check(rs < PROBE_RESIDUAL_MAX, f"streamed estimate residual {rs}")
    check(abs(rs - ro) <= STREAM_RESID_REL * ro,
          f"streamed residual {rs} not within 5% of the one-shot {ro}")
    del one_shot

    # 3. tree_merge of per-chunk partial states
    summ = summarizer()
    spans = chunks(0, d, STREAM_CHUNK)
    empty = summ.init(k_sketch, (d, n, n))
    parts = [summ.update(empty, A[lo:hi], B[lo:hi], lo) for lo, hi in spans]
    merged, ms = timed(lambda: streaming.tree_merge(parts))
    del parts
    fin = summ.finalize(merged)
    err = max(column_err(fin.A_sketch, seq_fin.A_sketch),
              column_err(fin.B_sketch, seq_fin.B_sketch),
              column_err(fin.probes, seq_fin.probes))
    emit("tree_merge", dict(parts=len(spans), ms=ms, err_vs_sequential=err,
                            rows_seen=int(merged.rows_seen)))
    check(err <= SKETCH_TOL and int(merged.rows_seen) == d,
          f"tree_merge against the sequential state: {err}")
    del merged, fin

    # 4. shuffled arrival: update_rows in a seeded order, 1,024-row chunks
    order = torch.Generator(device=dev)
    order.manual_seed(STREAM_SHUFFLE_SEED)
    perm = torch.randperm(d, generator=order, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = summ.init(k_sketch, (d, n, n))
    for lo in range(0, d, STREAM_SHUFFLE_CHUNK):
        ids = perm[lo:lo + STREAM_SHUFFLE_CHUNK]
        state = summ.update_rows(state, ids, A[ids], B[ids])
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    fin = summ.finalize(state)
    err = max(column_err(fin.A_sketch, seq_fin.A_sketch),
              column_err(fin.B_sketch, seq_fin.B_sketch))
    emit(f"shuffled_rows c={STREAM_SHUFFLE_CHUNK}", dict(
        total_ms=wall_ms, rows_per_s=d / (wall_ms / 1e3),
        launches=dict(ops.LAUNCHES), err_vs_sequential=err,
        row_high=int(state.row_high)))
    check(err <= SKETCH_TOL and int(state.row_high) == d,
          f"shuffled arrival against the sequential state: {err}")
    del state, fin, perm

    # 5. host ingest through the pinned ring and the copy stream; the host
    # copy of A and B is cut to the rows the host's free memory holds
    ring_bytes = (STREAM_PREFETCH + 1) * 2 * STREAM_CHUNK * n * 4
    avail = host_mem_available()
    fit = (avail - ring_bytes - HOST_SPARE_BYTES) // (2 * n * 4)
    rows = int(min(d, fit // STREAM_CHUNK * STREAM_CHUNK))
    check(rows > 0, f"host memory {avail} holds no {STREAM_CHUNK}-row chunk")
    t0 = time.perf_counter()
    A_host, B_host = (host_copy(X, rows, STREAM_CHUNK) for X in (A, B))
    to_host_s = time.perf_counter() - t0
    # the ring's pinned buffers, allocated once here: PyTorch's caching
    # host allocator keeps them, so both ingests below reuse them and
    # measure the steady state; the pinning itself is timed apart
    t0 = time.perf_counter()
    ring = [torch.empty((STREAM_CHUNK, n), pin_memory=True)
            for _ in range(2 * (STREAM_PREFETCH + 1))]
    pin_s = time.perf_counter() - t0
    del ring
    spans = chunks(0, rows, STREAM_CHUNK)
    if rows == d:
        ref = seq_4096
    else:
        ref = summ.init(k_sketch, (d, n, n))
        for lo, hi in spans:
            ref = summ.update(ref, A[lo:hi], B[lo:hi], lo)
    # the two copies alone: pageable to pinned on the host, pinned to card
    pinned = torch.empty((STREAM_CHUNK, n), pin_memory=True)
    host_gbps = pinned.nbytes / 1e9 / (timed_host(
        lambda: pinned.copy_(torch.from_numpy(A_host[:STREAM_CHUNK]))) / 1e3)
    pinned.to(dev)
    h2d_gbps = pinned.nbytes / 1e9 / (cuda_ms(
        lambda: pinned.to(dev, non_blocking=True), 3) / 1e3)
    del pinned
    ing = dict(rows=rows, d=d, host_mem_available_gb=avail / 1e9,
               host_copy_of_A_B_s=to_host_s, chunk=STREAM_CHUNK,
               ring_pinned_gb=2 * (STREAM_PREFETCH + 1) * STREAM_CHUNK * n
               * 4 / 1e9, ring_pin_s=pin_s,
               pageable_to_pinned_gbps=host_gbps, pinned_h2d_gbps=h2d_gbps)
    for prefetch in (0, STREAM_PREFETCH):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = summ.ingest(summ.init(k_sketch, (d, n, n)),
                          ((A_host[lo:hi], B_host[lo:hi])
                           for lo, hi in spans), prefetch=prefetch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        equal = _fields_equal(got, ref)
        ing[f"prefetch{prefetch}"] = dict(
            s=wall, rows_per_s=rows / wall,
            h2d_gbps=2 * rows * n * 4 / 1e9 / wall,
            launches=ops.LAUNCHES["sketch_fused"],
            bitwise_vs_update_loop=all(equal.values()))
        check(all(equal.values()),
              f"ingest prefetch={prefetch} bit-identical to the update loop: "
              f"{equal}")
        del got
    emit("ingest", ing)
    del A_host, B_host, ref
    torch.cuda.empty_cache()

    # 6. decay (one tick a chunk) and the window ring
    dec = summarizer(decay=STREAM_DECAY)
    spans = chunks(0, d, STREAM_CHUNK)
    half = len(spans) // 2
    parts = []
    t0 = time.perf_counter()
    for group in (spans[:half], spans[half:]):
        s = dec.init(k_sketch, (d, n, n))
        for lo, hi in group:
            s = dec.advance(dec.update(s, A[lo:hi], B[lo:hi], lo))
        parts.append(s)
    torch.cuda.synchronize()
    decay_ms = 1e3 * (time.perf_counter() - t0)
    lhs = streaming.decay_state(streaming.merge_states(*parts), 3)
    rhs = streaming.merge_states(*(streaming.decay_state(s, 3)
                                   for s in parts))
    law = _fields_equal(lhs, rhs)
    law_fin = _fields_equal(streaming.finalize_state(lhs),
                            streaming.finalize_state(rhs))
    check(all(law.values()) and all(law_fin.values()),
          f"decay(merge) == merge(decay) bit for bit: {law} {law_fin}")
    emit("decay", dict(decay=STREAM_DECAY, ticks_per_chunk=1, ms=decay_ms,
                       t_state=int(lhs.t_state),
                       law_bitwise=all(law.values())))
    del parts, lhs, rhs, s

    win = streaming.WindowedSummarizer(k, STREAM_BUCKETS, probes=PROBES,
                                       cosketch=COSKETCH)
    epochs = chunks(0, d, STREAM_EPOCH)
    w = win.init(k_sketch, (STREAM_EPOCH, n, n))
    log = {}
    t0 = time.perf_counter()
    for i, (e_lo, e_hi) in enumerate(epochs):
        if i:
            w = win.slide(w)
        for lo, hi in chunks(e_lo, e_hi, STREAM_CHUNK):
            w = win.update(w, A[lo:hi], B[lo:hi], lo - e_lo)
            log.setdefault(int(w.head), []).append((lo, hi, e_lo))
    w = win.slide(w, STREAM_SLIDES)
    torch.cuda.synchronize()
    window_ms = 1e3 * (time.perf_counter() - t0)
    head = int(w.head)
    live = [e for e in range(head - STREAM_BUCKETS + 1, head + 1)]
    inner = streaming.StreamingSummarizer(k, probes=PROBES,
                                          cosketch=COSKETCH)
    ref0 = w.buckets[0]
    rebuilt = []
    for e in live:
        b = inner.init(streaming.window_bucket_key(k_sketch, e),
                       (STREAM_EPOCH, n, n))._replace(
            omega=ref0.omega, cosketch_omega=ref0.cosketch_omega,
            cosketch_psi=ref0.cosketch_psi)
        for lo, hi, e_lo in log.get(e, []):
            b = inner.update(b, A[lo:hi], B[lo:hi], lo - e_lo)
        rebuilt.append(b)
    merged = win.merged(w)
    equal = _fields_equal(merged, streaming.tree_merge(rebuilt))
    check(all(equal.values()),
          f"window bit-identical to its rebuilt live buckets: {equal}")
    del rebuilt
    live_rows = [span for e in live for span in log.get(e, [])]
    lo_live = min(lo for lo, _, _ in live_rows)
    hi_live = max(hi for _, hi, _ in live_rows)
    res, ms = timed(lambda: estimation_engine.estimate_product(
        k_est, win.finalize(w), r, m=m, T=T, backend="cuda", with_error=True,
        device=dev))
    wres = resid(A[lo_live:hi_live], B[lo_live:hi_live], res.factors)
    emit("window", dict(
        n_buckets=STREAM_BUCKETS, epoch_rows=STREAM_EPOCH,
        epochs_filled=len(epochs), slides_after=STREAM_SLIDES, head=head,
        live_rows=[lo_live, hi_live], rows_seen=int(merged.rows_seen),
        ms=window_ms, bitwise_vs_rebuilt=all(equal.values()),
        estimate_ms=ms, probe_residual=wres,
        rel_est=float(res.error.rel_est)))
    check(int(merged.rows_seen) == hi_live - lo_live,
          "the window holds the live epochs' rows only")
    check(wres < PROBE_RESIDUAL_MAX, f"window estimate residual {wres}")
    del w, merged, res

    # 7. the wire format on the sequential state
    wire = {}
    for spec in streaming.WIRE_DTYPES:
        comp, ms = timed(lambda: streaming.compress_state(seq_4096, spec))
        wire[spec] = dict(wire_bytes=streaming.wire_bytes(comp),
                          compress_ms=ms,
                          wire_error=streaming.wire_error(seq_4096, spec))
        if spec == "f32":
            back = streaming.decompress_state(comp)
            equal = _fields_equal(back, seq_4096)
            check(all(equal.values()), f"f32 wire round trip: {equal}")
            del back
        del comp
    chosen, err = streaming.choose_wire_spec(seq_4096, tol=WIRE_TOL)
    packed, ms = timed(lambda: streaming.wire_pack(
        streaming.compress_state(seq_4096, chosen)))
    emit("wire", dict(specs=wire, choose_wire_spec_tol=WIRE_TOL,
                      chosen=chosen.sketch, chosen_error=err,
                      pack_bytes=len(packed), pack_ms=ms))
    del packed

    # 8. checkpoints after 6 of the 13 chunks: plain and int8, resumed
    spans = chunks(0, d, STREAM_CHUNK)
    state6 = summ.init(k_sketch, (d, n, n))
    for lo, hi in spans[:STREAM_CKPT_CHUNKS]:
        state6 = summ.update(state6, A[lo:hi], B[lo:hi], lo)
    ck = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, wire_spec in (("plain", None), ("int8", "int8")):
            path = os.path.join(tmp, label)
            _, write_ms = timed(lambda: checkpoint.save_stream_state(
                path, STREAM_CKPT_CHUNKS, state6, wire=wire_spec))
            restored, read_ms = timed(lambda: checkpoint.restore_stream_state(
                path, summ.init(k_sketch, (d, n, n))))
            meta = checkpoint.read_manifest(path)["extra"]
            resumed = summ.ingest(restored, ((A[lo:hi], B[lo:hi])
                                             for lo, hi in
                                             spans[STREAM_CKPT_CHUNKS:]))
            rec = dict(write_ms=write_ms, read_ms=read_ms,
                       rows_seen=meta["rows_seen"],
                       disk_bytes=sum(os.path.getsize(os.path.join(r_, f))
                                      for r_, _, fs in os.walk(path)
                                      for f in fs))
            if wire_spec is None:
                equal = _fields_equal(summ.finalize(resumed), seq_fin)
                rec["bitwise_vs_uninterrupted"] = all(equal.values())
                check(all(equal.values()),
                      f"plain checkpoint resume bit-identical: {equal}")
            else:
                dev_ = (resumed.A_acc.T @ (resumed.B_acc @ seq_4096.omega)
                        - seq_4096.A_acc.T @ (seq_4096.B_acc
                                              @ seq_4096.omega))
                wn2 = (seq_4096.omega ** 2).sum(dim=0)
                rel = float(torch.sqrt(((dev_ ** 2).sum(dim=0) / wn2).mean())
                            / torch.sqrt(((seq_4096.probe_acc ** 2).sum(dim=0)
                                          / wn2).mean()))
                rec.update(wire_error=meta["wire"]["error"],
                           resumed_rel_err=rel)
                check(rel <= meta["wire"]["error"],
                      f"int8 checkpoint resume {rel} within its wire_error "
                      f"{meta['wire']['error']}")
            ck[label] = rec
            del restored, resumed
    emit("checkpoint", dict(after_chunks=STREAM_CKPT_CHUNKS,
                            of_chunks=len(spans), **ck))
    del state6, seq_4096
    torch.cuda.empty_cache()
    print(f"stream phase [{card}]: {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return main_launches, seq_fin


def engine_small(seed, r, dev):
    """Card against CPU at d = 2,000, n = 200 with the same keys: every
    method on both backends (power with Tropp and with one sketch-power
    iteration), both with_error; the unrefined and refined gates; a
    batched L = 3 summary and estimate against the looped ones; the
    Bernoulli sampler. U V^T within SMALL_UVT_TOL, the chosen ranks
    equal, the sampler's rows and cols equal."""
    from repro_torch import prng
    from repro_torch.core import (
        error_engine, estimation_engine, refinement, sampling,
        summary_engine)
    from repro_torch.core.types import tree_index
    rng = np.random.default_rng(seed)
    ds, ns = 2000, 200
    Dn = (1.0 / np.arange(1, ns + 1)).astype(np.float32)
    As_ = rng.standard_normal((ds, ns)).astype(np.float32) * Dn
    Bs_ = As_ + 0.3 * rng.standard_normal((ds, ns)).astype(np.float32) * Dn
    As_, Bs_ = torch.from_numpy(As_), torch.from_numpy(Bs_)
    ms = estimation_engine.default_m(ns, ns, r)
    where = ("cuda", "cpu")

    def uvt_rel(f, g):
        a, b = (x.U.cpu() @ x.V.cpu().transpose(-1, -2) for x in (f, g))
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    summ = {w: summary_engine.build_summary(
        prng.PRNGKey(seed), As_, Bs_, 512, backend="cuda", probes=16,
        cosketch=10, device=w) for w in where}
    worst = {}
    cases = [(meth, be, None) for meth in ("rescaled_jl", "lela_waltmin",
                                           "direct_svd")
             for be in estimation_engine.BACKENDS]
    cases += [("power", be, spec) for be in estimation_engine.BACKENDS
              for spec in (refinement.RefineSpec(0, "tropp"),
                           refinement.RefineSpec(1, "power"))]
    for meth, be, spec in cases:
        res = {w: estimation_engine.estimate_product(
            prng.PRNGKey(seed + 1), summ[w], r, method=meth, backend=be,
            m=ms, T=8, refine=spec, with_error=True, device=w,
            exact_pair=(As_, Bs_) if meth == "lela_waltmin" else None)
            for w in where}
        rel = uvt_rel(res["cuda"].factors, res["cpu"].factors)
        est = [float(res[w].error.rel_est) for w in where]
        tag = f"{meth}/{be}" + ("" if spec is None else
                                f"/{spec.method}{spec.iters}")
        worst[tag] = rel
        check(rel < SMALL_UVT_TOL, f"{tag} card vs CPU at the small size: "
              f"{rel}")
        check(abs(est[0] - est[1]) <= SMALL_UVT_TOL * est[1],
              f"{tag} rel_est card {est[0]} vs CPU {est[1]}")
    gates = {}
    for name, spec in (("unrefined", None),
                       ("tropp", refinement.RefineSpec(0, "tropp"))):
        picks = {w: error_engine.adaptive_rank(summ[w], tol=GATE_TOL,
                                               r_max=GATE_R_MAX, refine=spec)
                 for w in where}
        gates[name] = picks["cuda"].r
        check(picks["cuda"].r == picks["cpu"].r,
              f"adaptive_rank {name}: card {picks['cuda'].r} vs CPU "
              f"{picks['cpu'].r}")
        check(uvt_rel(picks["cuda"].factors, picks["cpu"].factors)
              < SMALL_UVT_TOL, f"adaptive_rank {name} factors")
    # batched L = 3 against the looped single calls, on the card
    L = 3
    Ab = torch.stack([As_, As_.flip(1), 2.0 * As_])
    Bb = torch.stack([Bs_, Bs_.flip(1), Bs_])
    sb = summary_engine.build_summary(prng.PRNGKey(seed), Ab, Bb, 512,
                                      backend="cuda", probes=8, device=dev)
    eb = estimation_engine.estimate_product(prng.PRNGKey(seed + 1), sb, r,
                                            m=ms, T=8, with_error=True,
                                            device=dev)
    skeys = prng.split(prng.PRNGKey(seed, device=dev), L)
    ekeys = prng.split(prng.PRNGKey(seed + 1, device=dev), L)
    for i in range(L):
        one = summary_engine.build_summary(skeys[i], Ab[i], Bb[i], 512,
                                           backend="cuda", probes=8,
                                           device=dev)
        check(all(bool(torch.equal(x, y)) for x, y in
                  zip(tree_index(sb, i), one) if x is not None),
              f"batched summary pair {i} is the single one")
        est = estimation_engine.estimate_product(ekeys[i], one, r, m=ms, T=8,
                                                 with_error=True, device=dev)
        rel = uvt_rel(tree_index(eb.factors, i), est.factors)
        worst[f"batched pair {i}"] = rel
        check(rel < SMALL_UVT_TOL, f"batched estimate pair {i}: {rel}")
    # the Bernoulli sampler
    na, nb = summ["cpu"].norm_A, summ["cpu"].norm_B
    bern = {w: sampling.sample_entries_binomial(prng.PRNGKey(seed + 2),
                                                na.to(w), nb.to(w), ms)
            for w in where}
    same = all(bool(torch.equal(getattr(bern["cuda"], f).cpu(),
                                getattr(bern["cpu"], f)))
               for f in ("rows", "cols", "mask"))
    print(f"engine small d={ds} n={ns}: card vs CPU U V^T rel diff "
          + json.dumps(worst) + f" (tol {SMALL_UVT_TOL:.0e}); gates "
          f"{gates} equal on both; binomial sampler rows/cols/mask equal="
          f"{same} ({int(bern['cpu'].mask.sum())} kept)", flush=True)
    check(same, "sample_entries_binomial card vs CPU")


def device_trace(fn, label: str, record_shapes: bool = True):
    """Run ``fn`` (ending in a synchronize) under ``torch.profiler`` and
    return (its result, a record): the device's idle share of the host
    window the call spans (the share with no kernel, copy or set running),
    the five device operations that took the most time, and WAltMin's
    device time split by the PyTorch operation that launched it
    (``index_add_``, the (m, r, r) product, the solves, QR; the product is
    told apart by its input shapes, recorded only with ``record_shapes``).
    It reads the profiler's raw events: each device event names the
    operation that launched it (its linked correlation id), and an
    operation belongs to a category when an operation of that category on
    its thread encloses it (a solve calls its own helpers). Building
    torch's event tree instead takes tens of seconds for a flush's 400,000
    events. ``trace_s`` is the whole of it, the profiling included."""
    import bisect
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        with record_function(label):
            out = fn()
            torch.cuda.synchronize()

    def outer_product(e):
        shapes = e.shapes() if record_shapes else []
        return (len(shapes) >= 2 and len(shapes[0]) == 3
                and shapes[0][2] == 1 and len(shapes[1]) == 3
                and shapes[1][1] == 1)

    categories = {
        "index_add_": lambda name, e: name == "aten::index_add_",
        "outer_mrr_product": lambda name, e: (name == "aten::mul"
                                              and outer_product(e)),
        "solves": lambda name, e: name.startswith("aten::linalg_solve"),
        "qr": lambda name, e: name == "aten::linalg_qr"}
    ops, device, window = {}, [], None
    intervals = {cat: {} for cat in categories}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == label:
                window = (e.start_ns(), e.end_ns())
            if e.linked_correlation_id() != 0:
                continue
            span = (e.start_ns(), e.end_ns(), e.start_thread_id())
            ops[e.correlation_id()] = span
            for cat, pred in categories.items():
                if pred(name, e):
                    intervals[cat].setdefault(span[2], []).append(span[:2])
        elif e.device_type() == DeviceType.CUDA and name != label:
            device.append((name, e.start_ns(), e.end_ns(),
                           e.linked_correlation_id()))
    w0, w1 = window
    outermost = {}                       # cat -> thread -> (starts, ends)
    calls = {}
    for cat, by_thread in intervals.items():
        outermost[cat] = {}
        calls[cat] = 0
        for thread, spans in by_thread.items():
            merged = []
            for lo, hi in sorted(spans):
                if merged and lo <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], hi)
                else:
                    merged.append([lo, hi])
            outermost[cat][thread] = ([lo for lo, _ in merged],
                                      [hi for _, hi in merged])
            calls[cat] += len(merged)
    split = {cat: 0.0 for cat in categories}
    by_name: dict = {}
    spans = []
    for name, lo, hi, corr in device:
        spans.append((max(lo, w0), min(hi, w1)))
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (hi - lo), c + 1)
        op = ops.get(corr)
        if op is None:
            continue
        for cat, by_thread in outermost.items():
            starts, ends = by_thread.get(op[2], ((), ()))
            i = bisect.bisect_right(starts, op[0]) - 1
            if i >= 0 and op[1] <= ends[i]:
                split[cat] += hi - lo
    busy, end = 0.0, w0
    for lo, hi in sorted(spans):         # the union of the device spans
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    rec = {"window_ms": (w1 - w0) / 1e6, "device_events": len(spans),
           "device_busy_ms": busy / 1e6,
           "idle_share": (1.0 - busy / (w1 - w0) if spans else
                          "not measured: the profiler saw no device event"),
           "top5": [{"name": name[:90], "ms": t / 1e6, "count": c}
                    for name, (t, c) in top],
           "waltmin_split": {cat: {"ms": split[cat] / 1e6,
                                   "calls": calls[cat]}
                             for cat in categories},
           "trace_s": time.perf_counter() - t0}
    return out, rec


def service_stream(ops, key, A, B, k, r, seq_fin, gen, dev, card):
    """The serving phase's stream session over the full-width pair: a
    ``SketchService`` session fed phase 10's 4,096-row chunks with
    ``append``, its summary against phase 10's ``StreamingSummarizer``
    state bit for bit, then ``stream_factors(r)`` and its probe residual.
    Returns the launches of the session (counters set to 0 before it)."""
    from repro_torch import prng
    from repro_torch.serve.engine import SketchService
    d, n = A.shape
    k_sketch = prng.split(key, 3)[0]
    svc = SketchService(k=k, probes=PROBES, cosketch=COSKETCH, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sid = svc.open_stream(k_sketch, d, n, n)
    for lo in range(0, d, STREAM_CHUNK):
        svc.append(sid, A[lo:lo + STREAM_CHUNK], B[lo:lo + STREAM_CHUNK])
    summary = svc.query(sid)
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    equal = _fields_equal(summary, seq_fin)
    check(all(equal.values()),
          f"service stream session bit-identical to phase 10: {equal}")
    t0 = time.perf_counter()
    est = svc.stream_factors(sid, r=r)
    torch.cuda.synchronize()
    factors_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    resid = probe_residual(A, B, est.factors, gen)
    rec = dict(d=d, n=n, k=k, chunk=STREAM_CHUNK, append_s=append_s,
               stream_factors_s=factors_s, probe_residual=resid,
               bitwise_vs_phase10=equal, launches=launches,
               engine=vars(svc.engine.stats))
    print(f"serve stream_session [{card}] " + json.dumps(rec), flush=True)
    check(resid < PROBE_RESIDUAL_MAX, f"service stream residual {resid}")
    svc.close_stream(sid)
    return launches


def serving_sweep(key, gen, dev, card):
    """benchmarks/run.py::serving_sweep at its full size, per summary
    backend: one bucket of SERVE_L requests a flush through a
    ``SketchService`` on a fresh engine, per plan cell; the cold flush
    builds, every warm flush must build nothing. Each cell's summaries are
    held bit for bit against each request served alone. Returns the cells
    and the first cell's flush, to trace a warm one."""
    from repro_torch import prng
    from repro_torch.core.pipeline import PipelineEngine
    from repro_torch.serve.engine import SketchService
    pairs = [planted_pair(gen, SERVE_D, SERVE_N, dev)
             for _ in range(SERVE_L)]
    keys = [prng.fold_in(key, i) for i in range(SERVE_L)]
    cells = []
    for backend in SERVE_BACKENDS:
        for name, kw in SERVE_PLANS:
            engine = PipelineEngine()
            svc = SketchService(k=SERVE_K, backend=backend, block=1024,
                                probes=SERVE_PROBES, engine=engine,
                                device=dev)

            def flush_once(kw=kw, svc=svc):
                for kk, (A, B) in zip(keys, pairs):
                    svc.submit(kk, A, B)
                out = svc.flush_factors(**kw)
                torch.cuda.synchronize()
                return out

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flush_once()
            cold_us = (time.perf_counter() - t0) * 1e6
            traces_cold = engine.stats.traces
            est_cold = engine.stats.est_dispatches
            t0 = time.perf_counter()
            for _ in range(SERVE_WARM):
                out = flush_once()
            warm_us = (time.perf_counter() - t0) / SERVE_WARM * 1e6
            alone = PipelineEngine()
            spec = svc._sketch_spec()
            served = list(out.values())
            equal = all(
                all(torch.equal(getattr(alone.summarize(spec, kk, A, B), f),
                                getattr(s.summary, f))
                    for f in ("A_sketch", "B_sketch", "norm_A", "norm_B",
                              "probes"))
                for kk, (A, B), s in zip(keys, pairs, served))
            rec = {"backend": backend, "name": name,
                   "requests_per_flush": SERVE_L,
                   "cold_us_per_request": cold_us / SERVE_L,
                   "warm_us_per_request": warm_us / SERVE_L,
                   "cold_over_warm": cold_us / warm_us,
                   "traces_cold": traces_cold,
                   "traces_warm": engine.stats.traces - traces_cold,
                   "est_dispatches_per_flush":
                       (engine.stats.est_dispatches - est_cold) / SERVE_WARM,
                   "curve_dispatches": engine.stats.curve_dispatches,
                   "rank": served[0].factors.r,
                   "summaries_equal_served_alone": equal,
                   "cache": {"hits": engine.stats.hits,
                             "misses": engine.stats.misses}}
            print(f"serve sweep [{card}] " + json.dumps(rec), flush=True)
            check(rec["traces_warm"] == 0,
                  f"serving {backend} {name}: no build on a warm flush")
            check(equal, f"serving {backend} {name}: summaries equal each "
                  f"request served alone")
            cells.append(rec)
            if len(cells) == 1:
                first = flush_once
    return cells, first


def traffic_sweep(dev, card):
    """benchmarks/run.py::traffic_sweep at its full size (the JAX package's
    ``scan`` summary backend): a single shape, three shapes, four tenants
    and an overload into a bounded queue. Steady cells must batch
    (occupancy > 1); no cell may build after its warm-up."""
    from repro_torch.serve.traffic import TrafficConfig, run_traffic
    s1, s2, s3 = TRAFFIC_SHAPES
    cells = [
        TrafficConfig(name="steady_single_shape", shapes=(s1,),
                      **TRAFFIC_BASE),
        TrafficConfig(name="mixed_shapes", shapes=(s1, s2, s3),
                      **TRAFFIC_BASE),
        TrafficConfig(name="multi_tenant", shapes=(s1,),
                      tenants=("acme", "globex", 7, None), **TRAFFIC_BASE),
        TrafficConfig(name="overload_shed", shapes=(s1,), rate_x=4.0,
                      max_queue=2 * TRAFFIC_BASE["max_batch"],
                      **TRAFFIC_BASE),
    ]
    records = []
    for cfg in cells:
        rec = run_traffic(cfg, device=dev)
        print(f"serve traffic [{card}] " + json.dumps(
            {key: v for key, v in rec.items() if key != "config"}),
            flush=True)
        check(rec["traces_steady"] == 0,
              f"traffic {cfg.name}: no build in the steady state")
        check(rec["completed"] + sum(rec["shed"].values()) == cfg.n_requests,
              f"traffic {cfg.name}: every request served or shed")
        if cfg.name != "overload_shed":
            check(rec["occupancy"] > 1.0,
                  f"traffic {cfg.name}: occupancy {rec['occupancy']}")
        records.append(rec)
    return records


def residual_on(A, B, factors, W) -> float:
    """``probe_residual`` on a given W (n2, 8)."""
    AtBW = A.T @ (B @ W)
    UVtW = factors.U @ (factors.V.T @ W)
    return float(torch.linalg.norm(AtBW - UVtW) / torch.linalg.norm(AtBW))


def free_port() -> int:
    """A free localhost TCP port, from the OS."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def distributed_full_width(ops, key, A, B, k, r, m, T, phase4, seed, dev,
                           card):
    """Phase 4b: the distributed path on one NCCL rank at full width.
    ``phase4`` holds the warm call's factors and the memory it added.
    Returns the launches of ``distributed_smppca`` and of the distributed
    stream (counters set to 0 before each)."""
    import datetime
    import torch.distributed as tdist
    from repro_torch import prng
    from repro_torch.core import distributed, summary_engine
    from repro_torch.core.smppca import smppca_from_summary
    from repro_torch.core.streaming import StreamingSummarizer
    d, n = A.shape
    t0 = time.perf_counter()
    # what multihost.initialize does for a cell of more than one process:
    # a TCPStore on localhost (this process serves it), then NCCL over it
    store = tdist.TCPStore("127.0.0.1", free_port(), 1, is_master=True,
                           timeout=datetime.timedelta(seconds=120))
    tdist.init_process_group("nccl", store=store, rank=0, world_size=1)
    group = tdist.group.WORLD
    one = torch.ones(1, device=dev)
    tdist.all_reduce(one, group=group)      # NCCL's communicator, first use
    torch.cuda.synchronize()
    rec = dict(world_size=tdist.get_world_size(), backend=tdist.get_backend(),
               init_s=time.perf_counter() - t0)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        f = distributed.distributed_smppca(group, key, A, B, r=r, k=k, m=m,
                                           T=T, device=dev)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        rec["added_peak_gb"] = (torch.cuda.max_memory_allocated()
                                - before) / 1e9
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["phase4_added_peak_gb"] = phase4["added_peak_gb"]
        rec["launches"] = launches
        check(launches == {"sketch_fused": 2, "sampled_rescaled_dot": 1,
                           "blocked_fwht": 0, "flash_attention": 0},
              f"launches per distributed_smppca call: {launches}")
        check(tuple(f.U.shape) == (n, r) and bool(torch.isfinite(f.U).all())
              and bool(torch.isfinite(f.V).all()),
              "distributed factors: shape and finite")
        W = torch.randn(n, 8, generator=torch.Generator(device=dev)
                        .manual_seed(seed + 3), device=dev)
        rec["probe_residual"] = residual_on(A, B, f, W)
        rec["phase4_probe_residual"] = residual_on(A, B, phase4["factors"], W)
        uvw = f.U @ (f.V.T @ W)
        del f
        # the summary of the pass against the cuda backend's, and the
        # all-reduces of its blocks alone (CUDA events); steps 2 and 3 on
        # the cuda backend's summary under the same key
        k1, k2 = prng.split(key)
        got = summary_engine.build_summary(k1, A, B, k, backend="distributed",
                                           group=group, device=dev)
        want = summary_engine.build_summary(k1, A, B, k, backend="cuda",
                                            device=dev)
        alone = smppca_from_summary(k2, want, r=r, m=m, T=T,
                                    device=dev).factors
        ref = alone.U @ (alone.V.T @ W)
        rec["uvt_probe_rel_diff_vs_cuda_backend"] = float(
            torch.linalg.norm(uvw - ref) / torch.linalg.norm(ref))
        del alone, ref, uvw
        rec["summary_column_err"] = max(
            column_err(got.A_sketch, want.A_sketch),
            column_err(got.B_sketch, want.B_sketch))
        rec["summary_norm_rel_err"] = max(
            float(((got.norm_A - want.norm_A).abs() / want.norm_A).max()),
            float(((got.norm_B - want.norm_B).abs() / want.norm_B).max()))
        rec["summary_bitwise_vs_cuda"] = _fields_equal(got, want)
        blocks = [got.A_sketch, got.B_sketch, got.norm_A, got.norm_B]

        def reduce():
            for x in blocks:
                tdist.all_reduce(x, group=group)
        reduce()
        rec["allreduce_ms"] = cuda_ms(reduce, reps=5)
        rec["allreduce_bytes"] = sum(x.numel() * 4 for x in blocks)
        del got, want, blocks
        print(f"distributed smppca [{card}] " + json.dumps(rec), flush=True)
        check(rec["summary_column_err"] <= SKETCH_TOL,
              f"distributed summary against the cuda backend: "
              f"{rec['summary_column_err']}")
        check(rec["probe_residual"] < PROBE_RESIDUAL_MAX,
              f"distributed probe residual {rec['probe_residual']}")
        check(rec["uvt_probe_rel_diff_vs_cuda_backend"] < WARM_UVT_TOL,
              f"distributed factors against the cuda backend's summary's: "
              f"{rec['uvt_probe_rel_diff_vs_cuda_backend']}")
        check(rec["added_peak_gb"] <= phase4["added_peak_gb"]
              + DIST_ADDED_GB_SLACK,
              f"distributed call's added memory {rec['added_peak_gb']} GB")
        # the distributed stream against the single-process stream fed the
        # same slabs
        ops.reset_launch_counts()
        s_dist, ms = timed(lambda: distributed.distributed_streaming_summary(
            group, k1, A, B, k, slab=DIST_SLAB, probes=PROBES,
            cosketch=COSKETCH, device=dev))
        launches_stream = dict(ops.LAUNCHES)
        summ = StreamingSummarizer(k, probes=PROBES, cosketch=COSKETCH,
                                   device=dev)

        def single():
            st = summ.init(k1, (d, n, n))
            for off in range(0, d, DIST_SLAB):
                st = summ.update(st, A[off:off + DIST_SLAB],
                                 B[off:off + DIST_SLAB], off)
            return summ.finalize(st)
        s_one, ms_one = timed(single)
        bitwise = _fields_equal(s_dist, s_one)
        errs = {name: column_err(getattr(s_dist, name), getattr(s_one, name))
                for name in ("A_sketch", "B_sketch", "probes", "cosketch_Y",
                             "cosketch_W")}
        srec = dict(slab=DIST_SLAB, probes=PROBES, cosketch=COSKETCH, ms=ms,
                    single_process_ms=ms_one, launches=launches_stream,
                    bitwise_vs_single_process=bitwise, column_err=errs)
        print(f"distributed stream [{card}] " + json.dumps(srec), flush=True)
        check(launches_stream["sketch_fused"] == 2 * -(-d // DIST_SLAB),
              f"distributed stream launches {launches_stream}")
        check(all(e <= SKETCH_TOL for e in errs.values()),
              f"distributed stream against the single-process stream: {errs}")
        del s_dist, s_one
    finally:
        tdist.destroy_process_group()
    return launches, launches_stream


def multihost_rows(seed, lo, hi, n, dev):
    """Rows [lo, hi) of a planted pair, made on the card from the seed and
    ``lo`` alone (the same chunking gives the same rows in every
    process)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 1_000_003 + lo)
    return planted_pair(gen, hi - lo, n, dev)


def multihost_child(seed: int) -> int:
    """One process of phase 16's cell: join it (``multihost.initialize``
    from the REPRO_* environment), build the other host's partial state,
    then time this host's ingest while the other process waits (one rank on
    the card at a time, as each host would have its own card),
    ``sharded_ingest`` this host's shard on the card (both ranks at once),
    then time the f32 merge and the gate's merge alone, each after a
    barrier, and print one ``multihost_rank`` JSON line."""
    import hashlib
    import torch.distributed as tdist
    from repro_torch import prng
    from repro_torch.core import streaming
    from repro_torch.dist import multihost
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # the exchange goes through the store, not a collective: NCCL cannot
    # hold two ranks on one card, so the group is gloo's
    check(multihost.initialize(device="cpu", timeout=MULTIHOST_TIMEOUT),
          "the multi-host cell is configured")
    pid, nproc = multihost.process_topology()
    d, n = MULTIHOST_D, MULTIHOST_N
    key = prng.PRNGKey(seed, device=dev)
    summ = streaming.StreamingSummarizer(512, probes=PROBES, device=dev)
    shapes = (d, n, n)

    def fetch(lo, hi):
        return multihost_rows(seed, lo, hi, n, dev)

    def ingest(h):
        lo, hi = multihost.host_shard_range(d, hosts=nproc, host=h)
        chunks = (fetch(off, min(off + MULTIHOST_CHUNK, hi))
                  for off in range(lo, hi, MULTIHOST_CHUNK))
        return summ.ingest(summ.init(key, shapes), chunks, row_offset=lo)

    rec = dict(rank=pid, processes=nproc)
    parts = [None] * nproc
    for h in range(nproc):
        if h != pid:
            parts[h] = ingest(h)
    for h in range(nproc):
        tdist.barrier()
        if h == pid:
            parts[h], ms = timed(lambda: ingest(h))
            lo, hi = multihost.host_shard_range(d, hosts=nproc, host=h)
            rec["ingest_s"], rec["rows"] = ms / 1e3, hi - lo
    rec["rows_per_s"] = rec["rows"] / rec["ingest_s"]
    tdist.barrier()
    ops.reset_launch_counts()
    merged, ms = timed(lambda: multihost.sharded_ingest(
        summ, key, shapes, fetch, chunk=MULTIHOST_CHUNK, wire="f32",
        timeout=MULTIHOST_TIMEOUT))
    rec["sharded_ingest_s"] = ms / 1e3
    rec["launches"] = dict(ops.LAUNCHES)
    rec["equals_local_tree_merge"] = all(_fields_equal(
        merged, streaming.tree_merge(parts)).values())
    rec["wire_bytes_f32"] = len(streaming.wire_pack(
        streaming.compress_state(parts[pid], "f32")))
    tdist.barrier()
    again, ms = timed(lambda: multihost.cross_host_merge(
        parts[pid], wire="f32", timeout=MULTIHOST_TIMEOUT))
    rec["merge_f32_s"] = ms / 1e3
    rec["merge_f32_equal"] = all(_fields_equal(merged, again).values())
    del again
    tdist.barrier()
    gated, ms = timed(lambda: multihost.cross_host_merge(
        parts[pid], tol=WIRE_TOL, timeout=MULTIHOST_TIMEOUT))
    rec["merge_gate_s"] = ms / 1e3
    spec, err = streaming.choose_wire_spec(parts[pid], WIRE_TOL)
    rec.update(gate_vote=spec.sketch, gate_wire_error=err,
               wire_bytes_gate_vote=len(streaming.wire_pack(
                   streaming.compress_state(parts[pid], spec))),
               gate_rel_err=float((gated.A_acc - merged.A_acc).abs().max()
                                  / merged.A_acc.abs().max()))
    digest = hashlib.sha256()
    for x in merged:
        if x is not None:
            digest.update(x.detach().cpu().numpy().tobytes())
    rec["sha256"] = digest.hexdigest()
    rec["rows_seen"] = int(merged.rows_seen)
    print("multihost_rank " + json.dumps(rec), flush=True)
    return 0


def multihost_cell(seed: int, card: str) -> dict:
    """Phase 16: two processes of this script on the one card, joined
    through a TCPStore on localhost (``multihost.initialize`` from the
    REPRO_* environment), each under MULTIHOST_TIMEOUT seconds and killed
    when it expires. Returns the launches of both ranks'
    ``sharded_ingest``."""
    env = dict(os.environ, REPRO_COORDINATOR=f"127.0.0.1:{free_port()}",
               REPRO_NUM_PROCESSES="2", GLOO_SOCKET_IFNAME="lo")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for rank in range(2):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--multihost-child", "--seed", str(seed)],
                env=dict(env, REPRO_PROCESS_ID=str(rank)), stdout=log,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + MULTIHOST_TIMEOUT
        try:
            for p in procs:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f"multi-host rank {rank} rc={p.returncode}:\n{out[-4000:]}")
    ranks = [json.loads(next(line for line in out.splitlines()
                             if line.startswith("multihost_rank "))
                        .split(" ", 1)[1]) for out in outs]
    rec = dict(d=MULTIHOST_D, n=MULTIHOST_N, k=512, probes=PROBES,
               chunk=MULTIHOST_CHUNK, child_timeout_s=MULTIHOST_TIMEOUT,
               cell_s=time.perf_counter() - t0,
               ranks_bitwise_equal=ranks[0]["sha256"] == ranks[1]["sha256"],
               ranks=ranks)
    print(f"multihost [{card}] " + json.dumps(rec), flush=True)
    check(rec["ranks_bitwise_equal"], "both ranks' merged states agree")
    check(all(x["equals_local_tree_merge"] and x["merge_f32_equal"]
              and x["rows_seen"] == MULTIHOST_D for x in ranks),
          "the f32 merge is the local tree_merge of both partial states")
    check(all(x["gate_rel_err"] <= 2e-2 for x in ranks),
          "the gated merge within the quantization's tolerance")
    return {name: sum(x["launches"][name] for x in ranks)
            for name in ranks[0]["launches"]}


def gradient_phase(ops, seed, dev, card):
    """Phase 17: the gradient tap and the A = I compressor at one
    granite-3-8b MLP layer's widths. Returns the launches of the taps'
    backward and decompression, and of the compressor."""
    from repro_torch import prng
    from repro_torch.optim import grad_compression as gc
    from repro_torch.train import sketched_dense as sd
    n_in, n_out, T = GRAD_N_IN, GRAD_N_OUT, GRAD_T
    key = prng.PRNGKey(seed, device=dev)
    # benchmarks/run.py::grad_compression's construction, drawn with the
    # port's keys on the card
    kw, kx, kz, kp1, kp2 = prng.split(key, 5)
    w_true = prng.normal(kw, (n_in, n_out)) * 0.05
    w = w_true + (prng.normal(kp1, (n_in, 6))
                  @ prng.normal(kp2, (6, n_out))) * 0.02
    z = prng.normal(kz, (8, T // 8, 16))
    E = prng.normal(prng.fold_in(kx, 1), (16, n_in))
    x = z @ E + 0.05 * prng.normal(kx, (8, T // 8, n_in))
    target = x @ w_true
    del w_true, z, E
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def events(fn):
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    taps = {f: v.requires_grad_()
            for f, v in sd.tap_init(n_in, n_out, GRAD_K, device=dev).items()}
    wp, xp = w.clone().requires_grad_(), x.clone().requires_grad_()
    ops.reset_launch_counts()

    def tapped():
        y = sd.sketched_dense(wp, taps, xp, key, GRAD_K, 1024)
        torch.mean((y - target) ** 2).backward()
    cfg = sd.TapConfig(sketch_k=GRAD_K, rank=GRAD_R)
    with recording(ops, "sketch_fused", "sampled_rescaled_dot") as tap_calls:
        _, tap_ms = events(tapped)
        ghat, decompress_ms = events(lambda: sd.decompress_tap(
            key, {f: v.grad for f, v in taps.items()}, cfg))
    launches_taps = dict(ops.LAUNCHES)
    w2, x2 = w.clone().requires_grad_(), x.clone().requires_grad_()
    _, dense_ms = events(lambda: torch.mean((x2 @ w2 - target) ** 2)
                         .backward())
    dw_true, dx_ref = w2.grad, x2.grad
    dx_rel = float(torch.linalg.norm(xp.grad - dx_ref)
                   / torch.linalg.norm(dx_ref))

    def cosine(a, b):
        return float(torch.sum(a * b) / (torch.linalg.norm(a)
                                         * torch.linalg.norm(b)))
    cos_t = cosine(dw_true, ghat)
    ops.reset_launch_counts()
    grads = {"w": dw_true}
    with recording(ops, "sketch_fused", "sampled_rescaled_dot") as comp_calls:
        (out, _, stats), compress_ms = events(lambda: gc.compress_grads(
            key, grads, gc.init_state(grads), gc.CompressionConfig()))
    launches_comp = dict(ops.LAUNCHES)
    # the path's own launches against the plain versions on their inputs
    # (the taps' Pi.T with X and with dY, the compressor's Pi with dW, and
    # the gathers at m = 8 (n_in + n_out) r); the plain versions launch
    # nothing
    held = dict(
        sketch_taps=held_sketch(ops, tap_calls["sketch_fused"], "taps"),
        sampled_taps=held_sampled(ops, tap_calls["sampled_rescaled_dot"],
                                  "decompress_tap"),
        sketch_compressor=held_sketch(ops, comp_calls["sketch_fused"],
                                      "compressor"),
        sampled_compressor=held_sampled(
            ops, comp_calls["sampled_rescaled_dot"], "compress_grads"))
    del tap_calls, comp_calls
    cos_b = cosine(dw_true, out["w"])
    comm = (GRAD_K * (n_in + n_out) + n_in + n_out) / (n_in * n_out)
    rec = dict(n_in=n_in, n_out=n_out, T=T, k=GRAD_K, r=GRAD_R,
               m_taps=8 * (n_in + n_out) * GRAD_R,
               m_compressor=8 * (n_in + n_out) * gc.CompressionConfig().rank,
               cos_taps=cos_t, cos_AeqI=cos_b, comm=comm,
               compressor_comm_fraction=stats["comm_fraction"],
               dx_rel_err=dx_rel, tap_fwd_bwd_ms=tap_ms,
               decompress_tap_ms=decompress_ms, dense_fwd_bwd_ms=dense_ms,
               compress_grads_ms=compress_ms, launches_taps=launches_taps,
               launches_compressor=launches_comp, held_max_abs_err=held)
    print(f"gradient layer [{card}] " + json.dumps(rec), flush=True)
    check(launches_taps == {"sketch_fused": 2, "sampled_rescaled_dot": 1,
                            "blocked_fwht": 0, "flash_attention": 0},
          f"tap path launches {launches_taps}")
    check(launches_comp == {"sketch_fused": 1, "sampled_rescaled_dot": 1,
                            "blocked_fwht": 0, "flash_attention": 0},
          f"compressor launches {launches_comp}")
    check(bool((wp.grad == 0).all()), "the tap layer's dW is zero")
    check(dx_rel <= GRAD_DX_TOL, f"the tap layer's dx: {dx_rel}")
    check(math.isfinite(cos_t) and math.isfinite(cos_b) and cos_t > cos_b,
          f"cos_taps {cos_t} > cos_AeqI {cos_b}")
    return launches_taps, launches_comp


def lm_requests(ops, model, params, requests, seed, card, tag, flash,
                plain):
    """Each of ``requests`` (label, batch, prompt, new tokens, temperature)
    through ``Engine.generate`` on the card, request (a) twice (the same
    tokens both times), counters set to 0 before each run and read after:
    ``flash`` ``flash_attention`` launches and nothing else, routes
    {"flash": flash, "plain": plain}. Prints a ``{tag} request ...`` line a
    run; returns (the last run's record by label, the prompts by label,
    the launches of all runs)."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import attention as attn
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = model.cfg
    path_launches = {name: 0 for name in ops.LAUNCHES}
    reqs, prompts = {}, {}
    for label, B, P, new, temp in requests:
        batch = launch.prompt_batch(model, B, P, seed)
        prompts[label] = batch["tokens"]
        eng = Engine(model, params, ServeConfig(max_new_tokens=new,
                                                temperature=temp, seed=seed))
        runs = []
        for _ in range(2 if label == "a" else 1):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            attn.reset_route_counts()
            out = eng.generate(batch)
            launches, routes = dict(ops.LAUNCHES), dict(attn.ROUTES)
            for name in path_launches:
                path_launches[name] += launches[name]
            t = eng.timings
            rec = dict(batch=B, prompt=P, new_tokens=new, temperature=temp,
                       prefill_s=t["prefill_s"],
                       prefill_tokens_per_s=B * P / t["prefill_s"],
                       decode_ms_per_token=1e3 * t["decode_s"]
                       / t["decode_steps"],
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches=launches, routes=routes)
            print(f"{tag} request {label} [{card}] " + json.dumps(rec),
                  flush=True)
            check(launches == dict({n: 0 for n in launches},
                                   flash_attention=flash),
                  f"{tag} request {label}: {flash} flash launches a "
                  f"prefill, nothing else: {launches}")
            check(routes == {"flash": flash, "plain": plain},
                  f"{tag} request {label}: routes a prefill {routes}")
            check(tuple(out.shape) == (B, P + new)
                  and bool(torch.equal(out[:, :P], batch["tokens"]))
                  and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
                  f"{tag} request {label}: tokens {tuple(out.shape)}")
            runs.append(out)
        if len(runs) == 2:
            check(bool(torch.equal(runs[0], runs[1])),
                  f"{tag} request {label}: two greedy runs give the same "
                  f"tokens")
        reqs[label] = rec
        del runs, out, batch, eng
        torch.cuda.empty_cache()
    return reqs, prompts, path_launches


@contextlib.contextmanager
def recorded_routes():
    """While open, each ``moe.moe_apply`` call also appends its tokens'
    expert ids, (T, top_k) in ascending order, to the list it yields:
    recomputed from the call's own router inputs by the same float32 ops,
    so they are the ids the call uses."""
    from repro_torch.models import moe
    apply, routes = moe.moe_apply, []

    def recording(p, x, *, top_k, **kw):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p.router.w.float(), dim=-1)
        routes.append(moe.top_k_stable(probs, top_k)[1].sort(-1).values)
        return apply(p, x, top_k=top_k, **kw)
    moe.moe_apply = recording
    try:
        yield routes
    finally:
        moe.moe_apply = apply


def lm_forward_check(model, params, prompt, steps, seed, tol, tag):
    """Prefill of ``prompt`` tokens plus ``steps`` decode steps, batch 1,
    against the full-sequence forward of the same tokens (the twin of
    tests/models/test_archs.py::test_prefill_decode_matches_forward):
    fails at ``tol`` or above (``tol=None``: reported only); returns (the
    largest logit error held, a record). An MoE model's routes are recorded on both paths: from the
    first decoded token that some layer routes to other experts than the
    forward does (a near-tie that float32 noise tips), the steps compute
    another branch of the function and are reported, not held; tokens of
    the prompt routed otherwise are counted."""
    cfg = model.cfg
    S = prompt + steps
    batch = seeded_batch(model, 1, S, seed + 1)
    tokens = batch["tokens"]
    V = cfg.vocab_size
    record = recorded_routes() if cfg.n_experts else \
        contextlib.nullcontext([])
    with torch.inference_mode(), record as routes:
        full = model.forward(params, batch)[..., :V]
        fwd = list(routes)
        caches = model.init_cache(1, S)
        del routes[:]
        lg, caches = model.prefill(params, dict(batch,
                                                tokens=tokens[:, :prompt]),
                                   caches)
        pre = list(routes)
        errs = [float((lg[0, 0, :V] - full[0, prompt - 1]).abs().max())]
        rerouted = []
        for t in range(prompt, S):
            del routes[:]
            lg, caches = model.decode_step(params, caches, tokens[:, t:t + 1],
                                           t)
            errs.append(float((lg[0, 0, :V] - full[0, t]).abs().max()))
            if any(not torch.equal(r[0], f[t]) for r, f in zip(routes, fwd)):
                rerouted.append(t - prompt)
        prompt_rerouted = sum(int((f[:prompt] != r).any(-1).sum())
                              for f, r in zip(fwd, pre))
    del full, caches, lg, batch
    torch.cuda.empty_cache()
    held = errs[:1 + (rerouted[0] if rerouted else steps)]
    rec = dict(prompt=prompt, steps=steps, max_err=max(held), tol=tol,
               errs=errs, held_steps=len(held) - 1)
    if cfg.n_experts:
        rec.update(rerouted_steps=rerouted,
                   prompt_tokens_rerouted=prompt_rerouted,
                   route_decisions=len(fwd) * S)
    print(f"{tag} prefill+decode against the full forward " + json.dumps(rec),
          flush=True)
    check(tol is None or max(held) < tol,
          f"{tag} prefill+decode vs forward: {errs}")
    return max(held), rec


def lm_path_flash(ops, model, params, requests, prompts, dev):
    """Layer 0's attention on the model's own weights at each request's
    shapes, through the path's call (``attention.flash_prefill``) against
    the plain version, and the call's time: ({label: ms}, {label: max abs
    err})."""
    from repro_torch.models import attention as attn
    from repro_torch.models import common
    from repro_torch.models import transformer as tt
    cfg = model.cfg
    blk = params.groups[0][0][0]
    cd = tt._cdtype(cfg)
    flash_ms, held = {}, {}
    with torch.inference_mode():
        for label, B, P, *_ in requests:
            x = tt._embed_tokens(params, cfg, prompts[label])
            h = common.norm_apply(cfg.norm, blk.norm1, x).to(cd)
            q, k, v = attn.qkv_project(blk.attn, h, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim_,
                                       torch.arange(P, device=dev),
                                       cfg.rope_theta, cd)
            del x, h
            held[label] = flash_check(ops, q, k, v, True,
                                      f"{cfg.name} layer 0, request {label}",
                                      out=attn.flash_prefill(q, k, v))
            attn.flash_prefill(q, k, v)
            flash_ms[label] = cuda_ms(lambda: attn.flash_prefill(q, k, v),
                                      reps=1 if P >= 16_384 else 5)
            del q, k, v
    torch.cuda.empty_cache()
    return flash_ms, held


def lm_init(arch, seed, dev, card, tag, **kw):
    """``launch.serve.init_model`` on the card, with its time, bytes and
    peak in a ``{tag} init`` line: (model, params, the record)."""
    from repro_torch.launch import serve as launch
    torch.cuda.empty_cache()
    live_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    model, params, init_s = launch.init_model(arch, seed=seed, device=dev,
                                              **kw)
    n_blocks = sum(p.numel() for n, p in params.named_parameters()
                   if n.startswith("groups."))
    init = dict(arch=model.cfg.name, param_dtype=model.cfg.param_dtype,
                params=sum(p.numel() for p in params.parameters()),
                block_params=n_blocks,
                param_gb=sum(p.numel() * p.element_size()
                             for p in params.parameters()) / 1e9,
                live_before_gb=live_gb, init_s=init_s,
                init_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"{tag} init [{card}] " + json.dumps(init), flush=True)
    return model, params, init


def seeded_batch(model, B, S, seed) -> dict:
    """``launch.serve.prompt_batch``'s prompts, with its zero stub inputs
    (whisper's frames, llama's image embeddings) replaced by 0.1 N(0, 1)
    draws from the seed, in their dtype: on zeros every cross-attention's
    softmax is uniform, which no check would see through."""
    from repro_torch.launch import serve as launch
    batch = launch.prompt_batch(model, B, S, seed)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, t in batch.items():
        if name != "tokens":
            batch[name] = (0.1 * torch.randn(t.shape, generator=gen,
                                             device=t.device)).to(t.dtype)
    return batch


def attention_bound_ms(cfg, B, P, fa, kv_len=None) -> float:
    """One attention call at flash_attention's float32 bound (three TF32
    passes a product): causal over P tokens, or, given ``kv_len``, P
    queries against that many context rows, unmasked (a cross-attention,
    an encoder's self-attention)."""
    kv = P if kv_len is None else kv_len
    flops = (2.0 if kv_len is None else 4.0) * B * cfg.n_heads * P * kv \
        * cfg.head_dim_
    elems = B * (2 * P * cfg.n_heads + 2 * kv * cfg.n_kv_heads) * cfg.head_dim_
    qk, pv, _ = fa.PASSES["wgmma", 4]
    return bound((qk + pv) / 2 * flops, 4 * elems, PEAK_TF32_FLOPS)[0]


def prefill_bound(model, params, B, P, fa) -> dict:
    """A prefill's least time on the card: each weight's product at the
    bf16 rate over the rows it applies to (a prompt token; a context row
    for the cross-attention K and V, the encoder and the image projection;
    one row a sequence for the head, which scores the last token), plus
    every attention call at flash_attention's float32 bound (causal
    self-attention over the prompt, cross-attention against the context,
    the encoder's over its frames)."""
    from repro_torch.models import transformer as tt
    cfg = model.cfg
    L = cfg.enc_context if cfg.is_encdec else cfg.n_img_tokens
    ctx_kv = set()
    for name, mod in params.named_modules():
        if isinstance(mod, (tt.CrossBlock, tt.DecXAttnBlock)):
            a = "attn" if isinstance(mod, tt.CrossBlock) else "xattn"
            ctx_kv |= {f"{name}.{a}.wk.w", f"{name}.{a}.wv.w"}
    flops = 0.0
    for name, p in params.named_parameters():
        if p.ndim < 2 or name.startswith("embed."):
            continue                # norms, biases, gates; a table lookup
        rows = B if name.startswith("head.") else B * L if (
            name in ctx_kv or name.startswith(("enc.", "img_proj."))) \
            else B * P
        flops += 2.0 * p.numel() * rows
    attn_ms = 0.0
    for pattern, count in cfg.groups:
        for btype in pattern:
            if btype in ("attn", "attn_moe", "dec_xattn"):
                attn_ms += count * attention_bound_ms(cfg, B, P, fa)
            if btype in ("xattn", "dec_xattn"):
                attn_ms += count * attention_bound_ms(cfg, B, P, fa, L)
    if cfg.is_encdec:
        attn_ms += cfg.n_enc_layers * attention_bound_ms(cfg, B, L, fa, L)
    return dict(prefill_bound_s=flops / PEAK_BF16_FLOPS + attn_ms / 1e3,
                prefill_attention_bound_s=attn_ms / 1e3)


def layer_check(blk, btype, cfg, x, xattn_ctx, tag, label) -> dict:
    """One block's ``seq`` on the card against a copy of it on the CPU,
    over x (B, S, d) at positions 0..S-1 with the cross-attention context
    ``xattn_ctx`` (or None): the largest error, held within
    ``LM_LAYER_TOL`` of the CPU output's largest entry."""
    from repro_torch.models import transformer as tt
    S = x.shape[1]
    cpu_blk = tt.make_block(btype, cfg, device="cpu")
    cpu_blk.load_state_dict(blk.state_dict())
    with torch.inference_mode():
        y_card, _ = blk.seq(x, {"positions": torch.arange(S, device=x.device),
                                "xattn_ctx": xattn_ctx})
        y_cpu, _ = cpu_blk.seq(x.cpu(), {
            "positions": torch.arange(S),
            "xattn_ctx": None if xattn_ctx is None else xattn_ctx.cpu()})
    err = float((y_card.cpu() - y_cpu).abs().max())
    scale = float(y_cpu.abs().max())
    print(f"{tag} {label} card against CPU, S={S}: max abs err {err:.4e} of "
          f"{scale:.4e} (tol {LM_LAYER_TOL} of the largest)", flush=True)
    check(err <= LM_LAYER_TOL * scale,
          f"{tag} {label} card vs CPU: {err} of {scale}")
    return dict(S=S, max_abs_err=err, scale=scale)


def lm_phase(ops, seed, dev, card):
    """Phase 18: the LM path at full width (``launch.serve.init_model`` and
    ``serve.engine.Engine`` on the card). Returns the launches of the
    requests' runs (counters set to 0 before each and read after), and the
    largest error of the ``flash_attention`` calls held on the path's
    shapes."""
    from repro_torch.models import transformer as tt
    fa = ops.KERNELS["flash_attention"]
    model, params, init = lm_init(LM_ARCH, seed, dev, card, "lm")
    cfg = model.cfg
    param_bytes = init["param_gb"] * 1e9
    layers = sum(len(p) * c for p, c in cfg.groups)
    reqs, prompts, path_launches = lm_requests(
        ops, model, params, LM_REQUESTS, seed, card, "lm", layers, 0)

    # where a decode step's time goes: 4 steps at request (a)'s batch under
    # torch.profiler, and the cast of every float32 weight to bf16 that a
    # step makes (each dense_apply rounds its w), timed alone
    label, B, P, *_ = LM_REQUESTS[0]
    with torch.inference_mode():
        caches = model.init_cache(B, P + 4)
        _, caches = model.prefill(params, {"tokens": prompts[label]}, caches)
        last = prompts[label][:, -1:]

        def decode_steps():
            for t in range(4):
                model.decode_step(params, caches, last, P + t)
        decode_steps()
        _, trace = device_trace(decode_steps, "lm_decode",
                                record_shapes=False)
        del trace["waltmin_split"]

        def cast_all():
            for p in params.parameters():
                p.to(torch.bfloat16)
        cast_all()
        trace.update(steps=4, batch=B, cache_len=P + 4,
                     weight_cast_ms=cuda_ms(cast_all, reps=3))
    del caches
    torch.cuda.empty_cache()
    print(f"trace lm_decode [{card}] " + json.dumps(trace), flush=True)

    err_fwd, _ = lm_forward_check(model, params, LM_CHECK_PROMPT,
                                  LM_CHECK_STEPS, seed, LM_DECODE_TOL, "lm")
    flash_ms, held = lm_path_flash(ops, model, params, LM_REQUESTS, prompts,
                                   dev)

    # one layer on the card against the CPU, the model's block 0
    x = tt._embed_tokens(params, cfg, prompts["a"][:1, :LM_LAYER_S])
    layer = layer_check(params.groups[0][0][0], cfg.groups[0][0][0], cfg, x,
                        None, "lm", "layer 0")
    del x

    # bounds on the card: a prefill's projections at the bf16 rate plus
    # its attention calls at flash_attention's float32 bound; a decode step
    # reads the float32 parameters once
    summary = dict(init)
    for label, B, P, *_ in LM_REQUESTS:
        rec = reqs[label]
        rec.update(prefill_bound(model, params, B, P, fa),
                   decode_bound_ms=1e3 * param_bytes / HBM_BW,
                   flash_ms_a_call=flash_ms[label],
                   prefill_attention_s=layers * flash_ms[label] / 1e3,
                   prefill_rest_s=rec["prefill_s"]
                   - layers * flash_ms[label] / 1e3,
                   layer0_flash_max_abs_err=held[label])
        summary[label] = {kk: vv for kk, vv in rec.items()
                          if kk not in ("launches", "routes")}
    summary.update(decode_trace=dict(
                       idle_share=trace["idle_share"],
                       ms_a_step=trace["window_ms"] / 4,
                       device_busy_ms_a_step=trace["device_busy_ms"] / 4,
                       weight_cast_ms=trace["weight_cast_ms"]),
                   forward_check_max_err=err_fwd,
                   layer_card_vs_cpu=layer, path_launches=path_launches)
    print(f"lm [{card}] " + json.dumps(summary), flush=True)
    del params, model
    torch.cuda.empty_cache()
    return path_launches, max(held.values())


def same_params(model, params, **overrides):
    """The model under ``overrides`` of its config (another compute dtype
    or capacity), on the same parameter tensors (no copy)."""
    from repro_torch.models import build
    from repro_torch.models import transformer as tt
    cfg = dataclasses.replace(model.cfg, **overrides)
    other = tt.LM(cfg, device="meta")
    with torch.inference_mode():      # the parameters are inference tensors
        other.load_state_dict(params.state_dict(), assign=True)
    return build(cfg, device=model.device), other


def moe_serving(ops, seed, dev, card):
    """Phase 19, moonshot-v1-16b-a3b at full width in bf16 parameters:
    (the launches of its requests, the largest flash error held)."""
    from repro_torch.models import transformer as tt
    fa = ops.KERNELS["flash_attention"]
    tag = f"lm {MOE_ARCH}"
    model, params, init = lm_init(MOE_ARCH, seed, dev, card, tag,
                                  param_dtype="bfloat16")
    cfg = model.cfg
    param_bytes = init["param_gb"] * 1e9
    check(params.groups[1][0][0].moe.w_up.dtype == torch.bfloat16,
          "moonshot's experts in bf16")
    layers = cfg.n_layers
    reqs, prompts, path_launches = lm_requests(
        ops, model, params, MOE_REQUESTS, seed, card, tag, layers, 0)
    flash_ms, held = lm_path_flash(ops, model, params, MOE_REQUESTS, prompts,
                                   dev)

    # where a decode step's time goes: 2 steps at request (a)'s batch
    label, B, P, *_ = MOE_REQUESTS[0]
    with torch.inference_mode():
        caches = model.init_cache(B, P + 2)
        _, caches = model.prefill(params, {"tokens": prompts[label]}, caches)
        last = prompts[label][:, -1:]

        def decode_steps():
            for t in range(2):
                model.decode_step(params, caches, last, P + t)
        decode_steps()
        _, trace = device_trace(decode_steps, "moe_decode",
                                record_shapes=False)
        del trace["waltmin_split"]
    del caches
    torch.cuda.empty_cache()
    trace.update(steps=2, batch=B, cache_len=P + 2)
    print(f"trace {tag} decode [{card}] " + json.dumps(trace), flush=True)

    # float32 compute and a capacity that drops nothing, on the same
    # parameter tensors: prefill plus decode against the forward, and
    # layer 1 (the first attn_moe block) on the card against the CPU
    m32, p32 = same_params(model, params, compute_dtype="float32",
                           capacity_factor=cfg.n_experts / cfg.top_k)
    err_fwd, fwd_rec = lm_forward_check(m32, p32, MOE_CHECK_PROMPT,
                                        MOE_CHECK_STEPS, seed, MOE_CHECK_TOL,
                                        tag)
    blk = p32.groups[1][0][0]
    S = MOE_CHECK_PROMPT
    x = tt._embed_tokens(p32, m32.cfg, prompts["a"][:1, :S])
    ctx = {"positions": torch.arange(S, device=dev), "xattn_ctx": None}
    cpu_blk = tt.make_block("attn_moe", m32.cfg, device="cpu")
    cpu_blk.load_state_dict(blk.state_dict())
    with torch.inference_mode(), recorded_routes() as routes:
        y_card, aux_card = blk.seq(x, ctx)
        t0 = time.perf_counter()
        y_cpu, aux_cpu = cpu_blk.seq(x.cpu(), {"positions": torch.arange(S),
                                               "xattn_ctx": None})
        cpu_s = time.perf_counter() - t0
    # the MoE acts token by token after the attention: a token routed to
    # other experts on the two devices (a near-tie) differs alone
    same = (routes[0].cpu() == routes[1]).all(-1)
    layer_err = float((y_card.cpu() - y_cpu)[0, same].abs().max())
    layer_scale = float(y_cpu.abs().max())
    n_rerouted = S - int(same.sum())
    print(f"{tag} layer 1 (attn_moe, float32) card against CPU, S={S}: max "
          f"abs err {layer_err:.4e} of {layer_scale:.4e} (tol "
          f"{MOE_LAYER_TOL} of the largest) over the {S - n_rerouted} "
          f"tokens routed alike ({n_rerouted} otherwise, at most "
          f"{S // 100}), aux {float(aux_card):.6f} / {float(aux_cpu):.6f}, "
          f"CPU {cpu_s:.1f} s", flush=True)
    check(layer_err <= MOE_LAYER_TOL * layer_scale
          and n_rerouted <= S // 100
          and abs(float(aux_card) - float(aux_cpu)) <= 1e-5,
          f"attn_moe layer card vs CPU: {layer_err} of {layer_scale}, "
          f"{n_rerouted} tokens routed otherwise")
    del cpu_blk, x, y_card, y_cpu, m32, p32, blk

    # bounds: a prefill's active projections (attention, the dense first
    # layer, the shared experts and top_k of n_experts routed ones) at the
    # bf16 rate plus 48 attention calls at flash's float32 bound; a decode
    # step reads every expert (the capacity dispatch runs all of them), so
    # the whole 56.8 GB at the HBM rate
    active = sum(p.numel() * (cfg.top_k / cfg.n_experts
                              if n.split(".")[-1] in ("w_up", "w_gate",
                                                      "w_down") else 1.0)
                 for n, p in params.named_parameters()
                 if n.startswith("groups."))
    summary = dict(init, active_block_params=active)
    for label, B, P, *_ in MOE_REQUESTS:
        rec = reqs[label]
        proj_ms = 1e3 * 2.0 * active * B * P / PEAK_BF16_FLOPS
        attn_ms = layers * attention_bound_ms(cfg, B, P, fa)
        rec.update(prefill_bound_s=(proj_ms + attn_ms) / 1e3,
                   prefill_attention_bound_s=attn_ms / 1e3,
                   decode_bound_ms=1e3 * param_bytes / HBM_BW,
                   flash_ms_a_call=flash_ms[label],
                   prefill_attention_s=layers * flash_ms[label] / 1e3,
                   layer0_flash_max_abs_err=held[label])
        summary[label] = {kk: vv for kk, vv in rec.items()
                          if kk not in ("launches", "routes")}
    summary.update(decode_trace=dict(
                       idle_share=trace["idle_share"],
                       ms_a_step=trace["window_ms"] / 2,
                       device_busy_ms_a_step=trace["device_busy_ms"] / 2,
                       device_events_a_step=trace["device_events"] / 2),
                   forward_check=fwd_rec,
                   layer1_card_vs_cpu=dict(S=S, max_abs_err=layer_err,
                                           scale=layer_scale,
                                           tokens_rerouted=n_rerouted),
                   path_launches=path_launches)
    print(f"{tag} [{card}] " + json.dumps(summary), flush=True)
    del params, model
    torch.cuda.empty_cache()
    return path_launches, max(held.values())


def rglru_serving(ops, seed, dev, card):
    """Phase 19, recurrentgemma-9b at full width in float32 parameters:
    its requests (windowed attention on the plain route), the forward
    check and layer 0's scan against its step loop."""
    from repro_torch.models import common, rglru
    from repro_torch.models import transformer as tt
    tag = f"lm {RG_ARCH}"
    model, params, init = lm_init(RG_ARCH, seed, dev, card, tag)
    cfg = model.cfg
    param_bytes = init["param_gb"] * 1e9
    n_attn = sum(p.count("local_attn") * c for p, c in cfg.groups)
    reqs, prompts, path_launches = lm_requests(
        ops, model, params, RG_REQUESTS, seed, card, tag, 0, n_attn)
    # held in float32 compute on the same parameter tensors; the served
    # bf16 compute reported beside it
    m32, p32 = same_params(model, params, compute_dtype="float32")
    err_fwd, fwd_rec = lm_forward_check(m32, p32, RG_CHECK_PROMPT,
                                        RG_CHECK_STEPS, seed,
                                        RG_DECODE_TOL, tag)
    del m32, p32
    _, bf16_rec = lm_forward_check(model, params, RG_CHECK_PROMPT,
                                   RG_CHECK_STEPS, seed, None,
                                   f"{tag} bf16")

    # layer 0's RG-LRU: the scan over S tokens against the step loop
    blk = params.groups[0][0][0]
    cd = tt._cdtype(cfg)
    with torch.inference_mode():
        x = tt._embed_tokens(params, cfg, prompts["a"][:1])
        h = common.norm_apply(cfg.norm, blk.norm1, x)
        xin = common.dense_apply(blk.lru.w_in, h, cd)
        xc, _ = rglru._causal_conv(blk.lru.conv_w.float(), xin)
        (y_par, h_par), scan_ms = timed(lambda: rglru.rglru_seq(blk.lru, xc))
        state = torch.zeros_like(h_par)
        ys = []
        t0 = time.perf_counter()
        for t in range(xc.shape[1]):
            y, state = rglru.rglru_step(blk.lru, xc[:, t], state)
            ys.append(y)
        torch.cuda.synchronize()
        loop_ms = 1e3 * (time.perf_counter() - t0)
        scan_err = max(float((y_par - torch.stack(ys, 1)).abs().max()),
                       float((h_par - state).abs().max()))
    print(f"{tag} layer 0 rglru_seq against the step loop, S="
          f"{xc.shape[1]}: max abs err {scan_err:.4e} (tol {RG_SCAN_TOL}); "
          f"scan {scan_ms:.2f} ms, loop {loop_ms:.1f} ms", flush=True)
    check(scan_err <= RG_SCAN_TOL, f"rglru scan vs step: {scan_err}")
    del x, h, xin, xc, y_par, ys

    # bounds: every block product at the bf16 rate, plus the windowed
    # attention (4 B H S min(S, window) Dh FLOP) at the float32 FMA rate;
    # a decode step reads the float32 parameters once
    n_blocks = init["block_params"]
    summary = dict(init)
    for label, B, P, *_ in RG_REQUESTS:
        rec = reqs[label]
        attn_flops = n_attn * 4.0 * B * cfg.n_heads * P * min(P, cfg.window) \
            * cfg.head_dim_
        rec.update(prefill_bound_s=2.0 * n_blocks * B * P / PEAK_BF16_FLOPS
                   + attn_flops / PEAK_F32_FLOPS,
                   decode_bound_ms=1e3 * param_bytes / HBM_BW)
        summary[label] = {kk: vv for kk, vv in rec.items()
                          if kk not in ("launches", "routes")}
    summary.update(forward_check=fwd_rec, forward_check_bf16=bf16_rec,
                   scan_vs_steps=dict(S=RG_CHECK_PROMPT, max_abs_err=scan_err,
                                      scan_ms=scan_ms, loop_ms=loop_ms),
                   path_launches=path_launches)
    print(f"{tag} [{card}] " + json.dumps(summary), flush=True)
    del params, model
    torch.cuda.empty_cache()
    return path_launches


def xlstm_serving(ops, seed, dev, card):
    """Phase 19, xlstm-350m at full width: its requests (no attention), the
    forward check, layer 0's chunked mLSTM against its step loop, and the
    sLSTM time loop traced."""
    from repro_torch.models import common, xlstm
    from repro_torch.models import transformer as tt
    tag = f"lm {XL_ARCH}"
    model, params, init = lm_init(XL_ARCH, seed, dev, card, tag)
    cfg = model.cfg
    param_bytes = init["param_gb"] * 1e9
    reqs, prompts, path_launches = lm_requests(
        ops, model, params, XL_REQUESTS, seed, card, tag, 0, 0)
    # held in float32 compute on the same parameter tensors; the served
    # bf16 compute reported beside it
    m32, p32 = same_params(model, params, compute_dtype="float32")
    err_fwd, fwd_rec = lm_forward_check(m32, p32, XL_CHECK_PROMPT,
                                        XL_CHECK_STEPS, seed,
                                        XL_DECODE_TOL, tag)
    del m32, p32
    _, bf16_rec = lm_forward_check(model, params, XL_CHECK_PROMPT,
                                   XL_CHECK_STEPS, seed, None,
                                   f"{tag} bf16")

    cd = tt._cdtype(cfg)
    mblk, sblk = params.groups[0][0]
    with torch.inference_mode():
        # layer 0's mLSTM: the chunked form over S tokens against the
        # recurrence one step at a time
        x = tt._embed_tokens(params, cfg, prompts["a"][:1])
        h = common.norm_apply(cfg.norm, mblk.norm, x)
        q, k, v, log_f, log_i, *_ = xlstm.mlstm_inputs(mblk.core, h,
                                                       cfg.n_heads, cd)
        (h_par, _), chunk_ms = timed(
            lambda: xlstm._mlstm_chunk_parallel(q, k, v, log_f, log_i))
        Dh = q.shape[-1]
        C = torch.zeros(*q.shape[:2], Dh, Dh, device=dev)
        n = torch.zeros(*q.shape[:2], Dh, device=dev)
        m = torch.full(q.shape[:2], -1e30, device=dev)
        err = torch.zeros((), device=dev)       # max |chunked - step|
        excess = torch.zeros((), device=dev)    # max of it - tol |step|
        for t in range(q.shape[2]):
            m_new = torch.maximum(log_f[..., t] + m, log_i[..., t])
            df = torch.exp(log_f[..., t] + m - m_new)
            di = torch.exp(log_i[..., t] - m_new)
            C = df[..., None, None] * C + di[..., None, None] \
                * (k[..., t, :, None] * v[..., t, None, :])
            n = df[..., None] * n + di[..., None] * k[..., t, :]
            num = (q[..., t, None, :] @ C)[..., 0, :] / math.sqrt(Dh)
            den = torch.maximum(torch.abs((n * q[..., t, :]).sum(-1))
                                / math.sqrt(Dh), torch.exp(-m_new))
            h_t = num / den[..., None]
            diff = (h_par[..., t, :] - h_t).abs()
            err = torch.maximum(err, diff.max())
            excess = torch.maximum(excess, (diff - XL_MLSTM_TOL
                                            * h_t.abs()).max())
            m = m_new
        mlstm_err, mlstm_excess = float(err), float(excess)
        del q, k, v, log_f, log_i, h_par, C, n, x, h
        # one sLSTM layer over request (a)'s prompts: time and launches
        x = tt._embed_tokens(params, cfg, prompts["a"])
        hs = common.norm_apply(cfg.norm, sblk.norm, x)
        xlstm.slstm_block_seq(sblk.core, hs[:, :8], cd)
        _, slstm_ms = timed(lambda: xlstm.slstm_block_seq(sblk.core, hs, cd))
        _, slstm_trace = device_trace(
            lambda: xlstm.slstm_block_seq(sblk.core, hs, cd), "slstm",
            record_shapes=False)
        del slstm_trace["waltmin_split"], x, hs
    torch.cuda.empty_cache()
    S = prompts["a"].shape[1]
    print(f"{tag} layer 0 mLSTM chunked against the step loop, S={S}: max "
          f"abs err {mlstm_err:.4e} (tol {XL_MLSTM_TOL} + {XL_MLSTM_TOL} "
          f"|step|), chunked {chunk_ms:.2f} ms", flush=True)
    check(mlstm_excess <= XL_MLSTM_TOL,
          f"mLSTM chunked vs steps: {mlstm_err}")
    slstm = dict(batch=prompts["a"].shape[0], S=S, ms=slstm_ms,
                 device_events=slstm_trace["device_events"],
                 launches_a_step=slstm_trace["device_events"] / S,
                 idle_share=slstm_trace["idle_share"],
                 top5=slstm_trace["top5"])
    print(f"{tag} slstm layer [{card}] " + json.dumps(slstm), flush=True)

    # bounds: every block product at the bf16 rate; a decode step reads
    # the float32 parameters once
    n_blocks = init["block_params"]
    summary = dict(init)
    for label, B, P, *_ in XL_REQUESTS:
        rec = reqs[label]
        rec.update(prefill_bound_s=2.0 * n_blocks * B * P / PEAK_BF16_FLOPS,
                   decode_bound_ms=1e3 * param_bytes / HBM_BW)
        summary[label] = {kk: vv for kk, vv in rec.items()
                          if kk not in ("launches", "routes")}
    summary.update(forward_check=fwd_rec, forward_check_bf16=bf16_rec,
                   mlstm_chunked_vs_steps=dict(S=S, max_abs_err=mlstm_err,
                                               chunked_ms=chunk_ms),
                   slstm_layer=dict(ms=slstm_ms, launches_a_step=slstm[
                       "launches_a_step"]),
                   path_launches=path_launches)
    print(f"{tag} [{card}] " + json.dumps(summary), flush=True)
    del params, model
    torch.cuda.empty_cache()
    return path_launches


def moe_recurrent_phase(ops, seed, dev, card):
    """Phase 19: the MoE and recurrent families at full width, one model at
    a time, each freed before the next. Returns the launches of their
    requests and the largest flash error held on moonshot's shapes."""
    t0 = time.perf_counter()
    launches, err = moe_serving(ops, seed, dev, card)
    for extra in (rglru_serving(ops, seed, dev, card),
                  xlstm_serving(ops, seed, dev, card)):
        for name in launches:
            launches[name] += extra[name]
    print(f"moe and recurrent phase [{card}]: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, err


@contextlib.contextmanager
def timed_decompress(sink: list, capture: dict | None = None):
    """Time each ``decompress_tapped_params`` call of the train step (to a
    synchronize) into ``sink``, in seconds. With an empty ``capture``, the
    first call's key, config, gradient names and the taps of its first
    tapped layer (by name) are copied to the CPU into it before the call
    zeroes them."""
    from repro_torch.train import sketched_dense as sd
    saved = sd.decompress_tapped_params

    def call(key, grads, cfg):
        if capture is not None and not capture:
            prefix = min(n[:-len(".taps.a")] for n in grads
                         if n.endswith(".taps.a"))
            capture.update(prefix=prefix, key=key.cpu(), cfg=cfg,
                           names=list(grads), taps={
                               f: grads[f"{prefix}.taps.{f}"].to(
                                   "cpu", copy=True)
                               for f in sd.TAP_FIELDS})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved(key, grads, cfg)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out
    sd.decompress_tapped_params = call
    try:
        yield sink
    finally:
        sd.decompress_tapped_params = saved


def tapped_rank_err(grads, names, gen) -> float:
    """The largest sigma_9 / sigma_1 of dW Omega over the tapped layers
    (Omega: 16 Gaussian columns): 0 up to float32 rounding when every
    tapped dW is the rank-8 reconstruction."""
    worst = 0.0
    for prefix in names:
        g = grads[prefix + ".w"]
        omega = torch.randn(g.shape[1], 16, generator=gen, device=g.device)
        sv = torch.linalg.svdvals(g @ omega)
        check(float(sv[0]) > 0, f"{prefix}: a zero reconstruction")
        worst = max(worst, float(sv[8] / sv[0]))
    return worst


def tapped_vs_cpu(grads, cap) -> dict:
    """The captured layer's ``w`` gradient from the card against the
    SMP-PCA completion on the CPU (the kernels' plain versions) of the
    same taps under the key ``tap_keys`` gives it, as the largest error
    over the leaf's largest entry; beside it the same for a wrong key
    (``fold_in(key, 1)``), the size of the error the check is there to
    catch. The summary is finalized on the card and moved to the CPU:
    the CPU's vectorized ``torch.sqrt`` is an ulp off the card's
    correctly rounded one on some norms, which moves inverse-CDF draws."""
    from repro_torch import prng
    from repro_torch.core import streaming
    from repro_torch.core.smppca import smppca_from_summary
    from repro_torch.core.types import SketchSummary
    from repro_torch.train import sketched_dense as sd
    t0 = time.perf_counter()
    k = sd.tap_keys(cap["key"], cap["names"])[cap["prefix"]]
    got = grads[cap["prefix"] + ".w"]
    summary = streaming.finalize_state(sd.tap_state(
        {f: v.to(got.device) for f, v in cap["taps"].items()}))
    summary = SketchSummary(*(None if x is None else x.cpu()
                              for x in summary))
    cfg = cap["cfg"]
    m = int(cfg.sample_factor * (summary.n1 + summary.n2) * cfg.rank)
    got = got.cpu()
    scale = float(got.abs().max().clamp(min=1e-30))

    def err(key):
        f = smppca_from_summary(key, summary, r=cfg.rank, m=m,
                                T=cfg.als_iters, device="cpu").factors
        return float((got - f.U @ f.V.T).abs().max()) / scale
    return dict(layer=cap["prefix"], rel_err=err(k),
                wrong_key_rel_err=err(prng.fold_in(k, 1)),
                cpu_s=time.perf_counter() - t0)


def train_run(ops, label, comp, seed, dev, card, steps, trace=False,
              probe=None):
    """One phase-20 run: ``Trainer`` on phi3-mini-3.8b at full width for
    ``steps`` steps, each step timed (to a synchronize) with its launches
    and attention routes (counters set to 0 before each step). Step 1 is
    checked against the no_grad loss of the same parameters and its
    gradients held (every parameter but the taps nonzero; the tapped
    ones of rank 8); the parameters must change. With ``trace`` the last
    step runs under ``device_trace``. ``probe`` (a dict) receives step 1's
    gradients at ``TRAIN_PROBE`` (their first rows, on the host). Returns
    (the run's record, the launches of its steps, the recorded kernel
    calls of its first step)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import attention as attn
    from repro_torch.models import build
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig
    from repro_torch.train import sketched_dense as sd
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    if comp == "taps":
        cfg = dataclasses.replace(cfg, sketched_mlp=True)
    model = build(cfg, device=dev)
    data = SyntheticLM(vocab_size=cfg.vocab_size, batch_size=TRAIN_B,
                       seq_len=TRAIN_S, seed=seed, device=str(dev))
    opt = AdamW(lr=warmup_cosine(1e-3, max(steps // 10, 1), steps),
                weight_decay=0.01)
    trainer = Trainer(model.loss, opt, data,
                      TrainConfig(microbatches=TRAIN_MB, compression=comp),
                      TrainerConfig(num_steps=steps, log_every=steps,
                                    max_retries=0),
                      model.init_params, seed=seed)
    inner = trainer.step_fn
    rec = dict(label=label, arch=cfg.name, compression=comp, B=TRAIN_B,
               S=TRAIN_S, microbatches=TRAIN_MB, steps=[])
    total = {name: 0 for name in ops.LAUNCHES}
    snap, recorded, decomp, cap = {}, {}, [], {}
    gen = torch.Generator(device=dev).manual_seed(seed)

    def step(state, batch):
        named = dict(state.params.named_parameters())
        # set only once step 1's checks have passed: a failed step raises
        # (max_retries=0), and a step after it is never taken for step 1
        first = "step1_checked" not in rec
        if first:
            rec["init_s"] = time.perf_counter() - t_run
            rec["param_gb"] = sum(p.numel() * p.element_size()
                                  for p in named.values()) / 1e9
            with torch.no_grad():
                rec["nograd_loss"] = float(model.loss(state.params, batch))
            last = f"groups.0.{cfg.groups[0][1] - 1}.0"
            snap.update({n: named[n][:8].clone() for n in (
                "embed.table", "groups.0.0.0.attn.wq.w", last + ".mlp.up.w",
                last + ".norm2.scale")})
        ops.reset_launch_counts()
        attn.reset_route_counts()
        del decomp[:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if first:
                recorded.update(stack.enter_context(recording(
                    ops, "sketch_fused", "sampled_rescaled_dot", limit=2)))
            stack.enter_context(timed_decompress(
                decomp, cap if first else None))
            if trace and len(rec["steps"]) == steps - 1:
                out, rec["trace"] = device_trace(
                    lambda: inner(state, batch), f"train step {label}",
                    record_shapes=False)
            else:
                out = inner(state, batch)
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        new, metrics = out
        s = dict(step=len(rec["steps"]), s=dt, tokens_per_s=TRAIN_B * TRAIN_S
                 / dt, loss=float(metrics["loss"]),
                 grad_norm=float(metrics["grad_norm"]),
                 lr=float(metrics["lr"]), decompress_s=sum(decomp),
                 decompress_share=sum(decomp) / dt,
                 launches=dict(ops.LAUNCHES), routes=dict(attn.ROUTES),
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        rec["steps"].append(s)
        for name in total:
            total[name] += ops.LAUNCHES[name]
        print(f"train {label} step [{card}] " + json.dumps(s), flush=True)
        check(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]),
              f"train {label}: loss {s['loss']}, grad_norm {s['grad_norm']}")
        check(s["routes"]["flash"] == 0, f"train {label}: flash under grad")
        if first:
            check(abs(s["loss"] - rec["nograd_loss"]) <= TRAIN_LOSS_TOL,
                  f"train {label}: step 1's loss {s['loss']} against the "
                  f"no_grad loss {rec['nograd_loss']}")
            grads = {n: p.grad for n, p in named.items()}
            zero = [n for n, g in grads.items()
                    if ".taps." not in n and not bool(g.any())]
            check(not zero, f"train {label}: zero gradients {zero[:4]}")
            if probe is not None:
                probe.update(grad_probe(named))
            tapped = sorted(n[:-len(".taps.a")] for n in grads
                            if n.endswith(".taps.a"))
            if tapped:
                rec["tapped_layers"] = len(tapped)
                rec["tapped_rank_err"] = tapped_rank_err(grads, tapped, gen)
                check(rec["tapped_rank_err"] <= TRAIN_RANK_TOL,
                      f"train {label}: tapped dW rank err "
                      f"{rec['tapped_rank_err']}")
                rec["tapped_vs_cpu"] = tapped_vs_cpu(grads, cap)
                print(f"train {label} tapped layer vs CPU [{card}] "
                      + json.dumps(rec["tapped_vs_cpu"]), flush=True)
                check(rec["tapped_vs_cpu"]["rel_err"] <= TRAIN_TAP_TOL,
                      f"train {label}: tapped dW against the CPU's "
                      f"{rec['tapped_vs_cpu']}")
            rec["step1_checked"] = True
        return out

    trainer.step_fn = step
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    state = trainer.run()
    rec["run_s"] = time.perf_counter() - t_run
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    named = dict(state.params.named_parameters())
    same = [n for n, before in snap.items()
            if torch.equal(named[n][:8], before)]
    check(not same, f"train {label}: parameters unchanged {same}")
    check(int(state.step) == steps, f"train {label}: {int(state.step)} steps")
    rec["losses"] = [h["loss"] for h in trainer.metrics_history]
    print(f"train {label} [{card}] " + json.dumps(
        {k: v for k, v in rec.items() if k != "steps"}), flush=True)
    del state, named, trainer, model, inner
    torch.cuda.empty_cache()
    return rec, total, recorded


def grad_probe(named) -> dict:
    """The first rows of the gradients at ``TRAIN_PROBE``, on the host."""
    return {n: named[n].grad[:8].detach().float().cpu() for n in TRAIN_PROBE}


def train_card_vs_cpu(dev, card):
    """(c): one train step of granite-3-8b reduced (its head width 16),
    float32 compute, on the card against the CPU. The card's forward
    without grad takes the flash route; the step's attention the plain
    one."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import attention as attn
    from repro_torch.models import build
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg = dataclasses.replace(get_config(LM_ARCH).reduced(),
                              compute_dtype="float32")
    out = {}
    for d in ("cpu", dev):
        model = build(cfg, device=d)
        params = model.init_params(prng.PRNGKey(0, device=d))
        opt = AdamW(lr=warmup_cosine(1e-3, 1, 10), weight_decay=0.01)
        state = init_state(prng.PRNGKey(1, device=d), params, opt,
                           TrainConfig(microbatches=2))
        batch = SyntheticLM(vocab_size=cfg.vocab_size, batch_size=4,
                            seq_len=64, device=str(d)).batch(0)
        attn.reset_route_counts()
        with torch.no_grad():
            model.forward(params, batch)
        fwd_routes = dict(attn.ROUTES)
        attn.reset_route_counts()
        _, metrics = make_train_step(model.loss, opt,
                                     TrainConfig(microbatches=2))(state, batch)
        out[str(torch.device(d).type)] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.detach().cpu() for n, p in
                   params.named_parameters()},
            fwd_routes=fwd_routes, step_routes=dict(attn.ROUTES))
    cpu, gpu = out["cpu"], out["cuda"]
    rel = {k: abs(gpu["metrics"][k] - cpu["metrics"][k])
           / max(abs(cpu["metrics"][k]), 1e-30) for k in ("loss", "grad_norm")}
    grad_rel = max(float((gpu["grads"][n] - g).abs().max()
                         / g.abs().max().clamp(min=1e-30))
                   for n, g in cpu["grads"].items())
    rec = dict(arch=cfg.name, head_dim=cfg.head_dim, loss_rel=rel["loss"],
               grad_norm_rel=rel["grad_norm"], grad_rel_max=grad_rel,
               card_forward_routes=gpu["fwd_routes"],
               card_step_routes=gpu["step_routes"])
    print(f"train card_vs_cpu [{card}] " + json.dumps(rec), flush=True)
    check(gpu["fwd_routes"]["flash"] > 0, "(c): no flash route without grad")
    check(gpu["step_routes"]["flash"] == 0, "(c): flash route under grad")
    check(max(rel.values()) <= TRAIN_CPU_TOL and grad_rel <= TRAIN_CPU_TOL,
          f"(c): card against CPU {rec}")


def train_launcher(dev, card):
    """(d): ``launch.train --reduced`` on the card: 20 steps through its
    ``main`` (the loss falls); 20 steps with a fault at step 12 and
    checkpoints every 10 (recovered); a second Trainer resumes at 20."""
    import io
    from repro_torch.launch import train as launch
    with tempfile.TemporaryDirectory() as td:
        argv = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "20",
                "--device", str(dev), "--ckpt-dir", os.path.join(td, "a")]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            launch.main(argv)
        main_s = time.perf_counter() - t0
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(res["steps"] == 20 and res["last_loss"] < res["first_loss"],
              f"(d): launch.train {res}")
        args = launch.parser().parse_args(
            ["--arch", TRAIN_ARCH, "--reduced", "--steps", "20",
             "--device", str(dev), "--ckpt-dir", os.path.join(td, "b")])
        tr = launch.make_trainer(args)
        tr.cfg.ckpt_every = 10
        fired = []

        def hook(step):
            if step == 12 and not fired:
                fired.append(step)
                raise RuntimeError("simulated preemption")
        state = tr.run(fault_hook=hook)
        check(int(state.step) == 20 and fired == [12],
              f"(d): recovery at step {int(state.step)}, fired {fired}")
        args.steps = 30
        tr2 = launch.make_trainer(args)
        state = tr2.run()
        resumed = tr2.metrics_history[0]["step"]
        check(int(state.step) == 30 and resumed == 20,
              f"(d): resumed at {resumed}, ended at {int(state.step)}")
    rec = dict(main=res, main_s=main_s, fault_at=12, resumed_at=resumed)
    print(f"train launcher [{card}] " + json.dumps(rec), flush=True)


def train_phase(ops, seed, dev, card):
    """Phase 20: phi3-mini-3.8b training at full width, (a) without and
    (b) with SMP-PCA taps, each freed before the next; (c) the reduced
    step card against CPU; (d) launch.train. Returns the launches of (a)
    and (b)'s steps, the largest error of (b)'s first step's recorded
    kernel calls held against the plain versions, (a)'s record and its
    step 1's gradient probe."""
    t0 = time.perf_counter()
    probe = {}
    rec_a, launches, _ = train_run(ops, "a", "none", seed, dev, card,
                                   TRAIN_STEPS_A, probe=probe)
    rec_b, launches_b, calls = train_run(ops, "b", "taps", seed, dev, card,
                                         TRAIN_STEPS_B, trace=True)
    for name in launches:
        launches[name] += launches_b[name]
    check(launches_b["sketch_fused"] > 0
          and launches_b["sampled_rescaled_dot"] > 0,
          f"(b): the taps path launched {launches_b}")
    errs = dict(
        sketch_fused=held_sketch(ops, calls["sketch_fused"], "train taps"),
        sampled_rescaled_dot=held_sampled(
            ops, calls["sampled_rescaled_dot"], "train decompress_tap"))
    del calls
    torch.cuda.empty_cache()
    train_card_vs_cpu(dev, card)
    train_launcher(dev, card)
    from repro_torch.configs import get_config
    n = get_config(TRAIN_ARCH).n_params()
    tokens = TRAIN_B * TRAIN_S
    summary = dict(
        params=n, tokens_a_step=tokens,
        # forward, the remat forward and the backward's two products: 8
        # FLOP a parameter a token, at the bf16 rate
        step_bound_s=8.0 * n * tokens / PEAK_BF16_FLOPS,
        a_step_s=[s["s"] for s in rec_a["steps"]],
        b_step_s=[s["s"] for s in rec_b["steps"]],
        a_peak_gb=rec_a["peak_gb"], b_peak_gb=rec_b["peak_gb"],
        b_launches_a_step=rec_b["steps"][-1]["launches"],
        b_decompress_share=[s["decompress_share"] for s in rec_b["steps"]],
        b_trace=rec_b.get("trace"),
        # the traced step runs slower than the others (the profiler on the
        # host): its device time against the untraced warm step 2
        b_busy_share_of_step_2=rec_b["trace"]["device_busy_ms"] / 1e3
        / rec_b["steps"][1]["s"],
        phase_s=time.perf_counter() - t0)
    print(f"train phase [{card}] " + json.dumps(summary), flush=True)
    return launches, errs, rec_a, probe


def remat_step(ops, seed, dev, card, rec_a, probe):
    """Phase 21 (a): phase 20 (a)'s first step again, on the same
    parameters (``fold_in(PRNGKey(seed), 1)``, as its ``Trainer`` drew
    them) and batch (``SyntheticLM`` step 0), with
    ``remat_policy="save_attn_out"``: its loss equals (a)'s, its gradients
    at ``TRAIN_PROBE`` are held to (a)'s within ``REMAT_GRAD_TOL`` of
    each probe's largest entry; its time and peak beside (a)'s."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import attention as attn
    from repro_torch.models import build
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train import TrainConfig, init_state, make_train_step
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              remat_policy="save_attn_out")
    model = build(cfg, device=dev)
    key = prng.PRNGKey(seed)
    params = model.init_params(prng.fold_in(key, 1).to(dev))
    opt = AdamW(lr=warmup_cosine(1e-3, max(TRAIN_STEPS_A // 10, 1),
                                 TRAIN_STEPS_A), weight_decay=0.01)
    tcfg = TrainConfig(microbatches=TRAIN_MB)
    state = init_state(prng.fold_in(key, 2).to(dev), params, opt, tcfg)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, batch_size=TRAIN_B,
                        seq_len=TRAIN_S, seed=seed, device=str(dev)).batch(0)
    step = make_train_step(model.loss, opt, tcfg)
    ops.reset_launch_counts()
    attn.reset_route_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    named = dict(params.named_parameters())
    got = grad_probe(named)
    grad_err = max(float((got[n] - probe[n]).abs().max()
                         / probe[n].abs().max().clamp(min=1e-30))
                   for n in TRAIN_PROBE)
    a1 = rec_a["steps"][0]
    a2 = rec_a["steps"][-1]
    rec = dict(arch=cfg.name, remat_policy=cfg.remat_policy, B=TRAIN_B,
               S=TRAIN_S, microbatches=TRAIN_MB, step_s=dt,
               a_step1_s=a1["s"], a_warm_step_s=a2["s"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               a_peak_gb=rec_a["peak_gb"],
               # each layer's float32 (B/mb, S, d) attention output kept
               expected_added_gb=cfg.n_layers * TRAIN_B // TRAIN_MB * TRAIN_S
               * cfg.d_model * 4 / 1e9,
               loss=float(metrics["loss"]), a_loss=a1["loss"],
               grad_norm=float(metrics["grad_norm"]),
               a_grad_norm=a1["grad_norm"], grad_probe_rel_err=grad_err,
               grad_tol=REMAT_GRAD_TOL, launches=dict(ops.LAUNCHES),
               routes=dict(attn.ROUTES))
    print(f"remat save_attn_out [{card}] " + json.dumps(rec), flush=True)
    check(rec["loss"] == rec["a_loss"],
          f"21 (a): loss {rec['loss']} against (a)'s {rec['a_loss']}")
    check(grad_err <= REMAT_GRAD_TOL,
          f"21 (a): gradients against (a)'s: {grad_err}")
    check(rec["routes"]["flash"] == 0, "21 (a): flash under grad")
    del state, params, named, model, metrics
    torch.cuda.empty_cache()
    return rec


def step_roofline(seed, card, rec_a):
    """Phase 21 (b): ``roofline.trace_analyzer`` on phase 20 (a)'s step
    (phi3-mini-3.8b, its B, S and microbatches, no taps), on one device:
    traced on ``meta`` tensors, which take the card's route (bf16 GEMMs
    with float32 outputs, the plain attention under grad), so nothing is
    allocated on the card. The counted FLOPs and bytes, ``model_flops``,
    the ``Roofline`` terms, and the share of the roofline step time that
    (a)'s measured warm step reaches."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.roofline import analysis as roof
    from repro_torch.roofline import trace_analyzer
    from repro_torch.train import TrainConfig, TrainState, make_train_step
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    model = build(cfg, device="meta")
    params = model.param_shapes()
    named = dict(params.named_parameters())
    zeros = lambda: {n: torch.zeros(p.shape, device="meta")
                     for n, p in named.items()}
    state = TrainState(params, AdamWState(torch.zeros((), dtype=torch.int32),
                                          zeros(), zeros()),
                       (), torch.zeros((), dtype=torch.int32),
                       prng.PRNGKey(seed))
    opt = AdamW(lr=warmup_cosine(1e-3, max(TRAIN_STEPS_A // 10, 1),
                                 TRAIN_STEPS_A), weight_decay=0.01)
    step = make_train_step(model.loss, opt,
                           TrainConfig(microbatches=TRAIN_MB))
    batch = {k: torch.zeros((TRAIN_B, TRAIN_S), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    cost = trace_analyzer.analyze(step, state, batch)
    tokens = TRAIN_B * TRAIN_S
    mf = roof.model_flops("train", cfg.n_active_params(), tokens)
    rl = roof.Roofline(flops=cost.flops, bytes_accessed=cost.bytes,
                       coll_bytes=0.0, model_flops_per_device=mf, chips=1)
    measured = rec_a["steps"][-1]["s"]
    top = sorted(cost.by_op.items(), key=lambda kv: -kv[1][2])[:8]
    rec = dict(arch=cfg.name, B=TRAIN_B, S=TRAIN_S, microbatches=TRAIN_MB,
               ops=cost.ops, flops=cost.flops, bytes=cost.bytes,
               model_flops=mf, roofline=rl.as_dict(),
               measured_step_s=measured,
               roofline_share=rl.step_time / measured,
               top_bytes={n: dict(calls=c, flops=f, bytes=b)
                          for n, (c, f, b) in top},
               trace_s=time.perf_counter() - t0)
    print(f"remat step_roofline [{card}] " + json.dumps(rec), flush=True)
    check(cost.flops > mf and cost.bytes > 0,
          f"21 (b): counted {cost.flops} FLOPs against 6ND {mf}")
    return rec


def remat_phase(ops, seed, dev, card, rec_a, probe):
    """Phase 21: (a) ``save_attn_out`` against phase 20 (a), (b) the
    analyzer's roofline of phase 20 (a)'s step."""
    t0 = time.perf_counter()
    a = remat_step(ops, seed, dev, card, rec_a, probe)
    b = step_roofline(seed, card, rec_a)
    print(f"remat phase [{card}] " + json.dumps(dict(
        save_attn_out_step_s=a["step_s"], full_step_s=a["a_step1_s"],
        save_attn_out_peak_gb=a["peak_gb"], full_peak_gb=a["a_peak_gb"],
        roofline_step_s=b["roofline"]["step_time_lb_s"],
        measured_step_s=b["measured_step_s"],
        roofline_share=b["roofline_share"],
        phase_s=time.perf_counter() - t0)), flush=True)


def arch_serving(ops, arch, flash, plain, seed, dev, card):
    """Phase 22, one arch at full width in its float32 parameters:
    ``SERVE_REQUESTS`` with ``flash`` kernel launches and ``flash`` and
    ``plain`` attention routes a prefill, prefill plus decode against the
    forward, the kernel at the path's shapes, and layers card against CPU:
    layer 0, llama's first cross-attention layer, whisper's first encoder
    layer. Returns (the requests' launches, the largest flash error)."""
    from repro_torch.models import transformer as tt
    fa = ops.KERNELS["flash_attention"]
    tag = f"lm {arch}"
    model, params, init = lm_init(arch, seed, dev, card, tag)
    cfg = model.cfg
    check(all(p.dtype == torch.float32 for p in params.parameters()),
          f"{tag}: float32 parameters as configured")
    reqs, prompts, path_launches = lm_requests(
        ops, model, params, SERVE_REQUESTS, seed, card, tag, flash, plain)
    with torch.inference_mode():      # the parameters are inference tensors
        for mod in params.modules():
            if isinstance(mod, tt.CrossBlock):
                for gate, val in XATTN_GATES:
                    getattr(mod, gate).fill_(val)
    _, fwd_rec = lm_forward_check(model, params, LM_CHECK_PROMPT,
                                  LM_CHECK_STEPS, seed, LM_DECODE_TOL, tag)
    flash_ms, held = ({}, {}) if not flash else lm_path_flash(
        ops, model, params, SERVE_REQUESTS, prompts, dev)

    # layers on the card against the CPU at S = LM_LAYER_S, the context
    # drawn from the seed as an activation (whisper's encoder output,
    # llama's projected image tokens)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L = cfg.enc_context if cfg.is_encdec else cfg.n_img_tokens
    xctx = torch.randn(1, L, cfg.d_model, generator=gen, device=dev) \
        if L else None
    x = tt._embed_tokens(params, cfg, prompts["a"][:1, :LM_LAYER_S])
    pattern = cfg.groups[0][0]
    checks = [("layer 0", 0, pattern[0])] + [
        (f"layer {i} (xattn)", i, b) for i, b in enumerate(pattern)
        if b == "xattn"][:1]
    layers = {label: layer_check(
        params.groups[0][0][i], btype, cfg, x,
        xctx if btype in ("xattn", "dec_xattn") else None, tag, label)
        for label, i, btype in checks}
    if cfg.is_encdec:
        frames = torch.randn(1, L, cfg.d_model, generator=gen, device=dev)
        layers["encoder layer 0"] = layer_check(
            params.enc.groups[0][0][0], "enc", cfg, frames, None, tag,
            "encoder layer 0")
        del frames
    del x, xctx

    # bounds: the prefill's products at the bf16 rate plus its attention
    # calls at flash_attention's float32 bound; a decode step reads the
    # float32 parameters once
    summary = dict(init)
    for label, B, P, *_ in SERVE_REQUESTS:
        rec = reqs[label]
        rec.update(prefill_bound(model, params, B, P, fa),
                   decode_bound_ms=1e3 * init["param_gb"] * 1e9 / HBM_BW)
        if flash:
            rec.update(flash_ms_a_call=flash_ms[label],
                       prefill_flash_s=flash * flash_ms[label] / 1e3,
                       layer0_flash_max_abs_err=held[label])
        summary[label] = {kk: vv for kk, vv in rec.items()
                          if kk not in ("launches", "routes")}
    summary.update(forward_check=fwd_rec, layer_checks=layers,
                   path_launches=path_launches)
    print(f"{tag} [{card}] " + json.dumps(summary), flush=True)
    del params, model
    torch.cuda.empty_cache()
    return path_launches, max(held.values(), default=0.0)


def archs_phase(ops, seed, dev, card):
    """Phase 22: ``SERVE_ARCHS`` at full width, one at a time, each freed
    before the next. Returns the launches of their requests and the
    largest flash error held on their shapes."""
    t0 = time.perf_counter()
    launches, err = {name: 0 for name in ops.LAUNCHES}, 0.0
    for arch, flash, plain in SERVE_ARCHS:
        extra, e = arch_serving(ops, arch, flash, plain, seed, dev, card)
        for name in launches:
            launches[name] += extra[name]
        err = max(err, e)
    print(f"archs phase [{card}]: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches, err


def load_example(stem: str):
    """``examples/<stem>.py`` as a module (its ``main`` guarded, not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{stem}", os.path.join(ROOT, "examples", f"{stem}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn):
    """fn() with its printed lines dropped (the CPU reference runs, the
    holds)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


# the kernels the twins launch; every call of them in a twin's card run is
# held against the plain version on its own inputs (flash_attention: the
# reduced LMs' prefills, at their head width 16)
EXAMPLE_HELD = ("sketch_fused", "sampled_rescaled_dot", "flash_attention")
# the reduced archs whose prefill has no causal, unwindowed self-attention
# (recurrentgemma-9b's attention is windowed, xlstm-350m has none): no
# flash route; every other arch's attentions of that kind are flash routes
EXAMPLE_NO_FLASH = ("recurrentgemma-9b", "xlstm-350m")


def counted(ops, fn, label):
    """(fn(), its kernel launches, its wall seconds to a synchronize, the
    largest abs err of each held kernel): the launch counters set to 0
    just before the call and read just after. Every call of
    ``EXAMPLE_HELD`` in the run is kept, copied at the call (inside the
    wall time), and held afterwards on its own inputs by ``held_sketch``,
    ``held_sampled`` and ``held_flash``, with one line for the run in place
    of theirs."""
    ops.reset_launch_counts()
    with recording(ops, *EXAMPLE_HELD, copy=True) as calls:
        out, ms = timed(fn)
    launches = dict(ops.LAUNCHES)
    check(all(n == 0 for name, n in launches.items()
              if name not in EXAMPLE_HELD),
          f"{label}: no kernel launched but {EXAMPLE_HELD}: {launches}")
    err = quiet(lambda: {
        "sketch_fused": held_sketch(ops, calls["sketch_fused"], label),
        "sampled_rescaled_dot": held_sampled(
            ops, calls["sampled_rescaled_dot"], label),
        "flash_attention": held_flash(ops, calls["flash_attention"], label)})
    # the largest output entry beside each max abs err: its scale
    largest = {name: max((float(y.abs().max()) for _, _, res in calls[name]
                          for y in [res[0] if isinstance(res, tuple) else res]
                          if y.numel()), default=0.0)
               for name in EXAMPLE_HELD}
    print(f"example held {label}: " + json.dumps({
        name: dict(launches=launches[name], held=len(calls[name]),
                   max_abs_err=err[name], largest=largest[name])
        for name in EXAMPLE_HELD}), flush=True)
    return out, launches, ms / 1e3, err


def merged(*errs) -> dict:
    """The largest of each held kernel's errors."""
    return {name: max((e[name] for e in errs), default=0.0)
            for name in EXAMPLE_HELD}


def no_retries(mod) -> None:
    """A loaded twin's ``Trainer`` without retries: a step that fails
    raises and ends the script instead of restarting from a checkpoint."""
    mod.TrainerConfig = functools.partial(mod.TrainerConfig, max_retries=0)


def on_card(tag: str, *tensors) -> None:
    check(all(t.device.type == "cuda" for t in tensors),
          f"{tag}: the results lie on the card")


def example_quickstart(ops, card):
    """quickstart_torch on the card, against its CPU run. Returns the card
    run's result and launches."""
    qs = load_example("quickstart_torch")
    got, launches, wall, err = counted(
        ops, lambda: qs.main(["--device", "cuda"]), "quickstart")
    t0 = time.perf_counter()
    cpu = quiet(lambda: qs.main(["--device", "cpu"]))
    cpu_s = time.perf_counter() - t0
    on_card("quickstart", got["result"].factors.U, got["estimate"].factors.U,
            got["summary"].A_sketch)
    check(all(math.isfinite(got[name]) for name in ("err", "opt", "err_svd"))
          and got["err"] >= got["opt"],
          f"quickstart: finite errors, SMP-PCA's {got['err']} at or above "
          f"the optimal {got['opt']}")
    rel = {name: abs(got[name] - cpu[name]) / cpu[name]
           for name in ("err", "opt", "err_svd")}
    check(max(rel.values()) <= EXAMPLE_ERR_RTOL,
          f"quickstart: card errors within {EXAMPLE_ERR_RTOL} of the CPU's: "
          f"{rel}")
    check(launches["sampled_rescaled_dot"] >= 1,
          f"quickstart launched sampled_rescaled_dot: {launches}")
    print(f"example quickstart [{card}] " + json.dumps(dict(
        wall_s=wall, cpu_wall_s=cpu_s, launches=launches,
        err=got["err"], opt=got["opt"], err_svd=got["err_svd"],
        cpu_err=cpu["err"], cpu_opt=cpu["opt"], cpu_err_svd=cpu["err_svd"],
        rel_to_cpu=rel)), flush=True)
    return got, launches, wall, err


def example_quickstart_bare(card, card_err):
    """``PYTHONPATH=src python examples/quickstart_torch.py``, no
    arguments: the bare command line on the card."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join("examples", "quickstart_torch.py")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH="src"),
        capture_output=True, text=True, timeout=EXAMPLE_SUBPROCESS_TIMEOUT)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"bare quickstart_torch.py exit "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    check(len(lines) == 6 and lines[2].startswith("SMP-PCA spectral error"),
          f"bare quickstart_torch.py printed the quickstart's lines: {lines}")
    err, opt = (float(line.split(":")[1]) for line in lines[2:4])
    check(math.isfinite(err) and err >= opt
          and abs(err - card_err) <= EXAMPLE_ERR_RTOL * card_err + 5e-5,
          f"bare quickstart_torch.py: error {err} (optimal {opt}) against "
          f"the in-process card run's {card_err}")
    print(f"example quickstart bare [{card}] " + json.dumps(dict(
        wall_s=wall, lines=lines)), flush=True)
    return wall


def example_streaming(ops, card):
    """streaming_cooccurrence_torch on the card, against its CPU run."""
    st = load_example("streaming_cooccurrence_torch")
    got, launches, wall, err = counted(
        ops, lambda: st.main(["--device", "cuda"]), "streaming")
    cpu = quiet(lambda: st.main(["--device", "cpu"]))
    saved, restored = got["checkpointed"]
    check(all((x is None) == (y is None) and (x is None or (
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)))
        for x, y in zip(saved, restored)),
        "streaming: the restored state equals the saved one bit for bit")
    summary = got["summary"]
    on_card("streaming", summary.A_sketch, got["result"].factors.U)
    errs = {name: column_err(getattr(summary, name).cpu(),
                             getattr(cpu["summary"], name))
            for name in ("A_sketch", "B_sketch")}
    errs.update({name: column_err(getattr(summary, name).cpu()[None],
                                  getattr(cpu["summary"], name)[None])
                 for name in ("norm_A", "norm_B")})
    check(max(errs.values()) <= SKETCH_TOL,
          f"streaming: the card's summary within {SKETCH_TOL} of the CPU's: "
          f"{errs}")
    rel = {name: abs(got[name] - cpu[name]) / cpu[name]
           for name in ("err", "opt")}
    check(rel["err"] <= EXAMPLE_ERR_RTOL,
          f"streaming: spectral error within {EXAMPLE_ERR_RTOL} of the "
          f"CPU's: {rel}")
    check(launches["sketch_fused"] >= 1
          and launches["sampled_rescaled_dot"] >= 1,
          f"streaming launched sketch_fused and sampled_rescaled_dot: "
          f"{launches}")
    print(f"example streaming_cooccurrence [{card}] " + json.dumps(dict(
        wall_s=wall, launches=launches, err=got["err"], opt=got["opt"],
        cpu_err=cpu["err"], cpu_opt=cpu["opt"], rel_to_cpu=rel,
        summary_err=errs)), flush=True)
    return launches, wall, err


def example_gradient_compression(ops, card):
    """gradient_compression_torch's main on the card, its ``run`` wrapped
    to count, time and hold each mode's launches."""
    gc = load_example("gradient_compression_torch")
    no_retries(gc)
    real_run, modes, errs = gc.run, {}, []

    def run(mode, steps, device):
        curve, launches, wall, err = counted(
            ops, lambda: real_run(mode, steps, device),
            f"gradient_compression {mode}")
        modes[mode] = dict(steps=len(curve), first=curve[0], last=curve[-1],
                           launches=launches, wall_s=wall)
        errs.append(err)
        return curve

    gc.run = run
    t0 = time.perf_counter()
    curves = gc.main(["--steps", str(EXAMPLE_GC_STEPS), "--device", "cuda"])
    wall = time.perf_counter() - t0
    firsts = [c[0] for c in curves.values()]
    check(all(rec["steps"] == EXAMPLE_GC_STEPS and rec["last"] < rec["first"]
              for rec in modes.values()) and len(modes) == 3,
          f"gradient_compression: each mode's loss falls over "
          f"{EXAMPLE_GC_STEPS} steps: {modes}")
    check(max(firsts) - min(firsts) <= EXAMPLE_FIRST_LOSS_TOL,
          f"gradient_compression: first losses within "
          f"{EXAMPLE_FIRST_LOSS_TOL}: {firsts}")
    taps = modes["taps"]["launches"]
    check(taps["sketch_fused"] >= 1 and taps["sampled_rescaled_dot"] >= 1,
          f"gradient_compression: taps launched sketch_fused and "
          f"sampled_rescaled_dot: {taps}")
    launches = {name: sum(rec["launches"][name] for rec in modes.values())
                for name in ops.LAUNCHES}
    print(f"example gradient_compression [{card}] " + json.dumps(dict(
        wall_s=wall, modes=modes)), flush=True)
    return launches, wall, merged(*errs)


def example_train_lm(ops, card):
    """train_lm_torch on the card into a fresh checkpoint directory."""
    tl = load_example("train_lm_torch")
    no_retries(tl)
    with tempfile.TemporaryDirectory() as ckpt:
        out, launches, wall, err = counted(
            ops, lambda: tl.main(["--device", "cuda", "--ckpt-dir", ckpt]),
            "train_lm")
        on_disk = sorted(int(name[5:]) for name in os.listdir(ckpt)
                         if re.fullmatch(r"step_\d+", name))
    check(out["steps"] == 300 and out["loss_last"] < out["loss_first"]
          and {100, 200, 300} <= set(on_disk),
          f"train_lm: 300 steps, the loss falls, checkpoints at 100, 200 "
          f"and 300: {out}, {on_disk}")
    print(f"example train_lm [{card}] " + json.dumps(dict(
        wall_s=wall, launches=launches, checkpoints=on_disk, **out)),
        flush=True)
    return launches, wall, err


def example_serve_lm(ops, card):
    """serve_lm_torch on the card for every arch at the original's
    defaults, the default arch with --sketch-demo."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import attention as attn
    sv = load_example("serve_lm_torch")
    launches = {name: 0 for name in ops.LAUNCHES}
    archs, errs, t0 = {}, [], time.perf_counter()
    for arch in list_archs():
        demo = arch == EXAMPLE_SERVE_DEMO_ARCH
        argv = ["--arch", arch, "--device", "cuda"] + (
            ["--sketch-demo"] if demo else [])
        attn.reset_route_counts()
        out, got, wall, err = counted(ops, lambda: sv.main(argv),
                                      f"serve_lm {arch}")
        routes = dict(attn.ROUTES)
        errs.append(err)
        # the prefill's causal, unwindowed self-attentions at the reduced
        # width 16 run on the kernel, one launch a route
        check(routes["flash"] == got["flash_attention"]
              and (routes["flash"] == 0) == (arch in EXAMPLE_NO_FLASH),
              f"serve_lm {arch}: flash routes {routes}, launches {got}")
        tokens, vocab = out["tokens"], get_config(arch).reduced().vocab_size
        on_card(f"serve_lm {arch}", tokens)
        check(tuple(tokens.shape) == (4, 64)
              and int(tokens.min()) >= 0 and int(tokens.max()) < vocab,
              f"serve_lm {arch}: (4, 32 + 32) tokens in the vocabulary: "
              f"{tuple(tokens.shape)}")
        if demo:
            est = out["sketch"]
            on_card("serve_lm sketch session", est.factors.U)
            check(out["sketch_rows"] == 2048
                  and tuple(est.factors.U.shape) == (96, 4)
                  and tuple(est.factors.V.shape) == (96, 4),
                  f"serve_lm --sketch-demo: 2,048 rows, U and V (96, 4)")
            check(got["sketch_fused"] >= 1
                  and got["sampled_rescaled_dot"] >= 1,
                  f"serve_lm --sketch-demo launched sketch_fused and "
                  f"sampled_rescaled_dot: {got}")
        archs[arch] = dict(wall_s=wall, launches=got, routes=routes,
                           head_dim=get_config(arch).reduced().head_dim)
        for name in launches:
            launches[name] += got[name]
    wall = time.perf_counter() - t0
    print(f"example serve_lm [{card}] " + json.dumps(dict(
        wall_s=wall, archs=archs)), flush=True)
    return launches, wall, merged(*errs)


def examples_phase(ops, card):
    """Phase 23: the five twins of examples/*.py on the card, in process,
    then the bare quickstart command. Returns their launches and the
    largest abs err of their held launches."""
    t0 = time.perf_counter()
    qs, qs_launches, qs_wall, qs_err = example_quickstart(ops, card)
    walls, errs = {"quickstart": qs_wall}, [qs_err]
    launches = dict(qs_launches)
    for name, fn in (("streaming_cooccurrence", example_streaming),
                     ("gradient_compression", example_gradient_compression),
                     ("train_lm", example_train_lm),
                     ("serve_lm", example_serve_lm)):
        extra, walls[name], err = fn(ops, card)
        errs.append(err)
        for kernel in launches:
            launches[kernel] += extra[kernel]
    walls["quickstart_bare"] = example_quickstart_bare(card, qs["err"])
    err = merged(*errs)
    print(f"examples phase [{card}] " + json.dumps(dict(
        walls, launches=launches, held_max_abs_err=err,
        phase_s=time.perf_counter() - t0)), flush=True)
    return launches, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multihost-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.multihost_child:
        return multihost_child(args.seed)
    script_t0 = time.perf_counter()
    from repro_torch import prng
    from repro_torch.core import (
        estimation_engine, pipeline, sampling, summary_engine)
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
    # the kernels, and beside them sketch_fused's earlier float32 design,
    # which phase 6 times in turns with the kernel
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        mma_sync = pool.submit(sketch_fused_probe.build_mma_sync)
        paths = ops.build()
        mma_sync_lib = mma_sync.result()
    build_s = time.perf_counter() - t0
    print(f"build: {len(paths)} kernels in {build_s:.1f} s", flush=True)
    for name, path in paths.items():
        if name == "flash_attention":
            continue                  # per instance below
        log = path.with_name(path.name + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    # both of sketch_fused's instances on wgmma (HGMMA) fed by TMA
    # (UTMALDG), after the float32 one's prologue (elementwise: no MMA);
    # flash_attention's float32 and bf16 Dh 64, 96 and 128 instances on
    # wgmma fed by TMA (the float32 ones each after its prologue, a copy:
    # no MMA), the others on mma.sync
    fa = ops.KERNELS["flash_attention"]
    for name, tma_tags, prologue in (
            ("sketch_fused", ("f32_kernel", "bf16_kernel"), "sketch_pi_small"),
            ("flash_attention", tuple(f"flash_fwd_wgmma{kind}ILi{dh}ELb{m}E"
                                      for kind in ("", "_bf16")
                                      for dh in fa.WGMMA_DH
                                      for m in (0, 1)), "flash_vt")):
        sass = sass_counts(ops, paths[name])
        for fn, count in sass.items():
            print(f"  {name} SASS {fn}: " + ", ".join(
                f"{count[op]} {op}" for op in SASS_OPS), flush=True)
        tma_fns = [fn for fn in sass if any(tag in fn for tag in tma_tags)]
        mma_fns = [fn for fn in sass if fn not in tma_fns
                   and prologue not in fn]
        check(len(tma_fns) == len(tma_tags) and all(
            sass[fn]["HGMMA"] > 0 and sass[fn]["UTMALDG"] > 0
            and sass[fn]["HMMA"] == 0 for fn in tma_fns)
            and all(sass[fn]["HMMA"] > 0 for fn in mma_fns)
            and (name == "flash_attention") == (len(mma_fns) > 0),
            f"{name} runs on the tensor cores: SASS counts {sass}")
    sk = ops.KERNELS["sketch_fused"]
    sk_lib = ops._library("sketch_fused")
    sk_res = sketch_resources(paths["sketch_fused"])
    f32_res = sk_res.get("sketch_fused_f32_kernel", {})
    print(f"  sketch_fused clusters the card holds: bf16 "
          f"{sk.cluster_slots(sk_lib, k, 2)} of {sk.cluster_shape(k, n, 2)} "
          f"CTAs (along k, n), float32 {sk.cluster_slots(sk_lib, k, 4)} of "
          f"{sk.cluster_shape(k, n, 4)}; float32 instance "
          f"{f32_res.get('registers')} registers, "
          f"{f32_res.get('spill_bytes')} bytes spilled, "
          f"{sk.smem_bytes(4)} bytes of shared memory; bf16 instance "
          f"{sk.smem_bytes(2)}", flush=True)
    check(f32_res.get("spill_bytes") == 0 and not sk_res["serialised"],
          f"sketch_fused: no spill in the float32 instance, no wgmma "
          f"serialised: {sk_res}")
    flash_default = tuning.DEFAULTS["flash_attention"].block
    spills = flash_resources(paths["flash_attention"])
    serialised = spills.pop("serialised")
    for inst, (regs, spill) in spills.items():
        print(f"  flash_attention instance bq,bk,Dh,dtype={inst}: {regs} "
              f"registers, {spill} bytes spilled", flush=True)
    # the wgmma instances (float32 and bf16 at Dh 64, 96 and 128, each
    # with its masked twin, "_kv", for calls with kv_len below S) and the
    # float32 ones' prologues: no spill, the launch's registers those the
    # tuner models, no wgmma serialised
    for dh in fa.WGMMA_DH:
        vt_regs, vt_spill = spills.pop(("vt", dh))
        for kv in ("", "_kv"):
            wg_regs, wg_spill = spills.pop(("wgmma" + kv, dh))
            form = fa.WGMMA_FORMS[4, dh]
            print(f"flash_attention wgmma{kv} instance Dh {dh}: {wg_regs} "
                  f"registers, {wg_spill} bytes spilled; prologue "
                  f"{vt_regs} registers, {vt_spill} bytes spilled; (stages, "
                  f"sets) {(form.stages, form.sets)}, "
                  f"{fa.smem_bytes(128, 32, dh)} bytes of shared memory",
                  flush=True)
            check(wg_spill == 0 and vt_spill == 0
                  and wg_regs == fa.WGMMA_REGISTERS,
                  f"flash_attention wgmma{kv} instance Dh {dh}: {wg_regs} "
                  f"registers (the tuner's {fa.WGMMA_REGISTERS}), "
                  f"{wg_spill} and {vt_spill} bytes spilled")
            bf_regs, bf_spill = spills.pop(("wgmma_bf16" + kv, dh))
            form = fa.WGMMA_FORMS[2, dh]
            print(f"flash_attention bf16 wgmma{kv} instance Dh {dh}: "
                  f"{bf_regs} registers, {bf_spill} bytes spilled; (bk, "
                  f"stages, swizzle) {(form.bk, form.stages, form.swizzle)}, "
                  f"{fa.smem_bytes(128, form.bk, dh, 2)} bytes of shared "
                  f"memory", flush=True)
            check(bf_spill == 0 and bf_regs == fa.WGMMA_REGISTERS,
                  f"flash_attention bf16 wgmma{kv} instance Dh {dh}: "
                  f"{bf_regs} registers (the tuner's {fa.WGMMA_REGISTERS}), "
                  f"{bf_spill} bytes spilled")
    check(not serialised,
          f"flash_attention: no wgmma serialised: {serialised}")
    table = fa.REGISTERS
    check(all(regs <= table[inst[2]] for inst, (regs, _) in spills.items()),
          f"flash_attention: registers within the tuner's table {table}")
    default_insts = [i for i in spills if i[:2] == flash_default]
    mma_insts = sum(len(fa.tiles(dh, size)) for dh in fa.HEAD_DIMS
                    for size in (4, 2) if not fa.on_wgmma(dh, size))
    check(len(spills) == mma_insts
          and default_insts and all(spills[i][1] == 0 for i in default_insts),
          f"flash_attention: {len(spills)} mma.sync instances (want "
          f"{mma_insts}), no spill at the default tile {flash_default}")
    # the instances added for the reduced configs' width and Dh 256
    new_insts = {i: s for i, s in spills.items() if i[2] in (16, 256)}
    print("flash_attention Dh 16 and 256 instances (registers, spilled "
          "bytes): " + json.dumps({",".join(map(str, i)): s
                                   for i, s in new_insts.items()}),
          flush=True)
    check(len(new_insts) == 2 * (len(fa.tiles(16)) + len(fa.tiles(256)))
          and all(s == 0 for _, s in new_insts.values()),
          f"flash_attention: no spill at Dh 16 and 256: {new_insts}")
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
    # a head width whose menu lacks the default resolves to its own tile
    wide = ("flash_attention", (16, S_FULL, 256))
    cfg = tuning.lookup(*wide, backend=backend)
    print(f"tuning.lookup {wide[0]} {wide[1]} on {backend}: {cfg.block}",
          flush=True)
    check(cfg.block in fa.tiles(256), f"Dh 256 resolves to {cfg.block}, "
          f"a tile of its menu {fa.tiles(256)}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # draws for the block-mode and uniform-draw checks, apart so that gen's
    # stream (A, B and the probes' W) is the same with or without them
    aux = torch.Generator(device=dev)
    aux.manual_seed(args.seed + 1)
    # and for the engine's warm call and the serving phase
    serve_gen = torch.Generator(device=dev)
    serve_gen.manual_seed(args.seed + 2)
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
    sk = ops.KERNELS["sketch_fused"]
    small = sk.pi_small_launch(ops._library("sketch_fused"), Pi)
    check(bool(torch.equal(small, sk.pi_small_plain(Pi))),
          "sketch_fused's prologue: Pi's small parts equal the plain version")
    del small

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

    # 4. the slice at full width, through the pipeline engine --------------
    engine = pipeline.get_engine()

    def engine_delta(before):
        return {f: getattr(engine.stats, f) - before[f] for f in before}

    before = dict(vars(engine.stats))
    copies = ops.KERNELS["sketch_fused"].ALIGNED_COPIES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = smppca(key, A, B, r=r, k=k, m=m, T=T, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cold = engine_delta(before)
    print(f"smppca d={d} n1=n2={n} k={k} r={r} m={m} T={T}: {wall_s:.3f} s "
          f"wall, launches {launches}, peak memory {peak_gb:.3f} GB, engine "
          f"{cold}", flush=True)
    check(launches == {"sketch_fused": 2, "sampled_rescaled_dot": 1,
                       "blocked_fwht": 0, "flash_attention": 0},
          f"launches per smppca call: {launches}")
    check(cold["traces"] == 1 and cold["misses"] == 1 and cold["hits"] == 0,
          f"the first smppca call builds one cache entry: {cold}")
    check(ops.KERNELS["sketch_fused"].ALIGNED_COPIES == copies,
          "the float32 path's inputs are read by TMA in place")
    U, V = res.factors
    check(tuple(U.shape) == (n, r) and tuple(V.shape) == (n, r),
          "factor shapes")
    check(bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all()),
          "factors finite")
    resid = probe_residual(A, B, res.factors, gen)
    print(f"probe residual: {resid:.4f} (threshold {PROBE_RESIDUAL_MAX})",
          flush=True)
    check(resid < PROBE_RESIDUAL_MAX, f"probe residual {resid}")
    phase4_resid = resid
    # the same call again: a cache hit that builds nothing, keeping only
    # the first call's factors, on the host (its peak is then the call's)
    U1, V1 = U.cpu(), V.cpu()
    del res, U, V
    before = dict(vars(engine.stats))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live_warm = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = smppca(key, A, B, r=r, k=k, m=m, T=T, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = engine_delta(before)
    peak_warm_gb = torch.cuda.max_memory_allocated() / 1e9
    W8 = torch.randn(n, 8, generator=serve_gen, device=dev)
    ref = res.factors.U @ (res.factors.V.T @ W8)
    U1, V1 = U1.to(dev), V1.to(dev)
    warm_diff = float(torch.linalg.norm(U1 @ (V1.T @ W8) - ref)
                      / torch.linalg.norm(ref))
    print("smppca_warm " + json.dumps({
        "cold_s": wall_s, "warm_s": warm_s, "engine_cold": cold,
        "engine_warm": warm, "launches_warm": dict(ops.LAUNCHES),
        "peak_gb": peak_gb, "peak_warm_gb": peak_warm_gb,
        "uvt_probe_rel_diff": warm_diff}), flush=True)
    check(warm["traces"] == 0 and warm["hits"] == 1 and warm["misses"] == 0,
          f"the second smppca call is a cache hit: {warm}")
    check(dict(ops.LAUNCHES) == launches, "the warm call's launches")
    check(warm_diff < WARM_UVT_TOL,
          f"warm factors equal the cold ones to float32 rounding: {warm_diff}")
    check(max(peak_gb, peak_warm_gb) <= PHASE4_PEAK_GB_MAX,
          f"phase 4 peak memory {peak_gb}, {peak_warm_gb} GB")
    del U1, V1, W8, ref

    # the same path again, stage by stage, timed with CUDA events; its two
    # sketch_fused calls held against the plain version on a column slice
    # (recorded here, not in the calls above, whose peaks are held to the
    # byte: a record keeps Pi alive)
    with recording(ops, "sketch_fused") as step1_calls:
        stages, summary, samples, values = staged_run(key, A, B, k, m, r, T,
                                                      n, "gaussian", dev)
    cols = BF16_HELD_COLUMNS
    err_sketch = max(err_sketch, held_sketch(
        ops, [((Pi1, X[:, :cols]), kw, (out[:, :cols], norm[:cols]))
              for (Pi1, X), kw, (out, norm) in step1_calls["sketch_fused"]],
        "f32 path"))
    check(len(step1_calls["sketch_fused"]) == 2,
          "the staged run's step 1 launches sketch_fused twice")
    del step1_calls
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

    # 4b. the distributed path at full width, one NCCL rank ----------------
    launches_dist, launches_dist_stream = distributed_full_width(
        ops, key, A, B, k, r, m, T,
        dict(factors=res.factors,
             added_peak_gb=peak_warm_gb - live_warm / 1e9),
        args.seed, dev, card)

    # 4c. the Gaussian path in bf16 at full width --------------------------
    launches_bf16, err_bf16 = bf16_full_width(
        ops, smppca, key, A, B, k, r, m, T, phase4_resid, args.seed, dev,
        card)
    err_sketch = max(err_sketch, err_bf16)

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
    # the earlier mma.sync design (tools/sketch_fused_mma_sync.cu) in turns
    # with the kernel: mma.sync, kernel, kernel, mma.sync
    k1_turn, k1_mma = turns(
        lambda: sketch_fused_probe.launch_mma_sync(mma_sync_lib, Pi, A),
        lambda: ops.sketch_fused(Pi, A), reps=2)
    # the prologue alone: Pi's small parts, Pi read and written once
    k1_prologue = cuda_ms(lambda: sk.pi_small_launch(
        ops._library("sketch_fused"), Pi), reps=5)
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
                             bound_by=k1_by, mma_sync_ms=k1_mma,
                             kernel_in_turns_with_mma_sync_ms=k1_turn,
                             prologue_ms=k1_prologue,
                             clusters=sk.cluster_slots(
                                 ops._library("sketch_fused"), k, 4),
                             cluster_ctas=sk.cluster_shape(k, n, 4)),
        "sampled_rescaled_dot": dict(kernel_ms=k2_ms, plain_ms=k2_plain,
                                     library_ms=None, bound_ms=k2_bound,
                                     bound_by=k2_by),
    }
    for name, t in timing.items():
        print(f"timing {name} " + json.dumps(t), flush=True)
    del res, summary, samples, values, rows, cols, As_rows, Bs_rows
    del uni_rows, uni_cols

    # kernel 1 with bf16 inputs, on the bf16 tensor cores (wgmma); the
    # library's yardsticks: torch.matmul, whose output is bf16, and
    # torch.mm with a float32 output, the kernel's function
    Pi16, A16 = Pi.to(torch.bfloat16), A.to(torch.bfloat16)
    k1b_ms, k1b_plain = turns(lambda: sk.plain(Pi16, A16),
                              lambda: ops.sketch_fused(Pi16, A16), reps=2)
    k1b_bytes = 2.0 * (k * d + d * n) + 4.0 * (k * n + n)
    k1b_bound, k1b_by = bound(2.0 * k * d * n, k1b_bytes, PEAK_BF16_FLOPS)
    mm_f32 = lambda: torch.mm(Pi16, A16, out_dtype=torch.float32)
    torch.matmul(Pi16, A16)
    mm_f32()
    t = dict(kernel_ms=k1b_ms, plain_ms=k1b_plain,
             library_ms=cuda_ms(mm_f32, reps=2),
             matmul_bf16_out_ms=cuda_ms(lambda: torch.matmul(Pi16, A16),
                                        reps=2),
             bound_ms=k1b_bound, bound_by=k1b_by,
             clusters=sk.cluster_slots(ops._library("sketch_fused"), k, 2),
             cluster_ctas=sk.cluster_shape(k, n, 2))
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
    forms_srht = dict(ops.KERNELS["blocked_fwht"].BLOCK_FORMS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    blocks = -(-n // width)
    print(f"smppca srht d={d} (dp={dp}) n1=n2={n} k={k} r={r} m={m} T={T}: "
          f"{wall_s:.3f} s wall, launches {launches_srht} ({blocks} column "
          f"blocks of {width} per matrix), peak memory {peak_gb:.3f} GB",
          flush=True)
    check(launches_srht == {"sketch_fused": 0, "sampled_rescaled_dot": 1,
                            "blocked_fwht": 2 * blocks, "flash_attention": 0},
          f"launches per smppca(method='srht') call: {launches_srht}")
    print(f"smppca srht block forms {forms_srht}", flush=True)
    check(forms_srht == {"cluster": 2 * blocks, "two_pass": 0},
          f"every srht_block call of the SRHT path in the cluster form: "
          f"{forms_srht}")
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
    # the two-pass form at the same shape, in turns with the cluster form
    from repro_torch.core.sketch import _sqrt_f32
    lib3 = ops._library("blocked_fwht")
    rdp, rdpk = float(_sqrt_f32(dp)), float(_sqrt_f32(dp / k))
    s3, n3 = torch.empty((k, width), device=dev), torch.empty(width, device=dev)
    rows32 = plan_rows.to(torch.int32)
    k3_cluster, k3_two_pass = turns(
        lambda: fw.launch_block(lib3, X3, signs, rows32, dp, rdp, rdpk, s3,
                                n3, form="two_pass"),
        lambda: fw.launch_block(lib3, X3, signs, rows32, dp, rdp, rdpk, s3,
                                n3, form="cluster"), reps=3)
    plan3 = fw.block_plan(d, dp, X3.dtype, k)
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
    # the bytes the cluster form moves: those of the bound (it reads X
    # once and keeps the intermediate on chip; the sampled-row indices it
    # reads are k int32 a CTA, from L2)
    k3_bytes = 4.0 * (d * width + d + k * width + width)
    # no single PyTorch call computes a Walsh-Hadamard transform
    timing["blocked_fwht"] = dict(kernel_ms=k3_ms, plain_ms=k3_plain,
                                  library_ms=None, bound_ms=k3_bound,
                                  bound_by=k3_by, form=plan3.form,
                                  bytes_per_call=k3_bytes,
                                  gbps=k3_bytes / k3_ms / 1e6,
                                  cluster_turns_ms=k3_cluster,
                                  two_pass_turns_ms=k3_two_pass,
                                  cluster_smem_bytes=plan3.smem,
                                  cluster_slots=fw.cluster_slots(
                                      lib3, d, dp, X3.dtype, k),
                                  ptxas=cluster_resources(
                                      ops.library_path("blocked_fwht")),
                                  bf16_ms=k3b_ms,
                                  bf16_bound_ms=k3b_bound, full_mode_ms=full_ms,
                                  full_mode_bound_ms=full_bound,
                                  composition_ms=comp_ms)
    print("timing blocked_fwht " + json.dumps(timing["blocked_fwht"]),
          flush=True)
    del X3b

    # 9. the rest of the estimation engine at full width, then small ------
    engine = engine_full_width(ops, key, A, B, k, r, m, T, gen,
                               stages["waltmin"], dev)
    engine_small(args.seed, r, dev)
    print("engine_phase " + json.dumps({name: {kk: v for kk, v in x.items()
                                               if kk != "curve"}
                                        for name, x in engine.items()}),
          flush=True)
    torch.cuda.empty_cache()

    # 10. the streaming path at full width ----------------------------------
    launches_stream, seq_fin = stream_full_width(ops, key, A, B, k, r, m, T,
                                                 gen, dev, card)

    # 11. serving -----------------------------------------------------------
    # a SketchService stream session over the full-width pair, against
    # phase 10's state; a trace of one warm full-width smppca call
    serve_t0 = time.perf_counter()
    serve_s = {}
    launches_session = service_stream(ops, key, A, B, k, r, seq_fin,
                                      serve_gen, dev, card)
    serve_s["stream_session"] = time.perf_counter() - serve_t0
    del seq_fin
    torch.cuda.empty_cache()
    _, trace = device_trace(
        lambda: smppca(key, A, B, r=r, k=k, m=m, T=T, device=dev),
        "smppca_warm")
    # WAltMin's atomic adds: (m, r, r) and (m, r) per least-squares step
    # (2T + 1 of them), (m, r + 8) per COO product of its initial SVD (18)
    atomics = (2 * T + 1) * m * (r * r + r) + 18 * m * (r + 8)
    index_add_ms = trace["waltmin_split"]["index_add_"]["ms"]
    trace.update(waltmin_atomic_adds=atomics, atomic_adds_per_s=(
        atomics / (index_add_ms / 1e3) if index_add_ms else None))
    print(f"trace smppca_warm [{card}] " + json.dumps(trace), flush=True)
    serve_s["trace_smppca"] = trace["trace_s"]
    del A, B, X3, signs, plan_rows
    torch.cuda.empty_cache()
    # the serving sweep and the traffic cells at the JAX benchmark's sizes,
    # launch counters set to 0 before and read after; a trace of one warm
    # flush
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    serve_cells, warm_flush = serving_sweep(key, serve_gen, dev, card)
    serve_s["serving_sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    traffic = traffic_sweep(dev, card)
    serve_s["traffic_sweep"] = time.perf_counter() - t0
    launches_serve = {name: count + launches_session[name]
                      for name, count in ops.LAUNCHES.items()}
    print(f"serving launches {launches_serve}", flush=True)
    check(launches_serve["sketch_fused"] > 0
          and launches_serve["sampled_rescaled_dot"] > 0,
          f"the serving path launched its kernels: {launches_serve}")
    _, trace = device_trace(warm_flush, "serving_flush", record_shapes=False)
    print(f"trace serving_flush [{card}] " + json.dumps(trace), flush=True)
    serve_s["traces"] = serve_s.pop("trace_smppca") + trace["trace_s"]
    print(f"serving phase [{card}]: {time.perf_counter() - serve_t0:.1f} s "
          f"({len(serve_cells)} sweep cells, {len(traffic)} traffic cells; "
          f"parts {json.dumps(serve_s)})", flush=True)

    # 12. kernel 4 against its plain version ---------------------------------
    # tests/kernels/test_flash_attention.py's shapes, then the Dh 96, 112,
    # 16 and 256 ones of tests/test_torch_flash_attention.py, at every tile
    # their width compiles
    FLASH_MAX_ERR.clear()
    FLASH_BF16_AGREEMENT.update(share=0.0, excess=float("-inf"))
    for shape in ((1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 512, 2, 1, 128),
                  (1, 384, 3, 3, 64), (1, 256, 4, 2, 96), (1, 384, 2, 1, 112),
                  (1, 128, 4, 4, 16), (1, 256, 4, 1, 256)):
        B_, S_, H_, Hkv_, Dh_ = shape
        q, kk, v = attention_inputs(gen, S_, H_, Hkv_, Dh_, dev, batch=B_)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for block in fa.tiles(Dh_, dtype.itemsize):
                    flash_check(ops, q.to(dtype), kk.to(dtype), v.to(dtype),
                                causal, f"JAX test shape, tile {block}",
                                config=tuning.KernelConfig("flash_attention",
                                                           block))
    q, kk, v = attention_inputs(gen, S_TRAIN, HEADS, KV_HEADS, HEAD_DIM, dev)
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            flash_check(ops, q.to(dtype), kk.to(dtype), v.to(dtype), causal,
                        f"S={S_TRAIN}")
    # a head width past 256 raises before a launch
    for dh in REFUSED_WIDTHS:
        q = torch.randn(1, 128, 2, dh, generator=gen, device=dev)
        before = ops.LAUNCHES["flash_attention"]
        try:
            ops.flash_attention(q, q, q)
        except ValueError as err:
            print(f"flash_attention Dh {dh} refused: {err}", flush=True)
        else:
            check(False, f"flash_attention refuses Dh {dh}")
        check(ops.LAUNCHES["flash_attention"] == before,
              f"flash_attention Dh {dh}: no launch")
    flash_short_s(ops, gen, dev, card)
    for arch, heads, kv_heads, dh, batch in WIDTH_LAYOUTS:
        q, kk, v = attention_inputs(gen, S_TRAIN, heads, kv_heads, dh, dev,
                                    batch=batch)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                flash_check(ops, q.to(dtype), kk.to(dtype), v.to(dtype),
                            causal, f"{arch} heads, S={S_TRAIN}")
    # widths between compiled ones: one launch a call on the next wider
    # instance, on a zero-padded copy
    for dh in BETWEEN_WIDTHS:
        q, kk, v = attention_inputs(gen, S_TRAIN, 8, 2, dh, dev)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                before = ops.LAUNCHES["flash_attention"]
                out = ops.flash_attention(q.to(dtype), kk.to(dtype),
                                          v.to(dtype), causal=causal)
                check(ops.LAUNCHES["flash_attention"] == before + 1,
                      f"flash_attention Dh {dh}: one launch")
                flash_check(ops, q.to(dtype), kk.to(dtype), v.to(dtype),
                            causal, f"Dh {dh} on the Dh {fa.tile_width(dh)} "
                            f"instance, S={S_TRAIN}", out=out)
    del q, kk, v, out

    # 13. the attention path at full width ----------------------------------
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
    print(f"flash_attention phases 12 and 13 [{card}]: largest error bf16 "
          f"{FLASH_MAX_ERR[torch.bfloat16]:.3e} (tol "
          f"{FLASH_TOL[torch.bfloat16]:.0e} + {FLASH_TOL[torch.bfloat16]:.0e}"
          f" |ref|), float32 {FLASH_MAX_ERR[torch.float32]:.3e}; the bf16 "
          f"wgmma calls differ from the plain version's bf16 on at most "
          f"{FLASH_BF16_AGREEMENT['share']:.3e} of entries (limit "
          f"{fa.BF16_DIFFER_MAX}), largest excess over 1 ulp "
          f"{FLASH_BF16_AGREEMENT['excess']:.3e}", flush=True)

    # 14. kernel 4's timings ------------------------------------------------
    # every compiled tile at the full width, float32 and bf16, one call each
    # after a warm-up (the tuner below measures only its model's best three)
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dtype) for x in (q, kk, v))
        for block in fa.tiles(HEAD_DIM, dtype.itemsize):
            cfg = tuning.KernelConfig("flash_attention", block)
            ops.flash_attention(qd, kd, vd, config=cfg)
            ms = cuda_ms(lambda: ops.flash_attention(qd, kd, vd, config=cfg), 1)
            print(f"tile flash_attention S={S_FULL} {block} "
                  f"{str(dtype).split('.')[-1]}: {ms:.3f} ms", flush=True)
        del qd, kd, vd
    # the float32 Dh 128 instance's prologue alone (V^T in the P fragment's
    # key order, which every call of a wgmma instance runs first): equal to
    # its plain version, its time, and the instance's shared memory
    fa_lib = ops._library("flash_attention")
    vt = fa.vt_launch(fa_lib, v)
    check(torch.equal(vt, fa.vt_plain(v)),
          "flash_attention prologue: V^T as vt_plain gives it")
    del vt
    vt_ms = cuda_ms(lambda: fa.vt_launch(fa_lib, v), 5)
    vt_bytes = 2 * v.numel() * v.element_size()
    print(f"flash_attention wgmma instance S={S_FULL} [{card}]: prologue "
          f"{vt_ms:.4f} ms ({vt_bytes / 1e6:.1f} MB read and written, "
          f"{vt_bytes / vt_ms / 1e6:.1f} GB/s; bound "
          f"{bound(0.0, vt_bytes, PEAK_TF32_FLOPS)[0]:.4f} ms), shared "
          f"memory {fa.smem_bytes(128, 32, HEAD_DIM)} bytes a CTA",
          flush=True)
    for S_, reps in ((S_FULL, 1), (S_TRAIN, 5)):
        if S_ != S_FULL:
            q, kk, v = attention_inputs(gen, S_, HEADS, KV_HEADS, HEAD_DIM, dev)
        t = flash_timings(ops, q, kk, v, reps, "")
        if S_ == S_FULL:
            timing["flash_attention"] = t
    del q, kk, v
    torch.cuda.empty_cache()
    # the other head widths at S_FULL, one sequence, at the default tile;
    # at a float32 wgmma width (phi3's 96, whisper's 64) its prologue alone
    # too, equal to its plain version
    for arch, heads, kv_heads, dh, _ in WIDTH_LAYOUTS:
        q, kk, v = attention_inputs(gen, S_FULL, heads, kv_heads, dh, dev)
        flash_timings(ops, q, kk, v, 1, f" {arch} Dh {dh}")
        if fa.on_wgmma(dh, 2):
            form = fa.wgmma_form(dh, 2)
            print(f"flash_attention bf16 wgmma instance {arch} Dh {dh}: "
                  f"(bk, stages, swizzle) "
                  f"{(form.bk, form.stages, form.swizzle)}, shared memory "
                  f"{fa.smem_bytes(128, form.bk, dh, 2)} bytes a CTA, no "
                  f"prologue", flush=True)
        if fa.on_wgmma(dh):
            vt = fa.vt_launch(fa_lib, v)
            check(torch.equal(vt, fa.vt_plain(v)),
                  f"flash_attention prologue Dh {dh}: V^T as vt_plain gives "
                  f"it")
            del vt
            vt_ms = cuda_ms(lambda: fa.vt_launch(fa_lib, v), 5)
            vt_bytes = 2 * v.numel() * v.element_size()
            print(f"flash_attention wgmma instance {arch} Dh {dh} "
                  f"S={S_FULL} [{card}]: prologue {vt_ms:.4f} ms "
                  f"({vt_bytes / 1e6:.1f} MB read and written, "
                  f"{vt_bytes / vt_ms / 1e6:.1f} GB/s; bound "
                  f"{bound(0.0, vt_bytes, PEAK_TF32_FLOPS)[0]:.4f} ms), "
                  f"{fa.WGMMA_FORMS[4, dh][1:3]} (stages, sets), shared "
                  f"memory {fa.smem_bytes(128, 32, dh)} bytes a CTA",
                  flush=True)
        del q, kk, v
        torch.cuda.empty_cache()

    # 15. the kernel tuner --------------------------------------------------
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

    # 16. the multi-host cell: two processes on the one card ---------------
    torch.cuda.empty_cache()
    launches_multihost = multihost_cell(args.seed, card)

    # 17. gradient compression and the gradient tap at a layer's width -----
    launches_taps, launches_comp = gradient_phase(ops, args.seed, dev, card)
    torch.cuda.empty_cache()

    # 18. the LM path at full width ------------------------------------------
    launches_lm, err_lm = lm_phase(ops, args.seed, dev, card)
    err_flash = max(err_flash, err_lm)

    # 19. the MoE and recurrent families at full width ----------------------
    launches_moe, err_moe = moe_recurrent_phase(ops, args.seed, dev, card)
    err_flash = max(err_flash, err_moe)

    # 20. training at full width --------------------------------------------
    launches_train, err_train, rec_a, probe = train_phase(
        ops, args.seed, dev, card)
    err_sketch = max(err_sketch, err_train["sketch_fused"])
    err_sampled = max(err_sampled, err_train["sampled_rescaled_dot"])

    # 21. save_attn_out remat and the step's roofline -----------------------
    remat_phase(ops, args.seed, dev, card, rec_a, probe)

    # 22. four more archs served at full width -------------------------------
    launches_archs, err_archs = archs_phase(ops, args.seed, dev, card)
    err_flash = max(err_flash, err_archs)

    # 23. the examples' twins on the card -----------------------------------
    launches_examples, err_examples = examples_phase(ops, card)
    err_sketch = max(err_sketch, err_examples["sketch_fused"])
    err_sampled = max(err_sampled, err_examples["sampled_rescaled_dot"])
    err_flash = max(err_flash, err_examples["flash_attention"])

    # 24. the kernels line and the last line --------------------------------
    errs = {"sketch_fused": err_sketch, "sampled_rescaled_dot": err_sampled,
            "blocked_fwht": err_fwht, "flash_attention": err_flash}
    # each kernel's launches on the paths that run it: the Gaussian path
    # and the stream's 4,096-row pass for kernel 1, the Gaussian path for
    # kernel 2, the SRHT path for kernel 3, the attention call for kernel
    # 4, and for each the serving phase's (the sweep, the traffic cells and
    # the stream session); then the bf16 path (phase 4c), the distributed
    # call and stream, both
    # ranks' sharded ingest, the gradient tap and the compressor, the LM
    # requests' prefills (granite's, then moonshot's), the training steps
    # (the taps' sketches and their decompression), phase 22's prefills
    # (phi3's, starcoder2's, llama's, whisper's), and the examples' twins
    # (the reduced LMs' prefills among them)
    path_launches = dict(launches, blocked_fwht=launches_srht["blocked_fwht"],
                         flash_attention=launches_flash["flash_attention"])
    path_launches["sketch_fused"] += launches_stream["sketch_fused"]
    for extra in (launches_bf16, launches_serve, launches_dist,
                  launches_dist_stream, launches_multihost, launches_taps,
                  launches_comp,
                  launches_lm, launches_moe, launches_train,
                  launches_archs, launches_examples):
        for name in path_launches:
            path_launches[name] += extra[name]
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
    print(f"chip_smoke [{card}]: {time.perf_counter() - script_t0:.1f} s "
          f"(build {build_s:.1f} s)", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
