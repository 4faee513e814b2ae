#!/usr/bin/env python3
"""What holds ``flash_attention.cu`` back on the card: the kernel beside
variants of itself, each made by editing the source's text, and the rate of
the card's ``mma.sync`` TF32 instruction alone.

    python3 tools/flash_attention_probe.py [--seed 0] [--tile 128 32]
        [--layout 32 8 128 [--layout 32 32 96 ...]] [--dtype both]
        [--baseline OTHER/flash_attention.cu [--turns N]] [--only VARIANT ...]

Each variant edits every design: the ``mma.sync`` instances and the
``wgmma`` ones (float32 and bf16 at Dh 64, 96 and 128, ``flash_fwd_wgmma``
and ``flash_fwd_wgmma_bf16``).

* ``kernel``: the source as committed;
* ``no_copies``: the K/V stages after the first are never refilled
  (``mma.sync``: no ``cp.async``; ``wgmma``: no TMA load past the first
  ``STAGES`` tiles, whose barriers complete on the producer's arrival
  alone), so the kernel works on stale tiles: its time without the loads;
* ``no_mma``: each ``mma.sync`` becomes one float add of its operands'
  bits, each ``wgmma`` nothing (its accumulator keeps what it held): its
  time without the tensor cores;
* ``no_split``: big = small = x, with no rounding or subtraction: its time
  without the split's integer and float work (the MMAs stay; the float32
  ``wgmma`` instances' splitters still load and store their tiles, and
  their Q and P small parts are still written; bf16 ``wgmma`` has none);
* ``p_once``: the bf16 ``wgmma`` instances' PV on P's high bf16 part
  alone, one pass in place of two: what the second part costs (a
  yardstick, another function: it misses the float32 tolerance);
* ``qk_ahead``: the bf16 ``wgmma`` consumers issue tile kt + 1's QK^T into
  a second S accumulator before tile kt's softmax, and wait for it with
  tile kt's PV (the source issues each tile's QK^T and waits for it);
* ``stages<s>_sets<t>``: the float32 ``wgmma`` instances at Dh 64 and 96
  with ``s`` stages in their TMA ring and ``t`` sets of small parts (their
  ``WForm``), each form that fits and is not the source's (Dh 128 keeps
  its own: a third stage does not fit there);
* ``bf16_bk<b>_stages<s>``: the bf16 ``wgmma`` instances with k-tiles of
  ``b`` keys and ``s`` stages (their ``BForm``), at each width where the
  form fits (the others keep the source's), each form that is not the
  source's at every width.

Each build's ``wgmma_ptxas`` line gives each ``wgmma`` instance's
registers, spilled bytes and ptxas's notes that it serialised the
``wgmma`` (C7511, C7512, C7518) or injected a wait (C7517), by dtype and
width ("f32_128", "bf16_96"; "f32_128_kv" the masked instance that a
call with ``kv_len`` below S runs).

Each variant is checked against the plain version at S = 4,096 (in bf16
also the share of output entries that differ from the plain version's
and the largest excess over one bf16 ulp plus the float32 tolerance,
``flash_attention.bf16_agreement``) and timed
at one attention layer of S = 32,768, causal, in each dtype whose
instances it changes (float32 and bf16; ``--dtype`` keeps one and builds
only the variants that change it), at each layout (query heads, KV heads,
Dh; ``--layout`` again for another, all on one build), at the tile its
source runs there: a ``wgmma`` instance's one, else the tile given
(default: the one ``tuning.lookup`` resolves). The layout defaults to
granite-3-8b's 32 over 8 of 128; ``--layout 32 32 96`` is
phi3-mini-3.8b's, ``12 12 64`` whisper-small's, ``16 1 256``
recurrentgemma-9b's. ``--baseline`` builds another copy of the source (say
the parent commit's, unpacked with ``git archive``) and times it in turns
with the kernel and the variants of each dtype (float32: baseline, kernel,
its forms; bf16: baseline, kernel, ``no_copies``, ``no_mma``, ``p_once``,
``qk_ahead``, its forms; then the same backwards; its own line a layout):
the cost of a change to the source, within one call on one card
(``--turns`` repeats the whole alternation and adds each one's median
and interquartile range); its
``sass_vs_baseline`` line names the ``flash_fwd`` instances (bq, bk, Dh,
dtype) and the ``wgmma`` ones ("wgmma", Dh) and ("wgmma_bf16", Dh) whose
SASS differs from the baseline's, instruction for instruction
(``cuobjdump -sass``, branch labels renumbered), and its
``resources_vs_baseline`` line gives every instance's registers, spilled
bytes and ``HMMA``, ``HGMMA`` and ``UTMALDG`` counts, and ptxas's
serialisation notes, in both builds. ``--only`` builds and times the
variants named (``kernel`` always, and the baseline). A source is called
through its ``wgmma`` entry for a dtype at the widths it runs there (its
``wgmma_width``, or its one ``W_DH``, in float32; its ``BForm`` widths in
bf16), and through ``flash_attention_f32`` or ``flash_attention_bf16`` at
every other width and dtype, as that source took them (with ``kv_len``
or, a source from before it, without). ``mma_sync_peak``
times a kernel of independent ``mma.sync.m16n8k8`` TF32 MMAs on every SM,
the rate the ``mma.sync`` design can reach at most. One JSON line per variant; needs a CUDA card
and ``nvcc``. Builds go to ``build/repro_torch/probe/``.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import statistics
import subprocess
import sys

import numpy

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tools")]

from kernel_probe import (build, card, cuda_ms, edit as _edit,  # noqa: E402
                          relabelled)
from repro_torch.kernels import flash_attention, ops, tuning  # noqa: E402

REFILL = "if (kt + 1 < n_kt) load_stage("
MMA_ASM = '''  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
SPLIT = '''    big = (x + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));'''
TMA_EXPECT = "          mbar_expect(&full[slot], STAGE);\n"
SMALL_PART = "  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);"
WGMMA_OPS = tuple(f'"wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "'
                  for n in (32, 128, 96, 64))
BF16_WGMMA_OPS = tuple(
    f'"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "'
    for n in (64, 96, 128))
# the bf16 instances' second PV pass, on P's low part
PV_LO = "        wgmma_pv_bf16<DH>(part, a_lo, v_desc, 1);\n"
# the bf16 consumers' QK^T of tile kt, issued and waited for; a second S
# accumulator; the end of a k-tile's loop body
QK_NOW = "      issue_qk(s, kt);\n      wgmma_wait();\n      reg_fence(s);\n"
S_DECL = ("    float o[ACC], part[ACC], s[S_ACC], m[2] = {NEG, NEG}, l[2] = "
          "{0.f, 0.f};\n")
QK_LAMBDA_END = "      wgmma_commit();\n    };\n"
BF16_TILE_END = ("      reg_fence(p_lo);\n      warp_arrive(&empty[slot]);\n"
                 "#pragma unroll\n      for (int i = 0; i < ACC; ++i)\n"
                 "        o[i] = fmaf(o[i], corr[(i >> 1) & 1], part[i]);\n"
                 "    }\n")
# a wgmma width's form: stages of its TMA ring, sets of small parts
FORM = ("template <> struct WForm<{dh}> {{ static constexpr int STAGES = "
        "{stages}, SETS = {sets}; }};")
FORM_RE = (r"template <> struct WForm<{dh}> \{{ static constexpr int "
           r"STAGES = \d+, SETS = \d+; \}};")
# the forms tried at Dh 64 and 96, each where it fits (WTile's static_assert)
FORMS = ((2, 1), (3, 1), (4, 1), (2, 2), (3, 2))
# a bf16 width's form: keys a k-tile, stages, the swizzle's bytes a row
BFORM_RE = (r"template <> struct BForm<{dh}> \{{ static constexpr int BK = "
            r"(\d+), STAGES = (\d+), SWIZZLE = (\d+); \}};")
BFORM = ("template <> struct BForm<{dh}> {{ static constexpr int BK = {bk}, "
         "STAGES = {stages}, SWIZZLE = {sw}; }};")
# the (bk, stages) tried at the bf16 widths, each where it fits
BF16_FORMS = ((64, 2), (64, 3), (64, 4), (64, 6), (128, 2), (128, 3),
              (128, 4))

# Independent MMAs, 8 accumulators a warp, operands kept in registers.
PEAK_SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) peak(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (seed * (threadIdx.x + 7 * i)) & 0x3f7fe000u;
  for (int i = 0; i < 2; ++i) b[i] = (seed * (threadIdx.x + 3 * i)) & 0x3f7fe000u;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(float* out, int blocks, int iters, void* stream) {
  peak<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, 12345u);
  return (int)cudaGetLastError();
}
'''


edit = functools.partial(_edit, source=flash_attention.SOURCE)


def no_copies(text: str) -> str:
    text = edit(text, REFILL, "if (kt + 1 < 0) load_stage(")
    return edit(text, TMA_EXPECT,
                "          mbar_expect(&full[slot], kt < STAGES ? STAGE : "
                "0);\n          if (kt >= STAGES) continue;\n")


def no_mma(text: str) -> str:
    text = edit(text, MMA_ASM, "  c[0] += __uint_as_float(a[0] ^ a[1] ^ "
                               "a[2] ^ a[3] ^ b0 ^ b1);")
    for op in WGMMA_OPS + BF16_WGMMA_OPS:
        text = edit(text, op, '"// "')     # a PTX comment to the line's end
    return text


def p_once(text: str) -> str:
    return edit(text, PV_LO, "")


def qk_ahead(text: str) -> str:
    text = edit(text, S_DECL, S_DECL + "    float s_next[S_ACC];\n")
    text = edit(text, QK_LAMBDA_END, QK_LAMBDA_END + "    issue_qk(s, 0);\n")
    text = edit(text, QK_NOW, "      wgmma_wait();\n      reg_fence(s);\n"
                "      if (kt + 1 < n_kt) issue_qk(s_next, kt + 1);\n")
    return edit(text, BF16_TILE_END, BF16_TILE_END[:-6] + (
        "      reg_fence(s_next);\n#pragma unroll\n      for (int i = 0; i < "
        "S_ACC; ++i) s[i] = s_next[i];\n    }\n"))


def no_split(text: str) -> str:
    text = edit(text, SPLIT, "    big = x;\n    small = x;")
    return edit(text, SMALL_PART, "  return x;")


def with_form(text: str, stages: int, sets: int) -> str:
    """The source with its Dh 64 and 96 ``wgmma`` instances in the form
    (stages, sets)."""
    for dh in (64, 96):
        new = FORM.format(dh=dh, stages=stages, sets=sets)
        text, n = re.subn(FORM_RE.format(dh=dh), new, text)
        if n != 1:
            raise RuntimeError(f"{flash_attention.SOURCE} has no WForm<{dh}>")
    return text


def fits(stages: int, sets: int, dh: int) -> bool:
    """Whether the form fits one CTA's shared memory at width dh (the
    source's ``WTile::SMEM``)."""
    return 1024 + 8 * 128 * dh + (stages + sets) * 8 * 32 * dh + \
        8 * (2 * stages + 3 * sets) <= 232_448


def form_variants(text: str) -> dict:
    """{"stages<s>_sets<t>": source} for each form that fits at Dh 96 (and
    so at 64) and differs from the source's."""
    return {f"stages{s}_sets{n}": with_form(text, s, n)
            for s, n in FORMS if fits(s, n, 96)
            and with_form(text, s, n) != text}


def fits_bf16(bk: int, stages: int, dh: int) -> bool:
    """Whether a bf16 form fits one CTA's shared memory at width dh (the
    source's ``BTile::SMEM``)."""
    return 1024 + 2 * 128 * dh + stages * 4 * bk * dh + \
        8 * (2 * stages + 1) <= 232_448


def bf16_forms(text: str) -> dict:
    """{Dh: (bk, stages, swizzle)} of a source's bf16 ``wgmma`` instances;
    empty without them."""
    return {int(m[1]): (int(m[2]), int(m[3]), int(m[4]))
            for m in re.finditer(BFORM_RE.format(dh=r"(\d+)"), text)}


def with_bf16_form(text: str, bk: int, stages: int) -> str:
    """The source with each bf16 ``wgmma`` width where (bk, stages) fits
    in that form, its swizzle kept."""
    for dh, (_, _, sw) in bf16_forms(text).items():
        if fits_bf16(bk, stages, dh):
            text = re.sub(BFORM_RE.format(dh=dh), BFORM.format(
                dh=dh, bk=bk, stages=stages, sw=sw), text)
    return text


def bf16_form_variants(text: str) -> dict:
    """{"bf16_bk<b>_stages<s>": source} for each (bk, stages) that differs
    from the source at some width."""
    return {f"bf16_bk{bk}_stages{s}": with_bf16_form(text, bk, s)
            for bk, s in BF16_FORMS if with_bf16_form(text, bk, s) != text}


def wgmma_widths(text: str, dtype=torch.float32) -> tuple:
    """The widths a source runs on its ``wgmma`` entry for ``dtype``: in
    float32 its ``wgmma_width``, or the one ``W_DH`` of a source from
    before the other widths; in bf16 its ``BForm`` widths; none without
    the entry."""
    if dtype == torch.bfloat16:
        return tuple(sorted(bf16_forms(text))) \
            if "flash_attention_bf16_wgmma" in text else ()
    if "flash_attention_f32_wgmma" not in text:
        return ()
    m = re.search(r"bool wgmma_width\(int DH\) \{\s*return ([^;]*);", text)
    if m:
        return tuple(int(w) for w in re.findall(r"DH == (\d+)", m[1]))
    return (int(re.search(r"constexpr int W_DH = (\d+)", text)[1]),)


WGMMA_NAME = r"flash_fwd_wgmma(_bf16)?(?:ILi(\d+)E(Lb1E)?)?"


def _wgmma_key(bf16, dh, masked=None) -> str:
    """"f32_<Dh>" or "bf16_<Dh>" of a ``WGMMA_NAME`` match's groups (a
    source's untemplated float32 instance is its Dh 128), "_kv" after it
    for the instance a call with ``kv_len`` < S runs."""
    return f"{'bf16' if bf16 else 'f32'}_{int(dh or 128)}" + \
        ("_kv" if masked else "")


def _wgmma_inst(w) -> tuple:
    """("wgmma" or "wgmma_bf16", "_kv" after it for the masked instance,
    Dh) of a ``WGMMA_NAME`` match."""
    return (("wgmma_bf16" if w[1] else "wgmma") + ("_kv" if w[3] else ""),
            int(w[2] or 128))


def wgmma_report(lib) -> dict:
    """{"f32_<Dh>" or "bf16_<Dh>" (and "_kv" after it for a masked
    instance): {"registers", "spill_bytes", "notes"}} of each ``wgmma``
    instance, from the ``-Xptxas -v`` report kept beside
    the library: ptxas's notes that it serialised ``wgmma`` (C7511, C7512,
    C7518) or injected a wait (C7517)."""
    log = open(re.sub(r"\.so$", ".log", lib._name)).read()
    out, key = {}, None
    for m in re.finditer(r"\((C751[1278])\).*?" + WGMMA_NAME, log):
        out.setdefault(_wgmma_key(m[2], m[3], m[4]), {}).setdefault(
            "notes", []).append(m[1])
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(WGMMA_NAME, line)
            key = None if m is None else _wgmma_key(m[1], m[2], m[3])
        elif key is not None and "spill stores" in line:
            out.setdefault(key, {})["spill_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", line)[1])
        elif key is not None and "Used" in line:
            out[key]["registers"] = int(
                re.search(r"Used (\d+) registers", line)[1])
            out[key].setdefault("notes", [])
    return out


def sass_by_instance(lib) -> dict:
    """{(bq, bk, Dh, dtype): SASS text} of each ``flash_fwd`` instance in
    the loaded library, {("wgmma", Dh): SASS text} of each
    ``flash_fwd_wgmma`` one (a source's untemplated one is its Dh 128) and
    {("wgmma_bf16", Dh): SASS text} of each ``flash_fwd_wgmma_bf16`` one
    ("wgmma_kv" and "wgmma_bf16_kv" the masked instances), from
    ``cuobjdump -sass``, branch labels renumbered."""
    cuobjdump = os.path.join(os.path.dirname(ops._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name], check=True,
                          capture_output=True, text=True).stdout
    out, inst = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_fwdILi(\d+)ELi(\d+)ELi(\d+)E"
                          r"(f|13__nv_bfloat16)E", line)
            w = re.search(WGMMA_NAME, line)
            inst = (int(m[1]), int(m[2]), int(m[3]),
                    "float32" if m[4] == "f" else "bfloat16") if m else \
                _wgmma_inst(w) if w else None
            if inst is not None:
                out[inst] = []
        elif inst is not None:
            out[inst].append(" ".join(line.split()))
    return {i: relabelled("\n".join(lines)) for i, lines in out.items()}


def resources(lib, sass: dict) -> dict:
    """{instance: [registers, spilled bytes, HMMA, HGMMA, UTMALDG]} of
    each instance of ``sass_by_instance`` (its keys) and of each float32
    prologue (("vt", Dh): registers and spills), from the ``-Xptxas -v``
    report kept beside the library and the instance's SASS; under
    "serialised" ptxas's notes that it serialised ``wgmma`` (C7511, C7512,
    C7518) or injected a wait (C7517), as (code, function) pairs."""
    log = open(re.sub(r"\.so$", ".log", lib._name)).read()
    out = {"serialised": [list(n) for n in re.findall(
        r"\((C751[1278])\).*?function '\w*?(flash_\w+?E(?:Lb[01]E)?)",
        log)]}
    key = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_fwdILi(\d+)ELi(\d+)ELi(\d+)E"
                          r"(f|13__nv_bfloat16)E", line)
            w = re.search(WGMMA_NAME, line)
            vt = re.search(r"flash_vtILi(\d+)E", line)
            key = (int(m[1]), int(m[2]), int(m[3]),
                   "float32" if m[4] == "f" else "bfloat16") if m else \
                ("vt", int(vt[1])) if vt else \
                _wgmma_inst(w) if w else None
        elif key is not None and "spill stores" in line:
            out[key] = [None, int(
                re.search(r"(\d+) bytes spill stores", line)[1])]
        elif key is not None and "Used" in line and key in out:
            out[key][0] = int(re.search(r"Used (\d+) registers", line)[1])
    for inst, text in sass.items():
        out.setdefault(inst, [None, None])
        out[inst] += [len(re.findall(rf"\b{op}\b", text))
                      for op in ("HMMA", "HGMMA", "UTMALDG")]
    return out


def legacy_launch(lib, q, k, v, causal, bq, bk, wgmma):
    """``flash_attention.launch`` of a source from before the key length
    (``kv_len``): its ``wgmma`` entry for the dtype where ``wgmma`` (the
    float32 one with the prologue's V^T scratch), else its entry for the
    dtype, at any compiled width."""
    B, S, H, Dh = q.shape
    o = torch.empty_like(q)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    entry = flash_attention._ENTRY[q.dtype]
    if wgmma:
        entry = flash_attention._WGMMA_ENTRY[q.dtype]
        if q.dtype == torch.float32:
            vt = torch.empty((B, k.shape[2], Dh, S), dtype=torch.float32,
                             device=q.device)
            ptrs.append(vt.data_ptr())
    err = getattr(lib, entry)(
        *ptrs, o.data_ptr(), B, S, H, k.shape[2], Dh,
        ctypes.cast(strides, ctypes.c_void_p), 1.0 / Dh ** 0.5, int(causal),
        bq, bk, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"baseline flash_attention: CUDA error {err}")
    return o


def bind_any(lib, text: str, tile: tuple):
    """Bind the entry points of a library built from source ``text``, one
    from before the ``wgmma`` widths or the key length it has too; returns
    its launch function and the tile it runs at a (dtype, Dh): the
    ``wgmma`` entry at the widths the source runs there for the dtype, at
    that instance's one tile, its entry for the dtype at ``tile`` at every
    other width and dtype. A source with ``kv_len`` runs through
    ``flash_attention.launch``, an older one through ``legacy_launch``."""
    widths = {dtype: wgmma_widths(text, dtype)
              for dtype in (torch.float32, torch.bfloat16)}
    bk_bf16 = {dh: form[0] for dh, form in bf16_forms(text).items()}
    current = "kv_len" in text
    if current:
        flash_attention.bind(lib)
    else:
        rest = [ctypes.c_int64] * 5 + [ctypes.c_void_p, ctypes.c_float] + [
            ctypes.c_int64] * 3 + [ctypes.c_void_p]
        for name in flash_attention._ENTRY.values():
            getattr(lib, name).argtypes = [ctypes.c_void_p] * 4 + rest
            getattr(lib, name).restype = ctypes.c_int
        for dtype, n_ptrs in ((torch.float32, 5), (torch.bfloat16, 4)):
            if widths[dtype]:
                fn = getattr(lib, flash_attention._WGMMA_ENTRY[dtype])
                fn.argtypes = [ctypes.c_void_p] * n_ptrs + rest
                fn.restype = ctypes.c_int

    def tile_of(dtype, dh):
        width = flash_attention.tile_width(dh)
        if width not in widths[dtype]:
            return tuple(tile)
        return (128, 32) if dtype == torch.float32 else (128, bk_bf16[width])

    def launch(q, k, v, causal):
        bq, bk = tile_of(q.dtype, q.shape[3])
        if current:
            return flash_attention.launch(lib, q, k, v, causal, bq, bk)
        return legacy_launch(lib, q, k, v, causal, bq, bk,
                             flash_attention.tile_width(q.shape[3])
                             in widths[q.dtype])
    return launch, tile_of


def mma_peak_tflops(lib, dev) -> float:
    """FLOP/s of independent m16n8k8 TF32 MMAs, 8 warps a CTA, 8 CTAs per
    SM worth of work in flight."""
    lib.mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    lib.mma_peak.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, iters = 8 * sms, 4096
    out = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        if lib.mma_peak(out.data_ptr(), blocks, iters, stream):
            raise RuntimeError("mma_peak launch failed")
    ms = cuda_ms(call, 5)
    mmas = blocks * 8 * iters * 8          # warps x iterations x accumulators
    return mmas * 2.0 * 16 * 8 * 8 / (ms * 1e-3) / 1e12


DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the float32 tolerance of the JAX suite's flash test
F32_TOL = 5e-5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tile", type=int, nargs=2, default=None)
    ap.add_argument("--layout", type=int, nargs=3, action="append",
                    metavar=("HEADS", "KV_HEADS", "DH"))
    ap.add_argument("--dtype", choices=("both", *DTYPES), default="both")
    ap.add_argument("--baseline", default=None,
                    help="another flash_attention.cu, timed in turns")
    ap.add_argument("--turns", type=int, default=1,
                    help="times to repeat the baseline's turns (each the "
                         "order, then backwards), with medians and "
                         "interquartile ranges past one")
    ap.add_argument("--only", nargs="+", default=None, metavar="VARIANT",
                    help="build and time these variants alone (and the "
                         "baseline); 'kernel' is always kept")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_attention_probe: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    text = (ops.CSRC / flash_attention.SOURCE).read_text()
    # each variant and the dtypes whose instances it changes
    both, f32, bf16 = ("f32", "bf16"), ("f32",), ("bf16",)
    variants = {"kernel": (text, both), "no_copies": (no_copies(text), both),
                "no_mma": (no_mma(text), both),
                "no_split": (no_split(text), both),
                "p_once": (p_once(text), bf16),
                "qk_ahead": (qk_ahead(text), bf16),
                **{n: (s, f32) for n, s in form_variants(text).items()},
                **{n: (s, bf16) for n, s in bf16_form_variants(text).items()}}
    tags = both if args.dtype == "both" else (args.dtype,)
    variants = {name: (src, dts) for name, (src, dts) in variants.items()
                if set(dts) & set(tags) and (
                    args.only is None or name in ("kernel", *args.only))}
    sources = {name: src for name, (src, _) in variants.items()}
    if args.baseline:
        with open(args.baseline) as f:
            sources["baseline"] = f.read()
    libs = build({**sources, "peak": PEAK_SOURCE}, prefix="flash_")
    peak_lib = libs.pop("peak")
    base_lib = libs.pop("baseline", None)
    print(f"card: {card()}", flush=True)
    for name, lib in [*libs.items(), ("baseline", base_lib)]:
        if lib is not None:
            print(json.dumps({"variant": name, "wgmma_ptxas": wgmma_report(
                lib)}), flush=True)
    if base_lib is not None:
        mine, base = sass_by_instance(libs["kernel"]), sass_by_instance(base_lib)
        res = {"kernel": resources(libs["kernel"], mine),
               "baseline": resources(base_lib, base)}
        print(json.dumps({
            "variant": "resources_vs_baseline",
            "fields": ["registers", "spill_bytes", "HMMA", "HGMMA",
                       "UTMALDG"],
            "serialised": {n: r.pop("serialised") for n, r in res.items()},
            "instances": {",".join(map(str, i)): {
                n: r.get(i) for n, r in res.items()} for i in sorted(
                    set(res["kernel"]) | set(res["baseline"]), key=str)}}),
            flush=True)
        shared = sorted(set(mine) & set(base), key=str)
        print(json.dumps({
            "variant": "sass_vs_baseline", "instances": len(mine),
            "baseline_instances": len(base),
            "identical": sum(mine[i] == base[i] for i in shared),
            "differ": [list(i) for i in shared if mine[i] != base[i]],
            "new": [list(i) for i in sorted(set(mine) - set(base), key=str)],
            "gone": [list(i) for i in sorted(set(base) - set(mine),
                                             key=str)]}),
            flush=True)
    if base_lib is not None:
        libs["baseline"] = base_lib
        variants["baseline"] = (sources["baseline"], both)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for heads, kv_heads, dh in args.layout or [(32, 8, 128)]:
        tile = args.tile or tuning.lookup(
            "flash_attention", (heads, 32768, dh), backend="cuda").block
        bound = {name: bind_any(lib, sources[name], tile)
                 for name, lib in libs.items()}

        def inputs(S):
            return (torch.randn(1, S, heads, dh, generator=gen, device=dev),
                    torch.randn(1, S, kv_heads, dh, generator=gen,
                                device=dev),
                    torch.randn(1, S, kv_heads, dh, generator=gen,
                                device=dev))

        def timed(name):
            return [tag for tag in variants[name][1] if tag in tags]

        q, k, v = inputs(4096)
        errs = {name: {} for name in bound}
        for tag in tags:
            qd, kd, vd = (x.to(DTYPES[tag]) for x in (q, k, v))
            ref = flash_attention.plain(qd, kd, vd, True).float()
            for name, (launch, _) in bound.items():
                if tag in timed(name):
                    out = launch(qd, kd, vd, True)
                    errs[name][f"max_abs_err_{tag}"] = float(
                        (out.float() - ref).abs().max())
                    if tag == "bf16":
                        share, excess = flash_attention.bf16_agreement(
                            out, ref, F32_TOL)
                        errs[name].update(bf16_differ_share=share,
                                          bf16_ulp_excess=excess)
            del ref
        q, k, v = inputs(32768)
        for name, (launch, tile_of) in bound.items():
            times = {}
            for tag in timed(name):
                qd, kd, vd = (x.to(DTYPES[tag]) for x in (q, k, v))
                times[f"{tag}_ms"] = cuda_ms(
                    lambda: launch(qd, kd, vd, True), 2)
                times[f"{tag}_tile"] = tile_of(DTYPES[tag], dh)
            if times:
                print(json.dumps({"variant": name,
                                  "layout": [heads, kv_heads, dh],
                                  **errs[name], **times}), flush=True)
        if base_lib is not None:
            # baseline, kernel, the variants of the dtype, then backwards:
            # each one's two turns
            turns = {}
            for tag in tags:
                order = ["baseline", "kernel", *(
                    n for n in bound if n not in ("baseline", "kernel")
                    and tag in timed(n) and variants[n][1] != both)]
                if tag == "bf16":
                    order[2:2] = [n for n in ("no_copies", "no_mma")
                                  if n in bound]
                qd, kd, vd = (x.to(DTYPES[tag]) for x in (q, k, v))
                got = {name: [] for name in order}
                for _ in range(args.turns):
                    for name in order + order[::-1]:
                        got[name].append(cuda_ms(functools.partial(
                            bound[name][0], qd, kd, vd, True), 2))
                for name, ms in got.items():
                    turns[f"{name}_{tag}_ms"] = ms
                    if args.turns > 1:
                        turns[f"{name}_{tag}_median_ms"] = \
                            statistics.median(ms)
                        turns[f"{name}_{tag}_iqr_ms"] = float(
                            numpy.subtract(*numpy.percentile(ms, [75, 25])))
            print(json.dumps({"variant": "baseline_turns",
                              "layout": [heads, kv_heads, dh],
                              "baseline": args.baseline, **turns}),
                  flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({"variant": "mma_sync_peak",
                      "tf32_tflops": mma_peak_tflops(peak_lib, dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
