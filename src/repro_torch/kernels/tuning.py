"""Kernel configurations and a roofline-seeded autotuner for the Hopper
kernels: the port of ``repro.kernels.tuning``.

* ``KernelConfig`` names one kernel's layout knobs (block sizes, traversal,
  input precision) as a hashable value; ``TuningSpec`` bundles one per
  kernel.
* ``candidate_configs`` lists the tiles a kernel's CUDA source compiles
  that are legal at a shape and fit the shared-memory budget of one CTA.
  The compiled tile menus take the place of the TPU's lane/sublane
  alignment: ``sketch_fused`` and ``blocked_fwht`` compile one tile each
  today, ``flash_attention`` four at a width on ``mma.sync`` and one at a
  width and dtype on ``wgmma``.
* ``roofline_cost`` / ``rank_candidates``: a static cost model in the terms
  of ``repro_torch.roofline.analysis`` (bytes at ``HBM_BW``; FLOP at
  ``PEAK_TF32_FLOPS`` times the split passes for ``sketch_fused`` and
  ``flash_attention``, which run on the tensor cores, at
  ``PEAK_BF16_FLOPS`` for ``sketch_fused``'s bf16 instance and
  ``flash_attention``'s bf16 ``wgmma`` ones, and at ``PEAK_F32_FLOPS`` for
  the others; stretched by the tail wave over 132 SMs), so the ranking is
  deterministic on any machine.
* ``autotune`` measures the best-ranked candidates on the card
  (``measure_config``, CUDA events) and records winners in a versioned JSON
  ``TuningTable`` (``kernels/tunings/<backend>.json``) keyed by
  ``(kernel, dtype, pow2 shape bucket)``. The format, the key and
  ``TABLE_VERSION`` are the JAX package's, so either package reads a table
  the other writes.
* ``lookup`` is the resolution every ``kernels.ops`` wrapper uses when no
  config is passed: a table hit for the shape bucket, else ``DEFAULTS``,
  which are the tiles the kernels ran with before the tuner existed.

The tuner never changes numerics beyond float reassociation: candidates
inherit the caller's precision. The kernel names are the JAX package's
(``sampled_dot`` for the wrapper ``sampled_rescaled_dot``).

>>> from repro_torch.kernels import tuning
>>> tuning.lookup("sketch_fused", (64, 1024, 256), backend="cpu").block
(128, 32)
>>> cands = tuning.candidate_configs("flash_attention", (8, 1024, 128))
>>> all(tuning.smem_bytes(c, (8, 1024, 128)) <= tuning.SMEM_BUDGET_BYTES
...     for c in cands)
True
>>> best = tuning.rank_candidates("sketch_fused", (64, 1024, 256))[0]
>>> best == tuning.rank_candidates("sketch_fused", (64, 1024, 256))[0]
True
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import hadamard as _hadamard
from repro_torch.kernels import sampled_dot as _sampled_dot
from repro_torch.kernels import sketch_fused as _sketch_fused
from repro_torch.roofline.analysis import (
    HBM_BW, PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_TF32_FLOPS, SMEM_PER_BLOCK,
    SMEM_PER_SM, SMEM_RESERVED, SMS, THREADS_PER_SM, kernel_time_lb)

#: Shared memory one CTA may use on an H100 (the 227 KB opt-in).
SMEM_BUDGET_BYTES = SMEM_PER_BLOCK

#: Kernel name -> canonical shape tuple:
#:   sketch_fused     (k, d, n)       Pi: (k, d), A: (d, n)
#:   blocked_fwht     (d, n)          X: (d, n), d the (padded) power of two
#:   sampled_dot      (n1, n2, k, m)  row sketches + m sampled pairs
#:   flash_attention  (BH, S, Dh)     batch x heads, sequence, head width
KERNELS = ("sketch_fused", "blocked_fwht", "sampled_dot", "flash_attention")

#: The one traversal each CUDA kernel has (None names it too): a
#: sketch_fused CTA loops over d inside, blocked_fwht numbers its CTAs
#: column tile fastest, a flash_attention CTA loops over the k-tiles.
GRID_ORDERS: Dict[str, Tuple[str, ...]] = {
    "sketch_fused": ("d_inner",),
    "blocked_fwht": ("n_inner",),
    "sampled_dot": (),
    "flash_attention": ("k_inner",),
}

#: The tiles each source compiles: ``block`` must be one of these.
#: flash_attention's are those of its ``mma.sync`` widths up to 128, then
#: those of its ``wgmma`` instances that are not among them; a width's own
#: menu is ``flash_attention.tiles(Dh, dtype_bytes)`` (at Dh 64, 96 and
#: 128: the ``wgmma`` instance's one tile for the dtype), and candidates
#: and lookups keep to it.
TILE_MENUS: Dict[str, Tuple[Tuple[int, ...], ...]] = {
    "sketch_fused": (_sketch_fused.TILE,),
    "blocked_fwht": (_hadamard.TILE,),
    "sampled_dot": ((),),
    "flash_attention": tuple(dict.fromkeys(
        [(bq, bk) for bq in _flash.BLOCK_Q for bk in _flash.BLOCK_K]
        + [(_flash.WGMMA_BQ, form.bk)
           for form in _flash.WGMMA_FORMS.values()])),
}


class KernelConfig(NamedTuple):
    """One kernel's layout knobs as a hashable value.

    ``block`` is ``(bn, bd)`` for ``sketch_fused`` (columns of A per CTA,
    rows of d per step), ``(b, bn)`` for ``blocked_fwht`` (largest radix of
    a pass, columns per CTA), ``()`` for ``sampled_dot`` and ``(bq, bk)``
    for ``flash_attention``. ``grid_order=None`` means the kernel's one
    traversal; ``precision`` is None|'f32'|'bf16' (inputs cast, sums
    float32).
    """

    kernel: str
    block: Tuple[int, ...] = ()
    grid_order: Optional[str] = None
    precision: Optional[str] = None

    def tag(self) -> str:
        """Stable short label for bench records and table entries."""
        parts = [f"b{'x'.join(str(b) for b in self.block)}" if self.block
                 else "scalar"]
        if self.grid_order:
            parts.append(self.grid_order)
        if self.precision:
            parts.append(self.precision)
        return "_".join(parts)


#: ``lookup``'s fallback: the tiles the kernels ran with before the tuner,
#: so default-config results are bit-identical to them. flash_attention's
#: (128, 32) is the fastest compiled tile of its tensor-core source for
#: granite-3-8b's attention at S = 32,768 on an H100 (PERF.md); a head
#: width that lacks it (Dh 256) takes its own first tile
#: (``default_config``).
DEFAULTS: Dict[str, KernelConfig] = {
    "sketch_fused": KernelConfig("sketch_fused", _sketch_fused.TILE),
    "blocked_fwht": KernelConfig("blocked_fwht", _hadamard.TILE),
    "sampled_dot": KernelConfig("sampled_dot", ()),
    "flash_attention": KernelConfig("flash_attention", (128, 32)),
}


def default_config(kernel: str, shape: Tuple[int, ...],
                   dtype_bytes: int = 4) -> KernelConfig:
    """``DEFAULTS[kernel]``, except for a flash_attention head width whose
    menu for inputs of ``dtype_bytes`` lacks that tile: the width's first
    compiled tile. A width no instance runs (Dh > 256) keeps ``DEFAULTS``,
    which the card then refuses before a launch."""
    cfg = DEFAULTS[kernel]
    if kernel == "flash_attention":
        menu = _flash.tiles(shape[2], dtype_bytes)
        if menu and cfg.block not in menu:
            cfg = cfg._replace(block=menu[0])
    return cfg


class TuningSpec(NamedTuple):
    """A hashable bundle of per-kernel configs: at most one per kernel;
    ``config_for`` returns it, or None (resolve through the table).

    >>> from repro_torch.kernels.tuning import KernelConfig, TuningSpec
    >>> ts = TuningSpec((KernelConfig("sketch_fused", (128, 32)),))
    >>> ts.config_for("sketch_fused").block
    (128, 32)
    >>> ts.config_for("blocked_fwht") is None
    True
    """

    configs: Tuple[KernelConfig, ...] = ()

    def config_for(self, kernel: str) -> Optional[KernelConfig]:
        """The pinned config for ``kernel``, or None."""
        for cfg in self.configs:
            if cfg.kernel == kernel:
                return cfg
        return None

    def validate(self) -> None:
        """Validate every pinned config (ValueError)."""
        seen = set()
        for cfg in self.configs:
            validate_config(cfg)
            if cfg.kernel in seen:
                raise ValueError(
                    f"TuningSpec pins kernel {cfg.kernel!r} more than once")
            seen.add(cfg.kernel)


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def validate_config(cfg: KernelConfig) -> None:
    """Reject configs no kernel can run with a ValueError naming the field:
    an unknown kernel, a block the kernel's source does not compile, a
    traversal it does not have, an unknown precision. Whether a tile suits
    a shape (divisibility, shared memory) is the tuner's and the wrapper's
    business."""
    if not isinstance(cfg, KernelConfig):
        raise TypeError(f"expected a KernelConfig, got {type(cfg).__name__}")
    if cfg.kernel not in KERNELS:
        raise ValueError(f"unknown kernel {cfg.kernel!r} (use one of "
                         f"{KERNELS})")
    arity = len(TILE_MENUS[cfg.kernel][0])
    if len(cfg.block) != arity:
        raise ValueError(
            f"{cfg.kernel} takes {arity} block sizes, got {cfg.block!r}")
    if any((not isinstance(b, int)) or b <= 0 for b in cfg.block):
        raise ValueError(f"block sizes must be positive ints, got "
                         f"{cfg.block!r}")
    if tuple(cfg.block) not in TILE_MENUS[cfg.kernel]:
        raise ValueError(
            f"{cfg.kernel}: block {tuple(cfg.block)} is not compiled "
            f"(compiled: {TILE_MENUS[cfg.kernel]})")
    if cfg.grid_order is not None and \
            cfg.grid_order not in GRID_ORDERS[cfg.kernel]:
        raise ValueError(
            f"illegal grid_order {cfg.grid_order!r} for {cfg.kernel} "
            f"(legal: {GRID_ORDERS[cfg.kernel] or 'none'})")
    if cfg.precision not in (None, "f32", "bf16"):
        raise ValueError(f"unknown precision {cfg.precision!r} "
                         f"(use None|'f32'|'bf16')")


def _itemsize(precision: Optional[str], dtype_bytes: int = 4) -> int:
    if precision == "bf16":
        return 2
    if precision == "f32":
        return 4
    return dtype_bytes


def _fwht_radix(d: int, b: int) -> Tuple[int, int]:
    """(passes, radix of the first pass) of blocked_fwht.cu's split of a
    length-d transform into passes of radix at most b."""
    log_d, log_b = max(int(d) - 1, 0).bit_length(), int(b).bit_length() - 1
    passes = max(1, -(-log_d // log_b))
    return passes, 1 << -(-log_d // passes)


def _flash_tile(cfg: KernelConfig, S: int) -> Tuple[int, int]:
    return tuple(min(b, S) for b in cfg.block)


def smem_bytes(cfg: KernelConfig, shape: Tuple[int, ...], *,
               dtype_bytes: int = 4) -> int:
    """Shared memory of one CTA of the kernel at ``shape`` (bytes), as the
    kernel's source lays it out for inputs of ``dtype_bytes`` (or of the
    config's precision)."""
    validate_config(cfg)
    if cfg.kernel == "sketch_fused":
        return _sketch_fused.smem_bytes(_itemsize(cfg.precision, dtype_bytes))
    if cfg.kernel == "blocked_fwht":
        d, n = shape
        _, radix = _fwht_radix(d, cfg.block[0])
        return 4 * radix * cfg.block[1]
    if cfg.kernel == "sampled_dot":
        return 0
    BH, S, Dh = shape
    return _flash.smem_bytes(*_flash_tile(cfg, S), Dh,
                             _itemsize(cfg.precision, dtype_bytes))


def _threads(cfg: KernelConfig, shape: Tuple[int, ...],
             dtype_bytes: int = 4) -> int:
    if cfg.kernel == "sketch_fused":
        return _sketch_fused.threads(_itemsize(cfg.precision, dtype_bytes))
    if cfg.kernel == "blocked_fwht":
        _, radix = _fwht_radix(shape[0], cfg.block[0])
        log_l = radix.bit_length() - 1
        return (radix >> ((log_l + 1) // 2)) * 32   # warps = L / R
    if cfg.kernel == "sampled_dot":
        return _sampled_dot.GATHER_THREADS
    return _flash.threads(_flash_tile(cfg, shape[1])[0], shape[2],
                          _itemsize(cfg.precision, dtype_bytes))


@dataclasses.dataclass(frozen=True)
class RooflineCost:
    """Static cost terms for one kernel call at one shape and config."""

    hbm_bytes: float          # device-memory traffic per call
    flops: float              # FLOP per call, as the kernel issues them
    ctas: int                 # CTAs per launch
    slots: int                # CTAs resident on the card at once
    t_memory: float           # hbm_bytes / HBM_BW
    t_compute: float          # flops at the kernel's peak rate
    t_total: float            # max(mem, compute) stretched by the tail wave

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_cost(cfg: KernelConfig, shape: Tuple[int, ...], *,
                  dtype_bytes: int = 4,
                  srht: Optional[Tuple[int, int]] = None) -> RooflineCost:
    """The static model the ranking runs on: the bytes and FLOP of the
    kernel as its source does the work: the tensor-core passes of
    ``sketch_fused`` (three for float32 inputs at the TF32 rate, one for
    bf16 at the bf16 rate) and of ``flash_attention`` (its ``PASSES`` by
    design: three TF32 passes a product for float32; for bf16 one on QK^T
    and two on PV at the bf16 rate on ``wgmma``, two TF32 passes a product
    on ``mma.sync``), the
    other kernels' float32 arithmetic at the FMA rate, whatever they read.
    CTAs resident per SM count threads and shared memory, and registers
    where a kernel's launch bounds let it take up to 255 a thread
    (``sketch_fused``: one CTA; ``flash_attention``: its ptxas counts).
    ``flash_attention`` is modelled causal, as ``measure_config`` runs it:
    a q-tile works through the k-tiles up to its diagonal.
    ``srht=(rows, k)`` prices ``blocked_fwht``'s SRHT block mode instead
    of its full mode: X (rows, n) padded to the shape's d, k sampled rows,
    in the form ``hadamard.block_plan`` picks. The cluster form reads X
    once and writes the k rows and n norms (its intermediate stays on
    chip, one CTA an SM); the two-pass form also writes its intermediate
    and reads it back.
    """
    validate_config(cfg)
    ds = _itemsize(cfg.precision, dtype_bytes)
    plan = None
    if cfg.kernel == "sketch_fused":
        k, d, n = shape
        bn = cfg.block[0]
        n_tiles, k_tiles = -(-n // bn), -(-k // _sketch_fused.BM)
        # A streamed once; Pi re-read per column tile; sketch + norms out
        hbm = d * n * ds + n_tiles * k * d * ds + 4 * (k + 1) * n
        flops = _sketch_fused.PASSES[ds] * 2.0 * k * d * n
        ctas = n_tiles * k_tiles
    elif cfg.kernel == "blocked_fwht":
        d, n = shape
        passes, radix = _fwht_radix(d, cfg.block[0])
        flops = float(d) * max(d - 1, 0).bit_length() * n
        ctas = (d // radix) * -(-n // cfg.block[1])
        if srht is None:
            # the full mode, which the tuner measures: pass 1 reads X and
            # writes float32; later passes read and write it
            hbm = d * n * ds + 4 * d * n + 8 * d * n * (passes - 1) + 4 * d
        else:
            rows, k = srht
            plan = _hadamard.block_plan(
                rows, d, torch.bfloat16 if ds == 2 else torch.float32, k)
            # X and the signs read, the k rows and n norms written
            hbm = rows * n * ds + 4 * rows + 4 * (k + 1) * n
            if plan.form == "cluster":
                ctas = plan.ctas * -(-n // plan.cols)
            else:
                hbm += 8 * rows * n * (passes - 1)
    elif cfg.kernel == "sampled_dot":
        n1, n2, k, m = shape
        cblock = _sampled_dot.column_block(k, ds, n2)
        nb = _sampled_dot.buckets(n1, n2, cblock)
        rows_a = min(m, nb)        # an A row at most once per bucket
        passes = -(-max(nb - 1, 0).bit_length() // 8)
        # the sort into bucket order: the indices read and (key, t, col)
        # written, then per 8-bit pass the keys read for the histogram and
        # keys and values read and written; the gather: them read once, Bs
        # once from memory (a column block stays in L2 while its buckets
        # are worked; the per-sample L2 reads are not modelled), the A rows,
        # the norms, one float32 out per sample
        hbm = (20 * m + 28 * m * passes + 12 * m
               + (n2 + rows_a) * k * ds + 4 * (n1 + n2) + 4 * m)
        # the dot product per sample; each row's squared norm once
        flops = 2.0 * m * k + 2.0 * (n1 + n2) * k
        ctas = -(-m // _sampled_dot.SAMPLES_PER_CTA)
    else:                                   # flash_attention
        BH, S, Dh = shape
        bq, bk = _flash_tile(cfg, S)
        tiles = sum(((qt + 1) * bq - 1) // bk + 1 for qt in range(S // bq))
        # q in and o out once; K and V tiles per q-tile up to the diagonal;
        # all at the compiled width (ops.flash_attention zero-pads to it)
        width = _flash.tile_width(Dh) if Dh <= _flash.MAX_HEAD_DIM else Dh
        hbm = 2 * BH * S * width * ds + 2 * BH * tiles * bk * width * ds
        if _flash.on_wgmma(Dh, ds) and ds == 4:
            # the float32 instance's prologue: V read, V^T written
            hbm += 2 * BH * S * width * ds
        qk, pv, kind = _flash.PASSES[_flash.design(Dh, ds), ds]
        flops = (qk + pv) * 2.0 * BH * tiles * bq * bk * width
        ctas = BH * (S // bq)
    peak = (PEAK_BF16_FLOPS if cfg.kernel == "sketch_fused" and ds == 2
            or cfg.kernel == "flash_attention" and kind == "bf16"
            else PEAK_TF32_FLOPS
            if cfg.kernel in ("sketch_fused", "flash_attention")
            else PEAK_F32_FLOPS)
    per_sm = min(THREADS_PER_SM // _threads(cfg, shape, dtype_bytes),
                 SMEM_PER_SM // (smem_bytes(cfg, shape, dtype_bytes=dtype_bytes)
                                 + SMEM_RESERVED))
    if plan is not None and plan.form == "cluster":
        per_sm = min(THREADS_PER_SM // _hadamard.CLUSTER_THREADS,
                     SMEM_PER_SM // (plan.smem + SMEM_RESERVED))
    if cfg.kernel == "sketch_fused":
        per_sm = min(per_sm, _sketch_fused.CTAS_PER_SM)
    elif cfg.kernel == "flash_attention":
        per_sm = min(per_sm, _flash.ctas_per_sm(
            _flash_tile(cfg, shape[1])[0], shape[2], ds))
    slots = SMS * max(per_sm, 1)
    t_mem = hbm / HBM_BW
    t_comp = flops / peak
    t_total = kernel_time_lb(flops, hbm, peak_flops=peak, ctas=ctas,
                             slots=slots)
    return RooflineCost(hbm_bytes=float(hbm), flops=float(flops),
                        ctas=int(ctas), slots=int(slots), t_memory=t_mem,
                        t_compute=t_comp, t_total=t_total)


def candidate_configs(kernel: str, shape: Tuple[int, ...], *,
                      precision: Optional[str] = None,
                      smem_budget: int = SMEM_BUDGET_BYTES
                      ) -> List[KernelConfig]:
    """The compiled tiles legal for ``kernel`` at ``shape`` that fit the
    shared-memory budget; for flash_attention those of the head width's own
    menu (``flash_attention.tiles``) for the inputs ``measure_config``
    gives the kernel: float32, or bf16 under ``precision='bf16'``.
    ``precision`` is inherited, never swept. Never empty: when no tile is
    legal the default is kept (``default_config``), and when none fits the
    budget the smallest footprint is."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (use one of {KERNELS})")
    cands = []
    for block in TILE_MENUS[kernel]:
        if kernel == "flash_attention":
            BH, S, Dh = shape
            if any(b > S or S % b for b in block) or \
                    block not in _flash.tiles(Dh, _itemsize(precision)):
                continue
        cands.append(KernelConfig(kernel, block, None, precision))
    if not cands:
        return [default_config(kernel, shape, _itemsize(precision))
                ._replace(precision=precision)]
    fitting = [c for c in cands if smem_bytes(c, shape) <= smem_budget]
    if not fitting:
        fitting = [min(cands, key=lambda c: (smem_bytes(c, shape), c.block))]
    return fitting


def rank_candidates(kernel: str, shape: Tuple[int, ...], *,
                    precision: Optional[str] = None, dtype_bytes: int = 4,
                    smem_budget: int = SMEM_BUDGET_BYTES
                    ) -> List[KernelConfig]:
    """Candidates sorted best-first by the static roofline cost; ties break
    on the config tuple itself, so every run agrees on the order."""
    cands = candidate_configs(kernel, shape, precision=precision,
                              smem_budget=smem_budget)
    return sorted(cands, key=lambda c: (
        roofline_cost(c, shape, dtype_bytes=dtype_bytes).t_total,
        c.block, c.grid_order or "", c.precision or ""))


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def measure_config(cfg: KernelConfig, shape: Tuple[int, ...], *,
                   reps: int = 3, device="cuda") -> float:
    """Time one call of the kernel's ``ops`` wrapper under ``cfg`` at
    ``shape`` (microseconds per call, the mean of ``reps`` calls after one
    warm-up), on float32 inputs drawn from a ``torch.Generator`` seeded 0.
    On the card the time is the CUDA events' (device time); with
    ``device="cpu"`` it is the host clock's around the plain version, which
    says nothing about the card."""
    import time

    from repro_torch.device import resolve
    from repro_torch.kernels import ops

    validate_config(cfg)
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    if cfg.kernel == "sketch_fused":
        k, d, n = shape
        Pi, A = randn(k, d), randn(d, n)
        fn = lambda: ops.sketch_fused(Pi, A, config=cfg)
    elif cfg.kernel == "blocked_fwht":
        d, n = shape
        X = randn(d, n)
        signs = torch.randint(0, 2, (d,), generator=gen, device=dev) * 2.0 - 1
        fn = lambda: ops.blocked_fwht(X, signs, config=cfg)
    elif cfg.kernel == "sampled_dot":
        n1, n2, k, m = shape
        As, Bs = randn(n1, k), randn(n2, k)
        na = torch.ones(n1, device=dev)
        nb = torch.ones(n2, device=dev)
        rows = torch.randint(0, n1, (m,), generator=gen, device=dev,
                             dtype=torch.int32)
        cols = torch.randint(0, n2, (m,), generator=gen, device=dev,
                             dtype=torch.int32)
        fn = lambda: ops.sampled_rescaled_dot(As, Bs, na, nb, rows, cols,
                                              config=cfg)
    else:                                   # flash_attention
        BH, S, Dh = shape
        qkv = randn(3, BH, S, 1, Dh)
        fn = lambda: ops.flash_attention(qkv[0], qkv[1], qkv[2], config=cfg)
    fn()                                    # build, load, warm
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def autotune(kernel: str, shape: Tuple[int, ...], *,
             precision: Optional[str] = None, dtype_bytes: int = 4,
             measure_top: int = 0, reps: int = 3,
             table: Optional["TuningTable"] = None, device="cuda"
             ) -> Tuple[KernelConfig, List[dict]]:
    """Pick the best config for ``kernel`` at ``shape``.

    ``measure_top=0`` (static) returns the roofline ranking's head;
    ``measure_top=N`` times the N best-ranked candidates on ``device``, and
    the default tile where it is a candidate, and picks the fastest: the
    static model cannot order the flash tiles, whose FLOP and bytes differ
    by 1% while their times differ by 36% (PERF.md). With ``table`` the winner is recorded under the
    shape bucket. Returns ``(winner, records)``; each record carries the
    config tag, the model's cost terms and, when measured, ``us_per_call``
    and ``achieved_gbps``.
    """
    ranked = rank_candidates(kernel, shape, precision=precision,
                             dtype_bytes=dtype_bytes)
    chosen = ranked[:max(measure_top, 1)]
    default = default_config(kernel, shape, _itemsize(precision))._replace(
        precision=precision)
    if measure_top > 0 and default in ranked and default not in chosen:
        chosen.append(default)      # a measured winner never loses to it
    records = []
    for cfg in chosen:
        cost = roofline_cost(cfg, shape, dtype_bytes=dtype_bytes)
        rec = {"config": cfg.tag(), "block": list(cfg.block),
               "grid_order": cfg.grid_order, "precision": cfg.precision,
               **cost.as_dict()}
        if measure_top > 0:
            us = measure_config(cfg, shape, reps=reps, device=device)
            rec["us_per_call"] = us
            rec["achieved_gbps"] = cost.hbm_bytes / (us * 1e-6) / 1e9
        records.append((cfg, rec))
    if measure_top > 0:
        winner = min(records, key=lambda cr: cr[1]["us_per_call"])[0]
    else:
        winner = ranked[0]
    if table is not None:
        winning = next(r for c, r in records if c == winner)
        table.put(kernel, shape, winner, dtype_bytes=dtype_bytes,
                  stats={k: winning[k] for k in
                         ("us_per_call", "achieved_gbps") if k in winning})
    return winner, [r for _, r in records]


# ---------------------------------------------------------------------------
# The versioned tuning table (the JAX package's format)
# ---------------------------------------------------------------------------

TABLE_VERSION = 1

_DTYPE_TAGS = {2: "bf16", 4: "f32"}


def table_key(kernel: str, shape: Tuple[int, ...],
              dtype_bytes: int = 4) -> str:
    """``kernel|dtype|pow2-bucketed-shape``, the table's lookup key."""
    bucket = "x".join(str(_next_pow2(s)) for s in shape)
    return f"{kernel}|{_DTYPE_TAGS.get(dtype_bytes, dtype_bytes)}|{bucket}"


@dataclasses.dataclass
class TuningTable:
    """Persisted winners: ``{table_key: config dict}`` + provenance.

    >>> from repro_torch.kernels.tuning import KernelConfig, TuningTable
    >>> t = TuningTable(backend="cpu")
    >>> t.put("sketch_fused", (64, 1000, 300),
    ...       KernelConfig("sketch_fused", (128, 32)))
    >>> t.get("sketch_fused", (64, 1024, 512)).block    # same pow2 bucket
    (128, 32)
    >>> t.get("sketch_fused", (64, 4096, 512)) is None  # unknown bucket
    True
    """

    backend: str = "any"
    version: int = TABLE_VERSION
    entries: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def put(self, kernel: str, shape: Tuple[int, ...], cfg: KernelConfig,
            *, dtype_bytes: int = 4, stats: Optional[dict] = None) -> None:
        """Record ``cfg`` as the winner for the shape's bucket."""
        validate_config(cfg)
        entry = {"block": list(cfg.block), "grid_order": cfg.grid_order,
                 "precision": cfg.precision}
        if stats:
            entry["stats"] = dict(stats)
        self.entries[table_key(kernel, shape, dtype_bytes)] = entry

    def get(self, kernel: str, shape: Tuple[int, ...],
            dtype_bytes: int = 4) -> Optional[KernelConfig]:
        """The recorded winner for the shape's bucket, or None."""
        entry = self.entries.get(table_key(kernel, shape, dtype_bytes))
        if entry is None:
            return None
        return KernelConfig(kernel, tuple(entry["block"]),
                            entry.get("grid_order"), entry.get("precision"))

    def save(self, path: str) -> None:
        """Write the versioned JSON table."""
        payload = {"version": self.version, "backend": self.backend,
                   "entries": self.entries}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        """Read a table; any version but ``TABLE_VERSION`` is an error."""
        with open(path) as f:
            payload = json.load(f)
        version = payload.get("version")
        if version != TABLE_VERSION:
            raise ValueError(
                f"{path}: tuning-table version {version!r} not supported "
                f"(this build reads version {TABLE_VERSION})")
        return cls(backend=payload.get("backend", "any"),
                   version=version, entries=dict(payload.get("entries", {})))


_TUNINGS_DIR = os.path.join(os.path.dirname(__file__), "tunings")
_TABLE_CACHE: Dict[str, TuningTable] = {}
_BACKENDS: Dict[torch.device, str] = {}


def backend_of(device) -> str:
    """The table name for a device: ``cpu``, or the card's model in lower
    case (``h100`` for an NVIDIA H100), else its whole name as a slug."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    if dev not in _BACKENDS:
        name = torch.cuda.get_device_name(dev).lower()
        model = re.search(r"\b[a-z]\d{2,3}[a-z]?\b", name)
        _BACKENDS[dev] = (model.group(0) if model
                          else re.sub(r"[^a-z0-9]+", "_", name).strip("_"))
    return _BACKENDS[dev]


def table_path(backend: str) -> str:
    """Where the committed table for a backend lives."""
    return os.path.join(_TUNINGS_DIR, f"{backend}.json")


def builtin_table(backend: Optional[str] = None) -> TuningTable:
    """The committed table for ``backend`` (default: the card's, else the
    CPU's), cached per process; an absent file is an empty table. Call
    ``reload_tables()`` after editing a table on disk."""
    if backend is None:
        backend = backend_of("cuda" if torch.cuda.is_available() else "cpu")
    if backend not in _TABLE_CACHE:
        path = table_path(backend)
        _TABLE_CACHE[backend] = (TuningTable.load(path)
                                 if os.path.exists(path)
                                 else TuningTable(backend=backend))
    return _TABLE_CACHE[backend]


def reload_tables() -> None:
    """Drop the per-process table cache (the next lookup re-reads disk)."""
    _TABLE_CACHE.clear()


def lookup(kernel: str, shape: Tuple[int, ...], *, dtype_bytes: int = 4,
           backend: Optional[str] = None) -> KernelConfig:
    """The ops-wrapper resolution: the table's hit for the shape bucket,
    else ``default_config``. Never returns None. A flash_attention bucket
    holds one compiled width's heads (its pow2 bucket of Dh: 65 to 128 or
    129 to 256), so the tuner's winner for it is on that width's menu; a
    table edited by hand to name another tile is refused before a
    launch."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (use one of {KERNELS})")
    hit = builtin_table(backend).get(kernel, shape, dtype_bytes)
    return hit if hit is not None else default_config(kernel, shape,
                                                      dtype_bytes)


def dtype_bytes_of(x) -> int:
    """A tensor's, array's or dtype's itemsize at the table's granularity
    (2 or 4)."""
    if isinstance(x, torch.dtype):
        size = x.itemsize
    elif isinstance(x, torch.Tensor):
        size = x.element_size()
    else:
        import numpy as np
        size = np.dtype(getattr(x, "dtype", x)).itemsize
    return 2 if size == 2 else 4


def retune(shapes: Dict[str, List[Tuple[int, ...]]], *, backend: str,
           measure_top: int = 4, reps: int = 3,
           out_path: Optional[str] = None, device="cuda") -> TuningTable:
    """Measure and persist winners for ``{kernel: [shapes...]}`` on
    ``device``; writes ``out_path`` or the committed location of
    ``backend``'s table and returns the table."""
    table = TuningTable(backend=backend)
    for kernel, shape_list in shapes.items():
        for shape in shape_list:
            autotune(kernel, shape, measure_top=measure_top, reps=reps,
                     table=table, device=device)
    table.save(out_path or table_path(backend))
    return table


def achieved_gbps(cfg: KernelConfig, shape: Tuple[int, ...],
                  us_per_call: float, *, dtype_bytes: int = 4) -> float:
    """Modelled bytes over measured time (GB/s)."""
    cost = roofline_cost(cfg, shape, dtype_bytes=dtype_bytes)
    return cost.hbm_bytes / (us_per_call * 1e-6) / 1e9
