"""SummaryEngine: the paper's step-1 single pass, ``build_summary``.

``build_summary(key, A, B, k, method=..., backend=...)`` returns the
``SketchSummary`` (sketches and exact column norms) that sampling, estimation
and completion consume. Five backends (``backends()``; ``register_backend``
adds more), one randomness contract:

    reference    materialized projection operator, one dense product per
                 matrix (the oracle the other backends are tested against)
    scan         ``block`` rows at a time; each block regenerates its slice
                 of the projection, so the (k, d) operator never exists (the
                 paper's streaming pass); a block is one
                 ``chunk_contribution``, the body ``core/streaming.py``
                 shares, and on the card two ``sketch_fused`` launches
    rows         arbitrary-order row streaming (``rows_summary``) over rows
                 0..d-1; the reference's exact contraction, bit for bit
    cuda         the hand-written kernels, counterpart of the JAX package's
                 ``pallas`` backend: the fused sketch-and-norms kernel
                 (kernels/sketch_fused) for gaussian, the blocked FWHT
                 (kernels/hadamard) for srht; on CPU tensors they run their
                 plain versions
    distributed  rows sharded over the ranks of a ``torch.distributed``
                 group, each rank's shard one ``chunk_contribution``, then
                 all-reduces (``core/distributed.py``; needs ``group=``)

The contract is that of ``repro.core.summary_engine``:

* ``method='gaussian'``: the projection column of global row ``i`` is
  ``normal(fold_in(key, i), (k,)) / sqrt(k)``;
* ``method='srht'``: signs and sampled Hadamard rows come once from ``key``
  (``srht_plan``); the projection column of row ``i`` is ``signs[i] *
  H[rows, i] / sqrt(k)`` with ``H[r, i] = (-1)^popcount(r & i)``, which is
  what lets SRHT stream row by row.

Precision: ``precision='bf16'`` casts the inputs to bfloat16 while every
sum stays float32; sketches and norms are float32.

Two structured products are summarized here too, for the training side:
``identity_product_summary`` (A = I stacked over workers, the gradient
compressor's mapping) and ``tap_pair_summary`` (the gradient tap's
(X, dY) pair).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch import prng
from repro_torch.core.linalg import sqrt_f32
from repro_torch.core.sketch import (
    _next_pow2, _sqrt_f32, column_norms, gaussian_pi, pi_rows)
from repro_torch.core.types import SketchSummary, tree_stack

METHODS = ("gaussian", "srht")
# The backends that summarize in one process; ``backends()`` lists every
# registered one, 'distributed' included.
BACKENDS = ("reference", "scan", "rows", "cuda")

# Columns per blocked_fwht call in the cuda backend's SRHT pass. The
# transform acts on each column alone, so the pass never holds a padded or
# transformed (dp, n) copy of A or B. On the card the kernel's block mode
# keeps a block's intermediate in shared memory where dp takes two passes
# (its cluster form: no scratch); at other shapes (its two-pass form) it
# holds one block's (dp, SRHT_COLUMN_BLOCK) float32 intermediate and float64
# norm partials in device memory.
SRHT_COLUMN_BLOCK = 8192


def _cast(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """None keeps the input dtype; 'f32' and 'bf16' cast."""
    if precision is None:
        return x
    if precision == "f32":
        return x.float()
    if precision == "bf16":
        return x.to(torch.bfloat16)
    raise ValueError(f"unknown precision {precision!r} (use None|'f32'|'bf16')")


def srht_plan(key: torch.Tensor, d: int, k: int):
    """(signs (d,) float32, sampled Hadamard rows (k,) int32, dp): the SRHT
    randomness, drawn as ``core.sketch.srht_sketch`` and
    ``kernels.ops.srht_sketch_kernel`` draw it, so all backends share it."""
    dp = _next_pow2(d)
    if k > dp:
        raise ValueError(
            f"srht needs k <= next_pow2(d): k={k} exceeds the padded "
            f"dimension dp={dp} (d={d}) — no-replacement row sampling "
            f"cannot draw k rows from dp")
    key_sign, key_rows = prng.split(key)
    signs = prng.rademacher(key_sign, (d,), dtype=torch.float32)
    rows = prng.choice(key_rows, dp, (k,))
    return signs, rows, dp


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 entry below 2**32 (SWAR: pairs, nibbles,
    bytes, then one multiply sums the four bytes)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hadamard_cols(sampled_rows: torch.Tensor,
                  row_idx: torch.Tensor) -> torch.Tensor:
    """``H[sampled_rows][:, row_idx]`` (k, t) float32 for the Sylvester
    Hadamard matrix, pointwise: ``H[r, i] = (-1)^popcount(r & i)``."""
    r = sampled_rows.to(torch.int64)[:, None]
    i = row_idx.to(torch.int64)[None, :]
    bit = _popcount((r & i) & 0xFFFFFFFF) & 1
    return (1 - 2 * bit).to(torch.float32)


def srht_rows_from_plan(signs_rows: torch.Tensor, sampled_rows: torch.Tensor,
                        row_idx: torch.Tensor, k: int) -> torch.Tensor:
    """(t, k) SRHT projection columns of global rows ``row_idx``, given
    their signs ``signs_rows`` (t,) and the plan's sampled rows. The one
    place the streamed-SRHT formula lives: reference, scan and rows all call
    it."""
    Hc = hadamard_cols(sampled_rows, row_idx)                   # (k, t)
    return (Hc * signs_rows[None, :]).T / _sqrt_f32(k).to(Hc.device)


def projection_rows(key: torch.Tensor, row_idx: torch.Tensor, k: int, *,
                    method: str = "gaussian", d_total: Optional[int] = None,
                    plan=None) -> torch.Tensor:
    """Columns of the (k, d) sketch operator for the given global row ids:
    (t, k) with ``[t, :] = Pi[:, row_idx[t]]``.

    For srht pass ``d_total`` (the streamed dimension; the plan is drawn
    from ``key``) or ``plan = srht_plan(key, d_total, k)[:2]``, which a
    caller summarizing many chunks draws once. Rows past the signs (pad
    rows, whose data are zero) take the last sign."""
    if method == "gaussian":
        return pi_rows(key, row_idx, k)
    if method == "srht":
        if plan is not None:
            signs, rows = plan[0], plan[1]
        elif d_total is not None:
            signs, rows, _ = srht_plan(key, d_total, k)
        else:
            raise ValueError("method='srht' needs d_total or plan=")
        s = signs[torch.clamp(row_idx.long(), 0, signs.shape[0] - 1)]
        return srht_rows_from_plan(s, rows, row_idx, k)
    raise ValueError(f"unknown sketch method {method!r} (use {METHODS})")


def _sketch_dot(P: torch.Tensor, X: torch.Tensor,
                precision: Optional[str]) -> torch.Tensor:
    """(t, k)^T @ (t, n), accumulated in float32 whatever the input dtype.

    The projection is rounded to X's (possibly reduced) dtype, never the
    data up. bf16 products are exact in float32, so computing in float32
    from the rounded values is bf16-in, f32-accumulate."""
    Xc = _cast(X, precision)
    Pc = _cast(P, precision).to(Xc.dtype)
    return Pc.float().T @ Xc.float()


def _reference_backend(key, A, B, k: int, *, method: str, block: int,
                       precision: Optional[str],
                       configs=None) -> SketchSummary:
    """Materialized projection operator + one dense product per matrix."""
    del block, configs
    d = A.shape[0]
    P = projection_rows(key, torch.arange(d, device=key.device), k,
                        method=method, d_total=d)
    Ac, Bc = _cast(A, precision), _cast(B, precision)
    return SketchSummary(
        _sketch_dot(P, Ac, precision), _sketch_dot(P, Bc, precision),
        column_norms(Ac), column_norms(Bc))


def rows_summary(key: torch.Tensor, row_idx: torch.Tensor,
                 A_rows: torch.Tensor, B_rows: torch.Tensor, k: int, *,
                 method: str = "gaussian", d_total: Optional[int] = None,
                 plan=None, precision: Optional[str] = None) -> SketchSummary:
    """Rows arriving as (index, A row, B row) triples, in any order: the
    summary is a sum over rows, so the order does not change it. Partial
    streams combine with ``core.sketch.merge_summaries``. For srht pass
    ``d_total`` or a ``plan`` (see ``projection_rows``). Runs on the rows'
    device."""
    dev = A_rows.device
    P = projection_rows(key.to(dev), row_idx.to(dev), k, method=method,
                        d_total=d_total, plan=plan)
    Ac, Bc = _cast(A_rows, precision), _cast(B_rows, precision)
    return SketchSummary(
        _sketch_dot(P, Ac, precision), _sketch_dot(P, Bc, precision),
        column_norms(Ac), column_norms(Bc))


def _rows_backend(key, A, B, k: int, *, method: str, block: int,
                  precision: Optional[str], configs=None) -> SketchSummary:
    """Row-stream semantics over the whole pair (rows 0..d-1)."""
    del block, configs
    d = A.shape[0]
    return rows_summary(key, torch.arange(d, device=A.device), A, B, k,
                        method=method, d_total=d, precision=precision)


def _pad_rows(X: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.nn.functional.pad(X, (0, 0, 0, rows - X.shape[0]))


def chunk_contribution(key: torch.Tensor, plan, A_chunk: torch.Tensor,
                       B_chunk: torch.Tensor, gids: torch.Tensor, *, k: int,
                       method: str, precision: Optional[str], configs=None):
    """(dA, dB, dna2, dnb2) of one chunk of rows with global ids ``gids``:
    ``P^T A_chunk`` (k, n1), ``P^T B_chunk`` (k, n2) and the chunk's squared
    column norms, all float32, with ``P = projection_rows(key, gids, k)``
    and ``plan`` the SRHT ``(signs, sampled rows)`` (None for gaussian).

    The one body of the scan backend and of the stream
    (``core/streaming.py``), so that a stream ingested in chunks of c rows
    adds the scan backend's terms at ``block=c`` with the same float ops.
    On CPU tensors these are plain products; on CUDA tensors one
    ``ops.sketch_fused`` launch per matrix, whose squared norms are used as
    the kernel summed them, with the launch configs ``configs`` (a
    ``SketchConfigs``; None resolves them per launch)."""
    P = projection_rows(key, gids, k, method=method, plan=plan)   # (t, k)
    cfg_A, cfg_B = (None, None) if configs is None else \
        (configs.A[0], configs.B[0])
    dA, dna2 = _sketch_and_norms(P, A_chunk, precision, cfg_A)
    dB, dnb2 = _sketch_and_norms(P, B_chunk, precision, cfg_B)
    return dA, dB, dna2, dnb2


def _sketch_and_norms(P: torch.Tensor, X: torch.Tensor,
                      precision: Optional[str], config=None):
    """(P^T X (k, n), X's squared column norms (n,)) for P (t, k) and X
    (t, n), float32: plain products on CPU tensors, one
    ``ops.sketch_fused`` launch (``squared=True``, launch config
    ``config``) on CUDA tensors, whose squared norms are used as the
    kernel summed them."""
    Xc = _cast(X, precision)
    if Xc.device.type == "cpu":
        return _sketch_dot(P, Xc, precision), torch.sum(Xc.float() ** 2, dim=0)
    from repro_torch.kernels import ops
    return ops.sketch_fused(_cast(P, precision).to(Xc.dtype).T, Xc,
                            squared=True, config=config)


def _scan_backend(key, A, B, k: int, *, method: str, block: int,
                  precision: Optional[str], configs=None) -> SketchSummary:
    """One pass over ``block``-row blocks; each block regenerates its slice
    of the projection from (key, global row ids), so the (k, d) operator
    never exists. The last block is padded with zero rows, whose signs are
    1.0, as in the JAX package's scan. Each block is one
    ``chunk_contribution`` (on the card, two ``sketch_fused`` launches)."""
    d, n1 = A.shape
    n2 = B.shape[1]
    dev = A.device
    nblk = max(1, math.ceil(d / block))
    plan = None
    if method == "srht":
        signs, srows, _ = srht_plan(key, d, k)
        plan = (torch.nn.functional.pad(signs, (0, nblk * block - d),
                                        value=1.0), srows)
    As = torch.zeros((k, n1), dtype=torch.float32, device=dev)
    Bs = torch.zeros((k, n2), dtype=torch.float32, device=dev)
    na2 = torch.zeros((n1,), dtype=torch.float32, device=dev)
    nb2 = torch.zeros((n2,), dtype=torch.float32, device=dev)
    for bi in range(nblk):
        lo, hi = bi * block, (bi + 1) * block
        dA, dB, dna2, dnb2 = chunk_contribution(
            key, plan, _pad_rows(A[lo:hi], block), _pad_rows(B[lo:hi], block),
            torch.arange(lo, hi, device=dev), k=k, method=method,
            precision=precision, configs=configs)
        As, Bs = As + dA, Bs + dB
        na2, nb2 = na2 + dna2, nb2 + dnb2
    return SketchSummary(As, Bs, sqrt_f32(na2), sqrt_f32(nb2))


def _srht_blocked(X: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
                  dp: int, k: int, precision: Optional[str], configs=None):
    """(R H D X / sqrt(dp) * sqrt(dp / k), column norms of X), one
    ``ops.srht_block`` call per SRHT_COLUMN_BLOCK columns. On the card each
    call is one launch of the blocked FWHT's block mode: it writes only the
    k sampled rows of each transformed block, straight into the sketch, and
    takes the norms from its read of X (its own order of
    sums, float64 beyond a thread's float32); on the CPU the plain
    composition (transform, row gather, rescale, ``column_norms``).
    ``configs`` holds one launch config per column block (None: each
    call resolves its own)."""
    from repro_torch.kernels import ops
    n = X.shape[1]
    dev = X.device
    sketch = torch.empty((k, n), dtype=torch.float32, device=dev)
    norms = torch.empty((n,), dtype=torch.float32, device=dev)
    for i, c0 in enumerate(range(0, n, SRHT_COLUMN_BLOCK)):
        c1 = min(n, c0 + SRHT_COLUMN_BLOCK)
        ops.srht_block(_cast(X[:, c0:c1], precision), signs, rows, d_pad=dp,
                       sketch=sketch, norms=norms, col0=c0,
                       config=None if configs is None else configs[i])
    return sketch, norms


def _cuda_backend(key, A, B, k: int, *, method: str, block: int,
                  precision: Optional[str], configs=None) -> SketchSummary:
    """The kernels: sketch_fused twice against one materialized (k, d) Pi
    for gaussian; for srht the blocked FWHT over column blocks of A, then
    of B (the JAX ``pallas`` backend's srht branch, without its padded
    (dp, n) copies). ``configs`` (a ``SketchConfigs``; None resolves
    them here) gives each launch its config."""
    from repro_torch.kernels import ops
    if configs is None:
        configs = sketch_configs("cuda", method, k, block, precision, A, B)
    d = A.shape[0]
    if method == "gaussian":
        P = projection_rows(key, torch.arange(d, device=key.device), k).T
        As, na = ops.sketch_fused(P, A, precision=precision,
                                  config=configs.A[0])
        Bs, nb = ops.sketch_fused(P, B, precision=precision,
                                  config=configs.B[0])
        return SketchSummary(As, Bs, na, nb)
    signs, rows, dp = srht_plan(key, d, k)
    As, na = _srht_blocked(A, signs, rows, dp, k, precision, configs.A)
    Bs, nb = _srht_blocked(B, signs, rows, dp, k, precision, configs.B)
    return SketchSummary(As, Bs, na, nb)


def _distributed_backend(key, A, B, k: int, *, method: str, block: int,
                         precision: Optional[str], configs=None,
                         group=None) -> SketchSummary:
    """Rows sharded over the ranks of ``group`` (``core/distributed.py``):
    A and B are the whole pair on every rank, each rank summarizes its own
    shard."""
    del block, configs
    if group is None:
        raise ValueError("backend='distributed' needs group=... (a process "
                         "group, or an (outer, inner) pair of them)")
    from repro_torch.core.distributed import distributed_sketch_summary
    return distributed_sketch_summary(group, key, A, B, k, method=method,
                                      precision=precision, device=A.device)


_BACKENDS: Dict[str, Callable] = {
    "reference": _reference_backend, "scan": _scan_backend,
    "rows": _rows_backend, "cuda": _cuda_backend,
    "distributed": _distributed_backend}


def register_backend(name: str):
    """Register ``fn(key, A, B, k, *, method, block, precision, configs,
    **kw)`` as summary backend ``name`` (a decorator; an existing name is
    replaced). ``configs`` is the resolved kernel launch configs (None for
    a backend that launches nothing); a backend that does not act on it must
    accept and ignore it. ``build_summary(group=...)`` reaches the backend
    as ``group=``, and only when the caller gives one."""
    def _deco(fn):
        _BACKENDS[name] = fn
        return fn
    return _deco


def backends() -> tuple:
    """All registered summary backend names."""
    return tuple(sorted(_BACKENDS))


class SketchConfigs(NamedTuple):
    """The sketch kernel's launch configs for one call, in launch order:
    one per column block of A and of B on the SRHT pass, one for every
    launch otherwise (the Gaussian pass and the scan's blocks)."""

    A: Tuple
    B: Tuple


def _cast_dtype(dtype: torch.dtype, precision: Optional[str]) -> torch.dtype:
    return {None: dtype, "f32": torch.float32,
            "bf16": torch.bfloat16}.get(precision, dtype)


def sketch_configs(backend: str, method: str, k: int, block: int,
                   precision: Optional[str], A: torch.Tensor,
                   B: torch.Tensor, tuning=None) -> Optional[SketchConfigs]:
    """Resolve, once, the config of every kernel launch a summary of (A, B)
    (or of a stack of pairs) makes, as each ``ops`` wrapper would resolve
    it: the ``cuda`` backend takes ``tuning``'s pinned config
    (``sketch_fused`` for gaussian, ``blocked_fwht`` for srht) where it has
    one, and every launch otherwise ``tuning.lookup`` at its own shape and
    the dtype its kernel reads (after ``precision``'s cast) on A's device.
    The ``scan`` backend's blocks
    (``sketch_fused`` on the card) ignore ``tuning``, as the JAX package's
    non-kernel backends do. None for the backends that launch nothing."""
    from repro_torch.kernels import tuning as _tuning
    d = A.shape[-2]
    if backend == "cuda" and method == "gaussian":
        kernel, dtype = "sketch_fused", _cast_dtype(A.dtype, precision)

        def shapes(n):
            return [(k, d, n)]
    elif backend == "cuda":
        kernel, dtype = "blocked_fwht", _cast_dtype(A.dtype, precision)
        dp = _next_pow2(d)

        def shapes(n):
            return [(dp, min(n - c0, SRHT_COLUMN_BLOCK))
                    for c0 in range(0, n, SRHT_COLUMN_BLOCK)]
    elif backend == "scan":
        kernel, dtype = "sketch_fused", _cast_dtype(A.dtype, precision)

        def shapes(n):
            return [(k, block, n)]
    else:
        return None
    pinned = tuning.config_for(kernel) \
        if tuning is not None and backend == "cuda" else None
    table = _tuning.backend_of(A.device)
    dtype_bytes = _tuning.dtype_bytes_of(dtype)

    def resolve(n):
        return tuple(pinned if pinned is not None else
                     _tuning.lookup(kernel, shape, dtype_bytes=dtype_bytes,
                                    backend=table)
                     for shape in shapes(n))
    return SketchConfigs(resolve(A.shape[-1]), resolve(B.shape[-1]))


def pair_keys(key: torch.Tensor, L: int) -> torch.Tensor:
    """The (L, 2) per-pair keys of a batched call: ``key`` itself when it
    is a stack of L keys, else ``split(key, L)`` (the JAX package's
    ``_is_key_stack`` rule)."""
    return key if key.ndim == 2 and key.shape[0] == L else prng.split(key, L)


def _check_args(method: str, backend: str, A: torch.Tensor,
                B: torch.Tensor) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown sketch method {method!r} (use {METHODS})")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown summary backend {backend!r} "
                         f"(use one of {backends()})")
    if A.ndim != B.ndim or A.ndim not in (2, 3) or \
            A.shape[:-1] != B.shape[:-1]:
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)} "
                         f"disagree: expected (d, n1) and (d, n2), or "
                         f"(L, d, n1) and (L, d, n2)")


def build_summary(key: torch.Tensor, A: torch.Tensor, B: torch.Tensor, k: int,
                  *, method: str = "gaussian", backend: str = "reference",
                  block: int = 1024, precision: Optional[str] = None,
                  probes: int = 0, cosketch: int = 0, tuning=None,
                  group=None, device="cuda") -> SketchSummary:
    """One-pass summary of (A, B): sketches (k, n) and exact column norms.

    A: (d, n1), B: (d, n2), or stacked (L, d, n1) / (L, d, n2) for the
    batched mode, which summarizes the L pairs one after another and stacks
    the fields (``key`` is split L ways, or pass a stack of L keys).
    ``method`` is 'gaussian' or 'srht'; ``backend`` one of ``BACKENDS``;
    ``block`` the row-block size of the scan backend and of the probe and
    co-sketch passes. ``precision``: None/'f32' | 'bf16'. Key, A and B are
    moved to ``device`` (CUDA by default), where the summary is computed.

    probes:   retain this many held-out probe columns ``(A^T B) @ Omega``
              (``core/error_engine.py``: ``estimate_error``,
              ``adaptive_rank``).
    cosketch: retain an s-column Tropp range/co-range pair ``(A^T B) @
              Omega_c``, ``Psi_c @ (A^T B)`` (``core/refinement.py``:
              ``estimate_product(method='power')``).
    tuning:   a ``kernels.tuning.TuningSpec`` pinning kernel configs: the
              ``cuda`` backend launches with its ``sketch_fused`` (gaussian)
              or ``blocked_fwht`` (srht) config, the other backends ignore
              it; unpinned launches resolve through ``tuning.lookup``.
    group:    required by ``backend='distributed'``: a ``torch.distributed``
              process group, or an ``(outer, inner)`` pair for the
              hierarchical reduce (``dist.multihost.host_groups``); A and B
              are then the whole pair on every rank. No batched mode.

    Both blocks are plain PyTorch products over ``block``-row blocks, run
    after the backend whichever it is (as in the JAX package).

    >>> import torch
    >>> from repro_torch import prng
    >>> key = prng.PRNGKey(0)
    >>> A, B = torch.randn(64, 8), torch.randn(64, 6)
    >>> s = build_summary(key, A, B, 16, device="cpu")
    >>> (tuple(s.A_sketch.shape), tuple(s.B_sketch.shape), tuple(s.norm_A.shape))
    ((16, 8), (16, 6), (8,))
    >>> t = build_summary(key, A, B, 16, method="srht", backend="scan",
    ...                   block=32, probes=3, cosketch=2, device="cpu")
    >>> (tuple(t.A_sketch.shape), tuple(t.probes.shape), tuple(t.cosketch_W.shape))
    ((16, 8), (8, 3), (5, 6))
    """
    _check_args(method, backend, A, B)
    if group is not None and A.ndim == 3:
        raise NotImplementedError(
            "batched mode is not supported with a group (backend="
            "'distributed')")
    dev = _device.resolve(device)
    key, A, B = key.to(dev), A.to(dev), B.to(dev)
    configs = sketch_configs(backend, method, k, block, precision, A, B,
                             tuning)
    return _summarize(key, A, B, k, method=method, backend=backend,
                      block=block, precision=precision, probes=probes,
                      cosketch=cosketch, configs=configs, group=group)


def _summarize(key, A, B, k: int, *, method, backend, block, precision,
               probes, cosketch, configs, group=None) -> SketchSummary:
    """``build_summary`` on arguments already checked and on one device,
    with every launch config resolved; ``group`` reaches the backend as a
    keyword when it is given."""
    extra = {} if group is None else {"group": group}

    def _one(kk, a, b):
        out = _BACKENDS[backend](kk, a, b, k, method=method, block=block,
                                 precision=precision, configs=configs,
                                 **extra)
        if probes:
            from repro_torch.core import error_engine
            out = error_engine.attach_probes(out, kk, a, b, probes,
                                             block=block, precision=precision)
        if cosketch:
            from repro_torch.core import refinement
            out = refinement.attach_cosketch(out, kk, a, b, cosketch,
                                             block=block, precision=precision)
        return out

    if A.ndim == 2:
        return _one(key, A, B)
    keys = pair_keys(key, A.shape[0])
    return tree_stack([_one(keys[i], A[i], B[i]) for i in range(A.shape[0])])


def summary_stage(spec, key: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                  tuning=None, *, configs: Optional[SketchConfigs] = None
                  ) -> SketchSummary:
    """The step-1 pass driven by a declarative spec, on A's device.

    ``spec`` is any object with the ``SketchSpec`` fields (method, backend,
    k, block, precision, probes, cosketch); ``core.pipeline`` owns the
    concrete type. ``method='norms_only'`` is the sketch-free LELA first
    pass (the key is unused). ``tuning`` rides the plan
    (``PipelinePlan.tuning``), not the spec. ``configs``, the launch
    configs the ``PipelineEngine`` resolved once when it built its cache
    entry (``sketch_configs``), takes the place of ``tuning`` when given,
    so that a warm call resolves nothing.
    """
    if spec.method == "norms_only":
        return norms_only_summary(A, B)
    _check_args(spec.method, spec.backend, A, B)
    B = B.to(A.device)
    if configs is None:
        configs = sketch_configs(spec.backend, spec.method, spec.k,
                                 spec.block, spec.precision, A, B, tuning)
    return _summarize(key.to(A.device), A, B, spec.k,
                      method=spec.method, backend=spec.backend,
                      block=spec.block, precision=spec.precision,
                      probes=spec.probes, cosketch=spec.cosketch,
                      configs=configs)


def norms_only_summary(A: torch.Tensor, B: torch.Tensor) -> SketchSummary:
    """Exact column norms and empty (0, n) sketches, on A's device: LELA's
    first pass, all a norm-driven estimator (lela_waltmin) consumes."""
    return SketchSummary(
        torch.zeros((0, A.shape[1]), dtype=torch.float32, device=A.device),
        torch.zeros((0, B.shape[1]), dtype=torch.float32, device=B.device),
        column_norms(A), column_norms(B))


# ---------------------------------------------------------------------------
# Structured-product summaries for the training side
# ---------------------------------------------------------------------------

def identity_product_summary(key: torch.Tensor, G: torch.Tensor, k: int, *,
                             group=None, n_workers: int = 1,
                             precision: Optional[str] = None,
                             device="cuda") -> SketchSummary:
    """Summary of the structured product A^T B with A = vstack_w(I), so that
    A^T B = G = sum_w G_w: the gradient-compression mapping. A's sketch is
    each worker's Pi slice itself and ||A_i|| = sqrt(W), so A is never
    formed. G: (n1, n2), or stacked (L, n1, n2) (``key`` split L ways, or a
    stack of L keys), on ``device``.

    With ``group`` (a ``torch.distributed`` process group of the W =
    ``n_workers`` workers), G is this worker's summand: its Pi comes from
    ``fold_in(key, rank)`` and the sketches and squared norms are
    all-reduced over the group (the paper's treeAggregate). On the card
    ``Pi @ G`` and G's squared column norms are one ``ops.sketch_fused``
    launch."""
    dev = _device.resolve(device)
    key, G = key.to(dev), G.to(dev)
    if G.ndim == 3:
        keys = pair_keys(key, G.shape[0])
        return tree_stack([identity_product_summary(
            keys[i], G[i], k, group=group, n_workers=n_workers,
            precision=precision, device=dev) for i in range(G.shape[0])])
    n1 = G.shape[0]
    if group is not None:
        key = prng.fold_in(key, dist.get_rank(group))
    Gc = _cast(G, precision)
    # one operator for both sides: the (possibly rounded) Pi that contracts
    # with G is also what A's sketch reports (A's slice is I)
    Pi = _cast(gaussian_pi(key, k, n1), precision).to(Gc.dtype)
    A_sk = Pi.float()
    B_sk, nb2 = _sketch_and_norms(Pi.T, Gc, precision)
    if group is not None:
        for x in (A_sk, B_sk, nb2):
            dist.all_reduce(x, group=group)
    return SketchSummary(
        A_sk, B_sk,
        torch.full((n1,), float(_sqrt_f32(n_workers)), dtype=torch.float32,
                   device=dev),
        sqrt_f32(nb2))


def tap_pair_summary(key: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
                     k: int, *, precision: Optional[str] = None):
    """One-pass ``(Pi X, Pi Y, squared column norms of X, of Y)`` over X
    (T, n1) and Y (T, n2) for the gradient tap, on X's device, with Pi =
    ``normal(key, (T, k)) / sqrt(k)`` drawn whole over the token dimension.
    Returns the raw tuple: taps carry squared norms, so summing them over
    workers stays a plain sum. On the card two ``ops.sketch_fused``
    launches."""
    Pi = prng.normal(key.to(X.device), (X.shape[0], k)) / _sqrt_f32(k)
    As, na2 = _sketch_and_norms(Pi, X, precision)
    Bs, nb2 = _sketch_and_norms(Pi, Y, precision)
    return As, Bs, na2, nb2
