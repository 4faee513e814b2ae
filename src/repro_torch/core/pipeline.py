"""PipelineEngine: build-once execution of the paper's fixed pipeline.

The port of ``repro.core.pipeline``. The paper's method is a fixed recipe:
a one-pass summary of (A, B), completion of the top-r factors from it,
then optionally an a-posteriori error estimate. This module describes that
recipe as a value and runs it from a cache:

* ``PipelinePlan``: a hashable description of the whole pipeline, the
  sketch stage (``SketchSpec``), the estimation stage
  (``EstimationSpec``), the rank policy (``RankPolicy``: fixed ``r``, or
  quality-gated with ``tol``/``r_max``), the key layout (how the caller's
  one key fans out into the per-stage keys), error attachment and the
  pinned ``tuning``, ``refine`` and ``wire`` specs.
* ``PipelineEngine``: an LRU cache of callables, one per (entry kind,
  plan, signature). The signature is the shape, dtype and device type of
  every tensor argument, so a CPU call and a CUDA call never share an
  entry. Building an entry binds what is static for it: the layout
  fan-out, the stage callables, the sample budget ``m`` (``default_m`` at
  the signature's n1, n2 and r when the plan leaves it None), every sketch
  and gather launch's ``KernelConfig`` (the plan's ``tuning``, else
  ``tuning.lookup`` at the launch's shape) and the kernel libraries. A
  warm call is one dict lookup and then the stages; it resolves no config.
  ``EngineStats.traces`` counts builds, the counterpart of the reference's
  traced bodies; the other counters keep the reference's meanings.

An entry holds callables and the values above, never a tensor of a call,
so a cached entry keeps no input or result alive. The stages read the host
where the reference's jitted body cannot (the sampler's CDF, the gather
kernel's range flag), so an entry is not a CUDA graph.

``smppca`` / ``lela`` / ``sketch_svd`` are thin presets over this engine
(``smppca_plan`` / ``lela_plan`` / ``sketch_svd_plan``), and
``serve.SketchService`` runs every ``flush_factors`` / ``stream_factors``
bucket through the same cache. Key derivations are the JAX package's,
bit for bit.

Quality-gated rank (``RankPolicy(r=None, tol=...)``): one summary and
rank-curve call (the ``adaptive_rank`` sweep: a single SVD scores every
candidate rank), one host read of the curve to fast-forward the doubling
schedule (4, 8, 16, ...) past ranks that fail, then an estimation call at
the chosen rank whose served a-posteriori estimate has the final word
(doubling further only if the curve was optimistic about the completion).

Backend names are the port's: the sketch stage's ``'cuda'`` is the JAX
package's ``'pallas'``, and the estimation stage takes ``'reference'`` or
``'cuda'`` (the JAX ``'jit'`` and ``'pallas'``).

>>> import torch
>>> from repro_torch import prng
>>> key = prng.PRNGKey(0)
>>> A, B = torch.randn(128, 12), torch.randn(128, 10)
>>> engine = PipelineEngine()
>>> plan = smppca_plan(r=3, k=32, m=400, T=2)    # hashable, declarative
>>> res = engine.run(plan, key, A, B)            # cold: build once
>>> (tuple(res.estimate.factors.U.shape), tuple(res.estimate.factors.V.shape))
((12, 3), (10, 3))
>>> _ = engine.run(plan, key, A, B)              # warm: one lookup
>>> (engine.stats.traces, engine.stats.hits, engine.stats.misses)
(1, 1, 1)
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import zlib
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import error_engine, estimation_engine, streaming, \
    summary_engine
from repro_torch.core.refinement import RefineSpec, validate_refine
from repro_torch.core.types import EstimateResult, SketchSummary, tree_index
from repro_torch.kernels.tuning import TuningSpec

#: Supported key layouts: how one caller key fans out into per-stage keys.
LAYOUTS = ("service", "smppca", "sketch_svd", "direct")

# the start rank of the quality-gated doubling schedule
_R0 = 4

# reserved tenant-namespace fold tag ("tnt!"): like the error engine's probe
# tag, the two-level fold cannot collide with any per-row single fold_in
_TENANT_TAG = 0x746E7421


class SketchSpec(NamedTuple):
    """Declarative step-1 stage: what ``summary_stage`` builds.

    ``method='norms_only'`` is the sketch-free LELA first pass (``k``,
    ``backend``, ``block``, ``precision`` and the sketch key are unused).
    """

    method: str = "gaussian"       # 'gaussian' | 'srht' | 'norms_only'
    backend: str = "reference"     # summary_engine.backends()
    k: int = 128
    block: int = 1024
    precision: Optional[str] = None
    probes: int = 0
    cosketch: int = 0              # refinement co-sketch width s (0 = off)


class EstimationSpec(NamedTuple):
    """Declarative steps-2/3 stage: what ``estimation_stage`` runs.

    ``m=None`` means the paper's default sample budget (``default_m``),
    resolved when the cache entry is built, from the signature's shapes.
    """

    method: str = "rescaled_jl"    # estimation_engine.METHODS
    backend: str = "cuda"          # estimation_engine.BACKENDS
    m: Optional[int] = None
    T: int = 10
    use_splits: bool = False


class RankPolicy(NamedTuple):
    """Rank selection: fixed (``r=<int>``) or quality-gated auto.

    ``r=None`` with ``tol=<relative Frobenius error>`` gates the rank: the
    engine reads the per-rank error curve once and picks the first rank on
    the doubling schedule (4, 8, 16, ... capped at ``r_max`` and
    min(n1, n2, k)) whose estimated error meets ``tol``.
    """

    r: Optional[int] = None
    tol: Optional[float] = None
    r_max: Optional[int] = None

    @property
    def auto(self) -> bool:
        """True when the rank is quality-gated rather than fixed."""
        return self.r is None


class PipelinePlan(NamedTuple):
    """The whole pipeline as one hashable value: the cache key.

    ``key_layout`` fixes how the caller's key fans out into the (sketch
    key, estimation key) pair; the layouts are the JAX package's:

    * ``'service'``    sketch = key, estimation = ``fold_in(key, 1)``
      (per key of the stack in batched mode): ``SketchService``;
    * ``'smppca'``     ``split(key, 3)`` -> sketch = part 0, estimation =
      ``fold_in(part 1, 0)``: Algorithm 1's layout;
    * ``'sketch_svd'`` ``split(key)`` -> (sketch, estimation);
    * ``'direct'``     both stages get the caller key unchanged: LELA.

    ``with_error`` attaches the error engine's estimate (needs
    ``sketch.probes > 0``); the quality-gated path always attaches it.

    ``tuning`` pins kernel configs (a hashable ``kernels.tuning.TuningSpec``;
    the sketch stage's ``cuda`` backend and the ``cuda`` estimation
    backend's gather read it). ``None`` resolves each launch through the
    tuning table when the cache entry is built. ``refine`` pins the
    reconstruction refinement for ``method='power'`` (a ``RefineSpec``;
    needs ``SketchSpec(cosketch=s)``). ``wire`` pins the transport
    precision of states this plan's streams put on the wire (a
    ``streaming.WireSpec``); the compute path never reads it. All three
    join the cache key, and ``None`` is the default.
    """

    sketch: SketchSpec = SketchSpec()
    estimation: EstimationSpec = EstimationSpec()
    rank: RankPolicy = RankPolicy()
    key_layout: str = "service"
    with_error: bool = False
    tuning: Optional[TuningSpec] = None
    refine: Optional[RefineSpec] = None
    wire: Optional["streaming.WireSpec"] = None


class PipelineResult(NamedTuple):
    """One pipeline execution: the step-1 summary and the step-2/3 estimate
    (with the error estimate attached when the plan asked for it)."""

    summary: SketchSummary
    estimate: EstimateResult


@dataclasses.dataclass
class EngineStats:
    """Observable engine counters. ``traces`` counts entries built (the
    reference's traces), so a warm cache shows dispatches without
    builds."""

    traces: int = 0            # cache entries built
    hits: int = 0              # cache hits
    misses: int = 0            # cache misses (fresh builds)
    evictions: int = 0         # LRU evictions past max_entries
    est_dispatches: int = 0    # calls of an estimation-carrying entry
    curve_dispatches: int = 0  # calls of a rank-curve entry


def tenant_id(tenant: Union[int, str]) -> int:
    """Canonical uint31 id for a tenant handle (int passed through, str
    hashed): the value ``tenant_key`` folds into the key derivation.

    Ints must lie in the fold_in range [0, 2^31); strings map through crc32
    (stable across processes and Python versions, unlike ``hash``) masked
    into the same range.
    """
    if isinstance(tenant, bool) or not isinstance(tenant, (int, str)):
        raise TypeError(f"tenant must be an int or str, got {tenant!r}")
    if isinstance(tenant, str):
        return zlib.crc32(tenant.encode()) & 0x7FFFFFFF
    if not 0 <= tenant < 2 ** 31:
        raise ValueError(f"int tenant ids must be in [0, 2**31), got {tenant}")
    return tenant


def tenant_key(key: torch.Tensor, tenant: Union[int, str]) -> torch.Tensor:
    """Namespace a caller key (or a stack of keys) under a tenant: the
    reserved two-level fold ``fold_in(fold_in(key, 0x746E7421),
    tenant_id(tenant))``, on the key's device.

    Many tenants share one warm engine this way: the fold happens before
    the layout fan-out, changes only key values (never shapes, plans or
    cache entries), and two tenants submitting the same key get
    independent randomness.
    """
    return prng.fold_in(prng.fold_in(key, _TENANT_TAG), tenant_id(tenant))


def derive_keys(layout: str, key: torch.Tensor, *, batched: bool = False,
                tenant: Optional[Union[int, str]] = None):
    """(sketch key, estimation key) under a fixed layout.

    The one place the plan-path key fan-out lives, bit for bit the JAX
    package's. Batched mode (a (L, 2) stack of keys, one per pair) is a
    'service' notion: the other layouts take exactly one caller key.
    ``tenant`` namespaces the caller key through ``tenant_key`` before the
    fan-out; ``None`` leaves every derivation unchanged.
    """
    if batched and key.ndim != 2:
        raise ValueError(f"batched mode needs a (L, 2) stack of keys, got "
                         f"a key of shape {tuple(key.shape)}")
    if tenant is not None:
        key = tenant_key(key, tenant)
    if layout == "service":
        return key, prng.fold_in(key, 1)
    if batched:
        raise NotImplementedError(
            f"batched pipelines are only defined for key_layout='service' "
            f"(got {layout!r})")
    if layout == "smppca":
        k_sketch, k_sample, _ = prng.split(key, 3)
        return k_sketch, prng.fold_in(k_sample, 0)
    if layout == "sketch_svd":
        k_sketch, k_pow = prng.split(key)
        return k_sketch, k_pow
    if layout == "direct":
        return key, key
    raise ValueError(f"unknown key layout {layout!r} (use one of {LAYOUTS})")


def validate_plan(plan: PipelinePlan) -> None:
    """Reject malformed plans eagerly, before any entry is built."""
    if not isinstance(plan, PipelinePlan):
        raise TypeError(f"expected a PipelinePlan, got {type(plan).__name__}")
    sk, est, rank = plan.sketch, plan.estimation, plan.rank
    if plan.key_layout not in LAYOUTS:
        raise ValueError(f"unknown key layout {plan.key_layout!r} "
                         f"(use one of {LAYOUTS})")
    methods = summary_engine.METHODS + ("norms_only",)
    if sk.method not in methods:
        raise ValueError(f"unknown sketch method {sk.method!r} "
                         f"(use {methods})")
    if sk.method != "norms_only":
        if sk.backend not in summary_engine.backends():
            raise ValueError(f"unknown summary backend {sk.backend!r} "
                             f"(use one of {summary_engine.backends()})")
        if sk.backend == "distributed":
            raise ValueError(
                "backend='distributed' needs a process group and is not "
                "plan-compilable: use build_summary(..., group=) or "
                "core.distributed directly")
    if est.method not in estimation_engine.METHODS:
        raise ValueError(f"unknown estimation method {est.method!r} "
                         f"(use one of {estimation_engine.METHODS})")
    if est.backend not in estimation_engine.BACKENDS:
        raise ValueError(f"unknown estimation backend {est.backend!r} "
                         f"(use one of {estimation_engine.BACKENDS})")
    if rank.auto:
        if rank.tol is None:
            raise ValueError(
                "RankPolicy(r=None) is quality-gated and needs tol= "
                "(the relative-error gate)")
        if sk.probes <= 0:
            raise ValueError(
                "quality-gated rank needs a probe-carrying sketch stage: "
                "set SketchSpec(probes=p)")
    elif isinstance(rank.r, bool) or not isinstance(rank.r, int):
        raise ValueError(f"RankPolicy.r must be an int or None, "
                         f"got {rank.r!r}")
    if plan.with_error and sk.probes <= 0:
        raise ValueError("with_error=True needs SketchSpec(probes=p)")
    if est.method == "power" and sk.cosketch <= 0:
        raise ValueError(
            "estimation method 'power' reconstructs from the refinement "
            "co-sketch block: set SketchSpec(cosketch=s)")
    if plan.refine is not None:
        validate_refine(plan.refine)
        if est.method != "power":
            raise ValueError(
                f"PipelinePlan.refine only applies to estimation "
                f"method='power', got method={est.method!r}")
    if plan.tuning is not None:
        if not isinstance(plan.tuning, TuningSpec):
            raise ValueError(f"PipelinePlan.tuning must be a TuningSpec or "
                             f"None, got {type(plan.tuning).__name__}")
        plan.tuning.validate()
    if plan.wire is not None:
        if not isinstance(plan.wire, streaming.WireSpec):
            raise ValueError(f"PipelinePlan.wire must be a WireSpec or "
                             f"None, got {type(plan.wire).__name__}")
        streaming._as_wire_spec(plan.wire)


def _signature(*trees) -> tuple:
    """Shape, dtype and device type of every tensor leaf of the arguments
    (None leaves kept as None): the half of a cache key that says what an
    entry was built for."""
    out = []

    def walk(x):
        if x is None:
            out.append(None)
        elif isinstance(x, torch.Tensor):
            out.append((tuple(x.shape), str(x.dtype), x.device.type))
        else:
            for leaf in x:
                walk(leaf)
    walk(trees)
    return tuple(out)


def _load_kernels(device: torch.device, names) -> None:
    """Build or load the kernel libraries an entry launches (on the card
    only), so that its first call does not."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import ops
    for name in names:
        ops._library(name)


class PipelineEngine:
    """LRU cache of built pipeline callables and the host-side rank gate.

    One engine instance is one cache: the facades share the process default
    (``get_engine()``), services can hold their own. ``max_entries`` bounds
    the cache; the least-recently-used entry is dropped past it
    (``stats.evictions``) and rebuilt on next use. The cache and the
    counters are guarded by a lock, so a serving loop's thread and its
    callers may share an engine.
    """

    def __init__(self, max_entries: int = 64):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._cache: "collections.OrderedDict[tuple, Callable]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.stats = EngineStats()

    # -- cache plumbing ----------------------------------------------------

    def __len__(self) -> int:
        return len(self._cache)

    def clear(self) -> None:
        """Drop every cached entry (counters are kept)."""
        with self._lock:
            self._cache.clear()

    def _executable(self, cache_key: tuple, build: Callable,
                    counter: Optional[str] = None) -> Callable:
        """The entry for ``cache_key``, built on a miss; ``counter`` names
        the dispatch counter the caller's call of it adds one to."""
        with self._lock:
            fn = self._cache.get(cache_key)
            if fn is None:
                self.stats.misses += 1
                self.stats.traces += 1
                fn = build()
                self._cache[cache_key] = fn
                if len(self._cache) > self.max_entries:
                    self._cache.popitem(last=False)
                    self.stats.evictions += 1
            else:
                self._cache.move_to_end(cache_key)
                self.stats.hits += 1
            if counter is not None:
                setattr(self.stats, counter, getattr(self.stats, counter) + 1)
        return fn

    # -- building an entry: each binds what is static for its signature ----

    @staticmethod
    def _bind_summary(spec: SketchSpec, tuning: Optional[TuningSpec],
                      A: torch.Tensor, B: torch.Tensor) -> Callable:
        """``summary_stage`` with every launch config resolved for the
        shapes, dtypes and device of (A, B)."""
        if spec.method == "norms_only":
            return lambda key, A, B: summary_engine.norms_only_summary(A, B)
        configs = summary_engine.sketch_configs(
            spec.backend, spec.method, spec.k, spec.block, spec.precision,
            A, B, tuning)
        kernel = {"cuda": "sketch_fused" if spec.method == "gaussian"
                  else "blocked_fwht", "scan": "sketch_fused"}
        if spec.backend in kernel:
            _load_kernels(A.device, [kernel[spec.backend]])

        def summary_fn(key, A, B):
            return summary_engine.summary_stage(spec, key, A, B, tuning,
                                                configs=configs)
        return summary_fn

    @staticmethod
    def _bind_estimation(plan: PipelinePlan, r: int, n1: int, n2: int,
                         k: int, device: torch.device) -> Callable:
        """``estimation_stage`` at rank ``r`` with the sample budget and
        the gather kernel's config resolved for an (n1, n2) pair sketched
        to k rows on ``device``."""
        spec = plan.estimation
        if spec.m is None:
            spec = spec._replace(m=estimation_engine.default_m(n1, n2, r))
        tuning = None
        if spec.backend == "cuda" and spec.method == "rescaled_jl":
            from repro_torch.kernels import tuning as _tuning
            cfg = plan.tuning.config_for("sampled_dot") \
                if plan.tuning is not None else None
            if cfg is None:
                cfg = _tuning.lookup("sampled_dot", (n1, n2, k, spec.m),
                                     backend=_tuning.backend_of(device))
            tuning = TuningSpec((cfg,))
            _load_kernels(device, ["sampled_rescaled_dot"])

        def estimate_fn(k_est, summary, exact_pair):
            return estimation_engine.estimation_stage(
                spec, k_est, summary, r, exact_pair=exact_pair,
                refine=plan.refine, with_error=plan.with_error,
                tuning=tuning)
        return estimate_fn

    def _build_full(self, plan: PipelinePlan, batched: bool, A: torch.Tensor,
                    B: torch.Tensor) -> Callable:
        summary_fn = self._bind_summary(plan.sketch, plan.tuning, A, B)
        estimate_fn = self._bind_estimation(
            plan, plan.rank.r, A.shape[-1], B.shape[-1], plan.sketch.k,
            A.device)
        layout = plan.key_layout
        lela = plan.estimation.method == "lela_waltmin"

        def pipeline_fn(key, A, B):
            k_sketch, k_est = derive_keys(layout, key, batched=batched)
            summary = summary_fn(k_sketch, A, B)
            return PipelineResult(summary, estimate_fn(
                k_est, summary, (A, B) if lela else None))
        return pipeline_fn

    def _build_curve_full(self, plan: PipelinePlan, batched: bool,
                          A: torch.Tensor, B: torch.Tensor) -> Callable:
        summary_fn = self._bind_summary(plan.sketch, plan.tuning, A, B)
        curve_fn = self._bind_curve(plan, batched, A.shape[-1], B.shape[-1],
                                    plan.sketch.cosketch)
        layout = plan.key_layout

        def pipeline_fn(key, A, B):
            k_sketch, _ = derive_keys(layout, key, batched=batched)
            summary = summary_fn(k_sketch, A, B)
            return summary, curve_fn(summary)
        return pipeline_fn

    def _build_from_summary(self, plan: PipelinePlan, batched: bool,
                            summary: SketchSummary) -> Callable:
        estimate_fn = self._bind_estimation(
            plan, plan.rank.r, summary.A_sketch.shape[-1],
            summary.B_sketch.shape[-1], summary.A_sketch.shape[-2],
            summary.A_sketch.device)
        layout = plan.key_layout

        def from_summary_fn(key, summary, exact_pair):
            _, k_est = derive_keys(layout, key, batched=batched)
            return estimate_fn(k_est, summary, exact_pair)
        return from_summary_fn

    def _bind_curve(self, plan: PipelinePlan, batched: bool, n1: int,
                    n2: int, cosketch: int) -> Callable:
        """The per-rank estimated-error curve up to the plan's rank cap, the
        cap resolved here from the shapes. A batched summary gets one curve
        per pair. A refined plan scores refined truncations (the gate then
        passes at the rank the served factors achieve), capped additionally
        by the co-sketch width: the refined basis has only s columns."""
        cap = min(n1, n2, plan.sketch.k)
        if plan.refine is not None:
            cap = min(cap, cosketch)
        r_cap = cap if plan.rank.r_max is None else min(plan.rank.r_max, cap)
        refine = plan.refine

        def curve_fn(summary):
            if not batched:
                return error_engine.rank_curve(summary, r_cap, refine=refine)
            return torch.stack([
                error_engine.rank_curve(tree_index(summary, i), r_cap,
                                        refine=refine)
                for i in range(summary.A_sketch.shape[0])])
        return curve_fn

    # -- the rank gate (host side; ONE curve read per bucket) --------------

    @staticmethod
    def _pick_rank(curve: torch.Tensor, tol: float) -> int:
        """First rank on the doubling schedule whose estimated error meets
        ``tol`` for every request in the bucket (else the cap): the
        reference's decision rule, read off the curve in one host read."""
        worst = curve.detach().cpu().numpy()
        if worst.ndim == 2:
            worst = worst.max(axis=0)
        r_cap = int(worst.shape[0])
        r = min(_R0, r_cap)
        while worst[r - 1] > tol and r < r_cap:
            r = min(2 * r, r_cap)
        return r

    @staticmethod
    def _curve_cache_plan(plan: PipelinePlan) -> PipelinePlan:
        """The curve entry never reads ``tol`` (the rank pick on the host
        does), so it leaves the cache key: gated requests differing only in
        tolerance share one curve entry."""
        return plan._replace(rank=plan.rank._replace(tol=None))

    def _gated_estimate(self, plan: PipelinePlan, key, summary, curve,
                        exact_pair) -> EstimateResult:
        """The quality gate: the curve fast-forwards the doubling schedule
        to its first plausible rank, then the served factors' a-posteriori
        estimate decides; if it still misses ``tol`` (the curve scores SVD
        truncations of the rescaled sketch product; a completion method's
        factors can be worse) the schedule keeps doubling. The common case
        is one estimation call."""
        r_cap = int(curve.shape[-1])
        r = self._pick_rank(curve, plan.rank.tol)
        while True:
            fixed = plan._replace(rank=RankPolicy(r=r), with_error=True)
            est = self._estimate_from_summary(fixed, key, summary, exact_pair)
            worst = float(np.max(est.error.rel_est.detach().cpu().numpy()))
            if worst <= plan.rank.tol or r >= r_cap:
                return est
            r = min(2 * r, r_cap)

    # -- entry points ------------------------------------------------------

    def run(self, plan: PipelinePlan, key: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor) -> PipelineResult:
        """Execute the whole plan on (A, B): (d, n) pairs, or stacked
        (L, d, n) with a (L, 2) key stack for the batched mode, on the
        device where A and B lie.

        Fixed rank: one summary, estimation and error call. Auto rank: one
        summary and curve call, one host read of the curve, then the
        curve-fast-forwarded estimation rounds of ``_gated_estimate`` (one
        in the common case; ``with_error`` forced on, and the served
        estimate, not the curve, has the final word on ``tol``).
        """
        validate_plan(plan)
        batched = A.ndim == 3
        if not plan.rank.auto:
            fn = self._executable(
                ("full", plan, _signature(key, A, B)),
                lambda: self._build_full(plan, batched, A, B),
                "est_dispatches")
            return fn(key, A, B)
        curve_plan = self._curve_cache_plan(plan)
        fn = self._executable(
            ("curve_full", curve_plan, _signature(key, A, B)),
            lambda: self._build_curve_full(curve_plan, batched, A, B),
            "curve_dispatches")
        summary, curve = fn(key, A, B)
        exact = (A, B) if plan.estimation.method == "lela_waltmin" else None
        est = self._gated_estimate(plan, key, summary, curve, exact)
        return PipelineResult(summary, est)

    def run_from_summary(self, plan: PipelinePlan, key: torch.Tensor,
                         summary: SketchSummary, *,
                         exact_pair: Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]] = None
                         ) -> EstimateResult:
        """Steps 2-3 (and the error) of the plan against an existing
        summary: the path streaming sessions share with ``run`` (the
        summary was accumulated chunk by chunk). The estimation key is
        derived from ``key`` by the plan's layout, exactly as ``run``
        would."""
        validate_plan(plan)
        if not plan.rank.auto:
            return self._estimate_from_summary(plan, key, summary, exact_pair)
        batched = summary.A_sketch.ndim == 3
        curve_plan = self._curve_cache_plan(plan)
        fn = self._executable(
            ("curve_summary", curve_plan, _signature(summary)),
            lambda: self._bind_curve(
                curve_plan, batched, summary.A_sketch.shape[-1],
                summary.B_sketch.shape[-1], summary.n_cosketch),
            "curve_dispatches")
        return self._gated_estimate(plan, key, summary, fn(summary),
                                    exact_pair)

    def summarize(self, spec: SketchSpec, key: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, tuning: Optional[TuningSpec] = None
                  ) -> SketchSummary:
        """The step-1 stage alone as a cached entry (``SketchService.
        flush``); ``key`` is the sketch key (no layout fan-out), or a (L, 2)
        stack of them for stacked (L, d, n) input. ``tuning`` joins the
        cache key as ``PipelinePlan.tuning`` does."""
        if tuning is not None:
            if not isinstance(tuning, TuningSpec):
                raise ValueError(f"tuning must be a TuningSpec or None, "
                                 f"got {type(tuning).__name__}")
            tuning.validate()
        fn = self._executable(
            ("summary", spec, tuning, _signature(key, A, B)),
            lambda: self._bind_summary(spec, tuning, A, B))
        return fn(key, A, B)

    def _estimate_from_summary(self, plan, key, summary,
                               exact_pair) -> EstimateResult:
        batched = summary.A_sketch.ndim == 3
        fn = self._executable(
            ("est_summary", plan, _signature(key, summary, exact_pair)),
            lambda: self._build_from_summary(plan, batched, summary),
            "est_dispatches")
        return fn(key, summary, exact_pair)


# ---------------------------------------------------------------------------
# Plan presets: the algorithm facades as declarative plans
# ---------------------------------------------------------------------------

def smppca_plan(*, r: int, k: int, m: int, T: int = 10,
                method: str = "gaussian", backend: str = "reference",
                block: int = 1024, precision: Optional[str] = None,
                est_backend: str = "cuda",
                use_splits: bool = False) -> PipelinePlan:
    """Algorithm 1 (SMP-PCA) as a plan: gaussian/srht sketch -> rescaled-JL
    entries -> WAltMin, under the split(key, 3) layout."""
    return PipelinePlan(
        sketch=SketchSpec(method=method, backend=backend, k=k, block=block,
                          precision=precision),
        estimation=EstimationSpec(method="rescaled_jl", backend=est_backend,
                                  m=m, T=T, use_splits=use_splits),
        rank=RankPolicy(r=r), key_layout="smppca")


def lela_plan(*, r: int, m: int, T: int = 10,
              use_splits: bool = False) -> PipelinePlan:
    """The LELA two-pass baseline as a plan: norms-only first pass -> exact
    sampled entries -> WAltMin (the caller key goes straight to
    estimation)."""
    return PipelinePlan(
        sketch=SketchSpec(method="norms_only", k=0),
        estimation=EstimationSpec(method="lela_waltmin", backend="cuda", m=m,
                                  T=T, use_splits=use_splits),
        rank=RankPolicy(r=r), key_layout="direct")


def sketch_svd_plan(*, r: int, k: int, method: str = "gaussian",
                    backend: str = "reference",
                    est_backend: str = "cuda") -> PipelinePlan:
    """SVD(A~^T B~) as a plan: sketch -> top-r SVD of the sketch product,
    under the split(key) layout."""
    return PipelinePlan(
        sketch=SketchSpec(method=method, backend=backend, k=k),
        estimation=EstimationSpec(method="direct_svd", backend=est_backend),
        rank=RankPolicy(r=r), key_layout="sketch_svd")


_DEFAULT_ENGINE = PipelineEngine()


def get_engine() -> PipelineEngine:
    """The process-default engine the algorithm facades share: warm plans
    stay warm across ``smppca``/``lela``/``sketch_svd``/service calls."""
    return _DEFAULT_ENGINE
