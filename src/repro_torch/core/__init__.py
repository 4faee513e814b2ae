"""The port's estimation engine: sketch, sample, estimate, complete
(Algorithm 1), the baselines it is compared with, and the quality gate.

Entry points: ``core.smppca.smppca``, ``core.summary_engine.build_summary``,
``core.estimation_engine.estimate_product``, ``core.lela.lela``,
``core.baselines`` (``optimal_rank_r``, ``sketch_svd``,
``product_of_pcas``) and ``core.error_engine`` (``estimate_error``,
``rank_curve``, ``adaptive_rank``). The plans and their cached engine
(``PipelinePlan``, ``PipelineEngine``, ``get_engine``, the presets) are
``core.pipeline``; streaming summaries (chunked ingestion, merges, decay,
windows, the wire format) are ``core.streaming``. This package exports
their names as ``repro.core`` does.
"""
from repro_torch.core.summary_engine import summary_stage  # noqa: F401
from repro_torch.core.estimation_engine import estimation_stage  # noqa: F401
from repro_torch.core.pipeline import (  # noqa: F401
    EstimationSpec, PipelineEngine, PipelinePlan, PipelineResult, RankPolicy,
    SketchSpec, get_engine, lela_plan, sketch_svd_plan, smppca_plan)
from repro_torch.core.streaming import (  # noqa: F401
    CompressedState, StreamingSummarizer, StreamState, WindowedSummarizer,
    WindowState, WireSpec, choose_wire_spec, compress_state, decay_state,
    decompress_state, finalize_state, merge_states, tree_merge,
    window_bucket_key, wire_bytes, wire_error, wire_pack, wire_unpack)
