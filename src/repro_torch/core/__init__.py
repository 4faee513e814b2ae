"""repro_torch.core: Single-Pass PCA of Matrix Products (SMP-PCA, NIPS 2016)
in PyTorch. Every name ``repro.core`` exports, from the port's modules:

    build_summary / rows_summary                          (step 1: the engine)
    estimate_product                                      (steps 2-3: the engine)
    estimate_error / adaptive_rank / probe_omega          (quality: ErrorEngine)
    PipelinePlan / PipelineEngine / get_engine            (cached plans)
    sketch_summary / sketch_pass / streamed_rows_summary  (step 1, legacy wrappers)
    sample_entries / q_probabilities                      (step 2a, Eq 1)
    rescaled_entries / rescaled_matrix                    (step 2b, Eq 2)
    waltmin / waltmin_reference                           (step 3, Alg 2)
    smppca / smppca_from_summary                          (Alg 1)
    lela / sketch_svd / optimal_rank_r / product_of_pcas  (baselines)
    distributed_sketch_summary / distributed_smppca       (sharded over ranks)
    StreamingSummarizer / merge_states / finalize_state   (chunked ingestion)
    decay_state / WindowedSummarizer / window_bucket_key  (drifting streams)
    WireSpec / compress_state / choose_wire_spec          (state on the wire)
    RefineSpec / refine_factors / refined_svd             (sketch-power refinement)
    cosketch_omega / cosketch_psi / attach_cosketch       (Tropp co-sketch block)
"""
from repro_torch.core.types import (  # noqa: F401
    ErrorEstimate, EstimateResult, LowRankFactors, SampleSet, SketchSummary,
    SMPPCAResult)
from repro_torch.core.error_engine import (  # noqa: F401
    AdaptiveRankResult, adaptive_rank, estimate_error, merge_probes,
    probe_contribution, probe_omega, probe_pass, rank_curve)
from repro_torch.core.sketch import (  # noqa: F401
    column_norms, fwht, gaussian_pi, merge_summaries, pi_rows, sketch_pass,
    sketch_summary, srht_sketch, streamed_rows_summary)
from repro_torch.core.summary_engine import (  # noqa: F401
    backends, build_summary, identity_product_summary, norms_only_summary,
    projection_rows, register_backend, rows_summary, srht_plan,
    summary_stage, tap_pair_summary)
from repro_torch.core.sampling import (  # noqa: F401
    q_at, q_probabilities, sample_entries, sample_entries_binomial, split_omega)
from repro_torch.core.estimator import (  # noqa: F401
    plain_jl_entries, rescaled_entries, rescaled_matrix)
from repro_torch.core.waltmin import (  # noqa: F401
    coo_matmat, coo_rmatmat, coo_topr_svd, waltmin, waltmin_reference)
from repro_torch.core.estimation_engine import (  # noqa: F401
    default_m, estimate_product, estimation_stage, estimators, exact_entries,
    implicit_topr, register_estimator)
from repro_torch.core.pipeline import (  # noqa: F401
    EstimationSpec, PipelineEngine, PipelinePlan, PipelineResult, RankPolicy,
    SketchSpec, get_engine, lela_plan, sketch_svd_plan, smppca_plan)
from repro_torch.core.smppca import (  # noqa: F401
    smppca, smppca_from_summary, spectral_error, spectral_error_vs_optimal)
from repro_torch.core.lela import lela  # noqa: F401
from repro_torch.core.baselines import (  # noqa: F401
    optimal_rank_r, product_of_pcas, sketch_svd)
from repro_torch.core.distributed import (  # noqa: F401
    distributed_sketch_summary, distributed_smppca,
    distributed_streaming_summary, distributed_streaming_update)
from repro_torch.core.streaming import (  # noqa: F401
    CompressedState, StreamingSummarizer, StreamState, WindowedSummarizer,
    WindowState, WireSpec, choose_wire_spec, compress_state, decay_state,
    decompress_state, finalize_state, merge_states, tree_merge,
    window_bucket_key, wire_bytes, wire_error, wire_pack, wire_unpack)
from repro_torch.core.refinement import (  # noqa: F401
    RefineSpec, attach_cosketch, cosketch_contribution, cosketch_key,
    cosketch_omega, cosketch_pass, cosketch_psi, cosketch_width,
    merge_cosketch, refine_factors, refined_svd, validate_refine)
