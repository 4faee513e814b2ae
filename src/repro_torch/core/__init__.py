"""The port's estimation engine: sketch, sample, estimate, complete
(Algorithm 1), the baselines it is compared with, and the quality gate.

Entry points: ``core.smppca.smppca``, ``core.summary_engine.build_summary``,
``core.estimation_engine.estimate_product``, ``core.lela.lela``,
``core.baselines`` (``optimal_rank_r``, ``sketch_svd``,
``product_of_pcas``) and ``core.error_engine`` (``estimate_error``,
``rank_curve``, ``adaptive_rank``).
"""
