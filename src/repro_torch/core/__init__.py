"""The port's main path: sketch, sample, estimate, complete (Algorithm 1).

Entry points: ``core.smppca.smppca``, ``core.summary_engine.build_summary``
and ``core.estimation_engine.estimate_product``.
"""
