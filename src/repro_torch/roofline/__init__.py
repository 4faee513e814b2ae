"""Roofline terms for the H100 (``analysis``) and the per-device counts of a
traced step that feed them (``trace_analyzer``)."""
