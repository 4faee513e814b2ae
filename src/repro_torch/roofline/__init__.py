"""Roofline terms for the H100 (``analysis``)."""
