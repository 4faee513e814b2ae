"""repro_torch.data: synthetic data sources (no download)."""
from repro_torch.data import pipeline  # noqa: F401
from repro_torch.data.pipeline import SyntheticLM  # noqa: F401
