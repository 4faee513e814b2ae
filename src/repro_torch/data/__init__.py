"""repro_torch.data: synthetic data sources (numpy, no download)."""
from repro_torch.data import pipeline  # noqa: F401
