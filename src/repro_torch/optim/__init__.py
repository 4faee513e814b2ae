"""repro_torch.optim: AdamW, the learning-rate schedules and SMP-PCA
gradient compression (``grad_compression``)."""
from repro_torch.optim import grad_compression  # noqa: F401
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm  # noqa: F401
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: F401
