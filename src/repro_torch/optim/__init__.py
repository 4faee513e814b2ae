"""repro_torch.optim: SMP-PCA gradient compression (``grad_compression``).
(The JAX package's AdamW and schedules serve the trainer, not ported yet.)
"""
from repro_torch.optim import grad_compression  # noqa: F401
