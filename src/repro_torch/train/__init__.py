"""repro_torch.train: the gradient-tap dense layer (``sketched_dense``).
(The JAX package's train step and trainer are not ported yet.)
"""
from repro_torch.train import sketched_dense  # noqa: F401
