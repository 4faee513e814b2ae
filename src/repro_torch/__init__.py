"""SMP-PCA in PyTorch, with hand-written CUDA kernels for Hopper.

The port of ``repro`` (JAX/Pallas), module for module: ``repro_torch.core``
mirrors ``repro.core`` and ``repro_torch.kernels`` mirrors
``repro.kernels``. It imports no JAX; ``repro_torch.convert`` carries state
between the two packages as numpy arrays.
"""
