"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref``) and their wrappers (``ops``)."""
