"""The SVD every factorization and spectral norm of the port goes through,
and its float32 square root.

``torch.sqrt`` of float32 on the CPU is not correctly rounded: it rounded
6,623 of 2**20 inputs drawn uniformly from [0, 100) an ulp away from
``numpy.sqrt`` and ``jnp.sqrt`` (XLA's root is exact), so the port's
column norms, AdamW's ``sqrt(v_hat)`` and the rest moved a last bit away
from the JAX package's.
``sqrt_f32`` takes the root in float64 there and rounds it once to
float32, which is exact (a float64 root rounded to float32 is the
correctly rounded float32 root); on the card ``torch.sqrt`` is already
exact and is what it calls.

On CUDA tensors ``torch.linalg.svd`` picks cuSOLVER's Jacobi routine
(``gesvdj``) by default, which is less exact: on a 200 x 200 float32 matrix
with a 1/i spectrum it gave singular values 1.1e-5 (of the largest) away
from float64's on an NVIDIA H100, where the QR-based ``gesvd`` gave 1.2e-7
and the CPU 1.4e-7. The error gate's curve and the refined and completed
factors read those values, so the port asks for ``gesvd`` on the card.
"""
from __future__ import annotations

import torch


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor, as
    ``jnp.sqrt`` gives it: through float64 on the CPU, ``torch.sqrt``
    elsewhere (and for other dtypes)."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def svd(M: torch.Tensor):
    """``torch.linalg.svd(M, full_matrices=False)``: (U, s, Vh), through
    cuSOLVER's ``gesvd`` when M is on a CUDA device."""
    if M.is_cuda:
        return torch.linalg.svd(M, full_matrices=False, driver="gesvd")
    return torch.linalg.svd(M, full_matrices=False)


def spectral_norm(M: torch.Tensor) -> torch.Tensor:
    """The largest singular value of M (a 0-d tensor), through cuSOLVER's
    ``gesvd`` when M is on a CUDA device; on the CPU
    ``torch.linalg.matrix_norm(M, ord=2)``."""
    if M.is_cuda:
        return torch.linalg.svdvals(M, driver="gesvd").amax(dim=-1)
    return torch.linalg.matrix_norm(M, ord=2)
