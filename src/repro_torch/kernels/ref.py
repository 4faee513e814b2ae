"""Plain PyTorch versions of the kernels: what each kernel must compute.

``kernels/ops.py`` runs these for tensors on the CPU; ``chip_smoke.py``
holds each CUDA kernel against them on the card. They mirror
``repro.kernels.ref``.
"""
from __future__ import annotations

import torch

_EPS = 1e-12

# Samples gathered per step by the plain sampled dot: (2**20, k) float32 rows
# are 2 GiB at k = 512, where a single gather of all m rows would not fit.
_SAMPLE_CHUNK = 1 << 20


def sketch_fused_ref(Pi: torch.Tensor, A: torch.Tensor):
    """(Pi @ A, squared column norms of A), both float32."""
    out = Pi.float() @ A.float()
    norm2 = torch.linalg.vector_norm(A.float(), dim=0) ** 2
    return out, norm2


def sampled_rescaled_dot_ref(As_rows: torch.Tensor, Bs_rows: torch.Tensor,
                             norm_A: torch.Tensor, norm_B: torch.Tensor,
                             rows: torch.Tensor, cols: torch.Tensor
                             ) -> torch.Tensor:
    """Eq. 2 at (rows, cols) from row-major sketches (n1, k) and (n2, k):
    ``na[r] nb[c] <As[r], Bs[c]> / max(|As[r]| |Bs[c]|, 1e-12)``."""
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=rows.device)
    for s in range(0, rows.shape[0], _SAMPLE_CHUNK):
        r, c = rows[s:s + _SAMPLE_CHUNK], cols[s:s + _SAMPLE_CHUNK]
        a = As_rows[r].float()                  # (chunk, k)
        b = Bs_rows[c].float()
        dots = torch.sum(a * b, dim=1)
        sa = torch.linalg.vector_norm(a, dim=1)
        sb = torch.linalg.vector_norm(b, dim=1)
        out[s:s + _SAMPLE_CHUNK] = (dots * norm_A[r] * norm_B[c]
                                    / torch.clamp(sa * sb, min=_EPS))
    return out
