"""Plain PyTorch versions of the kernels: what each kernel must compute.

``kernels/ops.py`` runs these for tensors on the CPU; ``chip_smoke.py``
holds each CUDA kernel against them on the card. They mirror
``repro.kernels.ref``.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12

# Samples gathered per step by the plain sampled dot: (2**20, k) float32 rows
# are 2 GiB at k = 512, where a single gather of all m rows would not fit.
_SAMPLE_CHUNK = 1 << 20

# Scores formed per step by the plain attention: 2**26 float32 (256 MiB),
# 2,048 query rows at S = 32,768, where one head's (S, S) scores would take
# 4 GiB and all 32 heads' 137 GB.
_SCORE_CHUNK = 1 << 26


def sketch_fused_ref(Pi: torch.Tensor, A: torch.Tensor):
    """(Pi @ A, squared column norms of A), both float32."""
    out = Pi.float() @ A.float()
    norm2 = torch.linalg.vector_norm(A.float(), dim=0) ** 2
    return out, norm2


def blocked_fwht_ref(X: torch.Tensor, signs: torch.Tensor,
                     d_pad: int | None = None) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform of the sign-flipped input,
    ``H (signs * X)`` in float32, by the plain butterfly. X (d, n), signs
    (d,); with ``d_pad`` the rows d..d_pad-1 are zero (the transform has
    length d_pad)."""
    from repro_torch.core.sketch import fwht
    Xs = X.float() * signs[:, None].float()
    if d_pad is not None and d_pad != X.shape[0]:
        Xs = torch.nn.functional.pad(Xs, (0, 0, 0, d_pad - X.shape[0]))
    return fwht(Xs, axis=0)


def srht_block_ref(X: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
                   d_pad: int):
    """The SRHT pass's work on one column block, as the composition of
    plain operations: ``(H (signs * X))[rows] / sqrt(d_pad) * sqrt(d_pad /
    k)`` (each square root rounded to float32, two float32 roundings) and
    X's column norms accumulated in float32. Returns ((k, n), (n,))."""
    from repro_torch.core.sketch import _sqrt_f32, column_norms
    k = rows.shape[0]
    HX = blocked_fwht_ref(X, signs, d_pad)
    root_dp = _sqrt_f32(d_pad).to(X.device)
    root_dp_k = _sqrt_f32(d_pad / k).to(X.device)
    return (HX[rows.long()] / root_dp) * root_dp_k, column_norms(X)


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Naive softmax attention over folded heads, q/k/v (BH, S, Dh): float32
    scores ``q k^T / sqrt(Dh)``, keys after the query masked to -1e30 when
    ``causal``, softmax, then the product with v; the output in q's dtype.
    Every query row is independent, so the rows go in chunks of at most
    ``_SCORE_CHUNK`` scores: the same numbers at any S, in bounded memory."""
    BH, S, Dh = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rows = max(1, min(S, _SCORE_CHUNK // max(S, 1)))
    pos = torch.arange(S, device=q.device)
    for b in range(BH):
        kb, vb = k[b].float(), v[b].float()
        for r0 in range(0, S, rows):
            s = q[b, r0:r0 + rows].float() @ kb.T / math.sqrt(Dh)
            if causal:
                keep = pos[r0:r0 + rows, None] >= pos[None, :]
                s = torch.where(keep, s, torch.full_like(s, -1e30))
            out[b, r0:r0 + rows] = (torch.softmax(s, dim=-1) @ vb).to(q.dtype)
    return out
