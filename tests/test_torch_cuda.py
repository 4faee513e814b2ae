"""The port's CUDA kernels on the card: each against its plain version, the
launch counters, and the slice on the card against the slice on the CPU.

These tests need a CUDA card and skip without one; on a machine with a card
run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared tests/conftest.py imports jax, which a
machine set up for the port need not have.)
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core.smppca import smppca
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

# float32 sums over d in another order: sketch entries within 1e-5 of the
# largest entry at these small d, norms 1e-5 relative; Eq. 2 values within
# 1e-5 of their nA * nB scale.
RTOL = 1e-5


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d,n", [(512, 2048, 1024), (33, 517, 259),
                                   (1, 1, 1), (130, 16, 129)])
def test_sketch_fused_kernel_matches_plain(card, k, d, n, dtype):
    gen = torch.Generator(device=card).manual_seed(k + d + n)
    Pi = torch.randn(k, d, generator=gen, device=card).to(dtype)
    A = torch.randn(d, n, generator=gen, device=card).to(dtype)
    before = ops.LAUNCHES["sketch_fused"]
    out, norm = ops.sketch_fused(Pi, A)
    assert ops.LAUNCHES["sketch_fused"] == before + 1
    ref, ref_norm2 = ops.KERNELS["sketch_fused"].plain(Pi, A)
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=RTOL * float(ref.abs().max()))
    torch.testing.assert_close(norm ** 2, ref_norm2, rtol=RTOL, atol=0)


def test_sampled_dot_kernel_matches_plain(card):
    gen = torch.Generator(device=card).manual_seed(0)
    n1, n2, k, m = 3000, 2000, 512, 100_000
    As = torch.randn(n1, k, generator=gen, device=card)
    Bs = torch.randn(n2, k, generator=gen, device=card)
    na = torch.rand(n1, generator=gen, device=card) + 0.5
    nb = torch.rand(n2, generator=gen, device=card) + 0.5
    rows = torch.randint(0, n1, (m,), generator=gen, device=card,
                         dtype=torch.int32)
    cols = torch.randint(0, n2, (m,), generator=gen, device=card,
                         dtype=torch.int32)
    rows[:100], cols[:100] = rows[0], cols[0]          # duplicates
    before = ops.LAUNCHES["sampled_rescaled_dot"]
    out = ops.sampled_rescaled_dot(As, Bs, na, nb, rows, cols)
    assert ops.LAUNCHES["sampled_rescaled_dot"] == before + 1
    ref = ops.KERNELS["sampled_rescaled_dot"].plain(As, Bs, na, nb, rows,
                                                    cols)
    scale = na[rows.long()] * nb[cols.long()]
    assert float(((out - ref).abs() / scale).max()) < RTOL
    assert bool((out[:100] == out[0]).all())

    empty = rows[:0]
    assert ops.sampled_rescaled_dot(As, Bs, na, nb, empty, empty).shape == (0,)
    assert ops.LAUNCHES["sampled_rescaled_dot"] == before + 1   # no launch
    with pytest.raises(IndexError):
        ops.sampled_rescaled_dot(As, Bs, na, nb, rows + n1, cols)
    with pytest.raises(TypeError):
        ops.sampled_rescaled_dot(As, Bs, na, nb, rows.long(), cols.long())


def test_smppca_on_the_card_matches_the_cpu(card):
    rng = np.random.default_rng(0)
    d, n, r = 2000, 200, 5
    D = (1.0 / np.arange(1.0, n + 1.0)).astype(np.float32)
    A = torch.from_numpy(rng.standard_normal((d, n)).astype(np.float32) * D)
    B = A + 0.3 * torch.from_numpy(
        rng.standard_normal((d, n)).astype(np.float32) * D)
    m = int(10 * n * r * np.log(n))
    ops.reset_launch_counts()
    on_card = smppca(prng.PRNGKey(0), A, B, r=r, k=512, m=m, T=8)
    assert ops.LAUNCHES == {"sketch_fused": 2, "sampled_rescaled_dot": 1}
    on_cpu = smppca(prng.PRNGKey(0), A, B, r=r, k=512, m=m, T=8,
                    device="cpu")
    got = (on_card.factors.U @ on_card.factors.V.T).cpu()
    want = on_cpu.factors.U @ on_cpu.factors.V.T
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        < 1e-3
