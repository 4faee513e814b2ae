"""Quickstart over the PyTorch port: single-pass PCA of a matrix product.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of examples/quickstart.py on ``repro_torch``: the same sizes, key
and calls, drawn with ``repro_torch.prng`` (the JAX package's key tree).
``--device`` is "cuda" by default and raises without a card.

Choosing a summary backend
--------------------------
Step 1 (the one pass over A, B) goes through
``core.build_summary(key, A, B, k, method=..., backend=...)``; every
backend gives the same summary for the same key:

* ``reference`` -- materialize the (k, d) operator, one dense matmul.
* ``scan``      -- stream row blocks, regenerating each block's operator
      slice on the fly (the operator never exists).
* ``rows``      -- rows arrive as (global index, A row, B row) chunks in
      any order.
* ``cuda``      -- the hand-written Hopper kernels (sketch and norms in one
      read; SRHT through the blocked FWHT), where the JAX package has
      ``pallas``; on CPU tensors their plain versions run.
* ``distributed`` -- rows sharded over a process group.

Choosing an estimation method (steps 2-3)
-----------------------------------------
``core.estimate_product(key, summary, r, method=..., backend=...)`` with
``method`` in {'rescaled_jl' (the paper), 'direct_svd', 'lela_waltmin'} and
``backend`` in {'reference' (plain PyTorch), 'cuda' (the sampled-dot gather
kernel; the JAX package's 'jit' and 'pallas')}.
"""
import argparse
import math

import torch

from repro_torch import core, prng
from repro_torch import device as _device


def make_pair(key, d, n, device):
    """Two tall (d, n) matrices whose columns decay as 1/i, B = A + noise.
    ``@ diag(1/i)`` in the original is this column scaling exactly."""
    key = key.to(device)
    D = 1.0 / torch.arange(1.0, n + 1.0, device=device)
    A = prng.normal(key, (d, n)) * D
    B = A + 0.3 * prng.normal(prng.fold_in(key, 1), (d, n)) * D
    return A, B


def run(A, B, key, r, k, m, T, backend, device):
    """The original's calls and lines; returns what it prints."""
    key = key.to(device)
    # one pass: sketches + column norms; then sample, estimate, complete.
    # backend="scan" streams row blocks (swap in "reference", "cuda", ...
    # freely: same key -> same summary)
    result = core.smppca(key, A, B, r=r, k=k, m=m, T=T, backend=backend,
                         device=device)

    # smppca is exactly the two engines composed: sketch once, estimate
    # later (or many times, with different methods, from the same summary)
    summary = core.build_summary(key, A, B, k, backend=backend, device=device)
    print(f"summary: sketches {tuple(summary.A_sketch.shape)} + "
          f"{summary.n1 + summary.n2} norms")
    est = core.estimate_product(
        prng.fold_in(key, 2), summary, r,
        method="rescaled_jl",            # or "direct_svd" / "lela_waltmin"
        backend="cuda",                  # or "reference"
        m=m, T=T, device=device)
    print(f"estimate_product factors: U {tuple(est.factors.U.shape)}, "
          f"V {tuple(est.factors.V.shape)}")

    err, opt = core.spectral_error_vs_optimal(A, B, r, result.factors)
    print(f"SMP-PCA spectral error : {float(err):.4f}")
    print(f"optimal rank-{r} error   : {float(opt):.4f}")
    print(f"factors: U {tuple(result.factors.U.shape)}, "
          f"V {tuple(result.factors.V.shape)}")

    # compare with the naive one-pass baseline the paper beats
    sf = core.sketch_svd(key, A, B, r=r, k=k, device=device)
    err_svd, _ = core.spectral_error_vs_optimal(A, B, r, sf)
    print(f"SVD(sketch) error      : {float(err_svd):.4f}  "
          f"(paper Fig 3b: SMP-PCA wins)")
    return {"summary": summary, "estimate": est, "result": result,
            "err": float(err), "opt": float(opt), "err_svd": float(err_svd)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    key = prng.PRNGKey(0)
    # two tall matrices whose product A^T B we want the top-5 components of
    d, n, r = 20_000, 400, 5
    A, B = make_pair(key, d, n, dev)
    return run(A, B, key, r=r,
               k=256,                              # sketch size (Thm 3.1)
               m=int(10 * n * r * math.log(n)),    # samples (Fig 4a)
               T=8,                                # WAltMin iterations
               backend="scan", device=dev)


if __name__ == "__main__":
    main()
