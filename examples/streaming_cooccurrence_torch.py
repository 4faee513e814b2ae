"""The paper's co-occurrence use case over the PyTorch port: the top
components of a query x ad interaction matrix from a stream of rows
arriving in ARBITRARY order, without ever storing the data.

    PYTHONPATH=src python examples/streaming_cooccurrence_torch.py
    PYTHONPATH=src python examples/streaming_cooccurrence_torch.py --device cpu

The twin of examples/streaming_cooccurrence.py on ``repro_torch``: the same
sizes, seeds and numpy stream. ``core.StreamingSummarizer`` absorbs chunks
with ``update_rows`` (explicit global row ids), the pass is checkpointed
mid-stream and resumed, and partial states merge associatively
(``core.merge_states`` / ``core.tree_merge``). On the card each chunk's
sketches and norms come from the ``sketch_fused`` kernel and the sampled
entries from ``sampled_rescaled_dot``. ``--device`` is "cuda" by default
and raises without a card.
"""
import argparse
import math
import tempfile

import numpy as np
import torch

from repro_torch import core, prng
from repro_torch import device as _device
from repro_torch.ckpt import checkpoint
from repro_torch.data.pipeline import cooccurrence_stream


def stream(key, d, n1, n2, rank, k, chunk, ckpt_dir, device):
    """One pass over a shuffled stream of (user row) observations, with a
    checkpoint half way that the pass resumes from. Each chunk's
    contribution depends only on (key, global row ids), so arrival order
    is irrelevant and partial states merge exactly
    (``StreamingSummarizer(k, method="srht")`` streams SRHT the same way).
    Returns (summary, rows seen, (saved state, restored state))."""
    summ = core.StreamingSummarizer(k=k, device=device)
    state = summ.init(key, (d, n1, n2))
    rows_seen, checkpointed = 0, None
    for row_ids, A_rows, B_rows in cooccurrence_stream(
            seed=0, d=d, n1=n1, n2=n2, rank=rank, chunk=chunk):
        state = summ.update_rows(state, torch.from_numpy(row_ids),
                                 torch.from_numpy(A_rows),
                                 torch.from_numpy(B_rows))
        rows_seen += len(row_ids)
        if rows_seen == d // 2:
            # mid-pass checkpoint: a crashed ingestion job resumes here
            checkpoint.save_stream_state(ckpt_dir, step=rows_seen,
                                         state=state)
            saved, state = state, checkpoint.restore_stream_state(
                ckpt_dir, like=summ.init(key, (d, n1, n2)))
            checkpointed = (saved, state)
            print(f"checkpointed + restored at {int(state.rows_seen)} rows")
    return summ.finalize(state), rows_seen, checkpointed


def ground_truth(d, n1, n2, rank, device):
    """The stream's A and B, for evaluation only (a real deployment never
    materializes them): the numpy draws of ``cooccurrence_stream``."""
    rng = np.random.default_rng(0)
    UA = rng.normal(size=(d, rank)) / np.sqrt(rank)
    VA = rng.normal(size=(rank, n1))
    UB = 0.5 * UA + 0.5 * rng.normal(size=(d, rank)) / np.sqrt(rank)
    VB = rng.normal(size=(rank, n2))
    A = UA @ VA + 0.1 * rng.normal(size=(d, n1))
    B = UB @ VB + 0.1 * rng.normal(size=(d, n2))
    return (torch.from_numpy(A.astype(np.float32)).to(device),
            torch.from_numpy(B.astype(np.float32)).to(device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    key = prng.PRNGKey(0, device=dev)
    d, n1, n2, rank = 8192, 300, 200, 4

    summary, rows_seen, checkpointed = stream(
        key, d, n1, n2, rank, k=192, chunk=1024,
        ckpt_dir=tempfile.mkdtemp(prefix="smppca_stream_"), device=dev)
    print(f"streamed {rows_seen} rows in arbitrary order; "
          f"summary: sketches {tuple(summary.A_sketch.shape)}/"
          f"{tuple(summary.B_sketch.shape)} "
          f"+ {n1 + n2} norms (vs {d * (n1 + n2)} raw values)")

    # steps 2-3 on the summary only
    m = int(10 * max(n1, n2) * rank * math.log(max(n1, n2)))
    res = core.smppca_from_summary(key, summary, r=rank, m=m, T=8,
                                   device=dev)

    A, B = ground_truth(d, n1, n2, rank, dev)
    err, opt = core.spectral_error_vs_optimal(A, B, rank, res.factors)
    print(f"spectral error {float(err):.4f} "
          f"(optimal rank-{rank}: {float(opt):.4f})")
    return {"summary": summary, "checkpointed": checkpointed,
            "result": res, "err": float(err), "opt": float(opt)}


if __name__ == "__main__":
    main()
