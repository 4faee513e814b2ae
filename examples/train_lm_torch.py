"""End-to-end LM training driver over the PyTorch port, with SMP-PCA
gradient compression.

Default: a ~20M-param phi3-family model for 300 steps. ``--preset 100m``
selects a ~100M config (same code path). ``--compression taps`` turns on
the paper's single-pass gradient sketches on every MLP matmul.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --compression taps --steps 100
    PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu

The twin of examples/train_lm.py on ``repro_torch``: the same presets,
schedule, microbatches and checkpoints (in the JAX package's layout).
Checkpoints go to repro_torch_train_lm in the temporary directory
(/tmp/repro_torch_train_lm unless TMPDIR says otherwise), not the
original's directory: a run would otherwise resume from the other
package's checkpoint. A run resumes from the latest checkpoint there; one
that would resume at or past ``--steps`` stops and says so. ``--device``
is "cuda" by default and raises without a card.
"""
import argparse
import dataclasses
import json
import logging
import os
import tempfile

from repro_torch import device as _device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import build
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import TrainConfig, Trainer, TrainerConfig

PRESETS = {
    # (d_model, heads, kv, d_ff, layers, batch, seq) -- ~params
    "20m": (256, 8, 8, 1024, 8, 8, 128),
    "100m": (512, 8, 8, 2048, 12, 8, 256),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compression", default="none",
                    choices=["none", "taps", "lowrank"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    dev = _device.resolve(args.device)
    d, h, kv, ff, L, batch, seq = PRESETS[args.preset]
    cfg = dataclasses.replace(
        get_config("phi3-mini-3.8b"),
        d_model=d, n_heads=h, n_kv_heads=kv, head_dim=d // h, d_ff=ff,
        groups=((("attn",), L),), n_layers=L, vocab_size=8192,
        loss_chunk=seq, remat=False,
        sketched_mlp=(args.compression == "taps"))
    model = build(cfg, device=dev)
    print(f"model: {cfg.n_params()/1e6:.1f}M params, compression="
          f"{args.compression}")

    data = SyntheticLM(vocab_size=cfg.vocab_size, batch_size=batch,
                       seq_len=seq, seed=0, device=str(dev))
    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10, args.steps),
                weight_decay=0.01)
    tcfg = TrainConfig(microbatches=2, compression=args.compression)
    trainer = Trainer(model.loss, opt, data, tcfg,
                      TrainerConfig(num_steps=args.steps,
                                    ckpt_dir=args.ckpt_dir,
                                    ckpt_every=100, log_every=20),
                      init_params_fn=model.init_params)
    state = trainer.run()
    if not trainer.metrics_history:
        raise SystemExit(f"{args.ckpt_dir} holds step {int(state.step)}, at "
                         f"or past --steps {args.steps}: nothing to train; "
                         f"pass another --ckpt-dir")
    h0 = trainer.metrics_history[0]
    h1 = trainer.metrics_history[-1]
    out = {"steps": int(state.step),
           "loss_first": round(h0["loss"], 4),
           "loss_last": round(h1["loss"], 4)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
