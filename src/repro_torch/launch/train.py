"""End-to-end training driver: the port of ``repro.launch.train``, with
``--device`` (the card by default).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --reduced --steps 100 --batch 8 --seq 128 --compression taps \\
        --device cpu

It prints one JSON line: the first and last step's loss, the steps taken
and the straggler steps.
"""
from __future__ import annotations

import argparse
import json
import logging

from repro_torch import device as _device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import build
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.optim.grad_compression import CompressionConfig
from repro_torch.train import TrainConfig, Trainer, TrainerConfig
from repro_torch.train.sketched_dense import TapConfig


def make_trainer(args) -> Trainer:
    """The ``Trainer`` the command line describes."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = _device.resolve(args.device)
    model = build(cfg, device=dev)
    data = SyntheticLM(vocab_size=cfg.vocab_size, batch_size=args.batch,
                       seq_len=args.seq, seed=0, device=str(dev))
    opt = AdamW(lr=warmup_cosine(args.lr, max(args.steps // 10, 1),
                                 args.steps), weight_decay=0.01)
    tcfg = TrainConfig(microbatches=args.microbatches,
                       compression=args.compression,
                       comp_cfg=CompressionConfig(), tap_cfg=TapConfig())
    return Trainer(model.loss, opt, data, tcfg,
                   TrainerConfig(num_steps=args.steps, ckpt_dir=args.ckpt_dir,
                                 log_every=args.log_every),
                   init_params_fn=model.init_params)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "taps", "lowrank"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    trainer = make_trainer(args)
    state = trainer.run()
    hist = trainer.metrics_history
    print(json.dumps({"first_loss": hist[0]["loss"],
                      "last_loss": hist[-1]["loss"],
                      "steps": int(state.step),
                      "stragglers": trainer.straggler_events}))


if __name__ == "__main__":
    main()
