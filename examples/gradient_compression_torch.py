"""Ablation over the PyTorch port: SMP-PCA gradient compression in real
training loops.

Trains the same tiny LM three ways -- uncompressed, paper tap-path
(single-pass X/dY sketches on MLP matmuls), and the A=I grads-level
baseline with error feedback -- and prints the loss trajectories.

    PYTHONPATH=src python examples/gradient_compression_torch.py --steps 60
    PYTHONPATH=src python examples/gradient_compression_torch.py --device cpu

The twin of examples/gradient_compression.py on ``repro_torch``: the same
model, data, optimizer and steps. On the card the taps' sketches run through
the ``sketch_fused`` kernel and their completion through
``sampled_rescaled_dot``. ``--device`` is "cuda" by default and raises
without a card.
"""
import argparse
import dataclasses

from repro_torch import device as _device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import build
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import TrainConfig, Trainer, TrainerConfig


def run(compression: str, steps: int, device="cuda") -> list:
    dev = _device.resolve(device)
    cfg = dataclasses.replace(
        get_config("phi3-mini-3.8b").reduced(),
        d_model=128, d_ff=256, head_dim=32,
        sketched_mlp=(compression == "taps"))
    model = build(cfg, device=dev)
    data = SyntheticLM(vocab_size=cfg.vocab_size, batch_size=8, seq_len=64,
                       device=str(dev))
    opt = AdamW(lr=warmup_cosine(3e-3, 5, steps), weight_decay=0.01)
    trainer = Trainer(model.loss, opt, data,
                      TrainConfig(microbatches=1, compression=compression),
                      TrainerConfig(num_steps=steps, log_every=10_000),
                      init_params_fn=model.init_params)
    trainer.run()
    return [h["loss"] for h in trainer.metrics_history]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    curves = {}
    for mode in ("none", "taps", "lowrank"):
        curves[mode] = run(mode, args.steps, args.device)
        print(f"{mode:8s} first={curves[mode][0]:.3f} "
              f"last={curves[mode][-1]:.3f}")
    base = curves["none"][-1]
    print(f"\nfinal-loss ratio vs uncompressed: "
          f"taps={curves['taps'][-1]/base:.3f} "
          f"lowrank={curves['lowrank'][-1]/base:.3f}")
    return curves


if __name__ == "__main__":
    main()
