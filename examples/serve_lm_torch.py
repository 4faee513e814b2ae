"""Batched serving over the PyTorch port: prefill + decode with
preallocated caches.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch recurrentgemma-9b
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --sketch-demo
(reduced configs; any of the 10 assigned archs works)

The twin of examples/serve_lm.py on ``repro_torch``: the same configs, key,
prompts and sampling. On the card the prefill's causal, unwindowed
self-attentions run on the ``flash_attention`` kernel at the reduced
configs' head width, 16 (recurrentgemma's windowed attention takes the
plain route). The same serve layer also hosts sketch serving
(``SketchService``): ``--sketch-demo`` streams row chunks into a session
(on the card through ``sketch_fused``) and asks it for factors (through
``sampled_rescaled_dot``). ``--device`` is "cuda" by default and raises
without a card.
"""
import argparse

from repro_torch import prng
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.serve import prompt_batch
from repro_torch.models import build
from repro_torch.serve.engine import Engine, ServeConfig, SketchService


def sketch_demo(key, device):
    """A client streams row chunks of an (A, B) pair over time and asks the
    live accumulator for the top-r factors of A^T B. Returns (rows seen,
    the served estimate)."""
    svc = SketchService(k=64, backend="scan", block=256, device=device)
    d, n = 2048, 96
    A = prng.normal(key, (d, n))
    B = prng.normal(prng.fold_in(key, 1), (d, n))
    sid = svc.open_stream(key, d, n, n)
    for off in range(0, d, 256):
        svc.append(sid, A[off:off + 256], B[off:off + 256])
    est = svc.stream_factors(sid, r=4)
    return int(svc.close_stream(sid).rows_seen), est


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--sketch-demo", action="store_true",
                    help="also run a SketchService streaming session")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = build(cfg, device=args.device)
    key = prng.PRNGKey(0, device=model.device)
    params = model.init_params(key)
    # randint(key, (batch, prompt_len), 0, vocab) and zero stub-frontend
    # inputs, on the model's device
    batch = prompt_batch(model, args.batch, args.prompt_len, seed=0)

    eng = Engine(model, params, ServeConfig(max_new_tokens=args.new_tokens,
                                            temperature=args.temperature))
    out = eng.generate(batch)
    print(f"arch={cfg.name} generated {tuple(out.shape)} tokens")
    print("row 0:", out[0, args.prompt_len:].tolist())

    rows = est = None
    if args.sketch_demo:
        rows, est = sketch_demo(key, model.device)
        print(f"sketch session: {rows} rows -> factors "
              f"U{tuple(est.factors.U.shape)} V{tuple(est.factors.V.shape)}")
    return {"tokens": out, "sketch_rows": rows, "sketch": est}


if __name__ == "__main__":
    main()
