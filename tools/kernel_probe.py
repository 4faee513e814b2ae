"""Helpers the kernel probes share: edit a CUDA source's text into a
variant, build the variants side by side, and time a call on the card.

Used by ``tools/sketch_fused_probe.py`` and ``tools/flash_attention_probe.py``;
imports nothing that needs a card until ``build`` or ``cuda_ms`` runs.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import ops  # noqa: E402


def edit(text: str, old: str, new: str, *, source: str) -> str:
    """``text`` with ``old`` replaced by ``new``; RuntimeError naming
    ``source`` when ``old`` is no longer there."""
    if old not in text:
        raise RuntimeError(f"{source} no longer contains {old!r}")
    return text.replace(old, new)


def build(variants: dict, prefix: str) -> dict:
    """Compile each variant's source text, one ``nvcc`` each, all started
    together, into ``build/repro_torch/probe/<prefix><name>.so``; return
    the loaded libraries by name."""
    out = ops.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        src = out / f"{prefix}{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [ops._nvcc(), *ops.NVCC_FLAGS, "-o",
             str(out / f"{prefix}{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{prefix}{name}.so"))
    return libs


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
