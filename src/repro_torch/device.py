"""Where the port's entry points run.

Every entry point takes ``device=``, "cuda" by default. Without a card the
default raises: nothing moves to the CPU unless the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch sees no CUDA device; pass "
            f"device='cpu' to run on the CPU")
    return dev
