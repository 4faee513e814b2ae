"""Assigned input-shape suites (one set, shared by all 10 LM-family archs).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache / recurrent state of ``seq_len``), NOT ``train_step``; ``prefill_*``
lowers the cache-building forward. ``long_500k`` requires sub-quadratic
attention and only runs for hybrid/ssm archs (DESIGN.md §6)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_applicable(arch_family: str, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape_name == "long_500k" and arch_family not in ("hybrid", "ssm"):
        return False, ("full quadratic attention at 524288 ctx "
                       "(skip per assignment; sub-quadratic archs only)")
    return True, ""
