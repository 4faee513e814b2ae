"""Process-global mesh registry.

The port of ``repro.dist.meshctx``. Model code stays mesh-agnostic: launch
code calls ``set_mesh`` once with a ``DeviceMesh`` and optional
activation-sharding constraints (``models.transformer.constrain_act``)
look it up here, getting None (a no-op) when nothing is registered, as in
every single-device run.
"""
from __future__ import annotations


_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def clear_mesh() -> None:
    global _MESH
    _MESH = None
