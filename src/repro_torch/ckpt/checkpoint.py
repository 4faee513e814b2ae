"""Checkpoints: atomic, keep-N, asynchronous if asked, placed on restore.

The port of ``repro.ckpt.checkpoint``, in its on-disk format, so that a
checkpoint written by either package restores in the other:

    <dir>/step_<n>/arrays.npz + manifest.json

written to ``step_<n>.tmp`` and renamed, so a crash mid-write never
corrupts the latest checkpoint. Each leaf of the saved tree (NamedTuples,
tuples, lists and dicts of tensors or numpy arrays; None fields are absent)
is stored under its ``jax.tree_util.keystr`` path: ``.A_acc``,
``.buckets[0].A_acc``, ``['a']``. Two leaves are stored as the JAX package
stores them:

* a key (a leaf at a field named ``key``: the port's int64 key words) is
  stored as uint32 key data, as a jax key is;
* a bfloat16 leaf is stored as its uint16 bit pattern, listed in the
  manifest's ``bf16_leaves`` and typed ``"bfloat16"`` among its ``leaves``;
  numpy needs no bfloat16 type for either direction.

``restore`` rebuilds the template's structure; each leaf takes the
template leaf's dtype and device, or goes through ``sharding_fn(path,
np_array)``, which places it (bf16 leaves reach it as their uint16 bit
patterns).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import convert


def _paths(tree, prefix=""):
    """(keystr path, leaf) of every non-None leaf, in jax's flatten order."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, sub in zip(tree._fields, tree):
            yield from _paths(sub, f"{prefix}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from _paths(sub, f"{prefix}[{i}]")
    elif isinstance(tree, dict):
        for name in sorted(tree):
            yield from _paths(tree[name], f"{prefix}[{name!r}]")
    else:
        yield prefix, tree


def _unflatten(like, leaves, prefix=""):
    """``like``'s structure with each leaf replaced by ``leaves[path]``."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(sub, leaves, f"{prefix}.{name}")
                            for name, sub in zip(like._fields, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(sub, leaves, f"{prefix}[{i}]")
                          for i, sub in enumerate(like))
    if isinstance(like, dict):
        return {name: _unflatten(like[name], leaves, f"{prefix}[{name!r}]")
                for name in like}
    return leaves[prefix]


def _host_array(path: str, leaf):
    """(numpy array as stored, is bfloat16) of one leaf."""
    if torch.is_tensor(leaf):
        arr, bf16 = convert.tensor_to_bits(leaf), leaf.dtype == torch.bfloat16
    else:
        arr = np.asarray(leaf)
        bf16 = arr.dtype.name == "bfloat16"
        if bf16:
            arr = arr.view(np.uint16)
    if path.endswith(".key") and arr.dtype == np.int64 \
            and arr.shape[-1:] == (2,):
        arr = arr.astype(np.uint32)          # the port's key words
    return arr, bf16


def _flatten(tree):
    """({path: numpy array as stored}, sorted bf16 paths): the host copy of
    ``tree``, synchronous."""
    arrays, bf16 = {}, []
    for path, leaf in _paths(tree):
        arrays[path], is_bf16 = _host_array(path, leaf)
        if is_bf16:
            bf16.append(path)
    return arrays, sorted(bf16)


def _write(ckpt_dir: str, step: int, arrays: dict, bf16: list, keep: int,
           extra: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape),
                       "dtype": "bfloat16" if k in bf16 else str(v.dtype)}
                   for k, v in arrays.items()},
        "bf16_leaves": bf16,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic publish
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Atomic checkpoint write; keeps the newest ``keep`` steps. Returns
    the final directory path."""
    arrays, bf16 = _flatten(tree)
    return _write(ckpt_dir, step, arrays, bf16, keep, extra)


def save_async(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
               extra: Optional[dict] = None) -> threading.Thread:
    """Copy the tree to host memory now, write it on a background thread
    (join the returned thread before the process exits)."""
    arrays, bf16 = _flatten(tree)            # synchronous device-to-host copy
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, arrays, bf16, keep, extra),
                         daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _like_leaf(arr: np.ndarray, bf16: bool, like) -> Any:
    """A stored array as the template leaf: its dtype and device."""
    if not torch.is_tensor(like):
        return arr
    if arr.dtype == np.uint32:               # key data into the port's words
        arr = arr.astype(np.int64)
    return convert.bits_to_tensor(arr, bf16=bf16).to(dtype=like.dtype,
                                                      device=like.device)


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            sharding_fn: Optional[Callable[[str, Any], Any]] = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors). Each leaf
    takes the template leaf's dtype and device, or ``sharding_fn(path,
    np_array) -> tensor`` places it."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    data = np.load(os.path.join(d, "arrays.npz"))
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            bf16 = set(json.load(f).get("bf16_leaves", []))
    except FileNotFoundError:
        bf16 = set()
    leaves = {}
    for key, leaf in _paths(like):
        if key not in data:
            raise ValueError(
                f"checkpoint has no leaf {key!r} — the restore template's "
                f"pytree structure does not match the saved state (e.g. a "
                f"decayed template against an undecayed checkpoint)")
        arr = data[key]
        expect = tuple(leaf.shape)
        if tuple(arr.shape) != expect:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(arr.shape)} but "
                f"the restore template expects {expect} — was this "
                f"checkpoint written with a different config?")
        if sharding_fn is not None:
            leaves[key] = sharding_fn(key, arr)
        else:
            leaves[key] = _like_leaf(arr, key in bf16, leaf)
    return _unflatten(like, leaves)


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The manifest of ``step`` (default: the newest)."""
    if step is None:
        step = latest_step(ckpt_dir)
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def save_stream_state(ckpt_dir: str, step: int, state, *, keep: int = 3,
                      extra: Optional[dict] = None,
                      wire: Optional[str] = None,
                      tol: Optional[float] = None) -> str:
    """Checkpoint a ``streaming.StreamState`` mid-pass (resumable
    ingestion): ``save`` plus a manifest record of coverage and config
    (rows_seen, row_high, k, d_total, srht or not), enough to see how far a
    pass got without loading arrays. The key and SRHT plan are saved with
    the accumulators, so a restored state keeps absorbing rows under the
    same randomness.

    ``wire`` names a ``WireSpec`` precision ("f32"/"bf16"/"int8") to write
    the compressed wire image instead of the raw accumulators; ``tol``
    instead runs the probe-measured gate (``choose_wire_spec``) and writes
    the cheapest precision whose measured error meets it. The manifest's
    ``wire`` record (spec, measured error, wire bytes) tells
    ``restore_stream_state`` to decompress.
    """
    from repro_torch.core import streaming
    if wire is not None or tol is not None:
        if tol is not None:
            spec, err = streaming.choose_wire_spec(
                state, tol, specs=(("int8", "bf16", "f32") if wire is None
                                   else (wire,)))
        else:
            spec = streaming._as_wire_spec(wire)
            err = streaming.wire_error(state, spec) \
                if state.probe_acc is not None else None
        state = streaming.compress_state(state, spec)
        meta = {
            "kind": "stream_state",
            "wire": {"spec": spec.sketch,
                     "error": None if err is None else float(err),
                     "bytes": int(streaming.wire_bytes(state))},
            "rows_seen": int(state.rows_seen),
            "row_high": int(state.row_high),
            "d_total": int(state.d_total),
            "k": int(state.A_blk.shape[0]),
            "srht": bool(state.srht),
        }
        meta.update(extra or {})
        return save(ckpt_dir, step, state, keep=keep, extra=meta)
    meta = {
        "kind": "stream_state",
        "rows_seen": int(state.rows_seen),
        "row_high": int(state.row_high),
        "d_total": int(state.d_total),
        "k": int(state.A_acc.shape[0]),
        "srht": state.signs is not None,
        "probes": (0 if state.probe_acc is None
                   else int(state.probe_acc.shape[-1])),
        "cosketch": (0 if state.cosketch_Y is None
                     else int(state.cosketch_Y.shape[-1])),
    }
    if state.decay_rate is not None:
        # the decay clock rides the manifest, so the state's logical time
        # (and pending decay) is visible without loading arrays
        meta.update(decay_rate=float(state.decay_rate),
                    t_state=int(state.t_state), t_data=int(state.t_data))
    meta.update(extra or {})
    return save(ckpt_dir, step, state, keep=keep, extra=meta)


def restore_stream_state(ckpt_dir: str, like, step: Optional[int] = None):
    """Restore a ``StreamState`` saved by ``save_stream_state``.

    ``like`` is a matching state, in practice ``summarizer.init(key,
    shapes)`` with the configuration the pass started from (its key and
    plan are overwritten by the saved ones). Resuming, then finalizing, is
    bit-identical to the uninterrupted pass. A checkpoint written with
    ``wire=`` or ``tol=`` is recognized by its manifest's ``wire`` record:
    the template is compressed to the recorded spec, restored leaf for
    leaf, then decompressed (f32 wire checkpoints round-trip bit for bit).
    """
    manifest = read_manifest(ckpt_dir, step=step)
    wire_meta = manifest.get("extra", {}).get("wire")
    if wire_meta is not None:
        from repro_torch.core import streaming
        template = streaming.compress_state(
            like, streaming.WireSpec(wire_meta["spec"]))
        return streaming.decompress_state(
            restore(ckpt_dir, template, step=step))
    return restore(ckpt_dir, like, step=step)


def save_window_state(ckpt_dir: str, step: int, wstate, *, keep: int = 3,
                      extra: Optional[dict] = None) -> str:
    """Checkpoint a ``streaming.WindowState`` (the whole ring at once), with
    the ring's geometry in the manifest: ``head`` (the newest live epoch),
    ``n_buckets``, the ring index ``head % n_buckets`` and each bucket's
    coverage. Restoring resumes the window bit for bit."""
    from repro_torch.core.streaming import WindowState
    if not isinstance(wstate, WindowState):
        raise ValueError(
            f"save_window_state needs a streaming.WindowState, got "
            f"{type(wstate).__name__} (use save_stream_state for a plain "
            f"StreamState)")
    meta = {
        "kind": "window_state",
        "head": int(wstate.head),
        "n_buckets": wstate.n_buckets,
        "ring_index": int(wstate.head) % wstate.n_buckets,
        "bucket_rows_seen": [int(b.rows_seen) for b in wstate.buckets],
        "k": int(wstate.buckets[0].A_acc.shape[0]),
        "d_total": int(wstate.buckets[0].d_total),
    }
    meta.update(extra or {})
    return save(ckpt_dir, step, wstate, keep=keep, extra=meta)


def restore_window_state(ckpt_dir: str, like, step: Optional[int] = None):
    """Restore a ``WindowState`` saved by ``save_window_state``; ``like``
    is a matching window (``WindowedSummarizer(...).init(key, shapes)``,
    the same ``n_buckets``: rings are not resized on restore)."""
    manifest = read_manifest(ckpt_dir, step=step)
    saved = manifest.get("extra", {}).get("n_buckets")
    have = len(like.buckets)
    if saved is not None and saved != have:
        raise ValueError(
            f"checkpoint was written with n_buckets={saved} but the restore "
            f"template has {have} buckets — window rings cannot be resized "
            f"on restore")
    return restore(ckpt_dir, like, step=step)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
