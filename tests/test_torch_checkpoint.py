"""The port's checkpoint module against the JAX package's: the on-disk
format (leaf paths, uint32 keys, int32 counters, bf16 as uint16 bit
patterns, the manifest), checkpoints crossing in both directions (plain,
decayed, wire-compressed and window), resumed passes bit for bit, and the
raise paths. The JAX package's ``restore_stream_state`` and
``restore_window_state`` read the port's checkpoints as they are.

Inputs are made with numpy from a seed; every jax call runs under the
classic key tree (``jax.threefry_partitionable(False)``).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jax_checkpoint
from repro.core import streaming as jax_streaming
from repro_torch import convert, prng
from repro_torch.ckpt import checkpoint
from repro_torch.core import streaming
from repro_torch.core.streaming import StreamingSummarizer, WindowedSummarizer

D, N1, N2 = 192, 11, 7


def pair(seed, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, N1)).astype(np.float32),
            rng.standard_normal((d, N2)).astype(np.float32))


def t(x):
    return torch.from_numpy(x)


def assert_states_bit_equal(a, b):
    assert type(a) is type(b)
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if x is None:
            continue
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                assert_states_bit_equal(u, v)
            continue
        assert x.dtype == y.dtype and x.device == y.device, name
        assert torch.equal(x, y), name


def assert_leaves_equal(port_np, jax_state):
    """A port state as numpy (convert) against a JAX state: every leaf
    present on both sides, same dtype and shape, equal bit for bit."""
    flat = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}
    got = dict(checkpoint._paths(port_np))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = np.asarray(got[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def jax_state(method="gaussian", decay=1.0, probes=2, cosketch=2, rows=96,
              dt=2, seed=1):
    A, B = pair(seed)
    with jax.threefry_partitionable(False):
        summ = jax_streaming.StreamingSummarizer(
            8, method=method, probes=probes, cosketch=cosketch, decay=decay)
        st = summ.init(jax.random.PRNGKey(seed), (D, N1, N2))
        st = summ.update(st, jnp.asarray(A[:rows]), jnp.asarray(B[:rows]), 0)
        return summ, summ.advance(st, dt)


def port_summ(method="gaussian", decay=1.0, probes=2, cosketch=2):
    return StreamingSummarizer(8, method=method, probes=probes,
                               cosketch=cosketch, decay=decay, device="cpu")


def to_port(state):
    return convert.stream_state_from_numpy(
        [None if x is None else np.asarray(x) for x in state])


CASES = [("gaussian", 1.0), ("srht", 1.0), ("gaussian", 0.9), ("srht", 0.5)]


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,decay", CASES)
def test_checkpoint_roundtrip_bitwise(tmp_path, method, decay):
    """save mid-pass, restore, continue == uninterrupted, bit for bit; the
    manifest records coverage."""
    A, B = pair(3)
    summ = port_summ(method, decay)
    half = summ.advance(summ.update(summ.init(prng.PRNGKey(3), (D, N1, N2)),
                                    t(A[:96]), t(B[:96]), 0), 2)
    checkpoint.save_stream_state(str(tmp_path), 96, half)
    meta = checkpoint.read_manifest(str(tmp_path))["extra"]
    assert meta["rows_seen"] == 96 and meta["kind"] == "stream_state"
    assert meta["srht"] == (method == "srht")
    if decay < 1.0:
        assert meta["t_state"] == 2 and meta["t_data"] == 0
        assert meta["decay_rate"] == pytest.approx(decay)
    restored = checkpoint.restore_stream_state(
        str(tmp_path), summ.init(prng.PRNGKey(3), (D, N1, N2)))
    assert_states_bit_equal(restored, half)
    resumed = summ.update(restored, t(A[96:]), t(B[96:]), 96)
    direct = summ.update(half, t(A[96:]), t(B[96:]), 96)
    assert_states_bit_equal(resumed, direct)
    assert_states_bit_equal(summ.finalize(resumed), summ.finalize(direct))


def test_window_checkpoint_roundtrip_bit_exact(tmp_path):
    A, B = pair(5)
    win = WindowedSummarizer(8, 3, probes=2, device="cpu")
    w = win.init(prng.PRNGKey(5), (D, N1, N2))
    w = win.update(w, t(A[:96]), t(B[:96]), 0)
    w = win.update(win.slide(w, 2), t(A[96:]), t(B[96:]), 0)
    checkpoint.save_window_state(str(tmp_path), 1, w)
    meta = checkpoint.read_manifest(str(tmp_path))["extra"]
    assert meta["kind"] == "window_state"
    assert meta["head"] == 4 and meta["n_buckets"] == 3
    assert meta["ring_index"] == 1
    assert sorted(meta["bucket_rows_seen"]) == [0, 96, 96]
    restored = checkpoint.restore_window_state(
        str(tmp_path), win.init(prng.PRNGKey(5), (D, N1, N2)))
    assert_states_bit_equal(restored, w)
    assert_states_bit_equal(win.finalize(win.slide(restored)),
                            win.finalize(win.slide(w)))


@pytest.mark.parametrize("spec", streaming.WIRE_DTYPES)
def test_compressed_checkpoint_round_trip(tmp_path, spec):
    summ = port_summ(decay=0.95)
    A, B = pair(7)
    st = summ.advance(summ.update(summ.init(prng.PRNGKey(7), (D, N1, N2)),
                                  t(A), t(B), 0), 1)
    checkpoint.save_stream_state(str(tmp_path), 3, st, wire=spec)
    wire = checkpoint.read_manifest(str(tmp_path))["extra"]["wire"]
    assert wire["spec"] == spec
    assert wire["bytes"] == streaming.wire_bytes(
        streaming.compress_state(st, spec))
    back = checkpoint.restore_stream_state(
        str(tmp_path), summ.init(prng.PRNGKey(7), (D, N1, N2)))
    want = streaming.decompress_state(streaming.compress_state(st, spec))
    assert_states_bit_equal(back, want)
    if spec == "f32":
        assert_states_bit_equal(back, streaming._settle_state(st))


def test_gated_checkpoint_records_measured_error(tmp_path):
    summ = port_summ()
    A, B = pair(9)
    st = summ.update(summ.init(prng.PRNGKey(9), (D, N1, N2)), t(A), t(B), 0)
    checkpoint.save_stream_state(str(tmp_path), 1, st, tol=0.05)
    wire = checkpoint.read_manifest(str(tmp_path))["extra"]["wire"]
    assert wire["spec"] in streaming.WIRE_DTYPES
    assert 0.0 <= wire["error"] <= 0.05
    back = checkpoint.restore_stream_state(
        str(tmp_path), summ.init(prng.PRNGKey(9), (D, N1, N2)))
    assert int(back.rows_seen) == D


def test_plain_checkpoint_path_has_no_wire_record(tmp_path):
    summ = port_summ()
    A, B = pair(11)
    st = summ.update(summ.init(prng.PRNGKey(11), (D, N1, N2)), t(A), t(B), 0)
    checkpoint.save_stream_state(str(tmp_path), 1, st)
    assert "wire" not in checkpoint.read_manifest(str(tmp_path))["extra"]


# ---------------------------------------------------------------------------
# The on-disk format, and checkpoints crossing between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,decay", CASES)
def test_manifest_and_arrays_match_jax(tmp_path, method, decay):
    """The same state saved by both packages: the same manifest (leaf
    paths, shapes, dtypes, bf16 list, extra) and the same arrays."""
    summ, jst = jax_state(method, decay)
    with jax.threefry_partitionable(False):
        jax_checkpoint.save_stream_state(str(tmp_path / "jax"), 5, jst)
    checkpoint.save_stream_state(str(tmp_path / "port"), 5, to_port(jst))
    jm = jax_checkpoint.read_manifest(str(tmp_path / "jax"))
    pm = checkpoint.read_manifest(str(tmp_path / "port"))
    assert pm == jm
    assert list(pm["leaves"]) == list(jm["leaves"])
    jd = np.load(tmp_path / "jax" / "step_00000005" / "arrays.npz")
    pd = np.load(tmp_path / "port" / "step_00000005" / "arrays.npz")
    assert sorted(jd.files) == sorted(pd.files)
    for name in jd.files:
        assert jd[name].dtype == pd[name].dtype, name
        np.testing.assert_array_equal(jd[name], pd[name], err_msg=name)


@pytest.mark.parametrize("method,decay", CASES)
def test_jax_checkpoint_restores_in_the_port(tmp_path, method, decay):
    summ, jst = jax_state(method, decay)
    with jax.threefry_partitionable(False):
        jax_checkpoint.save_stream_state(str(tmp_path), 1, jst)
    got = checkpoint.restore_stream_state(
        str(tmp_path), port_summ(method, decay).init(prng.PRNGKey(0),
                                                     (D, N1, N2)))
    assert_leaves_equal(convert.stream_state_to_numpy(got), jst)
    assert got.rows_seen.device.type == "cpu" and got.rows_seen.ndim == 0


@pytest.mark.parametrize("method,decay", CASES)
def test_port_checkpoint_restores_in_jax(tmp_path, method, decay):
    """A port pass checkpointed mid-way, resumed by the JAX package: its
    leaves are the port's, and resuming there matches the port's resumed
    pass to tolerance."""
    A, B = pair(13)
    summ = port_summ(method, decay)
    half = summ.advance(summ.update(summ.init(prng.PRNGKey(13), (D, N1, N2)),
                                    t(A[:96]), t(B[:96]), 0), 1)
    checkpoint.save_stream_state(str(tmp_path), 2, half)
    with jax.threefry_partitionable(False):
        jsumm = jax_streaming.StreamingSummarizer(
            8, method=method, probes=2, cosketch=2, decay=decay)
        restored = jax_checkpoint.restore_stream_state(
            str(tmp_path), jsumm.init(jax.random.PRNGKey(0), (D, N1, N2)))
        assert_leaves_equal(convert.stream_state_to_numpy(half), restored)
        jfin = jax_streaming.finalize_state(
            jsumm.update(restored, jnp.asarray(A[96:]), jnp.asarray(B[96:]),
                         96))
    fin = summ.finalize(summ.update(half, t(A[96:]), t(B[96:]), 96))
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B", "probes"):
        w = np.asarray(getattr(jfin, name))
        np.testing.assert_allclose(getattr(fin, name).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("spec", streaming.WIRE_DTYPES)
def test_wire_checkpoints_cross_both_ways(tmp_path, spec):
    """Compressed checkpoints: the JAX-written one restores in the port to
    the port's decompression of the same image; the port-written one
    restores in JAX to JAX's."""
    summ, jst = jax_state(decay=0.95)
    with jax.threefry_partitionable(False):
        jax_checkpoint.save_stream_state(str(tmp_path / "jax"), 1, jst,
                                         wire=spec)
        jcomp = jax_streaming.compress_state(jst, spec)
    pst = to_port(jst)
    checkpoint.save_stream_state(str(tmp_path / "port"), 1, pst, wire=spec)
    jm = jax_checkpoint.read_manifest(str(tmp_path / "jax"))
    pm = checkpoint.read_manifest(str(tmp_path / "port"))
    assert pm["leaves"] == jm["leaves"]
    assert pm["bf16_leaves"] == jm["bf16_leaves"]
    assert pm["extra"]["wire"]["bytes"] == jm["extra"]["wire"]["bytes"]
    assert pm["extra"]["wire"]["error"] == pytest.approx(
        jm["extra"]["wire"]["error"], rel=1e-4)
    like = port_summ(decay=0.95).init(prng.PRNGKey(0), (D, N1, N2))
    got = checkpoint.restore_stream_state(str(tmp_path / "jax"), like)
    want = streaming.decompress_state(streaming.compress_state(pst, spec))
    for name in ("A_acc", "B_acc", "na2", "nb2", "probe_acc", "cosketch_Y",
                 "cosketch_W", "rows_seen", "t_state", "t_data", "key"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    with jax.threefry_partitionable(False):
        jlike = summ.init(jax.random.PRNGKey(0), (D, N1, N2))
        back = jax_checkpoint.restore_stream_state(str(tmp_path / "port"),
                                                   jlike)
        jwant = jax_streaming.decompress_state(jcomp)
    for name in ("A_acc", "B_acc", "na2", "nb2", "probe_acc", "cosketch_Y",
                 "cosketch_W", "rows_seen", "t_state", "key"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jwant, name)),
                                      err_msg=name)


def _jax_window():
    A, B = pair(15)
    with jax.threefry_partitionable(False):
        win = jax_streaming.WindowedSummarizer(8, 3, probes=2)
        w = win.init(jax.random.PRNGKey(15), (D, N1, N2))
        w = win.update(w, jnp.asarray(A[:96]), jnp.asarray(B[:96]), 0)
        w = win.update(win.slide(w, 2), jnp.asarray(A[96:]),
                       jnp.asarray(B[96:]), 0)
        return win, w


def test_window_checkpoints_cross_both_ways(tmp_path):
    jwin, jw = _jax_window()
    with jax.threefry_partitionable(False):
        jax_checkpoint.save_window_state(str(tmp_path / "jax"), 1, jw)
    pw = convert.window_state_from_numpy(jax.tree.map(np.asarray, jw))
    checkpoint.save_window_state(str(tmp_path / "port"), 1, pw)
    jm = jax_checkpoint.read_manifest(str(tmp_path / "jax"))
    assert checkpoint.read_manifest(str(tmp_path / "port")) == jm
    win = WindowedSummarizer(8, 3, probes=2, device="cpu")
    got = checkpoint.restore_window_state(
        str(tmp_path / "jax"), win.init(prng.PRNGKey(0), (D, N1, N2)))
    assert_leaves_equal(convert.window_state_to_numpy(got), jw)
    with jax.threefry_partitionable(False):
        back = jax_checkpoint.restore_window_state(
            str(tmp_path / "port"), jwin.init(jax.random.PRNGKey(0),
                                              (D, N1, N2)))
    assert_leaves_equal(convert.window_state_to_numpy(pw), back)


@pytest.mark.parametrize("converter", ["stream", "compressed", "window"])
def test_state_converters_round_trip_exactly(converter):
    """convert's state converters carry JAX states into the port and back,
    bit for bit (bf16 blocks included)."""
    _, jst = jax_state(decay=0.9)
    with jax.threefry_partitionable(False):
        state = {"stream": jst,
                 "compressed": jax_streaming.compress_state(jst, "bf16"),
                 "window": _jax_window()[1]}[converter]
    arrays = jax.tree.map(np.asarray, state)
    to, back = {
        "stream": (convert.stream_state_from_numpy,
                   convert.stream_state_to_numpy),
        "compressed": (convert.compressed_state_from_numpy,
                       convert.compressed_state_to_numpy),
        "window": (convert.window_state_from_numpy,
                   convert.window_state_to_numpy)}[converter]
    assert_leaves_equal(back(to(arrays)), state)


# ---------------------------------------------------------------------------
# The generic layer: any tree, bf16 leaves, async writes, keep-N, placement
# ---------------------------------------------------------------------------

def test_generic_tree_with_bf16_leaves_crosses_both_ways(tmp_path):
    """A dict/tuple tree with a bf16 leaf: stored as uint16 and listed in
    bf16_leaves by both packages; each restores the other's."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    port_tree = {"w": torch.from_numpy(x).to(torch.bfloat16),
                 "b": (torch.arange(4, dtype=torch.int32), None)}
    jax_tree = {"w": jnp.asarray(x, jnp.bfloat16),
                "b": (jnp.arange(4, dtype=jnp.int32), None)}
    checkpoint.save(str(tmp_path / "port"), 0, port_tree)
    jax_checkpoint.save(str(tmp_path / "jax"), 0, jax_tree)
    pm = checkpoint.read_manifest(str(tmp_path / "port"))
    assert pm == jax_checkpoint.read_manifest(str(tmp_path / "jax"))
    assert pm["bf16_leaves"] == ["['w']"]
    assert pm["leaves"]["['w']"]["dtype"] == "bfloat16"
    got = checkpoint.restore(str(tmp_path / "jax"), port_tree)
    assert got["w"].dtype == torch.bfloat16 and got["b"][1] is None
    assert torch.equal(got["w"], port_tree["w"])
    assert torch.equal(got["b"][0], port_tree["b"][0])
    back = jax_checkpoint.restore(str(tmp_path / "port"), jax_tree)
    np.testing.assert_array_equal(np.asarray(back["w"]),
                                  np.asarray(jax_tree["w"]))


def test_save_async_keep_and_latest_step(tmp_path):
    tree = (torch.arange(6.0), torch.ones(2, 2, dtype=torch.bfloat16))
    threads = []
    for step in range(5):
        th = checkpoint.save_async(str(tmp_path), step,
                                   (tree[0] + step, tree[1]), keep=2)
        th.join()
        threads.append(th)
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    got = checkpoint.restore(str(tmp_path), tree, step=3)
    assert torch.equal(got[0], tree[0] + 3) and torch.equal(got[1], tree[1])
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), tree)


def test_sharding_fn_places_each_leaf(tmp_path):
    summ = port_summ()
    st = summ.init(prng.PRNGKey(19), (D, N1, N2))
    checkpoint.save_stream_state(str(tmp_path), 0, st)
    seen = []

    def place(path, arr):
        seen.append(path)
        return torch.from_numpy(arr.astype(np.int64) if path == ".key"
                                else arr.copy())

    got = checkpoint.restore(str(tmp_path), st, sharding_fn=place)
    assert seen == [p for p, _ in checkpoint._paths(st)]
    assert_states_bit_equal(got, st)
    with open(tmp_path / "step_00000000" / "manifest.json") as f:
        assert json.load(f)["leaves"][".key"]["dtype"] == "uint32"


# ---------------------------------------------------------------------------
# Raise paths
# ---------------------------------------------------------------------------

def test_checkpoint_raises(tmp_path):
    A, B = pair(21)
    summ = port_summ(probes=0, cosketch=0)
    key = prng.PRNGKey(21)
    s = summ.update(summ.init(key, (D, N1, N2)), t(A), t(B), 0)
    checkpoint.save_stream_state(str(tmp_path), 0, s)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), StreamingSummarizer(
            16, device="cpu").init(key, (D, N1, N2)))
    with pytest.raises(ValueError, match="no leaf"):
        checkpoint.restore(str(tmp_path), StreamingSummarizer(
            8, decay=0.5, device="cpu").init(key, (D, N1, N2)))
    with pytest.raises(ValueError, match="WindowState"):
        checkpoint.save_window_state(str(tmp_path), 1, s)
    win2 = WindowedSummarizer(8, 2, device="cpu")
    checkpoint.save_window_state(str(tmp_path), 2, win2.init(key,
                                                             (D, N1, N2)))
    with pytest.raises(ValueError, match="resized"):
        checkpoint.restore_window_state(
            str(tmp_path), WindowedSummarizer(8, 3, device="cpu").init(
                key, (D, N1, N2)))
