"""The port's drift-aware summaries against the JAX package: the lazy decay
clock and its bitwise monoid laws, the window ring and its bucket keys,
recovery after a subspace flip, and the raise paths (the port's twin of
tests/core/test_streaming_drift.py, without its serving and distributed
tests).

Inputs are made with numpy from a seed; every jax call runs under the
classic key tree (``jax.threefry_partitionable(False)``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as jax_streaming
from repro_torch import convert, prng
from repro_torch.core import error_engine, streaming
from repro_torch.core.streaming import (
    StreamingSummarizer, WindowedSummarizer, decay_state, finalize_state,
    merge_states, tree_merge, window_bucket_key)

D, N1, N2 = 192, 11, 7
# The two packages' accumulators: float32 sums in other orders, and decay
# factors (a float32 base to an int32 power) that may differ by an ulp
# between the frameworks: each column within 1e-5 of its largest entry.
STATE_RTOL = 1e-5


def pair(seed, d=D, n1=N1, n2=N2):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((d, n1)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((d, n2)).astype(np.float32)))


def assert_states_bit_equal(a, b, msg=""):
    assert type(a) is type(b), msg
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), (msg, name)
        if x is None:
            continue
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                assert_states_bit_equal(u, v, msg)
            continue
        assert x.dtype == y.dtype and torch.equal(x, y), (msg, name)


def assert_close_to_jax(got, want, rtol=STATE_RTOL):
    """Port state (numpy via convert) against a JAX state: integer fields
    and keys bit for bit, floats to ``rtol`` of each column's largest
    entry."""
    for name, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if not np.issubdtype(w.dtype, np.floating) or name == "decay_rate":
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        scale = (np.abs(w).max(axis=0, keepdims=True) if w.ndim == 2
                 else np.abs(w).max(initial=0.0))
        assert np.all(np.abs(g - w) <= rtol * np.maximum(scale, 1e-30)), \
            (name, float(np.abs(g - w).max()))


def drifting_pair(seed, d=256, n1=14, n2=12, q=3):
    """tests/conftest.py::drifting_spectrum_pair with numpy draws: two
    phases with ``Ai^T Bi = Mi`` exactly, disjoint top-q left subspaces,
    phase 1 carrying 2x the singular values."""
    rng = np.random.default_rng(seed)
    U_all = np.linalg.qr(rng.standard_normal((n1, 2 * q)))[0]
    U1, U2 = U_all[:, :q], U_all[:, q:]
    V1 = np.linalg.qr(rng.standard_normal((n2, q)))[0]
    V2 = np.linalg.qr(rng.standard_normal((n2, q)))[0]
    M1, M2 = 8.0 * U1 @ V1.T, 4.0 * U2 @ V2.T
    W1 = np.linalg.qr(rng.standard_normal((d, n1)))[0]
    W2 = np.linalg.qr(rng.standard_normal((d, n1)))[0]
    f = lambda x: torch.from_numpy(x.astype(np.float32))
    return (f(W1), f(W1 @ M1), f(U1)), (f(W2), f(W2 @ M2), f(U2))


# ---------------------------------------------------------------------------
# The decay algebra, bit for bit inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [32, 96, 128])
@pytest.mark.parametrize("dt", [0, 1, 5])
@pytest.mark.parametrize("gamma", [0.5, 0.9, 0.99])
def test_decay_merge_commutation_bitwise(split, dt, gamma):
    """decay(merge(s1, s2)) == merge(decay(s1), decay(s2)) bit for bit, and
    after finalization."""
    A, B = pair(3)
    summ = StreamingSummarizer(8, probes=2, cosketch=2, decay=gamma,
                               device="cpu")
    s1 = summ.update(summ.init(prng.PRNGKey(3), (D, N1, N2)), A[:split],
                     B[:split], 0)
    s2 = summ.update(summ.init(prng.PRNGKey(3), (D, N1, N2)), A[split:],
                     B[split:], split)
    lhs = decay_state(merge_states(s1, s2), dt)
    rhs = merge_states(decay_state(s1, dt), decay_state(s2, dt))
    assert_states_bit_equal(lhs, rhs)
    assert_states_bit_equal(finalize_state(lhs), finalize_state(rhs))


@pytest.mark.parametrize("dt1,dt2", [(0, 3), (2, 2), (4, 1)])
def test_decayed_merge_commutative_bitwise(dt1, dt2):
    A, B = pair(5)
    summ = StreamingSummarizer(8, probes=2, decay=0.9, device="cpu")
    s1 = decay_state(summ.update(summ.init(prng.PRNGKey(5), (D, N1, N2)),
                                 A[:64], B[:64], 0), dt1)
    s2 = decay_state(summ.update(summ.init(prng.PRNGKey(5), (D, N1, N2)),
                                 A[64:], B[64:], 64), dt2)
    assert_states_bit_equal(merge_states(s1, s2), merge_states(s2, s1))


@pytest.mark.parametrize("i,j,dt", [(32, 96, 0), (64, 128, 3)])
def test_decayed_monoid_associative(i, j, dt):
    A, B = pair(7)
    summ = StreamingSummarizer(8, decay=0.9, device="cpu")
    parts = [summ.update(summ.init(prng.PRNGKey(7), (D, N1, N2)), A[a:b],
                         B[a:b], a) for a, b in ((0, i), (i, j), (j, D))]
    parts = [decay_state(s, n) for s, n in zip(parts, (dt, 0, dt))]
    left = finalize_state(merge_states(merge_states(parts[0], parts[1]),
                                       parts[2]))
    right = finalize_state(merge_states(parts[0],
                                        merge_states(parts[1], parts[2])))
    for x, y in zip(left[:4], right[:4]):
        torch.testing.assert_close(x, y, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("chunk", [32, 48, 192])
def test_decay_one_bit_parity_with_vanilla(chunk):
    """decay=1.0 is the vanilla path: the same fields (decay ones None) and
    the same bits, and advance() is the identity."""
    A, B = pair(11)

    def run(summ):
        s = summ.init(prng.PRNGKey(11), (D, N1, N2))
        for off in range(0, D, chunk):
            s = summ.update(s, A[off:off + chunk], B[off:off + chunk], off)
        return summ.advance(s, 3)

    assert_states_bit_equal(
        run(StreamingSummarizer(8, probes=2, device="cpu")),
        run(StreamingSummarizer(8, probes=2, decay=1.0, device="cpu")))


def test_decay_matches_explicit_reweighting():
    A, B = pair(13)
    gamma, dt = 0.5, 3
    summ = StreamingSummarizer(8, probes=2, decay=gamma, device="cpu")
    van = StreamingSummarizer(8, probes=2, device="cpu")
    s = summ.update(summ.init(prng.PRNGKey(13), (D, N1, N2)), A[:96], B[:96],
                    0)
    s = summ.update(summ.advance(s, dt), A[96:], B[96:], 96)
    c1 = van.update(van.init(prng.PRNGKey(13), (D, N1, N2)), A[:96], B[:96],
                    0)
    c2 = van.update(van.init(prng.PRNGKey(13), (D, N1, N2)), A[96:], B[96:],
                    96)
    w = gamma ** dt
    for name in ("A_acc", "probe_acc", "na2"):
        torch.testing.assert_close(getattr(s, name),
                                   w * getattr(c1, name) + getattr(c2, name),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gamma", [0.5, 0.9])
@pytest.mark.parametrize("ticks", [(1, 1, 1), (0, 3, 2)])
def test_decayed_stream_matches_jax(gamma, ticks):
    """Chunks with ticks between them in both packages: the clock and
    counters bit for bit, the decayed blocks to tolerance; and after the
    settle of finalize."""
    A, B = pair(17)
    with jax.threefry_partitionable(False):
        jsumm = jax_streaming.StreamingSummarizer(8, probes=2, cosketch=2,
                                                  decay=gamma)
        want = jsumm.init(jax.random.PRNGKey(17), (D, N1, N2))
        for i, dt in enumerate(ticks):
            want = jsumm.update(want, jnp.asarray(A[64 * i:64 * (i + 1)]),
                                jnp.asarray(B[64 * i:64 * (i + 1)]), 64 * i)
            want = jsumm.advance(want, dt)
        want_fin = jax_streaming.finalize_state(want)
    summ = StreamingSummarizer(8, probes=2, cosketch=2, decay=gamma,
                               device="cpu")
    got = summ.init(prng.PRNGKey(17), (D, N1, N2))
    for i, dt in enumerate(ticks):
        got = summ.update(got, A[64 * i:64 * (i + 1)], B[64 * i:64 * (i + 1)],
                          64 * i)
        got = summ.advance(got, dt)
    assert_close_to_jax(convert.stream_state_to_numpy(got), want)
    got_fin = convert.summary_to_numpy(finalize_state(got))
    assert_close_to_jax(got_fin, want_fin)


# ---------------------------------------------------------------------------
# The sliding window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epoch", [0, 1, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("seed", [0, 19])
def test_window_bucket_key_matches_jax(epoch, seed):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax_streaming.window_bucket_key(
            jax.random.PRNGKey(seed), epoch))
    got = window_bucket_key(prng.PRNGKey(seed), epoch)
    np.testing.assert_array_equal(convert.key_to_numpy(got), want)


def _rebuild_window(key, shapes, epoch_log, head, n_buckets, probes):
    """Each live bucket rebuilt from the per-epoch chunk log, merged in
    ascending epoch order: the oracle of the ring."""
    inner = StreamingSummarizer(8, probes=probes, device="cpu")
    omega = error_engine.probe_omega(key, shapes[2], probes) \
        if probes else None
    states = []
    for e in range(head - n_buckets + 1, head + 1):
        b = inner.init(window_bucket_key(key, e), shapes)
        if omega is not None:
            b = b._replace(omega=omega)
        for A_c, B_c, off in epoch_log.get(e, []):
            b = inner.update(b, A_c, B_c, off)
        states.append(b)
    return tree_merge(states)


@pytest.mark.parametrize("chunk", [32, 64, 96])
@pytest.mark.parametrize("slides", [1, 3])
@pytest.mark.parametrize("probes", [0, 2])
def test_windowed_slide_matches_rebuilt_from_buckets(chunk, slides, probes):
    key = prng.PRNGKey(19)
    win = WindowedSummarizer(8, 3, probes=probes, device="cpu")
    w = win.init(key, (D, N1, N2))
    epoch_log = {}
    rnd = np.random.default_rng(chunk * 100 + slides)
    for s in range(slides + 1):
        A, B = pair(1000 + s)
        for off in range(0, D, chunk):
            w = win.update(w, A[off:off + chunk], B[off:off + chunk], off)
            epoch_log.setdefault(int(w.head), []).append(
                (A[off:off + chunk], B[off:off + chunk], off))
        if s < slides:
            w = win.slide(w, int(rnd.integers(1, 3)))
    rebuilt = _rebuild_window(key, (D, N1, N2), epoch_log, int(w.head), 3,
                              probes)
    assert_states_bit_equal(win.merged(w), rebuilt)
    assert_states_bit_equal(finalize_state(win.merged(w)), win.finalize(w))


def test_window_matches_jax():
    """The same updates and slides in both packages: the ring's head and
    every bucket (keys, counters bit for bit), and the merged window."""
    chunks = [(0, 96), (96, 192)]
    A, B = pair(21)
    with jax.threefry_partitionable(False):
        jwin = jax_streaming.WindowedSummarizer(8, 3, probes=2, cosketch=2)
        want = jwin.init(jax.random.PRNGKey(21), (D, N1, N2))
        for i, (lo, hi) in enumerate(chunks):
            want = jwin.update(want, jnp.asarray(A[lo:hi]),
                               jnp.asarray(B[lo:hi]), lo)
            want = jwin.slide(want, i + 1)
        want_merged = jwin.merged(want)
    win = WindowedSummarizer(8, 3, probes=2, cosketch=2, device="cpu")
    got = win.init(prng.PRNGKey(21), (D, N1, N2))
    for i, (lo, hi) in enumerate(chunks):
        got = win.update(got, A[lo:hi], B[lo:hi], lo)
        got = win.slide(got, i + 1)
    got_np = convert.window_state_to_numpy(got)
    np.testing.assert_array_equal(got_np.key, np.asarray(want.key))
    assert int(got_np.head) == int(want.head) == 5
    for g, w in zip(got_np.buckets, want.buckets):
        assert_close_to_jax(g, w)
    assert_close_to_jax(convert.stream_state_to_numpy(win.merged(got)),
                        want_merged)


def test_window_forgets_expired_epochs():
    A, B = pair(23)
    win = WindowedSummarizer(8, 2, device="cpu")
    w = win.update(win.init(prng.PRNGKey(23), (D, N1, N2)), A, B, 0)
    assert int(win.merged(w).rows_seen) == D
    w = win.slide(w)
    assert int(win.merged(w).rows_seen) == D
    w = win.slide(w)
    assert int(win.merged(w).rows_seen) == 0
    s = win.finalize(w)
    assert bool(torch.all(s.A_sketch == 0)) and bool(torch.all(s.norm_A == 0))


def test_window_bucket_keys_decorrelate_epochs():
    A, B = pair(29)
    win = WindowedSummarizer(8, 2, device="cpu")
    w = win.update(win.init(prng.PRNGKey(29), (D, N1, N2)), A, B, 0)
    first = w.buckets[int(w.head) % 2]
    w = win.update(win.slide(w), A, B, 0)
    second = w.buckets[int(w.head) % 2]
    assert not torch.equal(first.A_acc, second.A_acc)
    assert torch.equal(first.na2, second.na2)


# ---------------------------------------------------------------------------
# Drift recovery: the subspace flip
# ---------------------------------------------------------------------------

def _top_subspace_residual(summary, U):
    E = summary.A_sketch.T @ summary.B_sketch
    Uh = torch.linalg.svd(E, full_matrices=False)[0][:, :U.shape[1]]
    return float(torch.linalg.matrix_norm(U - Uh @ (Uh.T @ U), 2))


@pytest.mark.parametrize("seed", [0, 1])
def test_drift_windowed_and_decayed_recover_vanilla_does_not(seed):
    (A1, B1, U1), (A2, B2, U2) = drifting_pair(seed)
    d, n1, n2 = A1.shape[0], A1.shape[1], B1.shape[1]
    key = prng.PRNGKey(seed)
    van = StreamingSummarizer(128, device="cpu")
    s = van.update(van.init(key, (2 * d, n1, n2)), A1, B1, 0)
    s = van.update(s, A2, B2, d)
    r_vanilla = _top_subspace_residual(van.finalize(s), U2)
    dec = StreamingSummarizer(128, decay=0.5, device="cpu")
    s = dec.update(dec.init(key, (d, n1, n2)), A1, B1, 0)
    s = dec.update(dec.advance(s, 6), A2, B2, 0)
    r_decay = _top_subspace_residual(dec.finalize(s), U2)
    win = WindowedSummarizer(128, 2, device="cpu")
    w = win.update(win.init(key, (d, n1, n2)), A1, B1, 0)
    w = win.update(win.slide(w), A2, B2, 0)
    r_window = _top_subspace_residual(win.finalize(win.slide(w)), U2)
    assert r_vanilla > 0.9, r_vanilla
    assert r_decay < 0.5, r_decay
    assert r_window < 0.5, r_window
    assert float(torch.linalg.matrix_norm(U1.T @ U2, 2)) < 1e-5


# ---------------------------------------------------------------------------
# Raise paths: each names its offender, as in the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [0.0, -0.5, 1.5, True, "fast"])
def test_decay_config_rejected(bad):
    with pytest.raises(ValueError, match="retention factor"):
        jax_streaming.StreamingSummarizer(8, decay=bad)
    with pytest.raises(ValueError, match="retention factor"):
        StreamingSummarizer(8, decay=bad, device="cpu")


def test_decay_state_rejects_negative_dt():
    summ = StreamingSummarizer(8, decay=0.5, device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        decay_state(summ.init(prng.PRNGKey(0), (D, N1, N2)), -1)


def test_merge_rejects_mixed_decay():
    key = prng.PRNGKey(0)
    plain = StreamingSummarizer(8, device="cpu").init(key, (D, N1, N2))
    decayed = StreamingSummarizer(8, decay=0.5, device="cpu").init(
        key, (D, N1, N2))
    other = StreamingSummarizer(8, decay=0.9, device="cpu").init(
        key, (D, N1, N2))
    with pytest.raises(ValueError,
                       match="decayed stream state with an undecayed"):
        merge_states(plain, decayed)
    with pytest.raises(ValueError, match="different decay rates: 0.5"):
        merge_states(decayed, other)


@pytest.mark.parametrize("bad", [0, -1, True, 2.0, "3"])
def test_window_config_rejected(bad):
    with pytest.raises(ValueError, match="n_buckets"):
        WindowedSummarizer(8, bad, device="cpu")


def test_window_guards():
    key = prng.PRNGKey(0)
    with pytest.raises(ValueError, match="epoch must be non-negative"):
        window_bucket_key(key, -1)
    win = WindowedSummarizer(8, 2, device="cpu")
    w = win.init(key, (D, N1, N2))
    for bad in (0, -2, True, 1.5):
        with pytest.raises(ValueError, match="positive epoch count"):
            win.slide(w, bad)
    wrong = WindowedSummarizer(8, 3, device="cpu").init(key, (D, N1, N2))
    with pytest.raises(ValueError, match="expects n_buckets=2"):
        win.merged(wrong)
    with pytest.raises(ValueError, match="expects n_buckets=2"):
        win.update(wrong, torch.ones(4, N1), torch.ones(4, N2), 0)


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSummarizer(8).init(prng.PRNGKey(0), (D, N1, N2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WindowedSummarizer(8, 2).init(prng.PRNGKey(0), (D, N1, N2))
    comp = streaming.compress_state(
        StreamingSummarizer(8, device="cpu").init(prng.PRNGKey(0),
                                                  (D, N1, N2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.wire_unpack(streaming.wire_pack(comp))
