"""The port's StreamingSummarizer against the JAX package: chunked ingestion,
shuffled arrival, the monoid laws, ``ingest``, the wire format and the
guards (the port's twin of tests/core/test_streaming.py and
tests/core/test_streaming_ingest.py, without their serving, distributed and
training-tap tests).

Inputs are made with numpy from a seed and handed to both packages; every
jax call runs under the classic key tree (``jax.threefry_partitionable
(False)``). Keys, row ids, counters, quantized int8 blocks and ``wire_pack``
bytes are compared bit for bit; float accumulators to tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as jax_streaming
from repro.core import summary_engine as jax_summary
from repro_torch import convert, prng
from repro_torch.core import streaming, summary_engine
from repro_torch.core.streaming import StreamingSummarizer, WindowedSummarizer

D, N1, N2 = 192, 11, 7
# Accumulators of the two packages: float32 sums of the same terms in other
# orders, and test matrices whose normals differ by an ulp now and then
# (tests/test_torch_prng.py): each column within 1e-5 of its own largest
# entry (1-D and 0-d blocks: of their largest entry).
STATE_RTOL = 1e-5
# Reassociated merges against the one-shot summary: the JAX suite's
# tolerance (tests/core/test_streaming.py::_assert_close).
MERGE_RTOL, MERGE_ATOL_SCALE = 2e-4, 1e-5
SUMMARY_FIELDS = ("A_sketch", "B_sketch", "norm_A", "norm_B")


def pair(seed, d=D, n1=N1, n2=N2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, n1)).astype(np.float32),
            rng.standard_normal((d, n2)).astype(np.float32))


def jax_ingest(seed, A, B, chunk, k=16, **kw):
    with jax.threefry_partitionable(False):
        summ = jax_streaming.StreamingSummarizer(k, **kw)
        state = summ.init(jax.random.PRNGKey(seed),
                          (A.shape[0], A.shape[1], B.shape[1]))
        for off in range(0, A.shape[0], chunk):
            state = summ.update(state, jnp.asarray(A[off:off + chunk]),
                                jnp.asarray(B[off:off + chunk]), off)
        return state


def port_ingest(seed, A, B, chunk, k=16, **kw):
    summ = StreamingSummarizer(k, device="cpu", **kw)
    state = summ.init(prng.PRNGKey(seed),
                      (A.shape[0], A.shape[1], B.shape[1]))
    for off in range(0, A.shape[0], chunk):
        state = summ.update(state, torch.from_numpy(A[off:off + chunk]),
                            torch.from_numpy(B[off:off + chunk]), off)
    return state


def jax_numpy(state):
    return type(state)(*(None if x is None else np.asarray(x)
                         for x in state))


def to_port(jax_state):
    return convert.stream_state_from_numpy(jax_numpy(jax_state))


def assert_matches_jax(port_state, jax_state, rtol=STATE_RTOL):
    """Same fields present; the key, integer fields and the decay rate bit
    for bit; float blocks to ``rtol`` of each column's largest entry."""
    got = convert.stream_state_to_numpy(port_state)
    want = jax_numpy(jax_state)
    for name, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "decay_rate" or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        scale = (np.abs(w).max(axis=0, keepdims=True) if w.ndim == 2
                 else np.abs(w).max(initial=0.0))
        assert np.all(np.abs(g - w) <= rtol * np.maximum(scale, 1e-30)), \
            (name, float(np.abs(g - w).max()))


def assert_states_bit_equal(a, b):
    assert type(a) is type(b)
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and x.device == y.device, name
            assert torch.equal(x, y), name


def assert_summary_bit_equal(got, want):
    for name in SUMMARY_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def assert_summary_close(got, want, rtol=MERGE_RTOL):
    for name in SUMMARY_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(
            g, w, rtol=rtol,
            atol=MERGE_ATOL_SCALE * max(float(w.abs().max()), 1.0))


def t(x):
    return torch.from_numpy(x)


# ---------------------------------------------------------------------------
# The stream against the JAX package's stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["gaussian", "srht"])
@pytest.mark.parametrize("chunk", [48, 80, 192])
def test_stream_matches_jax(method, chunk):
    """Sequential ingestion (80 leaves a ragged last chunk): the port's
    state against the JAX package's, keys and counters bit for bit."""
    A, B = pair(1)
    assert_matches_jax(port_ingest(3, A, B, chunk, method=method),
                       jax_ingest(3, A, B, chunk, method=method))


@pytest.mark.parametrize("method", ["gaussian", "srht"])
def test_stream_with_probes_and_cosketch_matches_jax(method):
    A, B = pair(2)
    kw = dict(method=method, probes=4, cosketch=3)
    assert_matches_jax(port_ingest(5, A, B, 64, **kw),
                       jax_ingest(5, A, B, 64, **kw))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_stream_precision_matches_jax(precision):
    """bf16 inputs: the projection rounded to bf16, float32 sums; the same
    rounding in both packages leaves float32 reordering only."""
    A, B = pair(4)
    kw = dict(precision=precision, probes=2)
    assert_matches_jax(port_ingest(6, A, B, 64, **kw),
                       jax_ingest(6, A, B, 64, **kw), rtol=1e-4)


def test_update_rows_shuffled_matches_jax():
    """Shuffled explicit-id chunks (the co-occurrence stream) in both
    packages, the same permutation: same counters, sums to tolerance."""
    A, B = pair(7)
    perm = np.random.default_rng(0).permutation(D)
    with jax.threefry_partitionable(False):
        summ = jax_streaming.StreamingSummarizer(16)
        want = summ.init(jax.random.PRNGKey(8), (D, N1, N2))
        for off in range(0, D, 48):
            ids = perm[off:off + 48]
            want = summ.update_rows(want, jnp.asarray(ids),
                                    jnp.asarray(A[ids]), jnp.asarray(B[ids]))
    summ = StreamingSummarizer(16, device="cpu")
    got = summ.init(prng.PRNGKey(8), (D, N1, N2))
    for off in range(0, D, 48):
        ids = perm[off:off + 48]
        got = summ.update_rows(got, torch.from_numpy(ids), t(A[ids]),
                               t(B[ids]))
    assert int(got.rows_seen) == D and int(got.row_high) == D
    assert_matches_jax(got, want)


# ---------------------------------------------------------------------------
# Chunked against one-shot, inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["gaussian", "srht"])
@pytest.mark.parametrize("d,chunk", [(256, 64), (192, 48), (192, 192)])
def test_sequential_chunks_bit_identical_to_scan(method, d, chunk):
    """Chunks of c rows == build_summary(scan, block=c), bit for bit, where
    c divides d: both add chunk_contribution of the same blocks."""
    A, B = pair(9, d=d)
    s = streaming.finalize_state(port_ingest(10, A, B, chunk, method=method))
    scan = summary_engine.build_summary(
        prng.PRNGKey(10), t(A), t(B), 16, method=method, backend="scan",
        block=chunk, device="cpu")
    assert_summary_bit_equal(s, scan)


@pytest.mark.parametrize("method", ["gaussian", "srht"])
def test_ragged_last_chunk_matches_scan_to_tolerance(method):
    """With a ragged last chunk the CPU's products sum the short chunk in
    another blocking than the scan's zero-padded block, so the identity
    needs c to divide d here; the norms, plain sums, stay bit-identical."""
    A, B = pair(11)
    s = streaming.finalize_state(port_ingest(12, A, B, 80, method=method))
    scan = summary_engine.build_summary(
        prng.PRNGKey(12), t(A), t(B), 16, method=method, backend="scan",
        block=80, device="cpu")
    assert_summary_close(s, scan, rtol=2e-5)
    assert torch.equal(s.norm_A, scan.norm_A)


@pytest.mark.parametrize("method", ["gaussian", "srht"])
@pytest.mark.parametrize("chunk", [48, 80, 192])
def test_chunked_matches_reference(method, chunk):
    A, B = pair(13)
    ref = summary_engine.build_summary(prng.PRNGKey(14), t(A), t(B), 16,
                                       method=method, backend="reference",
                                       device="cpu")
    s = streaming.finalize_state(port_ingest(14, A, B, chunk, method=method))
    assert_summary_close(s, ref)


def test_update_rows_arbitrary_order():
    A, B = pair(15)
    summ = StreamingSummarizer(16, device="cpu")
    ref = summary_engine.build_summary(prng.PRNGKey(16), t(A), t(B), 16,
                                       device="cpu")
    for seed in (0, 1):
        perm = np.random.default_rng(seed).permutation(D)
        state = summ.init(prng.PRNGKey(16), (D, N1, N2))
        for off in range(0, D, 48):
            ids = torch.from_numpy(perm[off:off + 48])
            state = summ.update_rows(state, ids, t(A)[ids], t(B)[ids])
        assert int(state.rows_seen) == D
        assert_summary_close(summ.finalize(state), ref)


def test_summarize_chunks_convenience():
    A, B = pair(17)
    summ = StreamingSummarizer(16, device="cpu")
    s = summ.summarize_chunks(
        prng.PRNGKey(18), (D, N1, N2),
        ((t(A[off:off + 64]), t(B[off:off + 64]))
         for off in range(0, D, 64)))
    assert_summary_bit_equal(s, summary_engine.build_summary(
        prng.PRNGKey(18), t(A), t(B), 16, backend="scan", block=64,
        device="cpu"))


@pytest.mark.parametrize("method", ["gaussian", "srht"])
def test_probe_and_cosketch_blocks_bit_identical_to_build_summary(method):
    """The stream's probe and co-sketch blocks add the one-shot passes'
    block terms in the same order: bit-identical at chunk = block."""
    A, B = pair(19)
    s = streaming.finalize_state(port_ingest(20, A, B, 64, method=method,
                                             probes=3, cosketch=2))
    want = summary_engine.build_summary(
        prng.PRNGKey(20), t(A), t(B), 16, method=method, backend="scan",
        block=64, probes=3, cosketch=2, device="cpu")
    for name, x, y in zip(s._fields, s, want):
        assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# Monoid laws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["gaussian", "srht"])
def test_merge_commutative_bitwise(method):
    A, B = pair(21)
    summ = StreamingSummarizer(16, method=method, probes=2, cosketch=2,
                               device="cpu")
    empty = summ.init(prng.PRNGKey(22), (D, N1, N2))
    s1 = summ.update(empty, t(A[:96]), t(B[:96]), 0)
    s2 = summ.update(empty, t(A[96:]), t(B[96:]), 96)
    assert_states_bit_equal(summ.merge(s1, s2), summ.merge(s2, s1))
    # the shared empty state was not changed in place
    assert float(empty.A_acc.abs().max()) == 0.0


@pytest.mark.parametrize("i,j", [(32, 128), (64, 160), (96, 128)])
def test_merge_associative(i, j):
    A, B = pair(23)
    summ = StreamingSummarizer(8, device="cpu")
    empty = summ.init(prng.PRNGKey(3), (D, N1, N2))
    a = summ.update(empty, t(A[:i]), t(B[:i]), 0)
    b = summ.update(empty, t(A[i:j]), t(B[i:j]), i)
    c = summ.update(empty, t(A[j:]), t(B[j:]), j)
    left = summ.merge(summ.merge(a, b), c)
    right = summ.merge(a, summ.merge(b, c))
    assert_summary_close(summ.finalize(left), summ.finalize(right),
                         rtol=2e-5)
    assert int(left.rows_seen) == D and int(left.row_high) == D


@pytest.mark.parametrize("chunk,order_seed", [(32, 0), (64, 7), (96, 42)])
def test_any_merge_order_matches_one_shot(chunk, order_seed):
    A, B = pair(25)
    summ = StreamingSummarizer(8, device="cpu")
    empty = summ.init(prng.PRNGKey(4), (D, N1, N2))
    parts = [summ.update(empty, t(A[off:off + chunk]), t(B[off:off + chunk]),
                         off) for off in range(0, D, chunk)]
    np.random.default_rng(order_seed).shuffle(parts)
    merged = parts[0]
    for p in parts[1:]:
        merged = streaming.merge_states(merged, p)
    assert_summary_close(summ.finalize(merged), summary_engine.build_summary(
        prng.PRNGKey(4), t(A), t(B), 8, device="cpu"))


def test_tree_merge_matches_sequential_and_jax():
    """tree_merge of per-chunk partials: the sequential state to tolerance,
    and the JAX package's tree_merge of its partials."""
    A, B = pair(27)
    summ = StreamingSummarizer(16, probes=2, device="cpu")
    empty = summ.init(prng.PRNGKey(5), (D, N1, N2))
    parts = [summ.update(empty, t(A[off:off + 48]), t(B[off:off + 48]), off)
             for off in range(0, D, 48)]
    merged = streaming.tree_merge(parts)
    assert_summary_close(summ.finalize(merged),
                         summ.finalize(port_ingest(5, A, B, 48, probes=2)),
                         rtol=2e-5)
    with jax.threefry_partitionable(False):
        jsumm = jax_streaming.StreamingSummarizer(16, probes=2)
        jempty = jsumm.init(jax.random.PRNGKey(5), (D, N1, N2))
        jparts = [jsumm.update(jempty, jnp.asarray(A[off:off + 48]),
                               jnp.asarray(B[off:off + 48]), off)
                  for off in range(0, D, 48)]
        want = jax_streaming.tree_merge(jparts)
    assert_matches_jax(merged, want)


def test_empty_chunk_is_identity():
    summ = StreamingSummarizer(8, device="cpu")
    state = summ.update(summ.init(prng.PRNGKey(6), (64, 4, 3)),
                        torch.ones(16, 4), torch.ones(16, 3), 0)
    after = summ.update(state, torch.zeros(0, 4), torch.zeros(0, 3), 16)
    after = summ.update_rows(after, torch.zeros(0, dtype=torch.int32),
                             torch.zeros(0, 4), torch.zeros(0, 3))
    assert_states_bit_equal(after, state)


@pytest.mark.parametrize("method", ["gaussian", "srht"])
def test_numpy_chunks_are_accepted(method):
    """Chunks may be numpy arrays, as the JAX package takes them."""
    A, B = pair(29)
    summ = StreamingSummarizer(16, method=method, device="cpu")
    got = summ.update(summ.init(prng.PRNGKey(7), (D, N1, N2)), A, B, 0)
    want = summ.update(summ.init(prng.PRNGKey(7), (D, N1, N2)), t(A), t(B),
                       0)
    assert_states_bit_equal(got, want)


# ---------------------------------------------------------------------------
# The guards raise as in the JAX package
# ---------------------------------------------------------------------------

def _guard_cases(pkg, key, arr):
    """(name, call, message) of each guard, built from one package."""
    S, W = pkg.StreamingSummarizer, pkg.WindowedSummarizer
    base = S(8, **({} if pkg is jax_streaming else {"device": "cpu"}))
    kw = {} if pkg is jax_streaming else {"device": "cpu"}
    state = base.init(key, (64, 4, 3))
    ones = lambda *s: arr(np.ones(s, np.float32))
    return {
        "shapes": (lambda: pkg.merge_states(
            state, base.init(key, (64, 5, 3))), "shapes"),
        "method": (lambda: pkg.merge_states(
            state, S(8, method="srht", **kw).init(key, (64, 4, 3))),
            "gaussian and srht"),
        "probes": (lambda: pkg.merge_states(
            state, S(8, probes=2, **kw).init(key, (64, 4, 3))),
            "probe-carrying"),
        "cosketch": (lambda: pkg.merge_states(
            state, S(8, cosketch=2, **kw).init(key, (64, 4, 3))),
            "cosketch-carrying"),
        "unknown_method": (lambda: S(8, method="nope", **kw), "method"),
        "tree_merge_empty": (lambda: pkg.tree_merge([]), "tree_merge"),
        "row_counts": (lambda: base.update(state, ones(0, 4), ones(16, 3),
                                           16), "row counts differ"),
        "rows_ids_counts": (lambda: base.update_rows(
            state, arr(np.zeros(0, np.int32)), ones(0, 4), ones(16, 3)),
            "row counts differ"),
        "offset_past_d": (lambda: base.update(state, ones(16, 4),
                                              ones(16, 3), 64), "d_total"),
        "negative_id": (lambda: base.update_rows(
            state, arr(np.arange(-1, 15, dtype=np.int32)), ones(16, 4),
            ones(16, 3)), "d_total"),
        "bad_prefetch": (lambda: base.ingest(state, [], prefetch=-1),
                         "prefetch"),
        "bool_prefetch": (lambda: base.ingest(state, [], prefetch=True),
                          "prefetch"),
        "wire_spec": (lambda: pkg.compress_state(state, "f16"), "wire spec"),
        "no_key": (lambda: pkg.compress_state(state._replace(key=None)),
                   "key"),
        "wire_error_no_probes": (lambda: pkg.wire_error(state, "bf16"),
                                 "probe"),
        "gate_tol": (lambda: pkg.choose_wire_spec(state, 0.0), "tolerance"),
        "n_buckets": (lambda: W(8, 0, **kw), "n_buckets"),
    }


GUARDS = ["shapes", "method", "probes", "cosketch", "unknown_method",
          "tree_merge_empty", "row_counts", "rows_ids_counts",
          "offset_past_d", "negative_id", "bad_prefetch", "bool_prefetch",
          "wire_spec", "no_key", "wire_error_no_probes", "gate_tol",
          "n_buckets"]


@pytest.mark.parametrize("guard", GUARDS)
def test_guards_raise_as_in_jax(guard):
    with jax.threefry_partitionable(False):
        jcall, jmsg = _guard_cases(jax_streaming, jax.random.PRNGKey(0),
                                   jnp.asarray)[guard]
        with pytest.raises(ValueError, match=jmsg) as want:
            jcall()
    call, msg = _guard_cases(streaming, prng.PRNGKey(0), t)[guard]
    with pytest.raises(ValueError, match=msg) as got:
        call()
    assert type(got.value) is type(want.value)


def test_valid_boundaries_pass():
    summ = StreamingSummarizer(8, method="srht", device="cpu")
    state = summ.init(prng.PRNGKey(0), (64, 4, 3))
    summ.update(state, torch.ones(16, 4), torch.ones(16, 3), 48)
    summ.update_rows(state, torch.arange(48, 64), torch.ones(16, 4),
                     torch.ones(16, 3))


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 1, 2, 4])
@pytest.mark.parametrize("chunk", [16, 32, 96])
def test_ingest_bit_parity_with_update_loop(prefetch, chunk):
    A, B = pair(31, d=96, n1=9, n2=7)
    summ = StreamingSummarizer(8, probes=4, cosketch=4, device="cpu")
    ref = summ.init(prng.PRNGKey(42), (96, 9, 7))
    for off in range(0, 96, chunk):
        ref = summ.update(ref, t(A[off:off + chunk]), t(B[off:off + chunk]),
                          off)
    got = summ.ingest(summ.init(prng.PRNGKey(42), (96, 9, 7)),
                      ((A[off:off + chunk], B[off:off + chunk])
                       for off in range(0, 96, chunk)), prefetch=prefetch)
    assert_states_bit_equal(got, ref)


def test_ingest_resumes_from_row_high():
    A, B = pair(33, d=96)
    summ = StreamingSummarizer(8, device="cpu")
    ref = summ.update(summ.init(prng.PRNGKey(1), (96, N1, N2)), t(A[:32]),
                      t(B[:32]), 0)
    ref = summ.update(ref, t(A[32:64]), t(B[32:64]), 32)
    got = summ.ingest(summ.init(prng.PRNGKey(1), (96, N1, N2)),
                      [(t(A[:32]), t(B[:32]))])
    got = summ.ingest(got, [(t(A[32:64]), t(B[32:64]))])
    assert_states_bit_equal(got, ref)


def test_windowed_ingest_matches_head_bucket_updates():
    A, B = pair(35, d=96, n1=9, n2=7)
    ws = WindowedSummarizer(8, n_buckets=2, probes=4, device="cpu")
    ref = ws.init(prng.PRNGKey(42), (96, 9, 7))
    for off in range(0, 64, 32):
        ref = ws.update(ref, t(A[off:off + 32]), t(B[off:off + 32]), off)
    got = ws.ingest(ws.init(prng.PRNGKey(42), (96, 9, 7)),
                    ((t(A[off:off + 32]), t(B[off:off + 32]))
                     for off in range(0, 64, 32)), row_offset=0)
    assert torch.equal(got.head, ref.head)
    for x, y in zip(got.buckets, ref.buckets):
        assert_states_bit_equal(x, y)


# ---------------------------------------------------------------------------
# The wire format
# ---------------------------------------------------------------------------

def _jax_state(cosketch=0, decay=1.0, method="gaussian", probes=4, seed=37,
               dt=2):
    A, B = pair(seed, d=96, n1=9, n2=7)
    with jax.threefry_partitionable(False):
        summ = jax_streaming.StreamingSummarizer(
            8, method=method, probes=probes, cosketch=cosketch, decay=decay)
        st = summ.init(jax.random.PRNGKey(42), (96, 9, 7))
        st = summ.update(st, jnp.asarray(A), jnp.asarray(B), 0)
        return summ.advance(st, dt)


def _port_state(cosketch=0, decay=1.0, method="gaussian", probes=4, seed=37,
                dt=2):
    """``_jax_state`` built by the port, whose regenerated test matrices
    are its own draws."""
    A, B = pair(seed, d=96, n1=9, n2=7)
    summ = StreamingSummarizer(8, method=method, probes=probes,
                               cosketch=cosketch, decay=decay, device="cpu")
    st = summ.update(summ.init(prng.PRNGKey(42), (96, 9, 7)), t(A), t(B), 0)
    return summ.advance(st, dt)


WIRE_CASES = [(c, g, m) for c in (0, 4) for g in (1.0, 0.95)
              for m in ("gaussian", "srht")]


@pytest.mark.parametrize("spec", streaming.WIRE_DTYPES)
@pytest.mark.parametrize("cosketch,decay,method", WIRE_CASES)
def test_wire_pack_bytes_equal_jax(spec, cosketch, decay, method):
    """The same state packed by both packages: the same bytes, JSON header
    included; the quantized blocks (int8 rounds half to even in both) and
    the scales come out bit-identical on the way."""
    jstate = _jax_state(cosketch, decay, method)
    with jax.threefry_partitionable(False):
        want = jax_streaming.wire_pack(
            jax_streaming.compress_state(jstate, spec))
    comp = streaming.compress_state(to_port(jstate), spec)
    assert streaming.wire_pack(comp) == want
    assert streaming.wire_bytes(comp) == len(want) - 4 - int.from_bytes(
        want[:4], "little")


@pytest.mark.parametrize("spec", streaming.WIRE_DTYPES)
def test_wire_images_cross_both_ways(spec):
    """A JAX image unpacks in the port to the JAX compressed state (as
    numpy, exactly); a port image unpacks in JAX to the same leaves."""
    jstate = _jax_state(cosketch=4, decay=0.95)
    with jax.threefry_partitionable(False):
        jcomp = jax_streaming.compress_state(jstate, spec)
        jbytes = jax_streaming.wire_pack(jcomp)
    got = streaming.wire_unpack(jbytes, device="cpu")
    back = convert.compressed_state_to_numpy(got)
    for name, x, y in zip(jcomp._fields, back, jcomp):
        assert (x is None) == (y is None), name
        if x is not None:
            y = np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    pbytes = streaming.wire_pack(streaming.compress_state(to_port(jstate),
                                                          spec))
    unpacked = jax_streaming.wire_unpack(pbytes)
    for name, x, y in zip(jcomp._fields, unpacked, jcomp):
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=name)


@pytest.mark.parametrize("cosketch,decay,method", WIRE_CASES)
def test_f32_round_trip_is_bit_identical(cosketch, decay, method):
    st = _port_state(cosketch, decay, method)
    back = streaming.decompress_state(streaming.compress_state(st, "f32"))
    assert_states_bit_equal(back, streaming._settle_state(st))


@pytest.mark.parametrize("spec", streaming.WIRE_DTYPES)
@pytest.mark.parametrize("cosketch", [0, 4])
def test_norm_and_probe_blocks_bit_exact_at_every_precision(spec, cosketch):
    st = _port_state(cosketch)
    back = streaming.decompress_state(streaming.compress_state(st, spec))
    for name in ("na2", "nb2", "probe_acc", "omega", "rows_seen", "key"):
        assert torch.equal(getattr(back, name), getattr(st, name)), name
    if cosketch:
        assert torch.equal(back.cosketch_psi, st.cosketch_psi)


@pytest.mark.parametrize("spec", streaming.WIRE_DTYPES)
def test_wire_pack_round_trips_every_leaf(spec):
    comp = streaming.compress_state(to_port(_jax_state(4, 0.95)), spec)
    back = streaming.wire_unpack(streaming.wire_pack(comp), device="cpu")
    assert_states_bit_equal(back, comp)
    assert streaming.wire_bytes(back) == streaming.wire_bytes(comp)


@pytest.mark.parametrize("spec", ["bf16", "int8"])
@pytest.mark.parametrize("cosketch", [0, 4])
def test_wire_error_matches_jax(spec, cosketch):
    """wire_error and the gate's choice of both packages on the same
    state."""
    jstate = _jax_state(cosketch)
    with jax.threefry_partitionable(False):
        want = jax_streaming.wire_error(jstate, spec)
        want_spec, _ = jax_streaming.choose_wire_spec(jstate, tol=0.05)
    st = to_port(jstate)
    got = streaming.wire_error(st, spec)
    assert got == pytest.approx(want, rel=1e-4)
    assert streaming.choose_wire_spec(st, tol=0.05)[0].sketch == \
        want_spec.sketch


def test_wire_bytes_ordering_and_spec_bits():
    st = to_port(_jax_state(4))
    sizes = {s: streaming.wire_bytes(streaming.compress_state(st, s))
             for s in streaming.WIRE_DTYPES}
    assert sizes["f32"] > sizes["bf16"] > sizes["int8"]
    assert streaming.WireSpec("f32").bits == 32
    assert streaming.WireSpec("int8").bits == 8


@pytest.mark.parametrize("spec", ["bf16", "int8"])
@pytest.mark.parametrize("split", [32, 48, 64])
def test_quantized_merge_error_within_probe_bound(spec, split):
    """Two quantized-wire partials merged stay within the sum of their
    probe-measured wire errors (the JAX suite's bound)."""
    A, B = pair(39, d=96, n1=9, n2=7)
    summ = StreamingSummarizer(8, probes=4, device="cpu")
    parts, errs = [], []
    for lo, hi in ((0, split), (split, 96)):
        st = summ.update(summ.init(prng.PRNGKey(42), (96, 9, 7)),
                         t(A[lo:hi]), t(B[lo:hi]), lo)
        errs.append(streaming.wire_error(st, spec))
        parts.append(streaming.decompress_state(
            streaming.compress_state(st, spec)))
    merged = streaming.tree_merge(parts)
    exact = summ.update(summ.init(prng.PRNGKey(42), (96, 9, 7)), t(A), t(B),
                        0)
    w = exact.omega
    dev = (merged.A_acc.T @ (merged.B_acc @ w)
           - exact.A_acc.T @ (exact.B_acc @ w))
    rel = float(torch.sqrt((dev ** 2).sum() / (exact.probe_acc ** 2).sum()))
    assert rel <= 2.0 * (sum(errs) + 1e-6), (spec, rel, errs)


def test_wire_error_f32_is_zero_and_gate_is_total():
    st = to_port(_jax_state())
    assert streaming.wire_error(st, "f32") == 0.0
    spec, err = streaming.choose_wire_spec(st, tol=0.05)
    assert spec.sketch in streaming.WIRE_DTYPES and err <= 0.05
    spec, err = streaming.choose_wire_spec(st, tol=1e-12)
    assert spec == streaming.WireSpec("f32") and err == 0.0
    spec, err = streaming.choose_wire_spec(st, tol=1e-12,
                                           specs=("int8", "bf16"))
    assert spec == streaming.WireSpec("f32") and err == 0.0


STREAMING_EXPORTS = [
    "CompressedState", "StreamingSummarizer", "StreamState",
    "WindowedSummarizer", "WindowState", "WireSpec", "choose_wire_spec",
    "compress_state", "decay_state", "decompress_state", "finalize_state",
    "merge_states", "tree_merge", "window_bucket_key", "wire_bytes",
    "wire_error", "wire_pack", "wire_unpack"]


@pytest.mark.parametrize("name", STREAMING_EXPORTS)
def test_core_exports_the_streaming_names(name):
    """repro_torch.core exports the streaming names repro.core does."""
    import repro.core
    import repro_torch.core
    assert getattr(repro.core, name) is getattr(jax_streaming, name)
    assert getattr(repro_torch.core, name) is getattr(streaming, name)


def test_jax_summary_of_the_port_stream():
    """The finalized port stream, handed to the JAX package through
    convert, matches the JAX package's own summary to tolerance."""
    A, B = pair(41)
    s = streaming.finalize_state(port_ingest(43, A, B, 64))
    with jax.threefry_partitionable(False):
        want = jax_summary.build_summary(jax.random.PRNGKey(43),
                                         jnp.asarray(A), jnp.asarray(B), 16,
                                         backend="scan", block=64)
    for name in SUMMARY_FIELDS:
        g = getattr(s, name).numpy()
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(g, w, rtol=MERGE_RTOL,
                                   atol=MERGE_ATOL_SCALE * np.abs(w).max())
