"""The port's ``SketchService`` stream sessions and quality-gated serving on
the CPU: the twins of the JAX serving tests that waited for the serving
layer (tests/core/test_streaming.py's sessions, the serving tests of
test_streaming_drift.py, test_streaming_ingest.py's ``append_async``,
test_refinement.py's refined stream) and of the quality-gated serving
tests of tests/core/test_error_engine.py.

Inputs are made with numpy from a seed. On the CPU a stream appended in
chunks that divide d equals the ``scan`` backend at ``block`` = chunk bit
for bit (BLAS blocks a row sum by the chunk's length, so other chunkings
agree to float32 rounding only).
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.ckpt import checkpoint
from repro_torch.core import streaming, summary_engine
from repro_torch.core.refinement import RefineSpec
from repro_torch.core.streaming import (
    StreamingSummarizer, WindowedSummarizer, WindowState, finalize_state)
from repro_torch.serve.engine import SketchService

D, N1, N2 = 192, 11, 7
# A stream whose chunks arrive out of order against the one-shot scan
# summary: the same float32 terms added in another order, each entry within
# 2e-5 of the summary's own (the JAX test's reassociation tolerance).
REASSOC_RTOL = 2e-5
# The refinement's small QR and least squares on the CPU (threaded MKL)
# do not repeat their last bits from call to call on equal inputs (up to
# 5.3e-7 of the largest entry over 30 repeats), so refined factors are held
# to 1e-5 of their largest entry, tests/test_torch_baselines.py's
# LOOPED_RTOL.
REFINE_RTOL = 1e-5
# The gate's known spectrum (tests/core/test_error_engine.py).
GATE_SPECTRUM = [16.0, 12.0, 8.0, 6.0, 4.0, 3.0, 0.05, 0.02]


def pair(seed, d=D, n1=N1, n2=N2):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((d, n1)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((d, n2)).astype(np.float32)))


def known_spectrum_pair(seed, d, n1, n2, spectrum):
    """tests/conftest.py::known_spectrum_pair with numpy draws."""
    rng = np.random.default_rng(seed)
    s = np.asarray(spectrum, np.float64)
    q = s.shape[0]
    W = np.linalg.qr(rng.standard_normal((d, n1)))[0]
    U0 = np.linalg.qr(rng.standard_normal((n1, q)))[0]
    V0 = np.linalg.qr(rng.standard_normal((n2, q)))[0]
    return (torch.from_numpy(W.astype(np.float32)),
            torch.from_numpy((W @ ((U0 * s) @ V0.T)).astype(np.float32)))


def drifting_pair(seed, d=256, n1=14, n2=12, q=3):
    """tests/conftest.py::drifting_spectrum_pair with numpy draws: two
    phases with ``Ai^T Bi = Mi`` exactly and disjoint top-q left
    subspaces."""
    rng = np.random.default_rng(seed)
    U_all = np.linalg.qr(rng.standard_normal((n1, 2 * q)))[0]
    U1, U2 = U_all[:, :q], U_all[:, q:]
    V1 = np.linalg.qr(rng.standard_normal((n2, q)))[0]
    V2 = np.linalg.qr(rng.standard_normal((n2, q)))[0]
    M1, M2 = 8.0 * U1 @ V1.T, 4.0 * U2 @ V2.T
    W1 = np.linalg.qr(rng.standard_normal((d, n1)))[0]
    W2 = np.linalg.qr(rng.standard_normal((d, n1)))[0]
    f = lambda x: torch.from_numpy(x.astype(np.float32))   # noqa: E731
    return (f(W1), f(W1 @ M1), f(U1)), (f(W2), f(W2 @ M2), f(U2))


def service(k=8, **kw):
    return SketchService(k=k, backend="scan", block=32, device="cpu", **kw)


def assert_summary_bit_equal(got, want,
                             names=("A_sketch", "B_sketch", "norm_A",
                                    "norm_B")):
    for name in names:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def assert_state_bit_equal(a, b):
    """Two states, field by field (window rings bucket by bucket)."""
    assert type(a) is type(b)
    for name, x, y in zip(a._fields, a, b):
        assert (x is None) == (y is None), name
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                assert_state_bit_equal(u, v)
        elif x is not None:
            assert torch.equal(x, y), name


@pytest.fixture()
def key():
    return prng.PRNGKey(0)


# ---------------------------------------------------------------------------
# Sessions (tests/core/test_streaming.py)
# ---------------------------------------------------------------------------

def test_resume_cursor_is_high_water_mark(key, tmp_path):
    """An out-of-order pass checkpointed and resumed continues appending
    after the highest absorbed row, not after rows_seen."""
    A, B = pair(1, d=128, n1=10, n2=8)
    svc = service()
    sid = svc.open_stream(key, 128, 10, 8)
    svc.append(sid, A[32:64], B[32:64], row_offset=32)   # out of order first
    state = svc.close_stream(sid)
    assert int(state.rows_seen) == 32 and int(state.row_high) == 64
    checkpoint.save_stream_state(str(tmp_path), 0, state)
    restored = checkpoint.restore_stream_state(
        str(tmp_path), like=StreamingSummarizer(8, device="cpu").init(
            key, (128, 10, 8)))
    sid2 = svc.open_stream(key, 128, 10, 8, state=restored)
    svc.append(sid2, A[64:96], B[64:96])          # default cursor -> row 64
    svc.append(sid2, A[96:], B[96:])
    svc.append(sid2, A[:32], B[:32], row_offset=0)        # backfill the gap
    got = svc.query(sid2)
    want = summary_engine.build_summary(key, A, B, 8, backend="scan",
                                        block=32, device="cpu")
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=REASSOC_RTOL, atol=0)


def test_open_stream_resume_validation(key):
    """Resuming with a mismatched state (shape, key, method, blocks or
    decay) raises instead of silently breaking the stream_factors
    parity."""
    svc = service()
    state = StreamingSummarizer(8, device="cpu").init(key, (64, 4, 3))
    with pytest.raises(ValueError, match="does not match"):
        svc.open_stream(key, 64, 5, 3, state=state)      # wrong n1
    with pytest.raises(ValueError, match="does not match"):
        svc.open_stream(key, 128, 4, 3, state=state)     # wrong d
    with pytest.raises(ValueError, match="different base key"):
        svc.open_stream(prng.PRNGKey(99), 64, 4, 3, state=state)
    srht_state = StreamingSummarizer(8, method="srht", device="cpu").init(
        key, (64, 4, 3))
    with pytest.raises(ValueError, match="method"):
        svc.open_stream(key, 64, 4, 3, state=srht_state)
    with pytest.raises(ValueError, match="decay clock"):
        svc.open_stream(key, 64, 4, 3, state=state, decay=0.5)
    decayed = StreamingSummarizer(8, decay=0.9, device="cpu").init(
        key, (64, 4, 3))
    with pytest.raises(ValueError, match="decayed at rate"):
        svc.open_stream(key, 64, 4, 3, state=decayed, decay=0.5)
    with pytest.raises(ValueError, match="probe"):
        service(probes=4).open_stream(key, 64, 4, 3, state=state)
    with pytest.raises(ValueError, match="co-sketch"):
        service(cosketch=2).open_stream(key, 64, 4, 3, state=state)
    sid = svc.open_stream(key, 64, 4, 3, state=state)    # matching: fine
    assert svc.append(sid, torch.ones(32, 4), torch.ones(32, 3)) == 32


def test_stream_session_matches_one_shot_flush(key):
    """open_stream/append/query == submit/flush, and stream_factors ==
    flush_factors, bit for bit when the chunks are the service's block (on
    the CPU: the chunk divides d)."""
    A, B = pair(2, d=128, n1=10, n2=8)
    svc = service()
    sid = svc.open_stream(key, 128, 10, 8)
    for off in range(0, 128, 32):
        seen = svc.append(sid, A[off:off + 32], B[off:off + 32])
    assert seen == 128
    ticket = svc.submit(key, A, B)
    flushed = svc.flush()[ticket]
    assert_summary_bit_equal(svc.query(sid), flushed)

    ticket = svc.submit(key, A, B)
    ff = svc.flush_factors(r=2, m=200, T=2)[ticket]
    sf = svc.stream_factors(sid, r=2, m=200, T=2)
    assert torch.equal(sf.factors.U, ff.factors.U)
    assert torch.equal(sf.factors.V, ff.factors.V)
    state = svc.close_stream(sid)
    assert int(state.rows_seen) == 128
    assert sid not in svc._streams


def test_stream_session_ragged_chunks_match_flush_to_rounding(key):
    """Chunks that do not divide d (48 rows against the service's block of
    32): the session's summary equals the one-shot flush to float32
    rounding of a reassociated row sum."""
    A, B = pair(3, d=128, n1=10, n2=8)
    svc = service()
    sid = svc.open_stream(key, 128, 10, 8)
    for off in range(0, 128, 48):
        svc.append(sid, A[off:off + 48], B[off:off + 48])
    ticket = svc.submit(key, A, B)
    flushed = svc.flush()[ticket]
    got = svc.query(sid)
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        torch.testing.assert_close(getattr(got, name),
                                   getattr(flushed, name),
                                   rtol=REASSOC_RTOL, atol=1e-6)


def test_stream_session_resumes_from_checkpoint(key, tmp_path):
    """A checkpointed state seeds a fresh session (open_stream(state=))."""
    A, B = pair(4, d=128, n1=10, n2=8)
    svc = service()
    sid = svc.open_stream(key, 128, 10, 8)
    svc.append(sid, A[:32], B[:32])
    svc.append(sid, A[32:64], B[32:64])
    checkpoint.save_stream_state(str(tmp_path), 64, svc.close_stream(sid))

    svc2 = service()
    restored = checkpoint.restore_stream_state(
        str(tmp_path), like=StreamingSummarizer(8, device="cpu").init(
            key, (128, 10, 8)))
    sid2 = svc2.open_stream(key, 128, 10, 8, state=restored)
    svc2.append(sid2, A[64:96], B[64:96])         # cursor resumed at 64
    assert svc2.append(sid2, A[96:], B[96:]) == 128
    assert_summary_bit_equal(
        svc2.query(sid2),
        summary_engine.build_summary(key, A, B, 8, backend="scan", block=32,
                                     device="cpu"))


def test_service_append_async_matches_append(key):
    """append_async (StreamingSummarizer.ingest) leaves the session state
    the append loop leaves, bit for bit."""
    A, B = pair(5, d=96, n1=9, n2=7)
    ref_svc = SketchService(k=8, probes=4, device="cpu")
    ref_sid = ref_svc.open_stream(key, 96, 9, 7)
    got_svc = SketchService(k=8, probes=4, device="cpu")
    got_sid = got_svc.open_stream(key, 96, 9, 7)
    for off in range(0, 96, 32):
        ref_svc.append(ref_sid, A[off:off + 32], B[off:off + 32])
    n = got_svc.append_async(
        got_sid, ((A[off:off + 32], B[off:off + 32])
                  for off in range(0, 96, 32)))
    assert n == 96
    assert_state_bit_equal(got_svc._streams[got_sid].state,
                           ref_svc._streams[ref_sid].state)
    assert got_svc.append(got_sid, A[:0], B[:0]) == 96    # cursor kept


def test_export_stream_round_trips(key):
    """export_stream: lossless f32 by default (the decompressed state is
    the session's), and the probe-measured gate under tol=."""
    A, B = pair(6)
    svc = service(probes=4)
    sid = svc.open_stream(key, D, N1, N2)
    svc.append(sid, A, B)
    back = streaming.decompress_state(svc.export_stream(sid))
    assert_summary_bit_equal(finalize_state(back), svc.query(sid))
    comp = svc.export_stream(sid, tol=1e-2)
    assert streaming.wire_bytes(comp) <= \
        streaming.wire_bytes(svc.export_stream(sid))
    wsid = svc.open_stream(key, D, N1, N2, window=2)
    svc.append(wsid, A, B)
    back = streaming.decompress_state(svc.export_stream(wsid, wire="bf16"))
    assert torch.equal(back.key, key)


# ---------------------------------------------------------------------------
# Drifting sessions (tests/core/test_streaming_drift.py)
# ---------------------------------------------------------------------------

def test_serving_decayed_session_matches_manual(key):
    """A decay= session is the manual summarizer lifecycle, bit for bit:
    append/advance/query against update/advance/finalize."""
    A, B = pair(41)
    svc = service(probes=2)
    sid = svc.open_stream(key, D, N1, N2, decay=0.5)
    svc.append(sid, A[:96], B[:96])
    svc.advance_stream(sid, 2)
    svc.append(sid, A[96:], B[96:])
    got = svc.query(sid)
    summ = StreamingSummarizer(8, probes=2, decay=0.5, device="cpu")
    s = summ.update(summ.init(key, (D, N1, N2)), A[:96], B[:96], 0)
    s = summ.update(summ.advance(s, 2), A[96:], B[96:], 96)
    assert_summary_bit_equal(got, finalize_state(s))
    assert svc.close_stream(sid).decayed


def test_serving_windowed_session_lifecycle(key):
    """A window= session slides with advance_stream (the cursor restarts
    each epoch) and forgets expired epochs; stream_factors answers 'top-r
    now' through the gated rank."""
    (A1, B1, _), (A2, B2, U2) = drifting_pair(0)
    d, n1, n2 = A1.shape[0], A1.shape[1], B1.shape[1]
    svc = service(k=128, probes=4)
    sid = svc.open_stream(key, d, n1, n2, window=2)
    svc.append(sid, A1, B1)
    svc.advance_stream(sid)
    assert svc.append(sid, A2, B2) == 2 * d        # cursor restarted at 0
    svc.advance_stream(sid)                        # phase 1 expires
    est = svc.stream_factors(sid, r="auto", tol=0.35, m=600, T=3,
                             with_error=True)
    assert est.error is not None
    Uh = est.factors.U
    resid = float(torch.linalg.matrix_norm(U2 - Uh @ (Uh.T @ U2), 2))
    assert resid < 0.6, resid
    assert isinstance(svc.close_stream(sid), WindowState)


def test_serving_windowed_resume_roundtrip(key, tmp_path):
    """close_stream -> save_window_state -> restore -> open_stream(state=)
    resumes the ring bit for bit."""
    A, B = pair(43)
    svc = service(probes=2)
    sid = svc.open_stream(key, D, N1, N2, window=2)
    svc.append(sid, A, B)
    svc.advance_stream(sid)
    w = svc.close_stream(sid)
    checkpoint.save_window_state(str(tmp_path), 0, w)
    win = WindowedSummarizer(8, 2, probes=2, device="cpu")
    restored = checkpoint.restore_window_state(
        str(tmp_path), win.init(key, (D, N1, N2)))
    sid2 = svc.open_stream(key, D, N1, N2, window=2, state=restored)
    assert_summary_bit_equal(svc.query(sid2), win.finalize(w))
    with pytest.raises(ValueError, match="resized"):
        svc.open_stream(key, D, N1, N2, window=3, state=restored)
    with pytest.raises(ValueError, match="different base key"):
        svc.open_stream(prng.PRNGKey(9), D, N1, N2, window=2, state=restored)
    with pytest.raises(ValueError, match="WindowState"):
        svc.open_stream(key, D, N1, N2, state=restored)


def test_serving_decayed_resume_roundtrip(key, tmp_path):
    """Decayed sessions resume through save_stream_state (pending clock
    included) and keep ticking."""
    A, B = pair(47)
    svc = service()
    sid = svc.open_stream(key, D, N1, N2, decay=0.5)
    svc.append(sid, A[:96], B[:96])
    svc.advance_stream(sid, 3)
    s = svc.close_stream(sid)
    checkpoint.save_stream_state(str(tmp_path), 0, s)
    summ = StreamingSummarizer(8, decay=0.5, device="cpu")
    restored = checkpoint.restore_stream_state(
        str(tmp_path), summ.init(key, (D, N1, N2)))
    sid2 = svc.open_stream(key, D, N1, N2, decay=0.5, state=restored)
    svc.append(sid2, A[96:], B[96:], 96)
    want = finalize_state(summ.update(s, A[96:], B[96:], 96))
    assert_summary_bit_equal(svc.query(sid2), want,
                             names=("A_sketch", "B_sketch"))


def test_serving_session_raises(key):
    svc = service()
    with pytest.raises(ValueError, match="decay= OR window=, not both"):
        svc.open_stream(key, D, N1, N2, decay=0.5, window=2)
    sid = svc.open_stream(key, D, N1, N2)
    with pytest.raises(ValueError, match="no time axis"):
        svc.advance_stream(sid)


# ---------------------------------------------------------------------------
# Refined and quality-gated serving (test_refinement.py, test_error_engine.py)
# ---------------------------------------------------------------------------

def test_service_stream_refined_matches_one_shot(key):
    """stream_factors with a co-sketch-carrying service reproduces the
    one-shot flush_factors under method='power' + refine: the summary (the
    sketches and the co-sketch pair) bit for bit (chunks of the service's
    block), the refined factors within REFINE_RTOL."""
    A, B = pair(8, d=64)
    svc = service(cosketch=3)
    t = svc.submit(key, A, B)
    served = svc.flush_factors(r=2, est_method="power",
                               refine=RefineSpec(1, "power"))[t]
    sid = svc.open_stream(key, 64, N1, N2)
    svc.append(sid, A[:32], B[:32])
    svc.append(sid, A[32:], B[32:])
    est = svc.stream_factors(sid, r=2, est_method="power",
                             refine=RefineSpec(1, "power"))
    assert_summary_bit_equal(
        est.summary, served.summary,
        names=("A_sketch", "B_sketch", "norm_A", "norm_B", "cosketch_Y",
               "cosketch_W"))
    for got, want in zip(est.factors, served.factors):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=REFINE_RTOL * float(want.abs().max()))


def test_quality_gated_flush_escalates_until_pass(key):
    """r='auto' escalates the bucket's rank until every request's estimate
    meets tol; the served error is the gate's estimate."""
    A, B = known_spectrum_pair(0, 384, 14, 12, GATE_SPECTRUM)
    svc = service(k=512, probes=24)
    t0 = svc.submit(key, A, B)
    t1 = svc.submit(prng.fold_in(key, 7), A, B)
    out = svc.flush_factors(r="auto", tol=0.2, m=1500, T=4,
                            est_method="direct_svd")
    for t in (t0, t1):
        assert out[t].error is not None
        assert float(out[t].error.rel_est) <= 0.2
        assert 8 <= out[t].factors.r <= 12       # escalated past rank 4
    t2 = svc.submit(key, A, B)                   # a loose tol stops at 4
    loose = svc.flush_factors(r="auto", tol=0.3, m=1500, T=4,
                              est_method="direct_svd")
    assert loose[t2].factors.r == 4


def test_quality_gated_stream_matches_flush(key):
    """Gated stream_factors == gated flush_factors for the same key and
    pair (same escalation, same key derivation), bit for bit on the CPU."""
    A, B = pair(9, d=128, n1=10, n2=8)
    svc = service(k=16, probes=8)
    sid = svc.open_stream(key, 128, 10, 8)
    for off in range(0, 128, 32):
        svc.append(sid, A[off:off + 32], B[off:off + 32])
    sf = svc.stream_factors(sid, r="auto", tol=0.5, m=300, T=2)
    ticket = svc.submit(key, A, B)
    ff = svc.flush_factors(r="auto", tol=0.5, m=300, T=2)[ticket]
    assert torch.equal(sf.factors.U, ff.factors.U)
    assert torch.equal(sf.summary.probes, ff.summary.probes)


def test_quality_gated_guards(key):
    svc = service(k=8, probes=0)
    A, B = pair(10, d=64, n1=6, n2=5)
    svc.submit(key, A, B)
    with pytest.raises(ValueError, match="probe"):
        svc.flush_factors(r="auto", tol=0.5)
    with pytest.raises(ValueError, match="tol"):
        service(k=8, probes=4).flush_factors(r="auto")
    with pytest.raises(ValueError, match="int or 'auto'"):
        service(k=8, probes=4).flush_factors(r=2.5)
    state = StreamingSummarizer(8, device="cpu").init(key, (64, 4, 3))
    with pytest.raises(ValueError, match="probe"):
        service(k=8, probes=4).open_stream(key, 64, 4, 3, state=state)
