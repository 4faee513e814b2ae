"""The port's training-side sketches against the JAX package's:
``identity_product_summary`` and ``tap_pair_summary``
(``core/summary_engine.py``), gradient compression
(``optim/grad_compression.py``), the gradient-tap layer
(``train/sketched_dense.py``) and ``data/pipeline.py::cooccurrence_stream``
(the twins of tests/train/test_training.py's compression, tap and data
tests and of tests/core/test_streaming.py::test_tap_state_monoid).

Inputs are made with numpy from a seed and handed to both packages; every
jax call runs under the classic key tree. The summed-over-workers paths run
in a 2-process gloo cell (``test_torch_distributed.run_ranks``), held
against the JAX package's functions composed by hand over the same
per-worker inputs.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_distributed import run_ranks

from repro.core import sketch as jax_sketch
from repro.core import streaming as jax_streaming
from repro.core import summary_engine as jax_summary
from repro.core.types import SketchSummary as JaxSummary
from repro.data import pipeline as jax_data
from repro.optim import grad_compression as jgc
from repro.train import sketched_dense as jsd
from repro_torch import convert, prng
from repro_torch.core import streaming, summary_engine
from repro_torch.data import pipeline as data
from repro_torch.optim import grad_compression as gc
from repro_torch.train import sketched_dense as sd

# repro.core exports the function smppca under its module's name
jax_smppca = importlib.import_module("repro.core.smppca")

# Sketches and norms: float32 sums of the same terms in other orders, and
# normals an ulp apart now and then: each column within 1e-5 of its own
# largest entry.
RTOL = 1e-5
# Reconstructions through sampling and WAltMin: the same keys and samples
# (up to a rare inverse-CDF tie), float32 sums in other orders; the
# slice's tolerance on U V^T (tests/test_torch_smppca.py's SLICE_RTOL).
RECON_RTOL = 1e-3


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_columns_close(got, want, rtol=RTOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = (np.abs(want).max(axis=-2, keepdims=True) if want.ndim >= 2
             else np.abs(want).max(initial=0.0))
    err = np.abs(got - want)
    assert np.all(err <= rtol * np.maximum(scale, 1e-30)), \
        (what, float(err.max()))


def rel(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# the structured-product summaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", [None, "bf16"])
def test_identity_product_summary_matches_jax(precision):
    G = normal(0, 96, 128)
    with jax.threefry_partitionable(False):
        want = jax_summary.identity_product_summary(
            jax.random.PRNGKey(3), jnp.asarray(G), 32, precision=precision)
    got = summary_engine.identity_product_summary(
        prng.PRNGKey(3), t(G), 32, precision=precision, device="cpu")
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        assert_columns_close(getattr(got, name), getattr(want, name),
                             what=name)
    np.testing.assert_array_equal(got.norm_A.numpy(), np.asarray(want.norm_A))


@pytest.mark.parametrize("keys", ["split", "stack"])
def test_identity_product_summary_stacked_matches_jax(keys):
    """A stacked (L, n1, n2) layer group: the key split L ways, or a stack
    of L keys, as the JAX package's batched mode takes them."""
    G = normal(1, 3, 64, 72)
    with jax.threefry_partitionable(False):
        jk = jax.random.PRNGKey(4)
        if keys == "stack":
            jk = jax.random.split(jk, 3)
        want = jax_summary.identity_product_summary(jk, jnp.asarray(G), 16)
    key = convert.key_from_numpy(np.asarray(jk))
    got = summary_engine.identity_product_summary(key, t(G), 16,
                                                  device="cpu")
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        assert_columns_close(getattr(got, name), getattr(want, name),
                             what=name)


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_tap_pair_summary_matches_jax(precision):
    X, Y = normal(2, 300, 40), normal(3, 300, 24)
    with jax.threefry_partitionable(False):
        want = jax_summary.tap_pair_summary(jax.random.PRNGKey(5),
                                            jnp.asarray(X), jnp.asarray(Y),
                                            16, precision=precision)
    got = summary_engine.tap_pair_summary(prng.PRNGKey(5), t(X), t(Y), 16,
                                          precision=precision)
    assert len(got) == 4
    for name, g, w in zip(("As", "Bs", "na2", "nb2"), got, want):
        assert g.dtype == torch.float32
        assert_columns_close(g, w, what=name)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_error_feedback_accumulates_residual():
    """The twin of tests/train/test_training.py's: residual = input -
    reconstruction, fed into the next step, and both steps against the JAX
    package's on the same gradients."""
    G, G2 = normal(10, 96, 128), normal(11, 96, 128)
    cfg = gc.CompressionConfig(rank=4, sketch_k=256)
    key = prng.PRNGKey(0)
    st0 = gc.init_state({"w": t(G)})
    out, st1, _ = gc.compress_grads(key, {"w": t(G)}, st0, cfg)
    torch.testing.assert_close(st1.err["w"], t(G) - out["w"], rtol=1e-4,
                               atol=1e-4)
    out2, st2, _ = gc.compress_grads(key, {"w": t(G2)}, st1, cfg)
    torch.testing.assert_close(st2.err["w"], t(G2) + st1.err["w"] - out2["w"],
                               rtol=1e-4, atol=1e-4)
    assert int(st2.step) == 2
    with jax.threefry_partitionable(False):
        jcfg = jgc.CompressionConfig(rank=4, sketch_k=256)
        jkey = jax.random.PRNGKey(0)
        j1, js1, _ = jgc.compress_grads(
            jkey, {"w": jnp.asarray(G)},
            jgc.init_state({"w": jnp.asarray(G)}), jcfg)
        j2, js2, _ = jgc.compress_grads(jkey, {"w": jnp.asarray(G2)}, js1,
                                        jcfg)
    assert rel(out["w"], j1["w"]) < RECON_RTOL
    assert rel(out2["w"], j2["w"]) < RECON_RTOL
    assert rel(st2.err["w"], js2.err["w"]) < RECON_RTOL


def test_compress_grads_tree_matches_jax():
    """Nested dicts and lists walked in jax.tree.flatten's order (sorted
    keys), so leaf i's key is the JAX package's: a stacked layer group, a
    matrix, and leaves too small to compress; the error state's tree, the
    step and the stats alike."""
    grads = {"layers": [{"w": normal(20, 2, 64, 80), "b": normal(21, 80)},
                        {"w": normal(22, 72, 64)}],
             "bias": normal(23, 5), "small": normal(24, 8, 100)}
    cfg = dict(rank=3, sketch_k=64)
    with jax.threefry_partitionable(False):
        jg = jax.tree.map(jnp.asarray, grads)
        jst = jgc.init_state(jg)
        jout, jst, jstats = jgc.compress_grads(
            jax.random.PRNGKey(9), jg, jst, jgc.CompressionConfig(**cfg))
        jout = jax.tree.map(np.asarray, jout)
        jst = jax.tree.map(np.asarray, jst)
    pg = jax.tree.map(t, grads)
    st = gc.init_state(pg)
    out, st, stats = gc.compress_grads(prng.PRNGKey(9), pg, st,
                                       gc.CompressionConfig(**cfg))
    assert stats == jstats
    assert jax.tree.structure(jax.tree.map(lambda x: 0, out)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, jout))
    for (path, w), g, e, we in zip(
            jax.tree_util.tree_flatten_with_path(jout)[0],
            jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), out)),
            jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), st.err)),
            jax.tree.leaves(jst.err)):
        assert g.shape == w.shape and e.shape == we.shape, path
        if w.ndim >= 2:
            assert rel(g, w) < RECON_RTOL, path
        else:
            np.testing.assert_array_equal(g, w)
    assert int(st.step) == int(jst.step) == 1
    # the residual tree crosses between the packages unchanged
    again = convert.compression_state_to_numpy(
        convert.compression_state_from_numpy(jst))
    for a, b in zip(jax.tree.leaves(again.err), jax.tree.leaves(jst.err)):
        np.testing.assert_array_equal(a, b)
    assert int(again.step) == 1


# ---------------------------------------------------------------------------
# the gradient tap
# ---------------------------------------------------------------------------

def _tap_inputs():
    w = normal(30, 64, 96) * 0.1
    x = normal(31, 4, 32, 64)
    return w, x


def test_sketched_dense_taps_ride_grads():
    """The twin of tests/train/test_training.py's: dW is zero, the taps
    carry the sketches, dx is the uncompressed layer's (against
    torch.autograd on x @ w and against the JAX package's dx), and the
    taps are the JAX package's tap gradients."""
    w_np, x_np = _tap_inputs()
    key = prng.PRNGKey(0)
    w = t(w_np).requires_grad_()
    x = t(x_np).requires_grad_()
    taps = {f: v.requires_grad_() for f, v in
            sd.tap_init(64, 96, 16, device="cpu").items()}
    y = sd.sketched_dense(w, taps, x, key, 16, 32)
    torch.mean(y ** 2).backward()
    assert bool((w.grad == 0).all())              # dW never formed
    assert float(taps["a"].grad.abs().sum()) > 0  # sketches present
    assert x.grad.shape == x.shape
    x2 = t(x_np).requires_grad_()
    torch.mean((x2 @ t(w_np)) ** 2).backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-4, atol=1e-5)
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(0)

        def loss(w, taps, x):
            return jnp.mean(jsd.sketched_dense(w, taps, x, jkey, 16, 32) ** 2)

        jw, jtaps, jx = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(w_np), jsd.tap_init(64, 96, 16), jnp.asarray(x_np))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-6)
    for f in sd.TAP_FIELDS:
        assert_columns_close(taps[f].grad, jtaps[f], what=f)


def test_sketched_dense_taps_are_the_tap_pair_summary():
    """The taps' gradients are ``tap_pair_summary`` of (x, dy) flattened
    over the tokens, bit for bit."""
    w_np, x_np = _tap_inputs()
    key = prng.PRNGKey(2)
    w, x = t(w_np), t(x_np)
    taps = {f: v.requires_grad_() for f, v in
            sd.tap_init(64, 96, 8, device="cpu").items()}
    y = sd.sketched_dense(w, taps, x, key, 8)
    gy = torch.ones_like(y) / y.numel()
    y.backward(gy)
    want = summary_engine.tap_pair_summary(key, x.reshape(-1, 64),
                                           gy.reshape(-1, 96), 8)
    for f, v in zip(sd.TAP_FIELDS, want):
        assert torch.equal(taps[f].grad, v), f


def test_decompress_tapped_grads_walks_stacked_layers():
    """The twin of tests/train/test_training.py's: a stacked (3, ...)
    layer group in a list under a dict gets a (3, 32, 48) dW and zeroed
    taps."""
    k = 16
    grads = {"groups": [{"w": torch.zeros(3, 32, 48),
                         "taps": {"a": torch.ones(3, k, 32),
                                  "b": torch.ones(3, k, 48),
                                  "na2": torch.ones(3, 32),
                                  "nb2": torch.ones(3, 48)}}]}
    out = sd.decompress_tapped_grads(prng.PRNGKey(0), grads,
                                     sd.TapConfig(sketch_k=k, rank=2))
    assert out["groups"][0]["w"].shape == (3, 32, 48)
    assert float(out["groups"][0]["taps"]["a"].abs().sum()) == 0.0


def test_decompress_tapped_grads_matches_jax():
    """Real tap gradients of a stacked group and of a lone layer, walked
    under fold_in over sorted items and split over the layers: each
    reconstruction against the JAX package's."""
    rng = np.random.default_rng(40)
    k = 16

    def taps(L, n1, n2, seed):
        X, Y = normal(seed, 200, n1), normal(seed + 1, 200, n2)
        out = [np.asarray(x) for x in jax_summary.tap_pair_summary(
            jax.random.PRNGKey(seed), jnp.asarray(X), jnp.asarray(Y), k)]
        if L:
            out = [np.stack([x * (1.0 + i) for i in range(L)]) for x in out]
        return dict(zip(sd.TAP_FIELDS, out))

    with jax.threefry_partitionable(False):
        tree = {"stack": {"w": np.zeros((2, 40, 56), np.float32),
                          "taps": taps(2, 40, 56, 41)},
                "dense": {"w": np.zeros((48, 32), np.float32),
                          "taps": taps(0, 48, 32, 43)},
                "other": rng.standard_normal(3).astype(np.float32)}
        cfg = dict(sketch_k=k, rank=3, als_iters=3)
        want = jsd.decompress_tapped_grads(
            jax.random.PRNGKey(8), jax.tree.map(jnp.asarray, tree),
            jsd.TapConfig(**cfg))
        want = jax.tree.map(np.asarray, want)
    got = sd.decompress_tapped_grads(
        prng.PRNGKey(8), convert.taps_from_numpy(tree), sd.TapConfig(**cfg))
    for name in ("stack", "dense"):
        assert rel(got[name]["w"], want[name]["w"]) < RECON_RTOL, name
        for f in sd.TAP_FIELDS:
            assert float(got[name]["taps"][f].abs().sum()) == 0.0
    np.testing.assert_array_equal(got["other"].numpy(), tree["other"])
    assert convert.taps_to_numpy(got)["dense"]["w"].shape == (48, 32)


def test_tap_state_monoid():
    """The twin of tests/core/test_streaming.py's: accumulate_taps is
    merge_states on the wrapped states; decompress_tap finalizes through
    streaming.finalize_state."""
    def mk(seed):
        return {"a": t(normal(seed, 8, 6)), "b": t(normal(seed + 1, 8, 5)),
                "na2": t(np.abs(normal(seed + 2, 6))),
                "nb2": t(np.abs(normal(seed + 3, 5)))}
    t1, t2 = mk(50), mk(60)
    acc = sd.accumulate_taps(t1, t2)
    merged = streaming.merge_states(sd.tap_state(t1), sd.tap_state(t2))
    for f, name in zip(sd.TAP_FIELDS, ("A_acc", "B_acc", "na2", "nb2")):
        assert torch.equal(acc[f], t1[f] + t2[f]), f
        assert torch.equal(acc[f], getattr(merged, name)), f
    s = streaming.finalize_state(sd.tap_state(t1))
    torch.testing.assert_close(s.norm_A, torch.sqrt(t1["na2"]), rtol=1e-6,
                               atol=0)
    dw = sd.decompress_tap(prng.PRNGKey(0), t1,
                           sd.TapConfig(sketch_k=8, rank=2, als_iters=2))
    assert dw.shape == (6, 5)


# ---------------------------------------------------------------------------
# the data source
# ---------------------------------------------------------------------------

def test_cooccurrence_stream_order_independent_summary():
    """The twin of tests/train/test_training.py's: the shuffled stream's
    merged row summaries equal the in-order summary; the stream's arrays
    are the JAX package's, bit for bit."""
    from repro_torch.core import sketch
    d, n1, n2 = 256, 12, 10
    chunks = list(data.cooccurrence_stream(0, d, n1, n2, rank=3, chunk=64))
    for (r, a, b), (jr, ja, jb) in zip(
            chunks, jax_data.cooccurrence_stream(0, d, n1, n2, rank=3,
                                                 chunk=64)):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
    key = prng.PRNGKey(0)
    merged = None
    for rows, Ar, Br in chunks:
        s = sketch.streamed_rows_summary(key, t(rows), t(Ar), t(Br), k=16)
        merged = s if merged is None else sketch.merge_summaries(merged, s)
    A = np.zeros((d, n1), np.float32)
    B = np.zeros((d, n2), np.float32)
    for rows, Ar, Br in chunks:
        A[rows], B[rows] = Ar, Br
    ref = sketch.streamed_rows_summary(key, torch.arange(d), t(A), t(B),
                                       k=16)
    torch.testing.assert_close(merged.A_sketch, ref.A_sketch, rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# summed over workers: a 2-process cell
# ---------------------------------------------------------------------------

WORKERS = dict(seed=70, n1=96, n2=80, k=32, rank=3, sketch_k=64)

CELL = """
from repro_torch import prng
from repro_torch.core import summary_engine as se
from repro_torch.optim import grad_compression as gc

c = {consts}
rng = np.random.default_rng(c["seed"] + RANK)
G = torch.from_numpy(rng.standard_normal((c["n1"], c["n2"])).astype(np.float32))
b = torch.from_numpy(rng.standard_normal(7).astype(np.float32))
s = se.identity_product_summary(prng.PRNGKey(1), G, c["k"],
                                group=dist.group.WORLD, n_workers=WORLD,
                                device="cpu")
for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
    save(f"summary/{{name}}", getattr(s, name))
grads = {{"w": G, "b": b}}
cfg = gc.CompressionConfig(rank=c["rank"], sketch_k=c["sketch_k"])
out, st, stats = gc.compress_grads(prng.PRNGKey(2), grads, gc.init_state(grads),
                                   cfg, group=dist.group.WORLD,
                                   n_workers=WORLD)
save("out/w", out["w"])
save("out/b", out["b"])
save("err/w", st.err["w"])
save("comm_fraction", np.asarray(stats["comm_fraction"]))
"""


def _worker_inputs(w):
    rng = np.random.default_rng(WORKERS["seed"] + w)
    G = rng.standard_normal((WORKERS["n1"], WORKERS["n2"])).astype(np.float32)
    return G, rng.standard_normal(7).astype(np.float32)


def _jax_summed_summary(key, Gs, k):
    """The JAX package's identity-product terms summed over workers by
    hand: worker w's Pi from fold_in(key, w)."""
    A = B = nb2 = 0.0
    for w, G in enumerate(Gs):
        Pi = jax_sketch.gaussian_pi(jax.random.fold_in(key, w), k,
                                    G.shape[0])
        A = A + Pi
        B = B + Pi @ jnp.asarray(G)
        nb2 = nb2 + jnp.sum(jnp.asarray(G) ** 2, axis=0)
    n1 = Gs[0].shape[0]
    return JaxSummary(A, B, jnp.full((n1,), jnp.sqrt(float(len(Gs))),
                                     jnp.float32), jnp.sqrt(nb2))


@pytest.fixture(scope="module")
def workers_cell(tmp_path_factory):
    return run_ranks(CELL.format(consts=repr(WORKERS)), 2,
                     tmp_path_factory.mktemp("workers2"))


@pytest.mark.dist
def test_identity_product_summary_over_workers(workers_cell):
    """``group=``: each worker's Pi from fold_in(key, rank), sketches and
    squared norms summed over the group; every worker gets the same bits,
    within RTOL of the JAX package's terms summed by hand."""
    Gs = [_worker_inputs(w)[0] for w in range(2)]
    with jax.threefry_partitionable(False):
        want = _jax_summed_summary(jax.random.PRNGKey(1), Gs, WORKERS["k"])
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        got = workers_cell[0][f"summary/{name}"]
        np.testing.assert_array_equal(workers_cell[1][f"summary/{name}"], got)
        assert_columns_close(got, getattr(want, name), what=name)


@pytest.mark.dist
def test_compress_grads_over_workers(workers_cell):
    """``compress_grads(group=)``: the compressed leaf is the same global
    reconstruction (divided by the worker count) on every worker, the JAX
    package's composed by hand within RECON_RTOL; the small leaf is the
    mean over the workers; each worker keeps its own residual."""
    Gs, bs = zip(*(_worker_inputs(w) for w in range(2)))
    with jax.threefry_partitionable(False):
        kk = jax.random.fold_in(jax.random.PRNGKey(2), 1)  # "w": leaf 1
        summary = _jax_summed_summary(kk, Gs, WORKERS["sketch_k"])
        n1, n2 = Gs[0].shape
        res = jax_smppca.smppca_from_summary(
            jax.random.fold_in(kk, 1), summary, r=WORKERS["rank"],
            m=8 * (n1 + n2) * WORKERS["rank"], T=4)
        want = np.asarray(res.factors.U @ res.factors.V.T) / 2
    r0, r1 = workers_cell
    np.testing.assert_array_equal(r0["out/w"], r1["out/w"])
    assert rel(r0["out/w"], want) < RECON_RTOL
    np.testing.assert_allclose(r0["out/b"], (bs[0] + bs[1]) / 2, rtol=1e-6)
    for w, r in enumerate(workers_cell):
        np.testing.assert_allclose(r["err/w"], Gs[w] - r["out/w"], rtol=1e-6,
                                   atol=1e-6)
    # the bytes sent over the uncompressed bytes, as the JAX package counts
    # them (above 1 at this toy size: k (n1 + n2) > n1 n2)
    total = 4.0 * (n1 * n2 + 7)
    sent = 4.0 * (WORKERS["sketch_k"] * (n1 + n2) + n2) + 4.0 * 7
    assert float(r0["comm_fraction"]) == pytest.approx(sent / total,
                                                       rel=1e-12)
