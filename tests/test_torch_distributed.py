"""The port's distributed pass (``core/distributed.py``) against the JAX
package's, on gloo process groups of 1, 2 and 4 ranks and on the (2 x 2)
hierarchy of ``dist.multihost.host_groups`` (the port's twins of the
distributed tests of tests/core/test_summary_engine.py,
test_error_engine.py, test_streaming.py and test_streaming_drift.py, and
of the 4-device cells of tests/dist/test_multihost.py).

No process group is made in the pytest process: one cell of 4 spawned
interpreters (``run_ranks``: gloo over a ``FileStore`` in a temporary
directory, each cell under its own time limit, its processes killed when
it expires) computes every multi-rank result at once and saves each rank's
arrays; the tests below read them. The cell forms groups of 1, 2 and 4
ranks out of its 4 and the (2 x 2) pair, so one start-up serves every
rank count. Inputs are made with numpy from a seed on both sides.

What is compared, and how:
* against the JAX package on a 1-device mesh (the projection values do
  not depend on the shard count, only the sums reassociate): each column
  within ``RTOL`` of its largest entry, the JAX suite's tolerance for its
  tree reduce; integers (counters, probe test matrices' keys) exactly;
* inside the port, bit for bit: the norms of the flat and hierarchical
  paths, the ragged summary against a hand-padded input, a rank's own
  rows against the whole pair, every rank's result, and one rank against
  the single-process stream.
"""
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import distributed as jax_distributed
from repro.core import streaming as jax_streaming
from repro.core import summary_engine as jax_summary
from repro_torch import prng
from repro_torch.core import distributed, pipeline, summary_engine

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
# A cell's time limit: the 4-rank cell below takes about 15 s on a CPU of
# a few cores (mostly four torch imports).
CELL_TIMEOUT = 240
# Float sums of the same terms in another order, and normals that differ
# by an ulp now and then (tests/test_torch_prng.py): each column within
# 1e-5 of its own largest entry (1e-5 relative: the JAX suite's tolerance
# for the tree reduce, tests/dist/test_multihost.py).
RTOL = 1e-5
# U V^T of port and JAX: the same keys and samples up to a rare
# inverse-CDF tie (tests/test_torch_smppca.py's SLICE_RTOL).
UVT_RTOL = 1e-3
GROUPS = ("g1", "g2", "g4", "h22")     # 1, 2, 4 ranks flat; 2 x 2 pair
METHODS = ("gaussian", "srht")

# the inputs, made alike here and in the cell
SKETCH = dict(seed=11, d=250, n1=9, n2=7, k=16)           # ragged over 4
STREAM = dict(seed=12, d=256, n1=20, n2=14, k=32, slab=96, probes=8,
              cosketch=4)
HIER = dict(seed=13, d=250, n1=12, n2=10, k=16, slab=64, probes=4,
            cosketch=4, decay=0.97)
DRIFT = dict(seed=14, d=192, n1=11, n2=7, k=8, probes=2, decay=0.5,
             split=96, dt=2)
WINDOW = dict(seed=15, d=60, n1=6, n2=5, k=8, buckets=2, probes=4,
              epochs=3)
SMPPCA = dict(seed=16, d=256, n1=20, n2=14, k=32, r=3, m=2000, T=5)
KEYS = dict(sketch=1, stream=2, hier=3, drift=4, window=5, smppca=6)


def pair(seed, d, n1, n2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, n1)).astype(np.float32),
            rng.standard_normal((d, n2)).astype(np.float32))


def run_ranks(code: str, world: int, tmp_path: pathlib.Path,
              timeout: float = CELL_TIMEOUT) -> list:
    """Run ``code`` in ``world`` fresh interpreters that form one gloo cell
    (``multihost.initialize`` over a ``FileStore`` in ``tmp_path``), each
    with its rank as ``RANK`` and ``WORLD`` and a ``save(name, x)`` that
    keeps an array; return each rank's arrays. The whole cell runs within
    ``timeout`` seconds, and its processes are killed when it expires or a
    rank fails."""
    prelude = f"""
        import sys
        import numpy as np
        import torch
        import torch.distributed as dist
        sys.path.insert(0, {str(SRC)!r})
        from repro_torch.dist import multihost
        RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
        torch.set_num_threads(1)
        assert multihost.initialize(
            num_processes=WORLD, process_id=RANK, device="cpu",
            store=dist.FileStore(sys.argv[3], WORLD), timeout=60.0)
        OUT = {{}}

        def save(name, x):
            OUT[name] = (x.detach().cpu().numpy() if torch.is_tensor(x)
                         else np.asarray(x))
    """
    coda = """
        dist.barrier()
        dist.destroy_process_group()
        np.savez(sys.argv[4], **OUT)
    """
    script = tmp_path / "cell.py"
    script.write_text(textwrap.dedent(prelude) + textwrap.dedent(code)
                      + textwrap.dedent(coda))
    # one host: gloo on the loopback interface, whatever the host's name
    # resolves to
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs, logs = [], []
    for rank in range(world):
        log = open(tmp_path / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(rank), str(world),
             str(tmp_path / "store"), str(tmp_path / f"rank{rank}.npz")],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
            if p.returncode:
                break
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    fails = [f"rank {r} rc={p.returncode}:\n"
             + (tmp_path / f"rank{r}.log").read_text()[-4000:]
             for r, p in enumerate(procs) if p.returncode]
    assert not fails, "\n".join(fails)
    out = []
    for rank in range(world):
        with np.load(tmp_path / f"rank{rank}.npz") as z:
            out.append(dict(z))
    return out


CELL = """
from repro_torch import prng
from repro_torch.core import distributed as D
from repro_torch.core import summary_engine as se
from repro_torch.core.smppca import smppca_from_summary
from repro_torch.core.streaming import StreamingSummarizer, WindowedSummarizer

SKETCH, STREAM, HIER, DRIFT, WINDOW, SMPPCA, KEYS = {consts}


def pair(seed, d, n1, n2):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((d, n1)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((d, n2)).astype(np.float32)))


groups = {{"g1": dist.new_group([0]), "g2": dist.new_group([0, 1]),
          "g4": dist.group.WORLD}}
groups["h22"] = multihost.host_groups(2)
member = {{"g1": RANK < 1, "g2": RANK < 2, "g4": True, "h22": True}}


def save_state(prefix, st):
    for name, x in zip(st._fields, st):
        if x is not None:
            save(f"{{prefix}}/{{name}}", x)


def save_summary(prefix, s):
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B", "probes",
                 "probe_omega", "cosketch_Y", "cosketch_W"):
        x = getattr(s, name)
        if x is not None:
            save(f"{{prefix}}/{{name}}", x)


# one-shot summaries, ragged d, both methods, every group
c = SKETCH
A, B = pair(c["seed"], c["d"], c["n1"], c["n2"])
key = prng.PRNGKey(KEYS["sketch"])
for label, g in groups.items():
    if not member[label]:
        continue
    for method in ("gaussian", "srht"):
        save_summary(f"sketch/{{method}}/{{label}}", D.distributed_sketch_summary(
            g, key, A, B, c["k"], method=method, device="cpu"))
        save_summary(f"backend/{{method}}/{{label}}", se.build_summary(
            key, A, B, c["k"], method=method, backend="distributed",
            group=g, device="cpu"))
# a hand-padded input, and this rank's own rows alone
pad = 252 - c["d"]
Ap = torch.nn.functional.pad(A, (0, 0, 0, pad))
Bp = torch.nn.functional.pad(B, (0, 0, 0, pad))
save_summary("padded", D.distributed_sketch_summary(
    groups["g4"], key, Ap, Bp, c["k"], device="cpu"))
lo, hi = D.shard_range(c["d"], WORLD, RANK)
save_summary("local", D.distributed_sketch_summary(
    groups["g4"], key, A[lo:hi], B[lo:hi], c["k"], d=c["d"], device="cpu"))

# streaming summaries with probes and a co-sketch
c = STREAM
A, B = pair(c["seed"], c["d"], c["n1"], c["n2"])
key = prng.PRNGKey(KEYS["stream"])
for label, g in groups.items():
    if not member[label]:
        continue
    for method in ("gaussian", "srht"):
        save_summary(f"stream/{{method}}/{{label}}",
                     D.distributed_streaming_summary(
                         g, key, A, B, c["k"], method=method, slab=c["slab"],
                         probes=c["probes"], cosketch=c["cosketch"],
                         device="cpu"))
if RANK == 0:
    # one rank against the single-process stream fed the same slabs
    summ = StreamingSummarizer(c["k"], probes=c["probes"],
                               cosketch=c["cosketch"], device="cpu")
    st = summ.init(key, (c["d"], c["n1"], c["n2"]))
    for off in range(0, c["d"], c["slab"]):
        st = summ.update(st, A[off:off + c["slab"]], B[off:off + c["slab"]],
                         off)
    save_summary("stream/single", summ.finalize(st))

# decayed, probed, co-sketched slab updates: flat against hierarchical
c = HIER
A, B = pair(c["seed"], c["d"], c["n1"], c["n2"])
key = prng.PRNGKey(KEYS["hier"])
summ = StreamingSummarizer(c["k"], probes=c["probes"], cosketch=c["cosketch"],
                           decay=c["decay"], device="cpu")
for label in ("g4", "h22"):
    st = summ.init(key, (c["d"], c["n1"], c["n2"]))
    for off in range(0, c["d"], c["slab"]):
        st = D.distributed_streaming_update(
            groups[label], summ, st, A[off:off + c["slab"]],
            B[off:off + c["slab"]], row_offset=off)
        st = summ.advance(st, 1)
    save_state(f"hier/{{label}}", st)

# decay commutes with the reduce
c = DRIFT
A, B = pair(c["seed"], c["d"], c["n1"], c["n2"])
key = prng.PRNGKey(KEYS["drift"])
summ = StreamingSummarizer(c["k"], probes=c["probes"], decay=c["decay"],
                           device="cpu")
s = c["split"]
st0 = summ.advance(summ.update(summ.init(key, (c["d"], c["n1"], c["n2"])),
                               A[:s], B[:s], 0), c["dt"])
for label, g in groups.items():
    if member[label]:
        save_state(f"drift/{{label}}", D.distributed_streaming_update(
            g, summ, st0, A[s:], B[s:], row_offset=s))
save_state("drift/single", summ.update(st0, A[s:], B[s:], s))

# a window whose epochs went through the reduce
c = WINDOW
ws = WindowedSummarizer(c["k"], n_buckets=c["buckets"], probes=c["probes"],
                        device="cpu")
key = prng.PRNGKey(KEYS["window"])
for label in ("g4", "h22"):
    w = ws.init(key, (c["d"], c["n1"], c["n2"]))
    for epoch in range(c["epochs"]):
        A, B = pair(c["seed"] + epoch, c["d"], c["n1"], c["n2"])
        slot = int(w.head) % ws.n_buckets
        bucket = D.distributed_streaming_update(
            groups[label], ws._inner, w.buckets[slot], A, B, 0)
        w = ws._with_head_bucket(w, bucket)
        if epoch < c["epochs"] - 1:
            w = ws.slide(w)
    save_state(f"window/{{label}}", ws.merged(w))

# the whole pipeline
c = SMPPCA
A, B = pair(c["seed"], c["d"], c["n1"], c["n2"])
key = prng.PRNGKey(KEYS["smppca"])
for label, g in groups.items():
    if member[label]:
        f = D.distributed_smppca(g, key, A, B, r=c["r"], k=c["k"], m=c["m"],
                                 T=c["T"], device="cpu")
        save(f"smppca/{{label}}", f.U @ f.V.T)
"""


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    consts = repr((SKETCH, STREAM, HIER, DRIFT, WINDOW, SMPPCA, KEYS))
    return run_ranks(CELL.format(consts=consts), 4,
                     tmp_path_factory.mktemp("cell4"))


def jkey(name):
    return jax.random.PRNGKey(KEYS[name])


def jpair(c):
    return tuple(jnp.asarray(x) for x in pair(c["seed"], c["d"], c["n1"],
                                              c["n2"]))


@pytest.fixture(scope="module")
def mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("x",))


@pytest.fixture(scope="module")
def jax_refs(mesh1):
    """The JAX package's results as numpy: its distributed functions on a
    1-device mesh (one-shot summaries, the Gaussian stream, the decayed
    slab update, SMP-PCA), its reference backend, and its single-process
    stream where its own suite holds the distributed one to it (each
    distributed call traces and compiles anew, so they are kept few)."""
    out = {}
    with jax.threefry_partitionable(False):
        c = SKETCH
        A, B = jpair(c)
        for method in METHODS:
            out[f"sketch/{method}"] = \
                jax_distributed.distributed_sketch_summary(
                    mesh1, "x", jkey("sketch"), A, B, c["k"], method=method)
            out[f"reference/{method}"] = jax_summary.build_summary(
                jkey("sketch"), A, B, c["k"], method=method)
        c = STREAM
        A, B = jpair(c)
        out["stream/gaussian"] = \
            jax_distributed.distributed_streaming_summary(
                mesh1, "x", jkey("stream"), A, B, c["k"], slab=c["slab"],
                probes=c["probes"], cosketch=c["cosketch"])
        out["stream/srht"] = jax_summary.build_summary(
            jkey("stream"), A, B, c["k"], method="srht", probes=c["probes"],
            cosketch=c["cosketch"])
        c = HIER
        A, B = jpair(c)
        summ = jax_streaming.StreamingSummarizer(
            c["k"], probes=c["probes"], cosketch=c["cosketch"],
            decay=c["decay"])
        st = summ.init(jkey("hier"), (c["d"], c["n1"], c["n2"]))
        for off in range(0, c["d"], c["slab"]):
            st = summ.advance(summ.update(st, A[off:off + c["slab"]],
                                          B[off:off + c["slab"]], off), 1)
        out["hier"] = st
        c = DRIFT
        A, B = jpair(c)
        summ = jax_streaming.StreamingSummarizer(
            c["k"], probes=c["probes"], decay=c["decay"])
        s = c["split"]
        st0 = summ.advance(summ.update(
            summ.init(jkey("drift"), (c["d"], c["n1"], c["n2"])),
            A[:s], B[:s], 0), c["dt"])
        out["drift"] = jax_distributed.distributed_streaming_update(
            mesh1, "x", summ, st0, A[s:], B[s:], row_offset=s)
        c = SMPPCA
        A, B = jpair(c)
        f = jax_distributed.distributed_smppca(
            mesh1, "x", jkey("smppca"), A, B, r=c["r"], k=c["k"], m=c["m"],
            T=c["T"])
        out["smppca"] = np.asarray(f.U @ f.V.T)
    return jax.tree.map(np.asarray, out)


def ranks_of(label):
    return {"g1": 1, "g2": 2, "g4": 4, "h22": 4}[label]


def assert_columns_close(got, want, rtol=RTOL, what=""):
    """Each column (a 1-D block: each entry) within ``rtol`` of its own
    largest entry."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = (np.abs(want).max(axis=0, keepdims=True) if want.ndim == 2
             else np.abs(want).max(initial=0.0))
    err = np.abs(got - want)
    assert np.all(err <= rtol * np.maximum(scale, 1e-30)), \
        (what, float(err.max()))


def assert_state_matches_jax(cell_out, prefix, want):
    """The port's saved state fields against a JAX StreamState: integer
    fields and the decay rate exactly, float blocks per column."""
    for name, w in zip(want._fields, want):
        key = f"{prefix}/{name}"
        if w is None or name == "key":
            continue
        g = cell_out[key]
        if name == "decay_rate" or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert_columns_close(g, w, what=key)


def summary_fields(out, prefix):
    return {k.split("/")[-1]: v for k, v in out.items()
            if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# one-shot summaries
# ---------------------------------------------------------------------------

@pytest.mark.dist
@pytest.mark.parametrize("label", GROUPS)
@pytest.mark.parametrize("method", METHODS)
def test_sketch_summary_matches_jax(cell, jax_refs, method, label):
    """1, 2 and 4 ranks flat and the (2 x 2) hierarchy over a ragged d
    against the JAX package's pass on a 1-device mesh."""
    want = jax_refs[f"sketch/{method}"]
    got = summary_fields(cell[0], f"sketch/{method}/{label}")
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        assert_columns_close(got[name], getattr(want, name),
                             what=f"{method}/{label}/{name}")


@pytest.mark.dist
@pytest.mark.parametrize("method", METHODS)
def test_norms_bit_equal_flat_and_hierarchical(cell, method):
    """The norms take one all-reduce over all ranks on both paths, so they
    agree bit for bit; the sketches reassociate."""
    flat = summary_fields(cell[0], f"sketch/{method}/g4")
    hier = summary_fields(cell[0], f"sketch/{method}/h22")
    for name in ("norm_A", "norm_B"):
        np.testing.assert_array_equal(flat[name], hier[name], err_msg=name)
    for name in ("A_sketch", "B_sketch"):
        assert_columns_close(hier[name], flat[name], what=name)


@pytest.mark.dist
def test_ragged_shard_bit_parity_with_padded_input(cell, jax_refs):
    """The zero-padded trailing shard gives the summary of an input padded
    by hand, bit for bit (gaussian; an SRHT plan of the padded d would be
    another plan), and both methods stay close to the reference backend."""
    got = summary_fields(cell[0], "sketch/gaussian/g4")
    padded = summary_fields(cell[0], "padded")
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
        np.testing.assert_array_equal(got[name], padded[name], err_msg=name)
    for method in METHODS:
        got = summary_fields(cell[0], f"sketch/{method}/g4")
        ref = jax_refs[f"reference/{method}"]
        assert np.abs(got["A_sketch"] - ref.A_sketch).max() <= 1e-4, method
        np.testing.assert_allclose(got["norm_A"], ref.norm_A, rtol=1e-6)


@pytest.mark.dist
def test_own_rows_equal_the_whole_pair(cell):
    """A rank passing its own rows (``d=``) gets the summary of the whole
    pair, bit for bit."""
    whole = summary_fields(cell[0], "sketch/gaussian/g4")
    local = summary_fields(cell[0], "local")
    for name, x in whole.items():
        np.testing.assert_array_equal(local[name], x, err_msg=name)


@pytest.mark.dist
def test_every_rank_gets_the_same_bits(cell):
    """The all-reduce hands every rank the same sums: every result of the
    4-rank groups (summaries, stream states, factors) is equal on every
    rank."""
    shared = [k for k in cell[0] if "/g4" in k or "/h22" in k
              or k in ("padded", "local") or k.startswith("window/")
              or k.startswith("hier/") or k.startswith("smppca/g4")]
    assert len(shared) > 40
    for rank in range(1, 4):
        for name in shared:
            if name.startswith("smppca/"):
                continue          # WAltMin runs on each rank: compared below
            np.testing.assert_array_equal(cell[rank][name], cell[0][name],
                                          err_msg=f"rank {rank} {name}")


@pytest.mark.dist
@pytest.mark.parametrize("method", METHODS)
def test_distributed_backend_parity(cell, jax_refs, method):
    """``build_summary(backend='distributed', group=)`` is
    ``distributed_sketch_summary``, bit for bit, and within the JAX suite's
    tolerance of the reference backend (the twin of
    tests/core/test_summary_engine.py::test_distributed_backend_parity)."""
    ref = jax_refs[f"reference/{method}"]
    for label in GROUPS:
        got = summary_fields(cell[0], f"backend/{method}/{label}")
        direct = summary_fields(cell[0], f"sketch/{method}/{label}")
        for name in ("A_sketch", "B_sketch", "norm_A", "norm_B"):
            np.testing.assert_array_equal(got[name], direct[name])
            w = np.asarray(getattr(ref, name))
            np.testing.assert_allclose(
                got[name], w, rtol=2e-4, atol=1e-5 * max(np.abs(w).max(), 1.0),
                err_msg=f"{method}/{label}/{name}")


# ---------------------------------------------------------------------------
# streaming summaries
# ---------------------------------------------------------------------------

@pytest.mark.dist
@pytest.mark.parametrize("label", GROUPS)
@pytest.mark.parametrize("method", METHODS)
def test_distributed_streaming_tree_reduce(cell, jax_refs, method, label):
    """Slabs of 96 rows (256 = 96 + 96 + 64) with probes and a co-sketch
    through the reduce, against the JAX package's distributed streaming
    pass (gaussian) and its reference backend (srht) (the twin
    of tests/core/test_streaming.py::test_distributed_streaming_tree_reduce
    and tests/core/test_error_engine.py::test_distributed_streaming_probes):
    every block per
    column (the probes' normals, too: an ulp apart now and then)."""
    want = jax_refs[f"stream/{method}"]
    got = summary_fields(cell[0], f"stream/{method}/{label}")
    for name in ("A_sketch", "B_sketch", "norm_A", "norm_B", "probes",
                 "probe_omega", "cosketch_Y", "cosketch_W"):
        assert_columns_close(got[name], getattr(want, name),
                             what=f"{method}/{label}/{name}")


@pytest.mark.dist
@pytest.mark.parametrize("label", GROUPS)
def test_distributed_streaming_probes(cell, jax_refs, label):
    """The probe block rides the same reduce as the sketches (the twin of
    tests/core/test_error_engine.py's): its test matrix and the block
    match the JAX package's distributed stream on a 1-device mesh within
    RTOL a column, and one rank's block, on every group alike."""
    want = jax_refs["stream/gaussian"]
    got = summary_fields(cell[0], f"stream/gaussian/{label}")
    assert got["probes"].shape == (STREAM["n1"], STREAM["probes"])
    assert_columns_close(got["probe_omega"], want.probe_omega)
    assert_columns_close(got["probes"], want.probes)
    flat = summary_fields(cell[0], "stream/gaussian/g1")
    assert_columns_close(got["probes"], flat["probes"])


@pytest.mark.dist
def test_one_rank_stream_equals_the_summarizer_bitwise(cell):
    """At world size 1 the all-reduce leaves the bits alone: the
    distributed stream equals ``StreamingSummarizer`` fed the same slabs,
    bit for bit (what chip_smoke.py holds at full width)."""
    got = summary_fields(cell[0], "stream/gaussian/g1")
    want = summary_fields(cell[0], "stream/single")
    assert set(got) == set(want)
    for name, x in want.items():
        np.testing.assert_array_equal(got[name], x, err_msg=name)


@pytest.mark.dist
def test_hierarchical_reduce_matches_flat_4dev(cell, jax_refs):
    """(2 x 2) tree reduce against the flat 4-rank reduce on a probed,
    co-sketched, decayed stream over a ragged row count: squared norms bit
    for bit, blocks within 1e-5 of their largest entry, counters exact;
    both against the JAX package's decayed single-process stream (its own
    suite's reference for the 1-device distributed update)."""
    flat = {k.split("/")[-1]: v for k, v in cell[0].items()
            if k.startswith("hier/g4/")}
    hier = {k.split("/")[-1]: v for k, v in cell[0].items()
            if k.startswith("hier/h22/")}
    assert set(flat) == set(hier)
    for name in ("na2", "nb2", "rows_seen", "row_high", "t_state", "t_data"):
        np.testing.assert_array_equal(flat[name], hier[name], err_msg=name)
    for name in ("A_acc", "B_acc", "probe_acc", "cosketch_Y", "cosketch_W"):
        scale = max(1.0, float(np.abs(flat[name]).max()))
        assert np.abs(flat[name] - hier[name]).max() <= 1e-5 * scale, name
    assert int(hier["rows_seen"]) == HIER["d"]
    for label in ("g4", "h22"):
        assert_state_matches_jax(cell[0], f"hier/{label}", jax_refs["hier"])


@pytest.mark.dist
def test_hierarchical_windowed_merge_matches_flat_4dev(cell):
    """A window whose epochs were absorbed through the hierarchical reduce
    merges to the flat window's state (norms bit for bit)."""
    flat, hier = "window/g4", "window/h22"
    for name in ("na2", "nb2", "rows_seen", "row_high"):
        np.testing.assert_array_equal(cell[0][f"{flat}/{name}"],
                                      cell[0][f"{hier}/{name}"])
    diff = np.abs(cell[0][f"{flat}/A_acc"] - cell[0][f"{hier}/A_acc"]).max()
    assert diff <= 1e-5
    assert int(cell[0][f"{flat}/rows_seen"]) == \
        WINDOW["buckets"] * WINDOW["d"]


@pytest.mark.dist
@pytest.mark.parametrize("label", GROUPS)
def test_distributed_update_decay_commutes_with_psum(cell, jax_refs, label):
    """The sharded slab update of a decayed state equals the single-process
    decayed update (the twin of tests/core/test_streaming_drift.py's): bit
    for bit on one rank, per column on more (the shards' sums
    reassociate), and the JAX package's 1-device update."""
    prefix = f"drift/{label}"
    single = {k.split("/")[-1]: v for k, v in cell[0].items()
              if k.startswith("drift/single/")}
    got = {k.split("/")[-1]: v for k, v in cell[0].items()
           if k.startswith(prefix + "/")}
    assert set(got) == set(single)
    for name, w in single.items():
        if ranks_of(label) == 1 or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        else:
            assert_columns_close(got[name], w, what=name)
    assert_state_matches_jax(cell[0], prefix, jax_refs["drift"])


# ---------------------------------------------------------------------------
# the whole pipeline
# ---------------------------------------------------------------------------

@pytest.mark.dist
@pytest.mark.parametrize("label", GROUPS)
def test_distributed_smppca_matches_jax(cell, jax_refs, label):
    """U V^T of ``distributed_smppca`` on every group against the JAX
    package's on a 1-device mesh, and equal on every rank of the group (on
    the CPU WAltMin adds in a fixed order)."""
    want = jax_refs["smppca"]
    got = cell[0][f"smppca/{label}"]
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < UVT_RTOL
    for rank in range(1, ranks_of(label)):
        np.testing.assert_array_equal(cell[rank][f"smppca/{label}"], got)


# ---------------------------------------------------------------------------
# in process: layout and guards (no process group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 4, 7])
def test_shard_range_is_the_padded_layout(world):
    """ceil(d / world) rows a shard, contiguous, covering [0, d) once; the
    trailing shards short or empty."""
    for d in (0, 1, 5, 250, 256):
        rows = -(-d // world)
        ranges = [distributed.shard_range(d, world, i) for i in range(world)]
        assert ranges[0][0] == 0 and ranges[-1][1] == d
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c
        assert all(hi - lo <= rows for lo, hi in ranges)
        assert [hi - lo for lo, hi in ranges] == sorted(
            [hi - lo for lo, hi in ranges], reverse=True)
    with pytest.raises(ValueError):
        distributed.shard_range(10, world, world)


def test_distributed_backend_needs_a_group():
    key = prng.PRNGKey(0)
    A, B = torch.randn(16, 4), torch.randn(16, 3)
    assert "distributed" in summary_engine.backends()
    with pytest.raises(ValueError, match="group"):
        summary_engine.build_summary(key, A, B, 4, backend="distributed",
                                     device="cpu")
    with pytest.raises(NotImplementedError, match="batched"):
        summary_engine.build_summary(key, A[None], B[None], 4,
                                     backend="distributed", group=(None,),
                                     device="cpu")
    with pytest.raises(ValueError, match="group"):
        distributed.distributed_sketch_summary((None,), key, A, B, 4,
                                               device="cpu")


def test_registered_backend_receives_the_group():
    """``build_summary(group=)`` reaches any registered backend, and only
    when given: no backend name is special."""
    key = prng.PRNGKey(0)
    A, B = torch.randn(16, 4), torch.randn(16, 3)
    seen = []

    @summary_engine.register_backend("test_grouped")
    def _grouped(key, A, B, k, *, method, block, precision, configs, **kw):
        seen.append(kw.get("group", "absent"))
        return summary_engine._BACKENDS["reference"](
            key, A, B, k, method=method, block=block, precision=precision)

    try:
        token = object()
        summary_engine.build_summary(key, A, B, 4, backend="test_grouped",
                                     group=token, device="cpu")
        summary_engine.build_summary(key, A, B, 4, backend="test_grouped",
                                     device="cpu")
    finally:
        del summary_engine._BACKENDS["test_grouped"]
    assert seen == [token, "absent"]


def test_plans_refuse_the_distributed_backend():
    """Like the JAX package's: the distributed pass needs a group, so no
    plan compiles it."""
    plan = pipeline.PipelinePlan(
        sketch=pipeline.SketchSpec(backend="distributed"),
        rank=pipeline.RankPolicy(r=2))
    with pytest.raises(ValueError, match="plan-compilable"):
        pipeline.validate_plan(plan)
