"""The port's multi-host ingest (``dist/multihost.py``) against the JAX
package's: the twins of tests/dist/test_multihost.py. Its in-process tests
cover every entry point in one process (no process group); its 2-process
cell (gloo over a ``FileStore``, spawned by
``test_torch_distributed.run_ranks``) ingests each host's shard and merges
through the store. The twins of that file's 4-device cells share the
4-rank cell of tests/test_torch_distributed.py
(``test_hierarchical_reduce_matches_flat_4dev``,
``test_hierarchical_windowed_merge_matches_flat_4dev``,
``test_ragged_shard_bit_parity_with_padded_input``).

Inputs are made with numpy from a seed on both sides; keys, counters and
wire bytes are compared bit for bit, float blocks per column.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_distributed import run_ranks

from repro.core import streaming as jax_streaming
from repro.dist import multihost as jax_multihost
from repro_torch import convert, prng
from repro_torch.core.streaming import StreamingSummarizer
from repro_torch.dist import multihost

# float blocks of the two packages' states: each column within 1e-5 of its
# own largest entry (tests/test_torch_streaming.py's STATE_RTOL)
STATE_RTOL = 1e-5
MERGE = dict(seed=21, d=90, n1=8, n2=6, k=12, probes=4, cosketch=4, chunk=16)


def pair(seed, d, n1, n2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d, n1)).astype(np.float32),
            rng.standard_normal((d, n2)).astype(np.float32))


def assert_state_close(got, want, rtol=STATE_RTOL):
    """A port state (as numpy) against a JAX state: the key and integer
    fields bit for bit, float blocks per column."""
    for name, g, w in zip(want._fields, got, want):
        assert (g is None) == (w is None), name
        if w is None:
            continue
        g, w = np.asarray(g), np.asarray(w)
        if name == "decay_rate" or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        scale = (np.abs(w).max(axis=0, keepdims=True) if w.ndim == 2
                 else np.abs(w).max(initial=0.0))
        assert np.all(np.abs(g - w) <= rtol * np.maximum(scale, 1e-30)), name


# ---------------------------------------------------------------------------
# in process: topology helpers
# ---------------------------------------------------------------------------

def test_host_shard_range_covers_and_balances():
    for d in (0, 1, 7, 10, 64, 101):
        for hosts in (1, 2, 3, 4, 7):
            ranges = [multihost.host_shard_range(d, hosts=hosts, host=h)
                      for h in range(hosts)]
            assert ranges == [jax_multihost.host_shard_range(
                d, hosts=hosts, host=h) for h in range(hosts)]
            assert ranges[0][0] == 0 and ranges[-1][1] == d
            for (a, b), (c, _) in zip(ranges, ranges[1:]):
                assert b == c
            sizes = [hi - lo for lo, hi in ranges]
            assert max(sizes) - min(sizes) <= 1
            assert sizes == sorted(sizes, reverse=True)


def test_host_shard_range_validates():
    with pytest.raises(ValueError):
        multihost.host_shard_range(10, hosts=2, host=2)
    with pytest.raises(ValueError):
        multihost.host_shard_range(10, hosts=0, host=0)
    with pytest.raises(ValueError):
        multihost.host_shard_range(-1, hosts=2, host=0)


def test_initialize_is_noop_without_coordinator(monkeypatch):
    for var in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    # an explicit single-process cell is equally a no-op
    assert multihost.initialize("127.0.0.1:1234", 1, 0) is False
    # a configured address with no process count is still single-process
    monkeypatch.setenv("REPRO_COORDINATOR", "127.0.0.1:1234")
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()


def test_process_topology_single_process():
    assert multihost.process_topology() == (0, 1)


def test_host_mesh_single_process():
    """``host_groups`` (the port's ``host_mesh``) needs a process group:
    outside a cell it refuses."""
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.host_groups()
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.host_groups(2)


def test_kv_client_requires_coordinator():
    with pytest.raises(RuntimeError, match="coordinator"):
        multihost._store()


# ---------------------------------------------------------------------------
# in process: single-process ingest and merge
# ---------------------------------------------------------------------------

def test_cross_host_merge_single_process_is_passthrough():
    summ = StreamingSummarizer(8, probes=4, device="cpu")
    st = summ.init(prng.PRNGKey(0), (32, 6, 5))
    st = summ.update(st, torch.ones(32, 6), torch.ones(32, 5), 0)
    out = multihost.cross_host_merge(st, wire="bf16", tol=None)
    assert out is st          # no wire, no copy in a 1-process cell


def test_sharded_ingest_single_process_matches_local():
    """One process ingests the whole range: the update loop bit for bit,
    and the JAX package's sharded ingest to tolerance."""
    d, na, nb, chunk = 50, 7, 5, 16
    A, B = pair(1, d, na, nb)
    summ = StreamingSummarizer(8, probes=4, cosketch=4, device="cpu")
    got = multihost.sharded_ingest(
        summ, prng.PRNGKey(0), (d, na, nb),
        lambda lo, hi: (torch.from_numpy(A[lo:hi]),
                        torch.from_numpy(B[lo:hi])), chunk=chunk)
    ref = summ.init(prng.PRNGKey(0), (d, na, nb))
    for off in range(0, d, chunk):
        ref = summ.update(ref, torch.from_numpy(A[off:off + chunk]),
                          torch.from_numpy(B[off:off + chunk]), off)
    assert int(got.rows_seen) == d
    for name, a, b in zip(got._fields, got, ref):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    with jax.threefry_partitionable(False):
        jst = jax_multihost.sharded_ingest(
            jax_streaming.StreamingSummarizer(8, probes=4, cosketch=4),
            jax.random.PRNGKey(0), (d, na, nb),
            lambda lo, hi: (jnp.asarray(A[lo:hi]), jnp.asarray(B[lo:hi])),
            chunk=chunk)
        jst = jax.tree.map(np.asarray, jst)
    assert_state_close(convert.stream_state_to_numpy(got), jst)


def test_sharded_ingest_validates_chunk():
    summ = StreamingSummarizer(8, device="cpu")
    for bad in (0, -1, True, 2.0):
        with pytest.raises(ValueError):
            multihost.sharded_ingest(
                summ, prng.PRNGKey(0), (10, 3, 3),
                lambda lo, hi: (torch.zeros(hi - lo, 3),) * 2, chunk=bad)


# ---------------------------------------------------------------------------
# a real 2-process cell
# ---------------------------------------------------------------------------

CELL = """
import hashlib
from repro_torch import prng
from repro_torch.core import streaming
from repro_torch.core.streaming import StreamingSummarizer

c = {consts}
pid, nproc = multihost.process_topology()
assert (pid, nproc) == (RANK, 2)
assert multihost.host_shard_range(c["d"]) == multihost.host_shard_range(
    c["d"], hosts=2, host=pid)
rng = np.random.default_rng(c["seed"])
A = torch.from_numpy(rng.standard_normal((c["d"], c["n1"])).astype(np.float32))
B = torch.from_numpy(rng.standard_normal((c["d"], c["n2"])).astype(np.float32))
key = prng.PRNGKey(7)
shapes = (c["d"], c["n1"], c["n2"])
summ = StreamingSummarizer(c["k"], probes=c["probes"], cosketch=c["cosketch"],
                           device="cpu")

merged = multihost.sharded_ingest(summ, key, shapes,
                                  lambda lo, hi: (A[lo:hi], B[lo:hi]),
                                  chunk=c["chunk"])

# every process rebuilds both partial states: the f32 merge must equal
# their local tree_merge, bit for bit
parts = []
for h in range(nproc):
    lo, hi = multihost.host_shard_range(c["d"], hosts=nproc, host=h)
    st = summ.init(key, shapes)
    for off in range(lo, hi, c["chunk"]):
        st = summ.update(st, A[off:min(off + c["chunk"], hi)],
                         B[off:min(off + c["chunk"], hi)], off)
    parts.append(st)
expect = streaming.tree_merge(parts)
assert int(merged.rows_seen) == c["d"]
for name, a, b in zip(merged._fields, merged, expect):
    assert (a is None) == (b is None), name
    assert a is None or torch.equal(a, b), name

# the vote: process 0 votes f32, process 1 int8 -> the cell takes f32
voted = multihost.cross_host_merge(parts[pid],
                                   wire="f32" if pid == 0 else "int8")
assert torch.equal(voted.A_acc, merged.A_acc)

# bf16 wire: the norms ride f32 (bit for bit), the sketches within the
# quantization's tolerance
lossy = multihost.cross_host_merge(parts[pid], wire="bf16")
assert torch.equal(lossy.na2, merged.na2)
rel = float((lossy.A_acc - merged.A_acc).abs().max()
            / merged.A_acc.abs().max())
assert 0 < rel <= 2e-2, rel

# the gate's vote: each process runs choose_wire_spec on its own state
gated = multihost.cross_host_merge(parts[pid], tol=1e-2)
votes = [streaming.choose_wire_spec(p, 1e-2)[0].sketch for p in parts]
spec = min(votes, key=streaming.WIRE_DTYPES.index)
want = streaming.tree_merge([streaming.decompress_state(
    streaming.compress_state(p, spec)) for p in parts])
assert torch.equal(gated.A_acc, want.A_acc), (votes, spec)
save("gate_spec", np.asarray(streaming.WIRE_DTYPES.index(spec)))

# four merges ran; process 0 returns from each only after deleting its
# keys, so after a barrier no process sees any of them
dist.barrier()
left = [f"repro/merge/{{seq}}/{{part}}/{{i}}/{{j}}" for seq in range(4)
        for part in ("spec", "state", "done") for i in range(nproc)
        for j in ("n", "0", "")]
save("keys_left", np.asarray(sum(
    multihost._store().check([name.rstrip("/")]) for name in left)))

for name, x in zip(merged._fields, merged):
    if x is not None:
        save(f"merged/{{name}}", x)
save("digest", np.frombuffer(hashlib.sha256(
    merged.A_acc.numpy().tobytes()).digest(), np.uint8))
save("wire", np.frombuffer(streaming.wire_pack(
    streaming.compress_state(merged, "f32")), np.uint8))
"""


@pytest.fixture(scope="module")
def merge_cell(tmp_path_factory):
    return run_ranks(CELL.format(consts=repr(MERGE)), 2,
                     tmp_path_factory.mktemp("merge2"))


@pytest.mark.dist
def test_two_process_compressed_merge_cell(merge_cell):
    """A real 2-process cell: each process ingests its host shard, the
    merge travels as ``wire_pack`` bytes through the store, and every
    process ends with the same merged state, bit for bit (the f32 merge ==
    the local tree_merge, the votes, the bf16 and gated merges are checked
    inside the cell)."""
    r0, r1 = merge_cell
    np.testing.assert_array_equal(r0["digest"], r1["digest"])
    np.testing.assert_array_equal(r0["wire"], r1["wire"])
    assert set(r0) == set(r1)
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)
    assert int(r0["merged/rows_seen"]) == MERGE["d"]


@pytest.mark.dist
def test_two_process_merge_releases_its_keys(merge_cell):
    """Each merge's votes and images leave the store once every process
    has read them, so repeated merges do not grow it."""
    assert [int(r["keys_left"]) for r in merge_cell] == [0, 0]


@pytest.mark.dist
def test_two_process_merge_matches_jax(merge_cell):
    """The cell's merged state against the JAX package's tree_merge of the
    same two host shards: counters exactly, blocks per column."""
    c = MERGE
    A, B = pair(c["seed"], c["d"], c["n1"], c["n2"])
    with jax.threefry_partitionable(False):
        summ = jax_streaming.StreamingSummarizer(
            c["k"], probes=c["probes"], cosketch=c["cosketch"])
        key = jax.random.PRNGKey(7)
        parts = []
        for h in range(2):
            lo, hi = jax_multihost.host_shard_range(c["d"], hosts=2, host=h)
            st = summ.init(key, (c["d"], c["n1"], c["n2"]))
            for off in range(lo, hi, c["chunk"]):
                st = summ.update(
                    st, jnp.asarray(A[off:min(off + c["chunk"], hi)]),
                    jnp.asarray(B[off:min(off + c["chunk"], hi)]), off)
            parts.append(st)
        want = jax.tree.map(np.asarray, jax_streaming.tree_merge(parts))
    got = merge_cell[0]
    for name, w in zip(want._fields, want):
        if w is None:
            assert f"merged/{name}" not in got, name
            continue
        g = got[f"merged/{name}"]
        if name == "key":
            np.testing.assert_array_equal(g.astype(np.uint32), w)
        elif not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            scale = (np.abs(w).max(axis=0, keepdims=True) if w.ndim == 2
                     else np.abs(w).max(initial=0.0))
            assert np.all(np.abs(g - w) <= STATE_RTOL * scale), name
