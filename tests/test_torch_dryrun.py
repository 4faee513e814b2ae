"""The port's dry run (``repro_torch.launch.dryrun``), its grid and report,
and the analyzer's per-device and collective counts, on a fake process
group.

No process group is made in the pytest process: one spawned interpreter
starts the fake backend with 8 ranks (``launch.mesh.init_fake_process_
group``), makes the (2, 4) debug mesh and computes every result below at
once, printing them as JSON:

* collectives: an all-reduce of (16, 16) float32 and an all-gather to
  (32, 16) over the mesh's ``data`` group (2 ranks) count 1,024 and 2,048
  bytes by op, 2 collectives, both booked to the ``data`` axis (the twin
  of tests/launch/test_roofline.py's collective parser case); under
  ``scaled(3)`` the all-reduce counts three times;
* per device: x (8, 16) ``Shard(0)`` on ``data`` @ w (16, 32) ``Shard(1)``
  on ``model`` counts 1/8 of the global product's FLOPs (``FlopCounter
  Mode`` counts DTensor ops at their global shapes);
* the dry run: a reduced dense arch (granite-3-8b) and a reduced MoE arch
  (moonshot-v1-16b-a3b) complete a train and a decode cell on the mesh;
  a reduced xlstm-350m completes prefill_32k (32,768 sLSTM steps a layer,
  traced as one: ``models.xlstm._SLSTMTrace``) well inside the child's
  limit;
* the scaled sLSTM count against the loop traced step by step (the
  model finding no analyzer: ``trace_analyzer.current`` patched to give
  None) on the mesh, at S = 16.

In the pytest process, on one device, the same comparison op by op: the
forward's counts are equal; a train step's differ by the once-only ops
of the loop's first and last steps (``_once_only``).
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import grid, report
from repro_torch.models import build
from repro_torch.roofline import trace_analyzer as ta

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
CHILD_TIMEOUT = 240
CELLS = [(a, s) for a in ("granite-3-8b", "moonshot-v1-16b-a3b")
         for s in ("train_4k", "decode_32k")]
#: (kind, S, global batch) of the scaled-against-unrolled sLSTM cells
SLSTM_CELLS = {"train_16": ("train", 16, 8), "prefill_16": ("prefill", 16, 8)}


@pytest.fixture(scope="module")
def fake_8(tmp_path_factory):
    code = f"""
        import json, sys
        sys.path.insert(0, {str(SRC)!r})
        import torch
        from torch.distributed._functional_collectives import (
            all_gather_tensor, all_reduce)
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch import dryrun, mesh as M
        from repro_torch.roofline import trace_analyzer as ta
        torch.set_num_threads(1)
        M.init_fake_process_group(8)
        mesh = M.make_debug_mesh(2, 4)
        out = {{}}
        data = mesh.get_group("data")
        t = torch.zeros(16, 16)
        c = ta.analyze(lambda: all_gather_tensor(
            all_reduce(t, "sum", data), 0, data), mesh=mesh)
        st = c.stats()
        out["coll"] = {{"by_op": st.by_op, "count": st.count,
                        "by_axis": st.by_axis}}
        an = ta.TraceAnalyzer(ta.axes_of_mesh(mesh))
        with an, an.scaled(3):
            all_reduce(t, "sum", data)
        st = an.cost.stats()
        out["coll_scaled"] = {{"by_op": st.by_op, "count": st.count,
                               "by_axis": st.by_axis,
                               "coll_bytes": an.cost.coll_bytes,
                               "calls": an.cost.by_op["all_reduce"][0]}}
        x = dryrun._dtensor((8, 16), torch.float32, mesh,
                            (Shard(0), Replicate()))
        w = dryrun._dtensor((16, 32), torch.float32, mesh,
                            (Replicate(), Shard(1)))
        out["global"] = ta.analyze(lambda: torch.mm(
            torch.empty(8, 16, device="meta"),
            torch.empty(16, 32, device="meta"))).flops
        out["local"] = ta.analyze(lambda: x @ w, mesh=mesh).flops
        out["cells"] = {{f"{{a}}/{{s}}": dryrun.lower_cell(
            a, s, reduced=True, mesh=mesh) for a, s in {CELLS!r}}}
        out["xlstm_prefill_32k"] = dryrun.lower_cell(
            "xlstm-350m", "prefill_32k", reduced=True, mesh=mesh)
        from repro_torch.configs import shapes
        current = ta.current
        out["slstm"] = {{}}
        for name, (kind, S, B) in {SLSTM_CELLS!r}.items():
            shapes.SHAPES[name] = shapes.ShapeConfig(name, kind, S, B)
            # the first trace of an op on DTensors counts a few ops of
            # its sharding propagation once: a first run warms that up
            for scaled in (False, True, False):
                ta.current = current if scaled else lambda: None
                r = dryrun.lower_cell("xlstm-350m", name, reduced=True,
                                      mesh=mesh)
                out["slstm"][f"{{name}}/{{scaled}}"] = r
        print(json.dumps(out))
    """
    script = tmp_path_factory.mktemp("fake8") / "child.py"
    script.write_text(textwrap.dedent(code))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_collectives_count_bytes_by_op_and_axis(fake_8):
    c = fake_8["coll"]
    assert c["by_op"] == {"all-reduce": 16 * 16 * 4,
                          "all-gather": 32 * 16 * 4}
    assert c["count"] == 2
    assert c["by_axis"] == {"data": 16 * 16 * 4 + 32 * 16 * 4}


def test_scaled_collective_counts_n_times(fake_8):
    """``TraceAnalyzer.scaled(3)``: an all-reduce of (16, 16) float32
    counted as three, by op, by axis and in the collectives' list."""
    c = fake_8["coll_scaled"]
    assert c["by_op"] == {"all-reduce": 3 * 16 * 16 * 4}
    assert c["by_axis"] == {"data": 3 * 16 * 16 * 4}
    assert c["coll_bytes"] == 3 * 16 * 16 * 4
    assert c["count"] == c["calls"] == 3


def test_sharded_product_counts_per_device(fake_8):
    assert fake_8["global"] == 2 * 8 * 16 * 32
    assert fake_8["local"] == fake_8["global"] / 8


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in CELLS])
def test_reduced_cells_complete_on_the_debug_mesh(fake_8, cell):
    r = fake_8["cells"][cell]
    assert r["status"] == "OK", r
    assert r["mesh"] == "2x4" and r["reduced"]
    rl = r["roofline"]
    assert rl["chips"] == 8
    assert rl["flops_per_device"] > 0 and rl["bytes_per_device"] > 0
    assert rl["step_time_lb_s"] == max(rl["t_compute_s"], rl["t_memory_s"],
                                       rl["t_collective_s"])
    assert r["memory"]["peak_size_in_bytes"] >= \
        r["memory"]["argument_size_in_bytes"] > 0
    if cell.endswith("train_4k"):
        # FSDP: the weights' data shards are gathered, their gradients
        # reduce-scattered back
        assert r["collectives"]["by_op"].get("all-gather", 0) > 0
        assert r["collectives"]["by_op"].get("reduce-scatter", 0) > 0
        assert r["routes"]["plain"] > 0
        assert r["policy"] == "fsdp_tp"


def test_report_renders_every_status(fake_8, tmp_path):
    rows = list(fake_8["cells"].values()) + [
        {"arch": "x", "shape": "long_500k", "mesh": "32x8", "status": "SKIP",
         "reason": "full quadratic attention"},
        {"arch": "y", "shape": "train_4k", "mesh": "32x8",
         "status": "TIMEOUT"}]
    table = report.fmt(rows)
    assert table.count("\n") == len(rows) + 1
    assert "SKIP" in table and "TIMEOUT" in table
    assert report.memory_table(rows).count("\n") == len(fake_8["cells"]) + 1
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert grid.done_cells(str(path)) == {
        (r["arch"], r["shape"], r["mesh"]) for r in rows}


def test_dry_run_cell_skips_quadratic_long_context():
    from repro_torch.launch import dryrun
    r = dryrun.lower_cell("granite-3-8b", "long_500k")
    assert r["status"] == "SKIP" and "quadratic" in r["reason"]
    assert r["mesh"] == "32x8"


@pytest.mark.parametrize("head_dim,want", [(16, "flash"), (256, "flash"),
                                           (264, "plain")])
def test_meta_routes_every_width_up_to_256_to_flash(head_dim, want):
    """On ``meta`` (the dry run's device) causal, unwindowed attention
    takes the card's flash route at every width the kernel takes: the
    reduced configs' 16 and recurrentgemma-9b's 256; past 256 the plain
    route."""
    from repro_torch.models import attention as attn
    assert attn.route(torch.device("meta"), causal=True, window=None,
                      head_dim=head_dim) == want


def test_reduced_prefill_on_meta_counts_the_flash_trace():
    """A reduced granite-3-8b forward on ``meta`` (2 x 64 tokens, 4 heads
    of 16) routes both of its attentions to the flash trace, and the
    analyzer counts the kernel's work from its operands: 4 B H S^2 Dh / 2
    FLOPs a call (causal), q, k, v and o once."""
    from repro_torch.models import attention as attn
    cfg = get_config("granite-3-8b").reduced()
    model = build(cfg, device="meta")
    batch = {"tokens": torch.zeros(2, 64, dtype=torch.int32, device="meta")}
    attn.reset_route_counts()
    with torch.inference_mode():
        cost = ta.analyze(lambda: model.forward(model.param_shapes(), batch))
    assert attn.ROUTES == {"flash": 2, "plain": 0}
    calls, flops, nbytes = cost.by_op["flash_attention_trace"]
    B, S, H, Dh = 2, 64, cfg.n_heads, cfg.head_dim
    assert (calls, Dh) == (2, 16)
    assert flops == 2 * 4.0 * B * H * S * S * Dh / 2
    assert nbytes == 2 * 4 * (4 * B * S * H * Dh)


def test_reduced_xlstm_prefill_32k_lowers_within_the_child_limit(fake_8):
    r = fake_8["xlstm_prefill_32k"]
    assert r["status"] == "OK", r
    assert r["lower_s"] < CHILD_TIMEOUT / 4
    assert r["routes"] == {"flash": 0, "plain": 0}
    assert r["roofline"]["flops_per_device"] > 0


def _once_only(b: int, d: int) -> dict:
    """The ops a train step's sLSTM loop (one layer, local batch b, width
    d, float32 state, bf16 recurrent product) runs fewer when traced step
    by step than one middle step counted S times, as op -> (calls, FLOPs,
    bytes). Step 0 has no gradient for its constant initial state: no dx
    product for h (``mm`` and its two casts, ``_to_copy``), no ``mul`` for
    the gradients of c and n, no ``add`` of m's two gradients. The last
    step receives none from a next step: no ``add`` for h, c, n and m.
    The recurrent weight's S gradients take S - 1 ``add``s, not S."""
    bd = b * d
    return {"mm": (1, 2 * b * 4 * d * d, 2 * b * 4 * d + 2 * 4 * d * d
                   + 4 * bd),
            "_to_copy": (2, 2 * bd, 12 * bd),
            "mul": (2, 2 * bd, 24 * bd),
            "add": (6, 5 * bd + 4 * d * d, 60 * bd + 48 * d * d)}


@pytest.mark.parametrize("name", list(SLSTM_CELLS))
def test_scaled_slstm_count_against_the_unrolled_on_the_mesh(fake_8, name):
    scaled, unrolled = (fake_8["slstm"][f"{name}/{s}"] for s in (True, False))
    assert scaled["status"] == unrolled["status"] == "OK"
    assert scaled["collectives"] == unrolled["collectives"]
    assert scaled["collectives"]["total_bytes"] > 0
    # the peak: under autograd the scaled loop holds S steps' saved bytes
    # until its backward ends, where the loop frees each step's as it
    # goes: never less, and within a quarter more at this S
    peaks = [r["memory"]["peak_size_in_bytes"] for r in (scaled, unrolled)]
    assert peaks[1] <= peaks[0] <= 1.25 * peaks[1]
    got = {k: scaled["roofline"][k] - unrolled["roofline"][k]
           for k in ("flops_per_device", "bytes_per_device")}
    want = {"flops_per_device": 0, "bytes_per_device": 0}
    if SLSTM_CELLS[name][0] == "train":
        cfg = get_config("xlstm-350m").reduced()
        layers = sum(p.count("slstm") * c for p, c in cfg.groups)
        b = SLSTM_CELLS[name][2] // 2           # the data axis splits B
        once = _once_only(b, cfg.d_model)
        want = {"flops_per_device": layers * sum(v[1] for v in once.values()),
                "bytes_per_device": layers * sum(v[2] for v in once.values())}
    assert got == want


def _xlstm_cost(S: int, train: bool, B: int = 2):
    """A reduced xlstm-350m traced on ``meta`` on one device: the forward,
    or the loss and its backward with remat."""
    cfg = dataclasses.replace(get_config("xlstm-350m").reduced(), remat=True)
    m = build(cfg, device="meta")
    params = m.param_shapes()
    batch = {k: torch.zeros(B, S, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with ta.TraceAnalyzer() as an:
        if train:
            m.loss(params, batch).backward()
        else:
            with torch.no_grad():
                m.forward(params, batch)
    return cfg, an.cost


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train"])
def test_scaled_slstm_count_against_the_unrolled_op_by_op(train,
                                                         monkeypatch):
    B, S = 2, 16
    cfg, scaled = _xlstm_cost(S, train, B)
    monkeypatch.setattr(ta, "current", lambda: None)   # step by step
    _, unrolled = _xlstm_cost(S, train, B)
    diff = {}
    for op in set(scaled.by_op) | set(unrolled.by_op):
        a, b = (c.by_op.get(op, [0, 0.0, 0.0]) for c in (scaled, unrolled))
        if a != b:
            diff[op] = tuple(x - y for x, y in zip(a, b))
    want = {}
    if train:
        layers = sum(p.count("slstm") * c for p, c in cfg.groups)
        want = {op: tuple(layers * x for x in v)
                for op, v in _once_only(B, cfg.d_model).items()}
    assert diff == want
    assert scaled.flops - unrolled.flops == sum(v[1] for v in want.values())
    assert scaled.bytes - unrolled.bytes == sum(v[2] for v in want.values())
    assert scaled.coll_bytes == unrolled.coll_bytes == 0
