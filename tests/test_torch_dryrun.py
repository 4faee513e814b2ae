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
  of tests/launch/test_roofline.py's collective parser case);
* per device: x (8, 16) ``Shard(0)`` on ``data`` @ w (16, 32) ``Shard(1)``
  on ``model`` counts 1/8 of the global product's FLOPs (``FlopCounter
  Mode`` counts DTensor ops at their global shapes);
* the dry run: a reduced dense arch (granite-3-8b) and a reduced MoE arch
  (moonshot-v1-16b-a3b) complete a train and a decode cell on the mesh.
"""
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.launch import grid, report

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
CHILD_TIMEOUT = 240
CELLS = [(a, s) for a in ("granite-3-8b", "moonshot-v1-16b-a3b")
         for s in ("train_4k", "decode_32k")]


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
