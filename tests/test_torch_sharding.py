"""The port's sharding rules (``repro_torch.dist.sharding``) and mesh
builders (``repro_torch.launch.mesh``) against the JAX package's.

Twins of every case in tests/dist/test_sharding.py and of the three
``dist``-marked cases in tests/launch/test_roofline.py. ``param_spec`` and
``cache_spec`` read only a mesh's axis sizes, so the rule table is checked
in-process on duck-typed meshes, the spec a tuple of the entries the JAX
``PartitionSpec`` holds. The mesh factories and the tree walkers on a real
``DeviceMesh`` run in one spawned interpreter on a fake process group of
512 ranks (``launch.mesh.init_fake_process_group``): no process group is
made in the pytest process.

Spec parity: for every reduced arch, the port's spec at each parameter's
JAX path and stacked shape equals ``repro.dist.sharding.param_spec``'s on
the JAX tree, on (4, 2) and (2, 16) meshes; the placements the port gives
a layer's tensor are that spec with the layer dim dropped.
"""
import json
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.dist import sharding as jax_sharding
from repro.models import build as jax_build
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import jax_path
from repro_torch.dist import sharding
from repro_torch.models import build

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
CHILD_TIMEOUT = 240


def _mesh_shape(data=4, model=2):
    # param_spec/cache_spec duck-type the mesh: only .shape is read
    return types.SimpleNamespace(shape={"data": data, "model": model})


def _p(spec):
    """A JAX ``PartitionSpec`` as the port's tuple."""
    return tuple(spec)


def test_param_spec_fsdp_tp_weight():
    mesh = _mesh_shape()
    assert sharding.param_spec(mesh, "/mlp/up/w", (8, 6)) == \
        _p(P(("data",), "model"))


def test_param_spec_divisibility_fallbacks():
    mesh = _mesh_shape(data=4, model=16)
    assert sharding.param_spec(mesh, "/attn/wq/w", (8, 12)) == \
        _p(P(("data",), None))
    assert sharding.param_spec(mesh, "/attn/wq/w", (6, 12)) == \
        _p(P(None, None))


def test_param_spec_bias_and_stacked_dims():
    mesh = _mesh_shape()
    assert sharding.param_spec(mesh, "/mlp/up/b", (6,)) == _p(P(None))
    assert sharding.param_spec(mesh, "/groups/0/0/mlp/up/w", (3, 8, 6)) == \
        _p(P(None, ("data",), "model"))


def test_param_spec_embed_is_vocab_tp_dmodel_dp():
    mesh = _mesh_shape()
    assert sharding.param_spec(mesh, "/embed/table", (10, 8)) == \
        _p(P("model", ("data",)))
    assert sharding.param_spec(mesh, "/embed/table", (11, 8)) == \
        _p(P(None, ("data",)))


def test_cache_spec_prefers_kv_heads_then_head_dim():
    mesh = _mesh_shape(data=2, model=4)
    assert sharding.cache_spec(mesh, "/cache/k", (4, 16, 8, 6)) == \
        _p(P(("data",), None, "model", None))
    assert sharding.cache_spec(mesh, "/cache/k", (4, 16, 3, 8)) == \
        _p(P(("data",), None, None, "model"))


@pytest.mark.parametrize("axes,expect", [("data", 4), (("data", "model"), 8)])
def test_axes_size_accepts_str_or_tuple(axes, expect):
    assert sharding._axes_size(_mesh_shape(data=4, model=2), axes) == expect


@pytest.mark.parametrize("policy", ["fsdp_tp", "tp_only"])
@pytest.mark.parametrize("shape,path", [
    ((64, 128), "/mlp/up/w"), ((64, 126), "/mlp/up/w"),
    ((512, 64), "/embed/table"), ((5, 64, 64), "/groups/0/0/attn/wo/w"),
    ((7,), "/final_norm/scale"), ((3, 16), "/groups/1/0/norm1/scale"),
    ((2, 8, 12, 20), "/groups/0/0/moe/w_up")])
@pytest.mark.parametrize("mesh", [(2, 4), (4, 2), (2, 16)])
def test_param_spec_equals_jax_rule(mesh, shape, path, policy):
    m = _mesh_shape(*mesh)
    assert sharding.param_spec(m, path, shape, policy=policy) == \
        _p(jax_sharding.param_spec(m, path, shape, policy=policy))


@pytest.mark.parametrize("shape", [(8, 16, 128, 4, 64), (8, 16, 128, 2, 64),
                                   (4, 16, 3, 8), (4, 5), (3, 4, 6)])
@pytest.mark.parametrize("mesh", [(2, 4), (4, 2), (2, 16)])
def test_cache_spec_equals_jax_rule(mesh, shape):
    m = _mesh_shape(*mesh)
    assert sharding.cache_spec(m, "/k", shape) == \
        _p(jax_sharding.cache_spec(m, "/k", shape))


@pytest.mark.parametrize("mesh", [(4, 2), (2, 16)])
@pytest.mark.parametrize("name", list_archs())
def test_spec_parity_with_jax_for_every_reduced_arch(name, mesh):
    m = _mesh_shape(*mesh)
    from repro.configs import get_config as jax_get_config
    jm = jax_build(jax_get_config(name).reduced())
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    want = {jax_sharding._path_str(kp): (tuple(leaf.shape), leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build(get_config(name).reduced(), device="meta").param_shapes()
    specs = sharding.params_specs(model, m)
    seen = set()
    for pname, p in model.named_parameters():
        path, layer = jax_path(pname)
        key = "/" + "/".join(str(x) for x in path)
        stacked, _ = want[key]
        assert stacked[(layer is not None):] == tuple(p.shape), (pname, key)
        jspec = _p(jax_sharding.param_spec(m, key, stacked))
        assert sharding.param_spec(m, key, stacked) == jspec, key
        assert specs[pname] == jspec[(layer is not None):], (pname, key)
        seen.add(key)
    assert seen == set(want)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sharding.placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.placements(mesh, (None, "model")) == \
        (Replicate(), Replicate(), Shard(1))


def test_local_over_without_dtensors_is_the_call():
    import torch
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.local_over(lambda a: a * 2, (x,), ((0, 1),), (0, 1)) \
        .equal(x * 2)
    assert sharding.gather_dp(x) is x


@pytest.fixture(scope="module")
def fake_512(tmp_path_factory):
    """The mesh factories, the tree walkers and the sharded cases of
    tests/launch/test_roofline.py on real ``DeviceMesh``es over a fake
    process group of 512 ranks, in one spawned interpreter."""
    code = f"""
        import json, sys
        sys.path.insert(0, {str(SRC)!r})
        from repro_torch.launch import mesh as M
        from repro_torch.dist import sharding as shr
        from repro_torch.models import build
        from repro_torch.configs import get_config
        M.init_fake_process_group(512)
        out = {{}}
        m1 = M.make_production_mesh()
        m2 = M.make_production_mesh(multi_pod=True)
        out["m1"] = [list(m1.mesh_dim_names), list(m1.shape)]
        out["m2"] = [list(m2.mesh_dim_names), list(m2.shape)]
        out["dp2"] = list(M.dp_axes(m2))
        out["dp1"] = list(M.dp_axes(m1))
        dbg = M.make_debug_mesh(2, 4)
        out["debug"] = [list(dbg.mesh_dim_names), list(dbg.shape)]
        specs = {{
            "a": shr.param_spec(dbg, "/mlp/up/w", (64, 128)),
            "b": shr.param_spec(dbg, "/mlp/up/w", (64, 126)),
            "c": shr.param_spec(dbg, "/embed/table", (512, 64)),
            "d": shr.param_spec(dbg, "/groups/0/0/attn/wo/w", (5, 64, 64)),
            "e": shr.cache_spec(dbg, "/k", (8, 16, 128, 4, 64)),
            "f": shr.cache_spec(dbg, "/k", (8, 16, 128, 2, 64))}}
        out["specs"] = {{k: [list(x) if isinstance(x, tuple) else x
                             for x in v] for k, v in specs.items()}}
        model = build(get_config("granite-3-8b").reduced(),
                      device="meta").param_shapes()
        ps = shr.params_shardings(m1, model)
        out["params"] = {{n: [repr(p) for p in pl] for n, pl in ps.items()}}
        out["shapes"] = {{n: list(p.shape) for n, p in model.named_parameters()}}
        out["count"] = get_config("granite-3-8b").reduced().groups[0][1]
        caches = build(get_config("granite-3-8b").reduced(),
                       device="meta").cache_shapes(64, 16)
        cs = shr.cache_shardings(m1, caches)
        out["cache"] = [repr(p) for p in cs[0][0][0]["k"]]
        print(json.dumps(out))
    """
    script = tmp_path_factory.mktemp("fake512") / "child.py"
    script.write_text(textwrap.dedent(code))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_mesh_factories(fake_512):
    assert fake_512["m1"] == [["data", "model"], [32, 8]]
    assert fake_512["m2"] == [["pod", "data", "model"], [2, 32, 8]]
    assert fake_512["dp2"] == ["pod", "data"]
    assert fake_512["dp1"] == ["data"]
    assert fake_512["debug"] == [["data", "model"], [2, 4]]


def test_sharding_divisibility_fallback(fake_512):
    s = fake_512["specs"]
    assert s["a"] == ["data", "model"]
    assert s["b"] == ["data", None]
    assert s["c"] == ["model", "data"]
    assert s["d"][0] is None


def test_cache_spec_kv_fallbacks(fake_512):
    s = fake_512["specs"]
    assert s["e"] == [None, "data", None, "model", None]
    assert s["f"] == [None, "data", None, None, "model"]


def _jax_placements(spec, drop):
    """The DTensor placements (as repr strings) on ("data", "model") of a
    JAX spec with its first ``drop`` dims dropped."""
    out = ["Replicate()", "Replicate()"]
    for d, entry in enumerate(tuple(spec)[drop:]):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[("data", "model").index(axis)] = f"Shard(dim={d})"
    return out


def test_tree_walkers_give_placements_on_a_real_mesh(fake_512):
    ps, shapes = fake_512["params"], fake_512["shapes"]
    mesh = _mesh_shape(32, 8)
    for name, path, stacked in (
            ("embed.table", "/embed/table", ()),
            ("final_norm.scale", "/final_norm/scale", ()),
            ("groups.0.0.0.mlp.up.w", "/groups/0/0/mlp/up/w",
             (fake_512["count"],)),
            ("groups.0.0.0.norm1.scale", "/groups/0/0/norm1/scale",
             (fake_512["count"],))):
        spec = jax_sharding.param_spec(mesh, path,
                                       stacked + tuple(shapes[name]))
        assert ps[name] == _jax_placements(spec, len(stacked)), name
    assert len(ps) == len(shapes)
    assert fake_512["cache"][0] == "Shard(dim=0)"      # batch 64 over 32
