"""The port's roofline terms (``repro_torch.roofline.analysis``) and its
trace analyzer (``repro_torch.roofline.trace_analyzer``) against the JAX
package's HLO analyzer.

Twins of the analyzer and roofline cases of tests/launch/test_roofline.py:
the same four programs (a loop of products, nested loops, ``tanh(a @ b) @
b``, a rectangular contraction) are traced eagerly by the port and
compiled and parsed by ``repro.roofline.hlo_analyzer``; their FLOPs agree
within 5%. The roofline's terms hold with the H100 peaks, and its
collective term charges each mesh axis its own link. The reduced granite
train step's counted FLOPs (one device, on ``meta`` tensors, which trace
the card's route) are within 10% of ``hlo_analyzer.analyze`` of the JAX
step at the same sizes. The collective and per-device cases need a
process group: they run in tests/test_torch_dryrun.py's spawned
interpreter.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.models import build as jax_build
from repro.optim.adamw import AdamW as JaxAdamW
from repro.roofline import hlo_analyzer as ha
from repro.train import train_step as jax_ts
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, cell_applicable
from repro_torch.models import build
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.roofline import analysis as roof
from repro_torch.roofline import trace_analyzer as ta
from repro_torch.train import train_step as ts

ANALYZER_RTOL = 0.05
STEP_RTOL = 0.10


def _jax_flops(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return ha.analyze(jax.jit(f).lower(*args).compile().as_text()).flops


def _loop(x, w):
    for _ in range(10):
        x = x @ w
    return x


def _jax_loop(x, w):
    y, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=10)
    return y


def _nested(x, w):
    for _ in range(4):
        for _ in range(3):
            x = x @ w
    return x


def _jax_nested(x, w):
    def outer(c, _):
        c2, _ = jax.lax.scan(lambda cc, _: (cc @ w, None), c, None, length=3)
        return c2, None
    y, _ = jax.lax.scan(outer, x, None, length=4)
    return y


CASES = {
    "loop": (_loop, _jax_loop, ((128, 128), (128, 128)), 2 * 128 ** 3 * 10),
    "nested": (_nested, _jax_nested, ((64, 64), (64, 64)), 2 * 64 ** 3 * 12),
    "tanh": (lambda a, b: torch.tanh(a @ b) @ b,
             lambda a, b: jnp.tanh(a @ b) @ b, ((96, 96), (96, 96)), None),
    "rect": (lambda a, b: torch.einsum("ij,kj->ik", a, b),
             lambda a, b: jnp.einsum("ij,kj->ik", a, b),
             ((32, 100), (48, 100)), 2 * 32 * 48 * 100),
}


@pytest.mark.parametrize("case", list(CASES))
def test_analyzer_counts_match_jax(case):
    fn, jfn, shapes, exact = CASES[case]
    got = ta.analyze(fn, *(torch.zeros(s) for s in shapes)).flops
    want = _jax_flops(jfn, *shapes)
    assert abs(got - want) / want < ANALYZER_RTOL, (got, want)
    if exact is not None:
        assert abs(got - exact) / exact < 0.01, (got, exact)


def test_analyzer_counts_bytes_views_and_slice_writes():
    x = torch.zeros(64, 32)
    c = ta.analyze(lambda: x.reshape(32, 64).T.contiguous())
    assert c.flops == 0
    assert c.bytes == 2 * x.numel() * 4          # the copy: read and write
    buf = torch.zeros(100, 32)
    c = ta.analyze(lambda: buf[10:20].copy_(x[:10]))
    assert c.bytes == 2 * 10 * 32 * 4            # the slice, not the buffer
    idx = torch.arange(8)
    c = ta.analyze(lambda: x[idx])
    assert c.bytes == 2 * 8 * 32 * 4             # a gather counts its slice
    c = ta.analyze(lambda: x.sum(0))
    assert c.flops == x.numel()                  # a reduction: its input


def test_analyzer_counts_a_card_gemm_at_its_dtypes():
    """``mm`` with ``out_dtype`` (the card's bf16 GEMM with a float32
    output, traced on ``meta``): its FLOPs, and bf16 operands' bytes."""
    a = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    b = torch.empty(32, 16, dtype=torch.bfloat16, device="meta")
    c = ta.analyze(lambda: torch.mm(a, b, out_dtype=torch.float32))
    assert c.flops == 2 * 64 * 16 * 32
    assert c.bytes == (64 * 32 + 32 * 16) * 2 + 64 * 16 * 4


def test_flash_trace_counts_the_kernels_work():
    from repro_torch.kernels import flash_attention as fa
    q = torch.empty(2, 256, 8, 64, device="meta")
    k = torch.empty(2, 256, 2, 64, device="meta")
    c = ta.analyze(lambda: fa.trace(q, k, k, True))
    assert c.flops == 2 * 2 * 8 * 256 * 256 * 64
    assert c.bytes == (2 * q.numel() + 2 * k.numel()) * 4


def test_roofline_terms_and_bottleneck():
    rl = roof.Roofline(flops=989e12, bytes_accessed=3.35e12 * 2,
                       coll_bytes=50e9 * 0.5,
                       model_flops_per_device=989e12 / 2, chips=256)
    assert abs(rl.t_compute - 1.0) < 1e-9
    assert abs(rl.t_memory - 2.0) < 1e-9
    assert abs(rl.t_collective - 0.5) < 1e-9     # no axis: the slow link
    assert rl.bottleneck == "memory"
    assert abs(rl.roofline_fraction - 0.25) < 1e-9
    assert rl.as_dict()["step_time_lb_s"] == rl.step_time


def test_roofline_charges_each_axis_its_link():
    rl = roof.Roofline(flops=0.0, bytes_accessed=0.0,
                       coll_bytes=450e9 + 50e9 + 25e9,
                       model_flops_per_device=0.0, chips=256,
                       coll_by_axis={"model": 450e9, "data": 50e9})
    # 1 s on NVLink, 1 s on InfiniBand, the unattributed rest 0.5 s
    assert abs(rl.t_collective - 2.5) < 1e-9
    assert rl.bottleneck == "collective"


def test_collective_bytes_of_records():
    st = roof.collective_bytes([("all-reduce", 1024, "data"),
                                ("all-gather", 2048, "model"),
                                ("all-gather", 100, None)])
    assert st.by_op == {"all-reduce": 1024, "all-gather": 2148}
    assert st.by_axis == {"data": 1024, "model": 2048}
    assert st.count == 3 and st.total_bytes == 3172


def test_model_flops():
    assert roof.model_flops("train", 10, 7) == 420.0
    assert roof.model_flops("decode", 10, 7, enc_extra=5) == 145.0


def test_cell_applicability_long_context():
    ok, _ = cell_applicable("hybrid", "long_500k")
    assert ok
    ok, reason = cell_applicable("dense", "long_500k")
    assert not ok and "quadratic" in reason


def test_shapes_registry_matches_jax():
    assert SHAPES.keys() == JAX_SHAPES.keys()
    for name, s in SHAPES.items():
        j = JAX_SHAPES[name]
        assert (s.kind, s.seq_len, s.global_batch) == \
            (j.kind, j.seq_len, j.global_batch)


def test_train_step_flops_match_jax():
    """Reduced granite, B = 2, S = 64, one device: the port's traced step
    (on ``meta``: the card's GEMMs) against the JAX step's compiled HLO."""
    B, S = 2, 64
    shapes = {"tokens": (B, S), "labels": (B, S)}
    with jax.threefry_partitionable(False):
        m = jax_build(jax_get_config("granite-3-8b").reduced())
        opt, tcfg = JaxAdamW(), jax_ts.TrainConfig(microbatches=1)
        state = jax.eval_shape(lambda p: jax_ts.init_state(
            jax.random.PRNGKey(0), p, opt, tcfg), m.param_shapes())
        batch = {k: jax.ShapeDtypeStruct(s, jnp.int32)
                 for k, s in shapes.items()}
        hlo = jax.jit(jax_ts.make_train_step(m.loss, opt, tcfg)).lower(
            state, batch).compile().as_text()
    want = ha.analyze(hlo).flops

    model = build(get_config("granite-3-8b").reduced(), device="meta")
    params = model.param_shapes()
    named = dict(params.named_parameters())
    zeros = lambda: {n: torch.zeros(p.shape, device="meta")
                     for n, p in named.items()}
    st = ts.TrainState(params, AdamWState(torch.zeros((), dtype=torch.int32),
                                          zeros(), zeros()),
                       (), torch.zeros((), dtype=torch.int32),
                       prng.PRNGKey(0))
    step = ts.make_train_step(model.loss, AdamW(), ts.TrainConfig())
    batch = {k: torch.zeros(s, dtype=torch.int32, device="meta")
             for k, s in shapes.items()}
    got = ta.analyze(step, st, batch)
    assert abs(got.flops - want) / want < STEP_RTOL, (got.flops, want)
    assert got.by_op["mm"][1] > 0.5 * got.flops   # the GEMMs dominate
