"""The port's LM serving (``serve.engine.Engine``, ``launch.serve``)
against the JAX package's.

Both engines get the same weights (``convert.lm_params_from_numpy`` of the
JAX tree) and prompts; every jax call runs under
``jax.threefry_partitionable(False)``, the key tree the port reproduces.
Greedy tokens are compared in float32 compute, where the two packages'
logits agree to about 4e-6 (tests/test_torch_models.py), far below the
gaps between the top logits of these random models.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch import convert, prng
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build
from repro_torch.serve.engine import Engine, ServeConfig


def _f32(name, cfg_of):
    return dataclasses.replace(cfg_of(name).reduced(), compute_dtype="float32")


def test_greedy_generation_deterministic():
    """The twin of tests/models/test_moe_serve.py's greedy test."""
    cfg = get_config("phi3-mini-3.8b").reduced()
    m = build(cfg, device="cpu")
    params = m.init_params(prng.PRNGKey(0))
    batch = {"tokens": torch.ones((2, 8), dtype=torch.int32)}
    eng = Engine(m, params, ServeConfig(max_new_tokens=6, temperature=0.0))
    out1 = eng.generate(batch)
    out2 = eng.generate(batch)
    assert tuple(out1.shape) == (2, 14) and out1.dtype == torch.int32
    assert torch.equal(out1, out2)
    assert set(eng.timings) == {"prefill_s", "decode_s", "decode_steps"}


def test_engine_matches_stepwise_argmax():
    """The twin of tests/models/test_moe_serve.py's: Engine greedy tokens
    == a manual prefill + decode argmax loop, on reduced xlstm-350m (its
    caches the recurrent states of mLSTM and sLSTM)."""
    cfg = get_config("xlstm-350m").reduced()
    m = build(cfg, device="cpu")
    params = m.init_params(prng.PRNGKey(1))
    toks = prng.randint(prng.PRNGKey(2), (1, 8), 0, cfg.vocab_size)
    out = Engine(m, params, ServeConfig(max_new_tokens=4)).generate(
        {"tokens": toks})
    with torch.inference_mode():
        cache = m.init_cache(1, 12)
        logits, cache = m.prefill(params, {"tokens": toks}, cache)
        cur = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        manual = [cur]
        for t in range(3):
            logits, cache = m.decode_step(params, cache, cur, 8 + t)
            cur = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            manual.append(cur)
    assert torch.equal(out[:, 8:], torch.cat(manual, 1))


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "whisper-small",
                                  "llama-3.2-vision-11b",
                                  "moonshot-v1-16b-a3b", "recurrentgemma-9b",
                                  "starcoder2-15b"])
def test_greedy_tokens_equal_the_jax_engine(name):
    with jax.threefry_partitionable(False):
        jcfg = _f32(name, jax_get_config)
        jm = jax_build(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(3))
        tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (2, 8),
                                               0, jcfg.vocab_size))
        batch = {"tokens": jnp.asarray(tokens)}
        rng = np.random.default_rng(5)
        for k, t in jm.aux_input_shapes(2).items():
            batch[k] = jnp.asarray(0.1 * rng.standard_normal(t.shape), t.dtype)
        want = np.asarray(JaxEngine(jm, jp, JaxServeConfig(max_new_tokens=6))
                          .generate(batch))
        tree = jax.tree.map(np.asarray, jp)
    pcfg = _f32(name, get_config)
    m = build(pcfg, device="cpu")
    params = convert.lm_params_from_numpy(tree, pcfg, "cpu")
    got = Engine(m, params, ServeConfig(max_new_tokens=6)).generate(
        {k: convert.tensor_from_numpy(np.asarray(v)) for k, v in batch.items()})
    assert np.array_equal(got.numpy(), want), (got.numpy(), want)


@pytest.mark.parametrize("name,plain", [
    ("llama-3.2-vision-11b", 8 + 2),      # (attn x4, xattn) x 2
    ("whisper-small", 2 + 2 + 2)])        # decoder, encoder, cross
def test_decode_counts_no_attention_route(name, plain):
    """``attention.ROUTES`` counts a prefill's calls: a request's decode
    steps, cross-attention to the cached context included, count none (on
    the CPU every call takes the plain route)."""
    from repro_torch.models import attention as attn
    m = build(get_config(name).reduced(), device="cpu")
    params = m.init_params(prng.PRNGKey(0))
    batch = launch_serve.prompt_batch(m, 2, 8, seed=1)
    attn.reset_route_counts()
    out = Engine(m, params, ServeConfig(max_new_tokens=4)).generate(batch)
    assert tuple(out.shape) == (2, 12)
    assert attn.ROUTES == {"flash": 0, "plain": plain}


@pytest.mark.parametrize("shape", [(2, 512), (3, 49408)])
def test_temperature_draws_equal_jax_on_the_same_logits(shape):
    """``jax.random.categorical(key, logits / T)`` is the argmax of the
    logits over T plus ``gumbel(key)`` (mode 'low'): the port draws the
    same uniforms bit for bit; its two logs are torch's, within 1e-6 of
    XLA's (an ulp or two of values of order 1 to 16); the draws are
    equal."""
    rng = np.random.default_rng(shape[1])
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    eng = Engine(None, None, ServeConfig(temperature=0.8))
    with jax.threefry_partitionable(False):
        for seed in range(4):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
            tkey = prng.fold_in(prng.PRNGKey(seed), 2)
            u = jax.random.uniform(key, shape, minval=np.finfo(np.float32).tiny)
            assert np.array_equal(
                np.asarray(u),
                prng.uniform(tkey, shape, np.finfo(np.float32).tiny).numpy())
            g = np.asarray(jax.random.gumbel(key, shape))
            np.testing.assert_allclose(prng.gumbel(tkey, shape).numpy(), g,
                                       rtol=0, atol=1e-6)
            want = np.asarray(jax.random.categorical(
                key, jnp.asarray(logits) / 0.8, axis=-1))
            got = eng._sample(tkey, torch.from_numpy(logits))
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want), seed


def test_temperature_generation_equals_jax_engine():
    """Temperature 0.8 end to end in float32 compute: the same tokens as
    the JAX Engine for the same seed."""
    name = "granite-3-8b"
    with jax.threefry_partitionable(False):
        jcfg = _f32(name, jax_get_config)
        jm = jax_build(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(6))
        tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (2, 8),
                                               0, jcfg.vocab_size))
        want = np.asarray(JaxEngine(jm, jp, JaxServeConfig(
            max_new_tokens=5, temperature=0.8, seed=11)).generate(
                {"tokens": jnp.asarray(tokens)}))
        tree = jax.tree.map(np.asarray, jp)
    pcfg = _f32(name, get_config)
    got = Engine(build(pcfg, device="cpu"),
                 convert.lm_params_from_numpy(tree, pcfg, "cpu"),
                 ServeConfig(max_new_tokens=5, temperature=0.8, seed=11)
                 ).generate({"tokens": torch.from_numpy(tokens.copy())})
    assert np.array_equal(got.numpy(), want)


def test_run_generate_on_the_cpu():
    args = launch_serve.parser().parse_args(
        ["--arch", "whisper-small", "--reduced", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
         "--seed", "3"])
    out = launch_serve.run_generate(args)
    vocab = get_config("whisper-small").reduced().vocab_size
    assert out["arch"] == "whisper-small" and out["device"] == "cpu"
    assert out["output_shape"] == [2, 12]
    assert all(0 <= t < vocab for t in out["sample_row"])
    assert out["prefill_s"] > 0 and out["decode_ms_per_token"] > 0
    # the prompts are the JAX package's draw under the same seed
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 8), 0,
                                             vocab))
    assert out["sample_row"][:8] == want[0].tolist()


def test_serve_main_prints_one_json_line(capsys):
    launch_serve.main(["--mode", "sketch", "--device", "cpu", "--requests",
                       "4", "--max-batch", "4", "--d", "256", "--n", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["completed"] == 4 and out["served_ranks"] == [4]
    assert out["device"] == "cpu"


def test_entry_points_default_to_the_card():
    """Without a card the default device raises; nothing falls back."""
    args = launch_serve.parser().parse_args(["--reduced"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build("phi3-mini-3.8b")


def test_init_model_takes_a_parameter_dtype():
    """``init_model(..., param_dtype="bfloat16")``: the experts in bf16,
    the router float32, and the Engine serves it (reduced moonshot)."""
    model, params, _ = launch_serve.init_model(
        "moonshot-v1-16b-a3b", reduced=True, device="cpu",
        param_dtype="bfloat16")
    assert model.cfg.param_dtype == "bfloat16"
    layer = params.groups[1][0][0].moe
    assert layer.w_up.dtype == torch.bfloat16
    assert layer.router.w.dtype == torch.float32
    batch = launch_serve.prompt_batch(model, 2, 8, seed=1)
    out = Engine(model, params, ServeConfig(max_new_tokens=3)).generate(batch)
    assert tuple(out.shape) == (2, 11)
    assert torch.equal(out[:, :8], batch["tokens"])
