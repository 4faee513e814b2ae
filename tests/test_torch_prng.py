"""The port's threefry keys and draws against jax.random.

Keys, bits and integer draws must match bit for bit. The key goldens are
copied from tests/core/test_key_contract.py, which recorded them under
``jax_threefry_partitionable=False``; every jax call here runs inside that
scoped mode (never ``jax.config.update``, which would flip the JAX tests
that share this worker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert, prng

KEY0 = [0, 0]
SMPPCA_SPLIT3 = [[2467461003, 428148500],
                 [3186719485, 3840466878],
                 [2562233961, 1946702221]]
SMPPCA_EST_KEY = [3085582442, 3617870444]
EST_SPLIT2 = [[3818717833, 1612203793], [166711035, 3635324495]]
ROW_KEYS = {0: [1797259609, 2579123966],
            1: [928981903, 3453687069],
            5: [1524306142, 1887795613]}
SPLIT2 = [[4146024105, 967050713], [2718843009, 1272950319]]

SEEDS = [0, 42, 2 ** 31 + 5]
SHAPES = [(7,), (3, 5), (1000,)]


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(convert.key_to_numpy(got),
                                  np.asarray(want, np.uint32))


def test_key_goldens_bit_exact():
    key = prng.PRNGKey(0)
    _eq(key, KEY0)
    _eq(prng.split(key, 3), SMPPCA_SPLIT3)
    _eq(prng.split(key), SPLIT2)
    k_sample = convert.key_from_numpy(np.asarray(SMPPCA_SPLIT3[1], np.uint32))
    _eq(prng.fold_in(k_sample, 0), SMPPCA_EST_KEY)
    _eq(prng.split(prng.fold_in(k_sample, 0)), EST_SPLIT2)
    for i, want in ROW_KEYS.items():
        _eq(prng.fold_in(key, i), want)
    # the vectorized fold_in is the stack of the scalar ones
    _eq(prng.fold_in(key, torch.tensor(list(ROW_KEYS))),
        list(ROW_KEYS.values()))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(seed)
        want_split = {num: np.asarray(jax.random.split(jkey, num))
                      for num in (1, 2, 3, 5)}
        want_fold = np.asarray(jax.vmap(lambda i: jax.random.fold_in(jkey, i))(
            jnp.array([0, 1, 7, 2 ** 32 - 1], jnp.uint32)))
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(convert.key_to_numpy(key), np.asarray(jkey))
    for num, want in want_split.items():
        _eq(prng.split(key, num), want)
    _eq(prng.fold_in(key, torch.tensor([0, 1, 7, 2 ** 32 - 1])), want_fold)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_randint_bernoulli_bit_exact(seed, shape):
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(seed)
        want_u = np.asarray(jax.random.uniform(jkey, shape))
        lo = np.nextafter(np.float32(-1), np.float32(0))
        want_u2 = np.asarray(jax.random.uniform(jkey, shape, minval=lo,
                                                maxval=1.0))
        want_b = np.asarray(jax.random.bernoulli(jkey, 0.5, shape))
        bounds = [(0, 10), (3, 100_000), (0, 65_536), (0, 70_000),
                  (-5, 5), (5, 5), (0, 2 ** 31 - 1)]
        want_i = [np.asarray(jax.random.randint(jkey, shape, a, b))
                  for a, b in bounds]
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.uniform(key, shape).numpy(), want_u)
    np.testing.assert_array_equal(
        prng.uniform(key, shape, float(lo), 1.0).numpy(), want_u2)
    np.testing.assert_array_equal(prng.bernoulli(key, 0.5, shape).numpy(),
                                  want_b)
    for (a, b), want in zip(bounds, want_i):
        got = prng.randint(key, shape, a, b).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"randint({a}, {b})")


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed):
    """Same uniforms, same erf_inv polynomial; only log1p's last bit may
    differ, so a few percent of the draws move by an ulp or two. Tolerance:
    1e-6 absolute (|x| < 6, float32 ulp there is 4.8e-7)."""
    shape = (20_000,)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.mean(got == want) > 0.9


def test_key_stack_draws_rowwise():
    """A (t, 2) key stack draws one independent row per key, each equal to
    the single-key draw (what pi_rows relies on)."""
    keys = prng.fold_in(prng.PRNGKey(3), torch.arange(4))
    stacked = prng.normal(keys, (9,))
    for i in range(4):
        np.testing.assert_array_equal(stacked[i].numpy(),
                                      prng.normal(keys[i], (9,)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_rademacher_bit_exact(seed):
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(seed)
        want = {dtype: np.asarray(jax.random.rademacher(jkey, (1000,),
                                                        dtype=dtype))
                for dtype in (jnp.float32, jnp.int32)}
    key = prng.PRNGKey(seed)
    got_f = prng.rademacher(key, (1000,)).numpy()
    got_i = prng.rademacher(key, (1000,), dtype=torch.int32).numpy()
    assert got_f.dtype == np.float32 and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_f, want[jnp.float32])
    np.testing.assert_array_equal(got_i, want[jnp.int32])


def _tied_first_round(key, n):
    """Whether the first sort round of permutation(key, n) has tied keys."""
    bits = prng.random_bits(prng.split(key)[1], (n,))
    return bits.unique().numel() < n


PERMUTATION_CASES = [(0, 64), (1, 2048), (2, 65_536), ("split0", 65_536)]


@pytest.mark.parametrize("seed,n", PERMUTATION_CASES)
def test_permutation_and_choice_bit_exact(seed, n):
    """jax shuffles by 1 round of a stable 32-bit-key sort at n <= 2048 and
    2 rounds at 65,536; split(PRNGKey(0))[1] at 65,536 has a tied sort key
    in its first round, so only a stable sort reproduces it."""
    with jax.threefry_partitionable(False):
        jkey = (jax.random.split(jax.random.PRNGKey(0))[1]
                if seed == "split0" else jax.random.PRNGKey(seed))
        want_perm = np.asarray(jax.random.permutation(jkey, n))
        want_choice = np.asarray(jax.random.choice(jkey, n, (n // 8,),
                                                   replace=False))
        want_grid = np.asarray(jax.random.choice(jkey, n, (2, 3),
                                                 replace=False))
    key = convert.key_from_numpy(np.asarray(jkey))
    got = prng.permutation(key, n).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want_perm)
    np.testing.assert_array_equal(prng.choice(key, n, (n // 8,)).numpy(),
                                  want_choice)
    np.testing.assert_array_equal(prng.choice(key, n, (2, 3)).numpy(),
                                  want_grid)
    if seed == "split0":
        assert _tied_first_round(key, n)


def test_choice_refuses_what_jax_refuses():
    key = prng.PRNGKey(0)
    with pytest.raises(ValueError, match="larger sample"):
        prng.choice(key, 4, (5,))
    with pytest.raises(ValueError, match="positive"):
        prng.choice(key, 0, (1,))
    assert prng.choice(key, 0, (0,)).shape == (0,)
