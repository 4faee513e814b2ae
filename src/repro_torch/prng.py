"""Counter-based threefry2x32 keys and draws, as plain functions on tensors.

The randomness contract of SMP-PCA is that a (key, global row index) pair
fixes the projection column of that row, whatever order rows arrive in, so
the port carries the same explicit keys as the JAX package rather than a
stateful ``torch.Generator``. This module reproduces ``jax.random``'s classic
key tree (``jax_threefry_partitionable=False``):

* a key is an int64 tensor of shape ``(2,)`` (or ``(..., 2)`` for a stack of
  keys) holding two 32-bit words; torch's uint32 support is thin, so every
  word lives in an int64 masked to 32 bits;
* ``split``, ``fold_in`` and the random bits are ``threefry_2x32`` of a
  counter array, exactly as ``jax/_src/prng.py`` lays the counters out;
* ``uniform``, ``normal``, ``randint`` and ``bernoulli`` apply
  ``jax/_src/random.py``'s bits-to-value transforms.

Integer outputs (keys, bits, ``randint``, ``bernoulli``) and ``uniform`` are
bit-exact with ``jax.random``. ``normal`` uses XLA's own ``erf_inv``
polynomial (Giles); its ``log1p`` rounds differently from XLA's in the last
bit now and then, so a few percent of normals differ by an ulp or two.

Every function runs on the device of its key tensor.
"""
from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """Key data of ``jax.random.PRNGKey(seed)`` with jax's default 32-bit
    types: (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block cipher on broadcastable int64 word tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _hash(key: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``threefry_2x32(key, counts)`` for 1-D counts; key (..., 2) gives
    (..., len(counts)). The counter array is padded to even length and its
    two halves are hashed as the two words, as in ``jax._src.prng``."""
    n = counts.shape[0]
    if n % 2:
        counts = torch.cat([counts, counts.new_zeros(1)])
    half = counts.shape[0] // 2
    k0, k1 = key[..., 0:1], key[..., 1:2]
    y0, y1 = threefry2x32(k0, k1, counts[:half], counts[half:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (classic tree): (num, 2) keys."""
    return _hash(key, _iota(2 * num, key.device)).reshape(num, 2)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``. ``data`` may be an int or an integer tensor
    (t,), which gives the (t, 2) stack of ``fold_in(key, data[i])``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element, int64 in [0, 2**32). A key stack (t, 2)
    gives (t, *shape): one independent draw per key."""
    shape = tuple(shape)
    size = math.prod(shape)
    if size >= _MASK:
        raise NotImplementedError(
            "random_bits: draws of 2**32 - 1 or more elements per key")
    bits = _hash(key, _iota(size, key.device))
    return bits.reshape(*key.shape[:-1], *shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa trick: float32 in [0, 1) from the top 23 bits."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    floats = _bits_to_unit(random_bits(key, shape))
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's float32 erf_inv: M. Giles, "Approximating the erfinv function", with
# one degree-8 polynomial for w = -log1p(-x^2) < 5 and one for the tails.
_ERFINV_CENTRE = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """erf^-1 on (-1, 1), rounded as XLA rounds it (``torch.erfinv`` is
    more exact and so differs from jax by up to 2e-5 in the tails)."""
    w = -torch.log1p(-x * x)
    centre = w < 5.0
    w = torch.where(centre, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for c_centre, c_tail in zip(_ERFINV_CENTRE, _ERFINV_TAIL):
        p = torch.where(centre, c_centre, c_tail) + p * w
    return p * x


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(u), u uniform on
    (nextafter(-1, 0), 1)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return _erfinv(u) * math.sqrt(2.0)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` for int32 output (returned as int32): two
    32-bit draws folded into [minval, maxval) by jax's multiply-mod trick,
    with its uint32 wraparound reproduced."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError("randint: bounds must lie in the int32 range")
    k1, k2 = split(key)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    return (offset + minval).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode='low'): uniform < p, as bool."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)
