"""JAX's Threefry-2x32 key stream in plain torch integer math.

The device games draw all their randomness through ``jax.random``: keys
made by ``PRNGKey``, ``split`` and ``fold_in``, and ``randint``, ``uniform``
and ``bernoulli`` draws.  All of it sits on the Threefry-2x32 counter hash
in its partitionable form (``jax_threefry_partitionable``, jax's default
since 0.5; sources ``jax/_src/prng.py`` ``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable`` and
``jax/_src/random.py`` ``_uniform``, ``_randint``, ``_bernoulli``).  This
module computes the same bits, so a game trajectory from a given key is
bit-equal in the JAX package, in the port's plain games and in K12, whose
``csrc/threefry.cuh`` holds the same functions for the card.

A key is a ``uint32[2]``, held here in an int64 tensor whose values lie in
[0, 2^32).  Every function is batched over leading key axes: ``keys`` of
shape [..., 2] give draws of shape [..., *shape], one stream per key.  The
tensors stay on the keys' device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def as_key(key, device=None) -> torch.Tensor:
    """A key as an int64 tensor [..., 2] (from a tensor, numpy array or pair)."""
    t = torch.as_tensor(key, device=device)
    if t.dtype != torch.int64:
        t = t.to(torch.int64) & MASK  # uint32 / int32 bit patterns alike
    return t


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter pair (x1, x2) under the key
    (k1, k2): 20 rounds, a key injection after every 4 (``prng.py``'s
    ``_threefry2x32_lowering``).  Arguments broadcast; int64 in [0, 2^32)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = (((x2 << r) | (x2 >> (32 - r))) & MASK) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64, device=device)


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of the flat index 0..n-1 (``iota_2x32_shape``)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: [..., 2] -> [..., num, 2]."""
    hi, lo = _counters(num, keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def random_bits32(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """32 random bits per element, ``bits1 ^ bits2`` of the hash of each
    element's flat index: [..., 2] -> [..., *shape] int64."""
    shape = _shape(shape)
    hi, lo = _counters(max(math.prod(shape), 1), keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], hi, lo)
    return (b1 ^ b2).reshape(*keys.shape[:-1], *shape)


def uniform(keys: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa of
    a float in [1, 2), minus one, scaled to [minval, maxval), then
    ``max(minval, .)``.  XLA contracts the scale ``u * (hi - lo) + lo`` into
    one fused multiply-add; the fp32 product is exact in fp64, so the fp64
    sum rounded to fp32 gives the same value (K12 uses ``fmaf``)."""
    bits = (random_bits32(keys, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    fused = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def randint(keys: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32: two 32-bit draws per element (from
    ``split(key)``), combined modulo the span as JAX does."""
    k = split(keys, 2)
    higher = random_bits32(k[..., 0, :], shape)
    lower = random_bits32(k[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    multiplier = ((2 ** 16 % span) ** 2) % span
    offset = (((higher % span) * multiplier + lower % span) & MASK) % span
    return (offset + minval).to(torch.int32)


def bernoulli(keys: torch.Tensor, p: float, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(key, shape) < p`` in float32."""
    return uniform(keys, shape) < torch.tensor(p, dtype=torch.float32, device=keys.device)
