"""The port's Threefry stream (``envs/prng.py``) against ``jax.random``, bit
for bit, over 256 keys: PRNGKey, split, fold_in, and the randint, uniform
and bernoulli draws at every (shape, low, high) the device games use.  The
tests run in JAX's partitionable Threefry mode (tests/conftest.py), JAX's
default."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu_torch.envs import prng

KEYS = jax.random.split(jax.random.PRNGKey(7), 256)


def _port_keys():
    return torch.from_numpy(np.asarray(KEYS).astype(np.int64))


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 977, 9137, 2 ** 31 - 1])
def test_prng_key(seed):
    _equal(prng.prng_key(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 3, 16, 1024])
def test_split(num):
    _equal(prng.split(_port_keys(), num), jax.vmap(lambda k: jax.random.split(k, num))(KEYS))


@pytest.mark.parametrize("data", [0, 5, 31, 2 ** 31 + 3])
def test_fold_in(data):
    _equal(prng.fold_in(_port_keys(), data),
           jax.vmap(lambda k: jax.random.fold_in(k, data))(KEYS))


def test_fold_in_per_key_data():
    levels = np.arange(256, dtype=np.int32) % 32
    _equal(prng.fold_in(_port_keys(), torch.from_numpy(levels)),
           jax.vmap(jax.random.fold_in)(KEYS, jnp.asarray(levels)))


# every randint of device_games.py: catch/breakout columns, freeway cars and
# speeds, asterix@var speeds, catch@var wind, invaders@var beats, level draws
@pytest.mark.parametrize("shape,lo,hi", [((), 0, 10), ((8,), 0, 10), ((8,), 2, 5),
                                         ((8,), 1, 4), ((10,), -1, 2), ((), 3, 6),
                                         ((), 4, 9), ((), 0, 16)])
def test_randint(shape, lo, hi):
    _equal(prng.randint(_port_keys(), shape, lo, hi),
           jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi, jnp.int32))(KEYS))


@pytest.mark.parametrize("shape,bounds", [((), None), ((8,), None), ((3, 10), None),
                                          ((4, 6), None), ((8,), (0.15, 0.5))])
def test_uniform(shape, bounds):
    if bounds is None:
        want = jax.vmap(lambda k: jax.random.uniform(k, shape))(KEYS)
        got = prng.uniform(_port_keys(), shape)
    else:
        lo, hi = bounds
        want = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, shape, minval=lo, maxval=hi)))(KEYS)
        got = prng.uniform(_port_keys(), shape, lo, hi)
    _equal(got, want)


@pytest.mark.parametrize("shape", [(), (8,)])
def test_bernoulli(shape):
    _equal(prng.bernoulli(_port_keys(), 0.5, shape),
           jax.vmap(lambda k: jax.random.bernoulli(k, 0.5, shape))(KEYS))


def test_random_bits_and_threefry_vector():
    """The raw 32-bit draws, and the hash itself on Random123's published
    known-answer vector (key and counter all ones)."""
    _equal(prng.random_bits32(_port_keys(), (5,)),
           jax.vmap(lambda k: jax.random.bits(k, (5,), jnp.uint32))(KEYS))
    ones = torch.tensor(prng.MASK, dtype=torch.int64)
    y1, y2 = prng.threefry2x32(ones, ones, ones, ones)
    assert (int(y1), int(y2)) == (0x1CB996FC, 0xBB002BE7)
