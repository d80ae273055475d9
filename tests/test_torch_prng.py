"""The port's threefry keys (``room_slam_torch/data/prng.py``) against
``jax.random`` bit for bit: ``key``, ``split``, ``fold_in`` and 32-bit
``bits`` over 32 numpy-seeded keys and several shapes; ``uniform``
(JAX's mantissa construction and its fused multiply-add), ``randint`` and
``choice(p=...)`` exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from room_slam_torch.data import prng

KEYS = np.random.default_rng(0).integers(0, 2 ** 32, size=(32, 2),
                                         dtype=np.uint64).astype(np.uint32)
JKEYS = jax.random.wrap_key_data(jnp.asarray(KEYS))
TKEYS = torch.from_numpy(KEYS.astype(np.int64))
SHAPES = [(), (3,), (2, 5), (7,)]


def _data(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 100, 10_100, 2 ** 31 - 1, -5])
def test_key_matches_jax(seed):
    assert (prng.key(seed).numpy() == _data(jax.random.key(seed))).all()


@pytest.mark.parametrize("num", [2, 3, 5, (2, 3)])
def test_split_matches_jax(num):
    ref = np.stack([_data(jax.random.split(k, num)) for k in JKEYS])
    np.testing.assert_array_equal(prng.split(TKEYS, num).numpy(), ref)


@pytest.mark.parametrize("data", [0, 1, 2, 12345, 2 ** 32 - 1])
def test_fold_in_matches_jax(data):
    ref = np.stack([_data(jax.random.fold_in(k, data)) for k in JKEYS])
    np.testing.assert_array_equal(prng.fold_in(TKEYS, data).numpy(), ref)
    # a tensor of data broadcast against the keys: one per key
    d = torch.arange(32) * 7919
    ref = np.stack([_data(jax.random.fold_in(k, int(i)))
                    for k, i in zip(JKEYS, d)])
    np.testing.assert_array_equal(prng.fold_in(TKEYS, d).numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_match_jax(shape):
    ref = np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(JKEYS))
    np.testing.assert_array_equal(prng.random_bits(TKEYS, shape).numpy(),
                                  ref.astype(np.int64))


RANGES = [(0.0, 1.0), (0.45, 0.9), (2.6, 4.0), (-1.0, 1.0),
          (0.0, 2 * np.pi), (float(np.log(0.145)), 0.0), (0.02, 0.2),
          (3.5, 9.0)]


@pytest.mark.parametrize("lo,hi", RANGES)
def test_uniform_matches_jax(lo, hi):
    for shape in SHAPES:
        ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, shape, minval=lo, maxval=hi))(JKEYS))
        got = prng.uniform(TKEYS, shape, lo, hi).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("lo,hi", [(0, 4), (2, 9), (0, 1), (5, 5),
                                   (-3, 1000)])
def test_randint_matches_jax(lo, hi):
    for shape in ((), (6,)):
        ref = np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, shape, lo, hi))(JKEYS))
        np.testing.assert_array_equal(
            prng.randint(TKEYS, shape, lo, hi).numpy(), ref)


def test_choice_matches_jax():
    p = [0.38, 0.31, 0.08, 0.23]
    keys = jax.random.split(jax.random.key(4), 512)
    ref = np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, jnp.array([1, 2, 3, 0]), (), p=jnp.array(p)))(keys))
    got = prng.choice(torch.from_numpy(_data(keys)),
                      torch.tensor([1, 2, 3, 0]), p).numpy()
    np.testing.assert_array_equal(got, ref)
    assert set(ref.tolist()) == {0, 1, 2, 3}      # every class drawn
