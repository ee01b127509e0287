"""The port's threefry draws against ``jax.random``, bit for bit.

Every function the main path draws through (key, fold_in, split, randint,
uniform, permutation) over many seeds and shapes; tolerance: none (bitwise).
``categorical`` draws from JAX's uniform bits but takes this library's
logarithms for the Gumbel noise, so it must equal JAX's draw on at least
99.9% of 20000 rows and follow the softmax distribution (chi-square).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crafter_tpu_torch import prng
from one_thread import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 7, 42, 12345, 2 ** 31 - 1]


def _kd(key):
  return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize('seed', SEEDS)
def test_key_fold_in_split(seed):
  kj, kt = jax.random.key(seed), prng.key(seed, 'cpu')
  np.testing.assert_array_equal(_kd(kj), kt.numpy())
  data = np.array([0, 1, 5, 0x5EED, 2 ** 31, 2 ** 32 - 1], np.uint32)
  want = _kd(jax.vmap(lambda d: jax.random.fold_in(kj, d))(data))
  got = prng.fold_in(kt[None].expand(len(data), 2),
                     torch.from_numpy(data.astype(np.int64)))
  np.testing.assert_array_equal(want, got.numpy())
  for num in (2, 3, 5):
    np.testing.assert_array_equal(_kd(jax.random.split(kj, num)),
                                  prng.split(kt, num).numpy())


def test_batched_home_keys():
  n = 300
  want = _kd(jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(
      jnp.arange(n)))
  got = prng.fold_in(prng.key(3, 'cpu')[None].expand(n, 2),
                     torch.arange(n))
  np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize('shape', [(), (7,), (4, 5, 3), (3, 64, 64)])
def test_uniform(shape):
  keys = jax.random.split(jax.random.key(11), 6)
  want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
  got = prng.uniform(torch.from_numpy(_kd(keys)), shape)
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize('maxval', [17, 2 ** 31 - 1])
def test_randint(maxval):
  keys = jax.random.split(jax.random.key(5), 64)
  want = np.asarray(jax.vmap(
      lambda k: jax.random.randint(k, (), 0, maxval))(keys))
  got = prng.randint(torch.from_numpy(_kd(keys)), 0, maxval)
  np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize('n', [1, 8, 16, 64, 256, 4096, 262144])
def test_permutation(n):
  for seed in (0, 3, 12345):
    # A key as training meets it: split off a run key.
    kj = jax.random.split(jax.random.key(seed), 3)[2]
    want = np.asarray(jax.random.permutation(kj, n))
    got = prng.permutation(torch.from_numpy(_kd(kj)), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(want, got.numpy())


def test_categorical_matches_jax_and_softmax():
  rows, n_act = 20000, 17
  logits = np.random.RandomState(0).randn(n_act).astype(np.float32)
  batch = np.broadcast_to(logits, (rows, n_act)).copy()
  kj = jax.random.key(21)
  want = np.asarray(jax.random.categorical(kj, batch))
  got = prng.categorical(torch.from_numpy(_kd(kj)),
                         torch.from_numpy(batch)).numpy()
  assert got.shape == (rows,) and got.min() >= 0 and got.max() < n_act
  assert (got == want).mean() >= 0.999
  # The draws follow softmax(logits): chi-square with 16 degrees of
  # freedom, whose 99.9th percentile is 39.25.
  probs = np.exp(logits - logits.max())
  probs /= probs.sum()
  counts = np.bincount(got, minlength=n_act)
  chi2 = ((counts - rows * probs) ** 2 / (rows * probs)).sum()
  assert chi2 < 39.25, chi2
