"""The port's ``generate_world`` against the JAX package's, leaf for leaf.

In the per-point noise mode ('fast') and in the default mode, whose
kernel wrapper takes the shared form (on the CPU its plain twin); every leaf
(materials, entity planes, chunk_touched, the episode key, the player
record) must be equal.  Tolerance: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crafter_tpu import worldgen as jworldgen
from crafter_tpu.config import EnvConfig as JaxConfig
from crafter_tpu_torch import convert, worldgen
from crafter_tpu_torch.config import EnvConfig
from crafter_tpu_torch.ops import noise_cuda
from one_thread import one_torch_thread  # noqa: F401


def _to_numpy(tree):
  def leaf(x):
    if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
      x = jax.random.key_data(x)
    return np.asarray(x)
  return jax.tree.map(leaf, tree)


def _assert_same(ours: dict, ref, path=''):
  for name, mine in ours.items():
    theirs = getattr(ref, name)
    if isinstance(mine, dict):
      _assert_same(mine, theirs, f'{path}.{name}')
    else:
      np.testing.assert_array_equal(mine, np.asarray(theirs),
                                    err_msg=f'{path}.{name}')


@pytest.mark.parametrize('seed', [0, 3, 77])
def test_generate_world_matches_jax(seed):
  n = 8
  keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
      jnp.arange(n))
  ref = _to_numpy(jax.jit(jax.vmap(
      lambda k: jworldgen.generate_world(k, JaxConfig(noise_mode='fast'))))(
          keys))
  kd = torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
      np.int64))
  ours = convert.to_numpy(worldgen.generate_world(
      kd, EnvConfig(noise_mode='fast')))
  _assert_same(ours, ref)
  # The worlds are not trivial: mobs and several materials appear.
  assert (ours['ent']['etype'] > 1).sum() > 0
  assert len(np.unique(ours['mat_map'])) >= 5


def _float32_grid(lo, hi, stride):
  """Every stride-th float32 in [lo, hi], in order."""
  def ordered(f):
    b = np.array(f, np.float32).view(np.int32).astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)
  o = np.arange(ordered(lo), ordered(hi) + 1, stride, dtype=np.int64)
  bits = np.where(o < 0, (-o) | np.int64(-2 ** 31), o)
  return (bits & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def test_sigmoid32_and_exp32_match_jax():
  """The worldgen sigmoid, bitwise against jax.nn.sigmoid and jnp.exp on
  2.2M float32 values spread over [-60, 60] and 0.5M more, denser, in
  [-1/16, 1/16] around the start-area threshold.  Tolerance: none."""
  from crafter_tpu_torch.ops.fma import exp32, sigmoid32
  x = np.concatenate([_float32_grid(-60.0, 60.0, 997),
                      _float32_grid(-0.0625, 0.0625, 4099)])
  t = torch.from_numpy(x)
  np.testing.assert_array_equal(sigmoid32(t).numpy(),
                                np.asarray(jax.jit(jax.nn.sigmoid)(x)))
  np.testing.assert_array_equal(exp32(t).numpy(),
                                np.asarray(jax.jit(jnp.exp)(x)))


@pytest.mark.parametrize('seed', [5, 41])
def test_generate_world_shared_noise_matches_jax(seed):
  """The default noise mode takes the kernel wrapper's shared form (its
  plain twin here): the worlds equal JAX's in every leaf, and worldgen
  passes the channels' points once and a seed a world and channel, never
  the expanded per-point inputs."""
  n = 6
  keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
      jnp.arange(n))
  ref = _to_numpy(jax.jit(jax.vmap(
      lambda k: jworldgen.generate_world(k, JaxConfig(noise_mode='fast'))))(
          keys))
  kd = torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
      np.int64))
  calls = []
  inner = noise_cuda.noise2

  def spy(points, seeds):
    calls.append((tuple(points.shape), tuple(seeds.shape)))
    return inner(points, seeds)

  def no_expansion(*args):
    raise AssertionError('the expanded per-point inputs were built')

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(noise_cuda, 'noise2', spy)
    mp.setattr(worldgen, 'noise_inputs', no_expansion)
    ours = convert.to_numpy(worldgen.generate_world(kd, EnvConfig()))
  assert calls == [((13, 4096, 2), (n, 13))]
  _assert_same(ours, ref)
