"""The port's plain 3-D noise against the JAX package's, and the roll
micro-bench's plain twin against numpy.

Tolerances: ``noise3_fast`` bitwise against ``jax.jit(noise3_fast)`` (on the
3-D form of worldgen's point set, on random points in +-50, with a scalar
and with per-point seeds); within 1e-5 absolute against ``noise3_pallas`` in
interpret mode, the tolerance the JAX package holds its own pair to
(tests/test_noise.py).  The roll twin: bitwise against an ``np.roll`` loop.
On the CPU the kernels' wrappers run these twins and count no launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crafter_tpu.ops import noise as jnoise
from crafter_tpu.ops.noise_pallas import noise3_pallas
from crafter_tpu_torch import worldgen
from crafter_tpu_torch.config import EnvConfig
from crafter_tpu_torch.ops import noise, noise_cuda, roll_cuda
from one_thread import one_torch_thread  # noqa: F401

PALLAS_ATOL = 1e-5


def _worldgen_points3():
  """Worldgen's 13 channel point sets with each channel's z as the third
  coordinate: (13, 64, 64, 3) float32."""
  xy = worldgen.channel_points(EnvConfig(), 'cpu').numpy()
  # The z of each channel (crafter_tpu/worldgen.py:44-58).
  zs = np.asarray([ch[4] for ch in worldgen.CHANNELS], np.float32)
  assert zs.tolist() == [8, 3, 3, 0, 0, 6, 7, 7, 1, 2, 6, 4, 5]
  z = np.broadcast_to(zs[:, None, None, None], xy.shape[:-1] + (1,))
  return np.concatenate([xy, z], -1)


def test_constants_match():
  np.testing.assert_array_equal(noise.CANDIDATES, jnoise.CANDIDATES)
  assert (noise.STRETCH_3D, noise.SQUISH_3D, noise.NORM_3D) == (
      jnoise.STRETCH_3D, jnoise.SQUISH_3D, jnoise.NORM_3D)
  assert sum(noise.DZ2_SHARED) == 6


@pytest.mark.parametrize('seed', [0, 12345, -7, 2 ** 31 - 2])
def test_noise3_fast_bitwise_on_worldgen_points(seed):
  pts = _worldgen_points3()
  want = np.asarray(jax.jit(jnoise.noise3_fast)(pts, jnp.int32(seed)))
  got = noise.noise3_fast(torch.from_numpy(pts), seed)
  assert got.shape == (13, 64, 64) and got.dtype == torch.float32
  np.testing.assert_array_equal(want, got.numpy())


def test_noise3_fast_bitwise_on_random_points():
  rs = np.random.RandomState(0)
  pts = ((rs.rand(50000, 3) - 0.5) * 100).astype(np.float32)
  want = np.asarray(jax.jit(jnoise.noise3_fast)(pts, jnp.int32(77)))
  got = noise.noise3_fast(torch.from_numpy(pts), 77)
  np.testing.assert_array_equal(want, got.numpy())
  assert np.abs(want).max() > 0.5
  # Per-point seeds, through the kernel's wrapper (the twin on the CPU).
  seeds = rs.randint(-2 ** 31, 2 ** 31 - 1, size=50000).astype(np.int32)
  want = np.asarray(jax.jit(jnoise.noise3_fast)(pts, seeds))
  before = noise_cuda.noise3.launches
  got = noise_cuda.noise3(torch.from_numpy(pts), torch.from_numpy(seeds))
  np.testing.assert_array_equal(want, got.numpy())
  assert noise_cuda.noise3.launches == before


def test_noise3_against_pallas_interpret():
  pts = _worldgen_points3()
  want = np.asarray(noise3_pallas(jnp.asarray(pts), jnp.int32(99),
                                  interpret=True))
  got = noise.noise3_fast(torch.from_numpy(pts), 99).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=PALLAS_ATOL)


def test_noise3_wrapper_rejects_bad_shapes():
  with pytest.raises(ValueError):
    noise_cuda.noise3(torch.zeros(5, 2), 0)


@pytest.mark.parametrize('kind', roll_cuda.KINDS)
@pytest.mark.parametrize('stages', [10, 40])
def test_roll_twin_matches_numpy(kind, stages):
  """The stages of tools/bench_roll.py:27-39, written with numpy."""
  x = np.random.RandomState(1).randint(0, 1 << 24, size=(7, 4096)).astype(
      np.int32)
  want, j = x.copy(), np.arange(4096)
  for k in range(stages):
    b = k % 12
    if kind == 'roll':
      f = np.roll(want, -(1 << b), axis=-1)
    elif kind == 'roll1':
      f = np.roll(want, -1, axis=-1)
    else:
      f = (want.astype(np.int64) * 3 + k).astype(np.int32)   # wraps
    want = np.where((j >> b) & 1 != 0, f, want)
  before = roll_cuda.roll_stages.launches
  got = roll_cuda.roll_stages(torch.from_numpy(x), kind, stages)
  np.testing.assert_array_equal(want, got.numpy())
  assert roll_cuda.roll_stages.launches == before
  if kind != 'ctl':
    assert sorted(got[0].tolist()) != sorted(x[0].tolist()) or stages < 12


def test_roll_rejects_bad_input():
  with pytest.raises(ValueError):
    roll_cuda.roll_stages(torch.zeros(2, 4096, dtype=torch.int32), 'spin', 1)
  with pytest.raises(ValueError):
    roll_cuda.roll_stages(torch.zeros(2, 100, dtype=torch.int32), 'roll', 1)
