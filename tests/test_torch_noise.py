"""The port's plain 2-D noise against the JAX package's.

Tolerances: bitwise against ``noise2_fast`` (the function worldgen calls
on the CPU, also in the shared form of the kernel's twin); within 1e-6 absolute against ``noise2_pallas`` in interpret
mode, whose candidate sum XLA fuses differently (the JAX package holds its
own fast-vs-Pallas pair to 1e-5, tests/test_noise.py).  The float32 fused
multiply-add the port uses to match XLA is checked against exact rational
arithmetic.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crafter_tpu.ops import noise as jnoise
from crafter_tpu.ops.noise_pallas import noise2_pallas
from crafter_tpu import worldgen as jworldgen
from crafter_tpu_torch import worldgen
from crafter_tpu_torch.config import EnvConfig
from crafter_tpu_torch.ops import noise, noise_cuda
from crafter_tpu_torch.ops.fma import fma32
from one_thread import one_torch_thread  # noqa: F401

PALLAS_ATOL = 1e-6


def _channel_inputs(seed):
  """Worldgen's 13 channel point sets and seeds, as the JAX package makes
  them."""
  xs = jnp.arange(64, dtype=jnp.int32)
  xy = jnp.stack(jnp.meshgrid(xs, xs, indexing='ij'), -1)
  x = xy[..., 0].astype(jnp.float32)
  y = xy[..., 1].astype(jnp.float32)
  chans = [(x / 3, y / 3), (x / 15, y / 15), (x / 5, y / 5),
           (x / 15, y / 15), (x / 5, y / 5), (x / 7, y / 7),
           (2 * x / 3, y / 15), (x / 15, 2 * y / 3), (x / 8, y / 8),
           (x / 6, y / 6), (x / 5, y / 5), (x / 9, y / 9), (x / 7, y / 7)]
  pts = jnp.stack([jnp.stack([a, b], -1) for a, b in chans])
  zs = jnp.asarray([8, 3, 3, 0, 0, 6, 7, 7, 1, 2, 6, 4, 5], jnp.int32)
  seeds = (jnp.int32(seed)
           + zs * jnp.int32(np.uint32(0x9E3779B9).view(np.int32)))
  return pts, seeds.reshape(13, 1, 1)


def test_channel_points_match_worldgen():
  pts, _ = jax.jit(_channel_inputs)(0)
  got = worldgen.channel_points(EnvConfig(), 'cpu')
  np.testing.assert_array_equal(np.asarray(pts), got.numpy())


@pytest.mark.parametrize('seed', [0, 12345, -7, 2 ** 31 - 2])
def test_noise2_fast_bitwise_on_worldgen_points(seed):
  pts, seeds = jax.jit(_channel_inputs)(seed)
  want = np.asarray(jnoise.noise2_fast(pts, seeds))
  got = noise.noise2_fast(torch.from_numpy(np.array(pts)),
                          torch.from_numpy(np.array(seeds)))
  np.testing.assert_array_equal(want, got.numpy())


def test_noise2_fast_bitwise_on_random_points():
  rs = np.random.RandomState(0)
  pts = ((rs.rand(50000, 2) - 0.5) * 400).astype(np.float32)
  seeds = rs.randint(-2 ** 31, 2 ** 31 - 1, size=50000).astype(np.int32)
  want = np.asarray(jnoise.noise2_fast(pts, seeds))
  got = noise.noise2_fast(torch.from_numpy(pts), torch.from_numpy(seeds))
  np.testing.assert_array_equal(want, got.numpy())


def test_noise2_against_pallas_interpret():
  pts, seeds = jax.jit(_channel_inputs)(99)
  want = np.asarray(jax.jit(
      lambda p, s: noise2_pallas(p, s, interpret=True))(pts, seeds))
  got = noise.noise2_fast(torch.from_numpy(np.array(pts)),
                          torch.from_numpy(np.array(seeds))).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=PALLAS_ATOL)


def test_worldgen_noise_inputs_shape():
  keys = torch.tensor([[0, 1], [2, 3]], dtype=torch.int64)
  pts, seeds = worldgen.noise_inputs(keys, EnvConfig())
  assert pts.shape == (2 * 13 * 4096, 2) and seeds.shape == (2 * 13 * 4096,)
  assert pts.dtype == torch.float32 and seeds.dtype == torch.int32


def _round_f32(q: fractions.Fraction) -> np.float32:
  """Correctly rounded float32 (ties to even) of an exact rational."""
  r = np.float32(float(q))
  best = None
  for cand in (np.nextafter(r, np.float32(-np.inf)), r,
               np.nextafter(r, np.float32(np.inf))):
    d = abs(fractions.Fraction(float(cand)) - q)
    key = (d, int(np.asarray(cand).view(np.int32)) & 1)
    if best is None or key < best[0]:
      best = (key, cand)
  return best[1]


def test_fma32_is_correctly_rounded():
  rs = np.random.RandomState(1)
  a = rs.randn(3000).astype(np.float32)
  b = rs.randn(3000).astype(np.float32)
  c = (rs.randn(3000) * 10.0 ** rs.randint(-9, 2, 3000)).astype(np.float32)
  # Hard cases: c cancels most of a*b, or sits far below it.
  c[:500] = (-(a[:500].astype(np.float64) * b[:500])).astype(np.float32)
  c[500:1000] = a[500:1000] * b[500:1000] * np.float32(2.0 ** -30)
  got = fma32(torch.from_numpy(a), torch.from_numpy(b),
              torch.from_numpy(c)).numpy()
  want = np.array([_round_f32(fractions.Fraction(float(x))
                              * fractions.Fraction(float(y))
                              + fractions.Fraction(float(z)))
                   for x, y, z in zip(a, b, c)], np.float32)
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('rows', [1, 3])
def test_noise2_shared_twin_equals_expanded_and_jax(rows):
  """The twin of the kernel's shared form (points once a channel, a seed a
  row and channel) equals ``noise2_fast`` on the expanded per-point inputs
  and JAX's ``noise2_fast`` on the same numpy inputs, bit for bit."""
  rs = np.random.RandomState(rows)
  pts = np.asarray(jax.jit(_channel_inputs)(0)[0]).reshape(13, 4096, 2)
  seeds = rs.randint(-2 ** 31, 2 ** 31 - 1, size=(rows, 13)).astype(np.int32)
  got = noise.noise2_shared(torch.from_numpy(pts), torch.from_numpy(seeds))
  assert got.shape == (rows, 13, 4096) and got.dtype == torch.float32
  flat = noise.noise2_fast(
      torch.from_numpy(np.broadcast_to(pts, (rows, 13, 4096, 2)).copy()),
      torch.from_numpy(np.repeat(seeds[:, :, None], 4096, 2)))
  np.testing.assert_array_equal(got.numpy(), flat.numpy())
  want = np.asarray(jnoise.noise2_fast(
      np.broadcast_to(pts, (rows, 13, 4096, 2)), seeds[:, :, None]))
  np.testing.assert_array_equal(got.numpy(), want)
  # The kernel wrapper on CPU tensors is this twin.
  np.testing.assert_array_equal(
      noise_cuda.noise2(torch.from_numpy(pts),
                        torch.from_numpy(seeds)).numpy(), want)


def test_noise_seeds_and_inputs_agree():
  """The per-point inputs are the shared ones expanded, world-major."""
  keys = torch.tensor([[0, 1], [2, 3], [5, 8]], dtype=torch.int64)
  cfg = EnvConfig()
  pts, seeds = worldgen.noise_inputs(keys, cfg)
  shared = worldgen.channel_points(cfg, 'cpu').reshape(13, 4096, 2)
  rows = worldgen.noise_seeds(keys)
  assert rows.shape == (3, 13) and rows.dtype == torch.int32
  assert torch.equal(pts.reshape(3, 13, 4096, 2),
                     shared[None].expand(3, -1, -1, -1))
  assert torch.equal(seeds.reshape(3, 13, 4096),
                     rows[:, :, None].expand(-1, -1, 4096))
  with pytest.raises(ValueError):
    noise_cuda.noise2(shared, rows[:, :12])
