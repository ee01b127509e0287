"""The 'compat' worldgen mode of the port against the JAX package's.

The permutation-table OpenSimplex (``ops/noise.py``: ``perm_from_key``,
``perm_from_java_seed``, ``noise3``, ``octaved_noise3``; the CPU route and
the checks of its kernel's wrapper ``noise_cuda.noise3_perm``) and
``generate_world`` / ``vec_reset_chunked`` with ``noise_mode='compat'``.
Tolerance: none.  Every table, noise value, composed channel and world
leaf is compared bitwise with the jitted JAX function (``noise3`` also on
its own, ``generate_world`` under ``jax.jit(jax.vmap(...))``, as the JAX
package resets).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crafter_tpu import env as jenv
from crafter_tpu import worldgen as jworldgen
from crafter_tpu.config import EnvConfig as JaxConfig
from crafter_tpu.ops import noise as jnoise
from crafter_tpu_torch import convert, env, worldgen
from crafter_tpu_torch.config import EnvConfig
from crafter_tpu_torch.ops import noise, noise_cuda
from crafter_tpu_torch.ops.fma import fma32
from crafter_tpu_torch.utils import profiling
from one_thread import one_torch_thread  # noqa: F401
from test_torch_worldgen import _assert_same, _to_numpy


def _keys(seed, n):
  return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
      jnp.arange(n))


def _key_words(keys):
  return torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
      np.int64))


def _points3(area=(64, 64)):
  """The 13 channels' 3-D points of the compat mode, (13 * W * H, 3)."""
  return worldgen.channel_points3(EnvConfig(area=area), 'cpu').numpy()


def test_constants_match():
  np.testing.assert_array_equal(noise.GRAD3, jnoise.GRAD3)
  np.testing.assert_array_equal(noise.CANDIDATES, jnoise.CANDIDATES)


@pytest.mark.parametrize('seed', [0, 11])
def test_perm_from_key_matches_vmap(seed):
  keys = _keys(seed, 96)
  want = np.asarray(jax.vmap(jnoise.perm_from_key)(keys))
  got = noise.perm_from_key(_key_words(keys))
  assert got.dtype == torch.int32 and got.shape == (96, 256)
  np.testing.assert_array_equal(want, got.numpy())
  assert (np.sort(got.numpy(), 1) == np.arange(256)).all()


@pytest.mark.parametrize('seed', [0, 1, -1, 2 ** 31 - 2, 2 ** 40 + 3,
                                  -(2 ** 63), 2 ** 64 - 1])
def test_perm_from_java_seed_matches(seed):
  np.testing.assert_array_equal(noise.perm_from_java_seed(seed),
                                jnoise.perm_from_java_seed(seed))


@pytest.mark.parametrize('area', [(64, 64), (48, 40)])
def test_noise3_bitwise_on_worldgen_points(area):
  """The 13 channels' points, where many stretched coordinates land exactly
  on lattice planes (counted in test_floor_flips_on_lattice_boundaries)."""
  pts = _points3(area)
  for seed in (0, 5, 99):
    perm = jnoise.perm_from_java_seed(seed)
    want = np.asarray(jax.jit(jnoise.noise3)(pts, perm))
    got = noise.noise3(torch.from_numpy(pts), torch.from_numpy(perm))
    assert got.dtype == torch.float32 and got.shape == (pts.shape[0],)
    np.testing.assert_array_equal(want, got.numpy())


def test_noise3_bitwise_on_random_points_and_per_row_tables():
  rs = np.random.RandomState(0)
  pts = ((rs.rand(3, 20000, 3) - 0.5) * 100).astype(np.float32)
  perms = np.stack([jnoise.perm_from_java_seed(s) for s in (3, 4, 5)])
  want = np.asarray(jax.jit(jax.vmap(jnoise.noise3))(pts, perms))
  got = noise.noise3(torch.from_numpy(pts), torch.from_numpy(perms))
  np.testing.assert_array_equal(want, got.numpy())
  # One point set shared by every row, as worldgen calls it.
  shared = noise.noise3(torch.from_numpy(pts[:1]), torch.from_numpy(perms))
  for r in range(3):
    np.testing.assert_array_equal(
        shared[r].numpy(), np.asarray(jax.jit(jnoise.noise3)(pts[0],
                                                             perms[r])))


def test_noise3_perm_cpu_route_is_the_twin():
  """On the CPU the kernel's wrapper runs ``noise3_total`` on the shared
  points (bit for bit, zeros' signs included), launches nothing, and its
  normalised sum is the JAX package's noise."""
  pts = torch.from_numpy(_points3((16, 12)))
  perms = np.stack([jnoise.perm_from_java_seed(s) for s in (8, 9, 10)])
  perm = torch.from_numpy(perms)
  before = noise_cuda.noise3_perm.launches
  got = noise_cuda.noise3_perm(pts, perm)
  assert got.dtype == torch.float32 and got.shape == (3, pts.shape[0])
  assert torch.equal(got.view(torch.int32),
                     noise.noise3_total(pts[None], perm).view(torch.int32))
  assert noise_cuda.noise3_perm.launches == before
  for r in range(3):
    np.testing.assert_array_equal(
        (got[r] * noise.F32_INV_NORM_3D).numpy(),
        np.asarray(jax.jit(jnoise.noise3)(pts.numpy(), perms[r])))


@pytest.mark.parametrize('case,error', [
    ('float64 points', TypeError), ('int64 tables', TypeError),
    ('2-D points', ValueError), ('one table', ValueError),
    ('short tables', ValueError), ('points elsewhere', ValueError),
    ('strided points', ValueError)])
def test_noise3_perm_rejects_bad_inputs(case, error):
  pts = torch.zeros(10, 3)
  perm = torch.arange(256, dtype=torch.int32).repeat(2, 1)
  pts, perm = {
      'float64 points': (pts.double(), perm),
      'int64 tables': (pts, perm.long()),
      '2-D points': (pts[:, :2], perm),
      'one table': (pts, perm[0]),
      'short tables': (pts, perm[:, :255]),
      'points elsewhere': (pts.to('meta'), perm),
      'strided points': (torch.zeros(10, 6)[:, ::2], perm),
  }[case]
  with pytest.raises(error):
    noise_cuda.noise3_perm(pts, perm)


def test_noise3_perm_launches_are_counted():
  assert dict(profiling.counted_wrappers())['noise3_perm'] \
      is noise_cuda.noise3_perm
  noise_cuda.noise3_perm.launches = 3
  assert profiling.launches()['noise3_perm'] == 3
  profiling.zero_launches()
  assert profiling.launches()['noise3_perm'] == 0


def test_floor_flips_on_lattice_boundaries():
  """The compat points put thousands of stretched coordinates exactly on
  integers.  XLA fuses the stretch into ``fma(x + y + z, -1/6, p)``; without
  the 2**-13 nudge the fused and the unfused stretch would floor
  differently at hundreds of them, with it at none."""
  pts = torch.from_numpy(_points3())
  px, py, pz = pts.unbind(-1)
  total = (px + py) + pz
  on_plane = flips_bare = flips_nudged = 0
  for p in (px, py, pz):
    fused = fma32(total, noise.F32_STRETCH_3D, p)
    plain = p + total * noise.F32_STRETCH_3D
    on_plane += int((fused == torch.round(fused)).sum())
    flips_bare += int((torch.floor(fused) != torch.floor(plain)).sum())
    flips_nudged += int((torch.floor(fused + noise.NUDGE)
                         != torch.floor(plain + noise.NUDGE)).sum())
  assert on_plane == 2435
  assert flips_bare == 877
  assert flips_nudged == 0


def test_octaved_noise3_matches():
  xy = np.mgrid[0:24, 0:20].transpose(1, 2, 0).astype(np.float32)
  perm = jnoise.perm_from_java_seed(99)
  for sizes, normalize in (({15: 1.0, 5: 0.15}, False),
                           ({15: 1, 5: 0.3}, True), ({7: 1}, True)):
    want = np.asarray(jnoise.octaved_noise3(xy, 3.0, sizes, perm,
                                            normalize=normalize))
    got = noise.octaved_noise3(torch.from_numpy(xy), 3.0, sizes,
                               torch.from_numpy(perm), normalize=normalize)
    np.testing.assert_array_equal(want, got.numpy())


def test_composed_channels_match_jax_fusion():
  """water and mountain as XLA fuses them in the compat mode: the 1/103
  multiply of the first channel folded into its sum.  The 2-D modes'
  placement gives other bits at about a third of the cells, so this is
  the telling comparison (no world among hundreds has a cell whose
  material the placement flips)."""
  keys = _keys(1, 6)

  def channels(k):
    k_perm, _, _ = jax.random.split(k, 3)
    xs = jnp.arange(64, dtype=jnp.int32)
    xy = jnp.stack(jnp.meshgrid(xs, xs, indexing='ij'), -1)
    return jworldgen._noise_channels(xy, jnoise.perm_from_key(k_perm),
                                     'compat')

  ref = jax.jit(jax.vmap(channels))(keys)
  n, water_n, mountain_n = worldgen._compat_channels(
      _key_words(keys), EnvConfig(noise_mode='compat'))
  np.testing.assert_array_equal(water_n.numpy(), np.asarray(ref['water']))
  np.testing.assert_array_equal(
      (mountain_n * worldgen._recip(1.3)).numpy(), np.asarray(ref['mountain']))
  for i, name in ((0, 'start'), (5, 'cave'), (12, 'tree')):
    np.testing.assert_array_equal(n[:, i].numpy(), np.asarray(ref[name]))
  other = fma32(0.15, n[:, 2], n[:, 1])
  assert (other != water_n).float().mean() > 0.2


@pytest.mark.parametrize('area,n,seed', [((64, 64), 16, 0), ((64, 64), 16, 9),
                                         ((48, 40), 8, 1)])
def test_generate_world_compat_matches_jax(area, n, seed):
  keys = _keys(seed, n)
  ref = _to_numpy(jax.jit(jax.vmap(lambda k: jworldgen.generate_world(
      k, JaxConfig(area=area, noise_mode='compat'))))(keys))
  ours = convert.to_numpy(worldgen.generate_world(
      _key_words(keys), EnvConfig(area=area, noise_mode='compat')))
  _assert_same(ours, ref)
  assert (ours['ent']['etype'] > 1).sum() > 0
  assert len(np.unique(ours['mat_map'])) >= 6


def test_vec_reset_chunked_compat_across_two_chunks():
  n, chunk = 24, 16
  ref = _to_numpy(jenv.vec_reset_chunked(
      jenv.home_keys(4, n), JaxConfig(noise_mode='compat'), chunk=chunk))
  vs = env.vec_reset_chunked(env.home_keys(4, n, 'cpu'),
                             EnvConfig(noise_mode='compat'), chunk=chunk)
  _assert_same(convert.to_numpy(vs.env), ref.env)
  np.testing.assert_array_equal(vs.episode.numpy(), np.asarray(ref.episode))
  # The two chunks are not the same worlds.
  mats = vs.env.mat_map.numpy()
  assert not np.array_equal(mats[:chunk - 8], mats[chunk:])


def test_compat_is_accepted_and_differs_from_fast():
  cfg = EnvConfig(noise_mode='compat')
  keys = env.home_keys(0, 2, 'cpu')
  a = worldgen.generate_world(keys, cfg).mat_map
  b = worldgen.generate_world(keys, EnvConfig(noise_mode='fast')).mat_map
  assert not torch.equal(a, b)
  with pytest.raises(ValueError):
    EnvConfig(noise_mode='pallas')
