"""The port's ``ParityEnv`` (numpy on the host, no PIL, no imageio) against
the JAX package's.

Tolerance: none.  Over seeded random rollouts with stretches of sleep
actions, every observation byte, reward, done flag and ``info`` entry
(inventory, achievements, discount, semantic map, player position,
reward) must be equal, across night and sleeping frames, balance ticks,
deaths and episode ends into a second episode, at sizes whose tile unit is
not a multiple of 16 (so the item and amount textures are resized to
``int(0.8 * unit)`` and ``int(0.6 * unit)``).  The digest of
``tests/parity_digest.py`` (which ``chip_smoke.py`` checks on the GPU's
machine) is pinned to the JAX package's ``ParityEnv``.
"""

import numpy as np
import pytest

import parity_digest
from crafter_tpu import parity as jparity
from crafter_tpu_torch import parity
from one_thread import one_torch_thread  # noqa: F401


def _actions(seed, steps):
  rng = np.random.default_rng(seed)
  acts = rng.integers(0, 17, steps)
  t = np.arange(steps)
  return np.where((t % 100 >= 30) & (t % 100 < 70), parity_digest.SLEEP, acts)


def _assert_info_equal(a, b, where):
  assert a.keys() == b.keys(), where
  for name in a:
    if isinstance(a[name], dict):
      assert a[name] == b[name], (where, name)
    else:
      np.testing.assert_array_equal(np.asarray(a[name]), np.asarray(b[name]),
                                    err_msg=f'{where} {name}')
      assert np.asarray(a[name]).dtype == np.asarray(b[name]).dtype


@pytest.mark.parametrize('seed,size,length,steps', [
    (0, (64, 64), 250, 300),
    (1, (96, 96), 250, 300),      # unit 10: items at 8 px, amounts at 6 px
    (2, (80, 48), 220, 300),      # unit (8, 5), not square
    (3, (600, 600), 10000, 90),   # unit 66: items at 52 px, amounts at 39 px
])
def test_parity_env_matches_jax(seed, size, length, steps):
  ours = parity.ParityEnv(seed=seed, size=size, length=length)
  ref = jparity.ParityEnv(seed=seed, size=size, length=length)
  obs_a, obs_b = ours.reset(), ref.reset()
  np.testing.assert_array_equal(obs_a, obs_b)
  assert obs_a.shape == (size[1], size[0], 3) and obs_a.dtype == np.uint8
  seen = dict(night=0, sleeping=0, done=0, episodes=1)
  for t, action in enumerate(_actions(seed, steps).tolist()):
    a = ours.step(action)
    b = ref.step(action)
    np.testing.assert_array_equal(a[0], b[0], err_msg=f'obs at step {t}')
    assert a[1] == b[1] and type(a[1]) is type(b[1]), t
    assert a[2] == b[2], t
    _assert_info_equal(a[3], b[3], f'step {t}')
    seen['night'] += int(ours._daylight < 0.5)
    seen['sleeping'] += int(ours._sleeping)
    if a[2]:
      seen['done'] += 1
      seen['episodes'] += 1
      np.testing.assert_array_equal(ours.reset(), ref.reset())
  assert seen['sleeping'] > 0
  if steps >= 200:
    assert seen['night'] > 0 and seen['done'] >= 1, seen


def test_digest_pinned_to_jax_parity_env():
  want, counts = parity_digest.rollout(jparity.ParityEnv)
  got, ours = parity_digest.rollout(parity.ParityEnv)
  assert want == parity_digest.DIGEST
  assert got == parity_digest.DIGEST
  assert counts == ours
  assert counts['episodes'] >= 3 and counts['night'] > 0
  assert counts['sleeping'] > 0


@pytest.mark.parametrize('factor', [0.0, 0.4, 1.0, 0.73])
def test_desaturate_equals_pil(factor):
  from PIL import Image, ImageEnhance
  rng = np.random.default_rng(int(factor * 100))
  canvas = rng.uniform(0, 255.99, (37, 29, 3))
  canvas[0, :4] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]
  want = np.array(ImageEnhance.Color(
      Image.fromarray(canvas.astype(np.uint8))).enhance(factor))
  np.testing.assert_array_equal(parity._desaturate(canvas, factor), want)


def test_texture_store_equals_jax_package():
  ours, ref = parity._TextureStore(), jparity._TextureStore()
  for name in (None, 'grass', 'player-left', 'wood_pickaxe', 'sapling', '7',
               'unknown', 'zombie'):
    for size in ((7, 7), (8, 8), (10, 10), (16, 16), (52, 52), (39, 39),
                 (66, 66), (8, 5), (6, 4)):
      np.testing.assert_array_equal(ours.get(name, size), ref.get(name, size))


def test_spaces_are_the_ports():
  from crafter_tpu_torch import env as env_lib
  env = parity.ParityEnv(seed=0, size=(96, 96))
  assert isinstance(env.action_space, env_lib.DiscreteSpace)
  assert env.action_space.n == 17
  assert env.observation_space.shape == (96, 96, 3)
  assert env.action_names == jparity.ParityEnv(seed=0).action_names
