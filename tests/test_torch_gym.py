"""The port's gym surfaces against the JAX package's on the CPU.

``Env`` against ``crafter_tpu.Env`` for seeds 0 and 7 and both reward
settings, over random-policy episodes of 30 ticks across two resets: obs,
reward, done and every ``info`` entry equal, values and types
(tolerance: none).  ``GymnasiumEnv`` against the JAX adapter, seeded
reset and the terminated / truncated split included.  ``register_gym_envs``
in a fresh interpreter that never imports ``crafter_tpu`` (both packages
register the same ids and keep an id that exists).  ``VideoRecorder``'s gif
decoded with imageio: the recorder's frame count and size, every pixel
within the 3-3-2 palette's quantisation step of the frame it saw.  And the
package imports and steps without gymnasium.
"""

import json
import os
import pathlib
import subprocess
import sys

import gymnasium
import imageio.v3 as iio
import numpy as np
import pytest

from crafter_tpu import env as jenv
import crafter_tpu_torch as ct
from crafter_tpu_torch import recorder
from one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
LENGTH = 30
# A fresh interpreter with this checkout first and one PyTorch thread.
SUBPROCESS_ENV = {**os.environ, 'OMP_NUM_THREADS': '1',
                  'PYTHONPATH': str(ROOT)}


@pytest.fixture(scope='module')
def jax_envs():
  """One JAX ``Env`` a reward setting, reseeded by each test: its jitted
  reset and step compile once."""
  return {reward: jenv.Env(seed=0, reward=reward, length=LENGTH)
          for reward in (True, False)}


def _reseed(env, seed):
  env._seed, env._episode = seed, 0


def _assert_info_equal(ours, theirs):
  assert list(ours) == list(theirs)
  for name, want in theirs.items():
    got = ours[name]
    if isinstance(want, np.ndarray):
      assert got.dtype == want.dtype and got.shape == want.shape, name
      np.testing.assert_array_equal(got, want, err_msg=name)
    else:
      assert type(got) is type(want) and got == want, name


@pytest.mark.parametrize('reward', [True, False])
@pytest.mark.parametrize('seed', [0, 7])
def test_env_matches_jax(jax_envs, seed, reward):
  theirs = jax_envs[reward]
  _reseed(theirs, seed)
  ours = ct.Env(seed=seed, reward=reward, length=LENGTH, device='cpu')
  assert ours.action_names == theirs.action_names
  assert ours.action_space.n == theirs.action_space.n
  assert ours.observation_space.shape == theirs.observation_space.shape
  np.testing.assert_array_equal(ours.reset(), theirs.reset())
  rs = np.random.RandomState(seed)
  resets, rewards = 0, 0.0
  while resets < 2:
    action = int(rs.randint(17))
    a, b = ours.step(action), theirs.step(action)
    assert a[0].dtype == np.uint8 and a[0].shape == (64, 64, 3)
    np.testing.assert_array_equal(a[0], b[0])
    assert type(a[1]) is float and a[1] == b[1]
    assert type(a[2]) is bool and a[2] == b[2]
    _assert_info_equal(a[3], b[3])
    rewards += abs(a[3]['reward'])
    if a[2]:
      assert a[3]['ended']
      resets += 1
      np.testing.assert_array_equal(ours.reset(), theirs.reset())
  assert ours._episode == theirs._episode == 3
  assert rewards > 0   # the info reward moved: the check has teeth
  np.testing.assert_array_equal(ours.render((96, 80)),
                                theirs.render((96, 80)))


def test_gymnasium_env_matches_jax_adapter():
  theirs = jenv.GymnasiumEnv(reward=True, length=12, seed=1)
  ours = ct.GymnasiumEnv(reward=True, length=12, seed=1, device='cpu')
  assert isinstance(ours, gymnasium.Env)
  for seed in (3, 4):
    (oa, ia), (ob, ib) = ours.reset(seed=seed), theirs.reset(seed=seed)
    np.testing.assert_array_equal(oa, ob)
    assert ia == ib == {}
    rs = np.random.RandomState(seed)
    while True:
      action = int(rs.randint(17))
      a, b = ours.step(action), theirs.step(action)
      np.testing.assert_array_equal(a[0], b[0])
      assert a[1:4] == b[1:4]
      _assert_info_equal(a[4], b[4])
      if a[2] or a[3]:
        assert a[3] and not a[2]   # the episode cap: truncated
        break
    np.testing.assert_array_equal(ours.render(), theirs.render())
  # Terminated: a zero discount (the player died) ends without truncation.
  dead = {'discount': 0.0}
  ours._env.step = lambda action: (oa, 0.0, True, dead)
  assert ours.step(0)[2:4] == (True, False)


def test_register_gym_envs_in_a_fresh_interpreter():
  code = '''
import json, sys
import gymnasium
import crafter_tpu_torch as ct
ct.register_gym_envs()
ct.register_gym_envs()   # a second call keeps the ids as they are
specs = {i: gymnasium.spec(i) for i in ('CrafterReward-v1',
                                        'CrafterNoReward-v1')}
env = gymnasium.make('CrafterNoReward-v1', device='cpu', seed=2)
obs, info = env.reset(seed=2)
obs, reward, terminated, truncated, info = env.step(5)
print(json.dumps({
    'entry': [s.entry_point for s in specs.values()],
    'kwargs': [s.kwargs for s in specs.values()],
    'steps': [s.max_episode_steps for s in specs.values()],
    'obs': list(obs.shape), 'dtype': str(obs.dtype),
    'types': [type(reward).__name__, type(terminated).__name__],
    'jax': sorted(m for m in sys.modules
                  if m.split('.')[0] in ('jax', 'crafter_tpu'))}))
'''
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=SUBPROCESS_ENV)
  assert out.returncode == 0, out.stderr
  got = json.loads(out.stdout.strip().splitlines()[-1])
  assert got['entry'] == ['crafter_tpu_torch.env:GymnasiumEnv'] * 2
  assert got['kwargs'] == [{'reward': True}, {'reward': False}]
  assert got['steps'] == [10000, 10000]
  assert got['obs'] == [64, 64, 3] and got['dtype'] == 'uint8'
  assert got['types'] == ['float', 'bool']
  assert got['jax'] == []


class _Seen:
  """An env whose renders are kept: the frames the recorder saw."""

  def __init__(self, env):
    self.env, self.frames = env, []

  def reset(self):
    return self.env.reset()

  def step(self, action):
    return self.env.step(action)

  def render(self, size):
    frame = self.env.render(size)
    self.frames.append(frame)
    return frame


def test_video_recorder_writes_a_gif_of_the_frames_it_saw(tmp_path):
  seen = _Seen(ct.Env(seed=3, length=12, device='cpu'))
  env = ct.VideoRecorder(seen, tmp_path, size=(96, 80))
  env.reset()
  done, steps = False, 0
  while not done:
    _, _, done, _ = env.step(steps % 17)
    steps += 1
  gifs = list(tmp_path.glob('*.gif'))
  assert len(gifs) == 1 and gifs[0].name.endswith(f'-len{steps}.gif')
  frames = iio.imread(gifs[0], index=None)
  assert frames.shape == (steps + 1, 80, 96, 3) == (len(seen.frames), 80, 96,
                                                    3)
  step = np.array([32, 32, 64])
  for got, want in zip(frames, seen.frames):
    assert (np.abs(got.astype(int) - want.astype(int)) < step).all()
  assert len({f.tobytes() for f in seen.frames}) > 1


def test_gif_writer_round_trips_the_palette(tmp_path):
  """Every one of the 256 palette colours, and a noise frame large enough
  that the LZW table fills and clears, decode to the palette's colour of
  each pixel."""
  rs = np.random.RandomState(0)
  level = np.arange(256)
  colours = np.stack([(level >> 5) << 5, ((level >> 2) & 7) << 5,
                      (level & 3) << 6], -1).astype(np.uint8)
  every = colours.reshape(16, 16, 3).repeat(3, 0).repeat(3, 1)
  big = rs.randint(0, 256, (160, 160, 3)).astype(np.uint8)
  for case, fr in enumerate(([every, every], [big, big[::-1].copy()])):
    path = tmp_path / f'{case}.gif'
    recorder.write_gif(path, fr)
    got = iio.imread(path, index=None)
    assert got.shape == (len(fr),) + fr[0].shape
    for g, f in zip(got, fr):
      f = f.astype(int)
      want = np.stack([(f[..., 0] >> 5) * 255 // 7, (f[..., 1] >> 5) * 255 // 7,
                       (f[..., 2] >> 6) * 255 // 3], -1)
      np.testing.assert_array_equal(g, want)


def test_package_imports_and_steps_without_gymnasium():
  code = '''
import sys
sys.modules['gymnasium'] = None   # an import of it fails
import crafter_tpu_torch as ct
env = ct.Env(seed=1, length=5, device='cpu')
assert env.reset().shape == (64, 64, 3)
assert env.step(1)[0].shape == (64, 64, 3)
assert type(env.action_space).__name__ == 'DiscreteSpace'
assert env.action_space.n == 17
assert env.observation_space.shape == (64, 64, 3)
assert ct.GymnasiumEnv.__mro__[1] is object
ct.register_gym_envs()   # nothing to register with
print('ok')
'''
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=SUBPROCESS_ENV)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip().splitlines()[-1] == 'ok'
