"""A seeded ``ParityEnv`` rollout and the sha256 of what it returns.

Shared by ``tests/test_torch_parity.py``, which pins :data:`DIGEST` to the
JAX package's ``ParityEnv``, and ``chip_smoke.py``, which requires the
port's ``ParityEnv`` to give the same digest on the GPU's machine.  Imports
numpy only, never JAX.

The rollout: seed :data:`SEED`, episodes capped at :data:`LENGTH` steps,
:data:`STEPS` steps in all (two episodes end in them, both by death, and
a third starts), random actions from
``np.random.default_rng(SEED)`` with a stretch of sleep actions every 100
steps, so that night frames (steps 147-200 of an episode), sleeping frames
and balance ticks occur.  The digest covers every observation's bytes (the
reset frames too), and each step's reward (float64), done flag and
semantic map.
"""

import hashlib
import struct

import numpy as np

SEED = 0
STEPS = 400
LENGTH = 200
SLEEP = 6        # the sleep action (rules.ACTIONS)
DIGEST = '915d1e868ad6581c1b9f397fc77019c36de2bcf81868d49e06d4c09e2d14d5b2'


def actions(steps: int = STEPS, seed: int = SEED) -> np.ndarray:
  """The rollout's actions: uniform over the 17, but the sleep action for
  steps 40..79 of every hundred."""
  rng = np.random.default_rng(seed)
  acts = rng.integers(0, 17, steps)
  t = np.arange(steps)
  return np.where((t % 100 >= 40) & (t % 100 < 80), SLEEP, acts)


def rollout(env_cls, seed: int = SEED, steps: int = STEPS,
            length: int = LENGTH, size=(64, 64)):
  """Run the rollout on ``env_cls(seed=..., length=..., size=...)``: returns
  ``(sha256 hex digest, counts)`` with counts of episodes, night frames
  and sleeping frames (read off the env's daylight and sleeping state)."""
  env = env_cls(seed=seed, length=length, size=size)
  digest = hashlib.sha256()
  counts = dict(episodes=1, night=0, sleeping=0, steps=0)
  digest.update(np.ascontiguousarray(env.reset()).tobytes())
  for action in actions(steps, seed).tolist():
    obs, reward, done, info = env.step(action)
    counts['steps'] += 1
    counts['night'] += int(env._daylight < 0.5)
    counts['sleeping'] += int(env._sleeping)
    digest.update(np.ascontiguousarray(obs).tobytes())
    digest.update(struct.pack('<d?', float(reward), bool(done)))
    digest.update(np.ascontiguousarray(info['semantic']).tobytes())
    if done:
      counts['episodes'] += 1
      digest.update(np.ascontiguousarray(env.reset()).tobytes())
  return digest.hexdigest(), counts
