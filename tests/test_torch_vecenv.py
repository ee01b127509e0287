"""The per-tick env: ``step_batch``, ``vec_step``, ``vec_step_k`` and
``VecEnv`` against the JAX package's.

* ``step_batch`` over 12 ticks with ``balance=None`` (each env on its own
  cadence) against ``crafter_tpu.step.step_batch(engine='pallas')``, whose
  tick kernel runs in interpret mode.
* ``vec_step`` with ``reset_every`` and with an overflowing reset batch
  against the JAX ``vec_step``: the latched ``pending`` and the ``ended``
  pulse must be equal tick by tick.
* ``vec_step_k`` against K ``vec_step`` calls.
* ``VecEnv.reset`` / ``step`` against the JAX ``VecEnv``: obs, reward, done
  and every ``info`` entry, ``semantic`` included.

13 envs; the port runs its plain twins on the CPU.  Tolerance: none.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from crafter_tpu import env as jenv
from crafter_tpu import step as jstep
from crafter_tpu.config import EnvConfig as JaxConfig
import crafter_tpu_torch as ct
from crafter_tpu_torch import step_cuda
from one_thread import one_torch_thread  # noqa: F401

N = 13


def _to_numpy(tree):
  def leaf(x):
    if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
      x = jax.random.key_data(x)
    return np.asarray(x)
  return jax.tree.map(leaf, tree)


def _assert_same(ours: dict, ref, path=''):
  for name, mine in ours.items():
    theirs = ref[name] if isinstance(ref, dict) else getattr(ref, name)
    if isinstance(mine, dict):
      _assert_same(mine, theirs, f'{path}.{name}')
    else:
      theirs = np.asarray(theirs)
      assert mine.dtype == theirs.dtype, f'{path}.{name}'
      np.testing.assert_array_equal(mine, theirs, err_msg=f'{path}.{name}')


def test_step_batch_matches_jax_tick_kernel():
  jcfg, cfg = JaxConfig(), ct.EnvConfig()
  vs = jax.jit(jenv.vec_reset, static_argnums=1)(jenv.home_keys(5, N), jcfg)
  step = jax.jit(lambda s, a: jstep.step_batch(s, a, jcfg, balance=None,
                                               engine='pallas'))
  a = vs.env
  b = ct.state_from_numpy(_to_numpy(a), 'cpu')
  # Spread the envs' steps so that the per-env balance cadence falls on
  # different ticks, at night, where the pass spawns.
  steps = 200 + np.arange(N, dtype=np.int32)
  a = a.replace(step=jax.numpy.asarray(steps))
  b = dataclasses.replace(b, step=torch.from_numpy(steps))
  rs = np.random.RandomState(7)
  balanced = 0
  for i in range(12):
    acts = rs.randint(0, 17, size=N).astype(np.int32)
    before = b.ent.etype.clone()
    a, oa = step(a, acts)
    b, ob = ct.step_batch(b, torch.from_numpy(acts), cfg)
    _assert_same(ct.to_numpy(b), _to_numpy(a), f'tick {i}')
    _assert_same(ct.to_numpy(ob), _to_numpy(oa), f'out {i}')
    balanced += int(((b.ent.etype != before) & (b.ent.etype > 1)
                     & (before == 0)).sum())
  assert balanced > 0
  # The tick kernel's wrapper on CPU tensors is its plain twin.
  sp, sm, _ = ct.step.tick_seeds(b.key, b.step + 1)
  acts = torch.from_numpy(acts)
  got = step_cuda.tick(b, acts, sp, sm, cfg)
  want = ct.tick_plain(b, acts, sp, sm, cfg)
  _assert_same(ct.to_numpy(got), ct.to_numpy(want))
  assert step_cuda.tick.launches == 0


@pytest.mark.parametrize('reset_every, reset_batch', [(1, 2), (4, 13)],
                         ids=['overflow', 'reset_every'])
def test_vec_step_matches_jax(reset_every, reset_batch):
  """An episode cap of 5 ticks ends all 13 envs at once: with
  ``reset_batch=2`` eleven stay pending and drain two a tick; with
  ``reset_every=4`` all wait for the next pass."""
  jcfg, cfg = JaxConfig(length=5), ct.EnvConfig(length=5)
  vj = jax.jit(jenv.vec_reset, static_argnums=1)(jenv.home_keys(2, N), jcfg)
  vt = ct.vec_reset(ct.home_keys(2, N, 'cpu'), cfg)
  step = jax.jit(lambda v, a: jenv.vec_step(v, a, jcfg, reset_batch,
                                            reset_every=reset_every))
  rs = np.random.RandomState(3)
  seen_pending = 0
  for i in range(12):
    acts = rs.randint(0, 17, size=N).astype(np.int32)
    vj, oj, sj = step(vj, acts)
    vt, ot, st = ct.vec_step(vt, torch.from_numpy(acts), cfg, reset_batch,
                             reset_every=reset_every)
    _assert_same(ct.to_numpy(vt), _to_numpy(vj), f'tick {i}')
    _assert_same(ct.to_numpy(ot), _to_numpy(oj), f'out {i}')
    _assert_same(ct.to_numpy(st), _to_numpy(sj), f'stepped {i}')
    seen_pending = max(seen_pending, int(vt.pending.sum()))
  assert seen_pending >= N - 2 and int(vt.episode.max()) >= 2
  assert int(vt.tick) == 12


def test_vec_step_k_equals_k_vec_steps():
  cfg = ct.EnvConfig(length=12, balance_every=4)
  k = cfg.balance_every
  va = ct.vec_reset(ct.home_keys(6, N, 'cpu'), cfg)
  vb = ct.vec_reset(ct.home_keys(6, N, 'cpu'), cfg)
  rs = np.random.RandomState(2)
  for g in range(4):
    acts = torch.from_numpy(rs.randint(0, 17, size=(k, N)).astype(np.int32))
    va, outs = ct.vec_step_k(va, acts, cfg, 4)
    for i in range(k):
      vb, out, _ = ct.vec_step(vb, acts[i], cfg, 4, balance=(i == k - 1))
      for name in ('reward', 'done', 'dead', 'ended'):
        assert torch.equal(getattr(outs, name)[i], getattr(out, name)), name
    _assert_same(ct.to_numpy(va), ct.to_numpy(vb), f'group {g}')
  assert int(va.episode.max()) >= 2
  with pytest.raises(ValueError):
    ct.vec_step_k(va, acts[:2], cfg, 4)


def test_vec_env_matches_jax():
  jcfg, cfg = JaxConfig(length=4), ct.EnvConfig(length=4)
  je = jenv.VecEnv(N, jcfg, seed=3, reset_batch=5)
  te = ct.VecEnv(N, cfg, seed=3, reset_batch=5, device='cpu')
  assert te.reset_batch == je.reset_batch
  assert te.action_names == je.action_names
  assert te.action_space.n == je.action_space.n == 17
  assert tuple(te.observation_space.shape) == (64, 64, 3)
  np.testing.assert_array_equal(te.reset().numpy(), np.asarray(je.reset()))
  rs = np.random.RandomState(9)
  ended = 0
  for i in range(6):
    acts = rs.randint(0, 17, size=N).astype(np.int32)
    oj, rj, dj, ij = je.step(acts)
    ot, rt, dt, it = te.step(acts)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj), f'obs {i}')
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj), f'reward {i}')
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj), f'done {i}')
    assert set(it) == set(ij)
    _assert_same(ct.to_numpy(it), _to_numpy(ij), f'info {i}')
    ended += int(it['ended'].sum())
  assert it['semantic'].shape == (N, 64, 64)
  assert it['semantic'].dtype == torch.uint8
  assert ended == N and int(te.state.episode.max()) == 2
  _assert_same(ct.to_numpy(te.state), _to_numpy(je.state), 'state')
