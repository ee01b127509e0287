"""The pixel path: the group tick's render snapshots and
``vec_step_group_obs`` as a whole, against the JAX package's.

The JAX side runs its Pallas kernels (group tick with snapshots, balance,
render) in interpret mode; the port runs its plain twins on the CPU.  The
group is 3 ticks long and there are 13 envs: interpret-mode compile time
grows steeply with the group, and the tick code is the same for any K
(see tests/test_torch_env.py).  Tolerance: none — every state leaf, result
and frame byte equal.
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

N, K, LENGTH, RESET_BATCH = 13, 3, 7, 4
JCFG = JaxConfig(length=LENGTH, balance_every=K, engine='pallas')
CFG = ct.EnvConfig(length=LENGTH, balance_every=K)   # 'auto': twins on CPU


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


@pytest.fixture(scope='module')
def fresh():
  """13 fresh JAX envs (a VecState)."""
  return jax.jit(jenv.vec_reset, static_argnums=1)(jenv.home_keys(11, N),
                                                   JCFG)


def test_group_snapshots_match_step_group_batch(fresh):
  group = jax.jit(lambda s, a: jstep.step_group_batch(s, a, JCFG,
                                                      snapshots=True))
  ref_state = fresh.env
  ours = ct.state_from_numpy(_to_numpy(fresh.env), 'cpu')
  rs = np.random.RandomState(4)
  for g in range(3):
    acts = rs.randint(0, 17, size=(K, N)).astype(np.int32)
    ref_state, raw, occ, snaps = group(ref_state, acts)
    ours, oraw, oocc, osnaps = ct.step_group_plain(
        ours, torch.from_numpy(acts), CFG, snapshots=True)
    _assert_same(ct.to_numpy(ours), _to_numpy(ref_state), f'group {g}')
    _assert_same(ct.to_numpy(oraw), _to_numpy(raw), f'raw {g}')
    np.testing.assert_array_equal(oocc.numpy(), np.asarray(occ))
    got = ct.to_numpy(osnaps)
    assert got['packed'].shape == (K, N, 64 * 64)
    # Row K-1 of `packed` is the caller's to fill in both packages.
    np.testing.assert_array_equal(got['packed'][:K - 1],
                                  np.asarray(snaps.packed)[:K - 1])
    for name in ('px', 'py', 'facing', 'sleeping'):
      assert got[name].shape == (K - 1, N) and got[name].dtype == np.int32
      np.testing.assert_array_equal(got[name],
                                    np.asarray(getattr(snaps, name))[..., 0],
                                    err_msg=name)
    np.testing.assert_array_equal(got['inv'], np.asarray(snaps.inv))
  # The kernel wrapper on CPU tensors is the twin, snapshots included.
  again = step_cuda.group_tick(ours, torch.from_numpy(acts), CFG,
                               snapshots=True)
  ref = ct.step_group_plain(ours, torch.from_numpy(acts), CFG, snapshots=True)
  assert torch.equal(again[3].packed[:K - 1], ref[3].packed[:K - 1])
  assert len(step_cuda.group_tick(ours, torch.from_numpy(acts), CFG)) == 3


def test_vec_step_group_obs_matches_jax(fresh):
  """2 groups of the pixel path; the episode cap of 7 ticks falls inside
  group 3 of 3, so a third group crosses a reset: four envs then show
  their next episode's first frame and nine stay pending."""
  jcore = jenv.CrafterEnv(JCFG)
  core = ct.CrafterEnv(CFG, 'cpu')
  step = jax.jit(lambda v, a: jenv.vec_step_group_obs(v, a, JCFG,
                                                      RESET_BATCH, jcore))
  vj = fresh
  vt = ct.vec_reset(ct.home_keys(11, N, 'cpu'), CFG)
  _assert_same(ct.to_numpy(vt), _to_numpy(vj), 'reset')
  rs = np.random.RandomState(8)
  for g in range(3):
    acts = rs.randint(0, 17, size=(K, N)).astype(np.int32)
    vj, oj, obs_j = step(vj, acts)
    vt, ot, obs_t = ct.vec_step_group_obs(vt, torch.from_numpy(acts), CFG,
                                          RESET_BATCH, core)
    _assert_same(ct.to_numpy(vt), _to_numpy(vj), f'group {g}')
    _assert_same(ct.to_numpy(ot), _to_numpy(oj), f'outs {g}')
    assert obs_t.shape == (K, N, 64, 64, 3) and obs_t.dtype == torch.uint8
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j),
                                  err_msg=f'frames {g}')
  assert int((vt.episode == 2).sum()) == RESET_BATCH
  assert int(vt.pending.sum()) == N - RESET_BATCH
  # The last frame of a reset env is its fresh world's first observation.
  fresh_obs = core.observe(vt.env)
  assert torch.equal(obs_t[K - 1], fresh_obs)


def test_group_obs_plain_engine_equals_auto():
  """``noise_mode='fast'`` (the per-point noise twin) gives the same pixel
  path as ``'auto'`` (on the CPU the shared-form twin)."""
  plain = dataclasses.replace(CFG, noise_mode='fast')
  core = ct.CrafterEnv(CFG, 'cpu')
  va = ct.vec_reset(ct.home_keys(3, 5, 'cpu'), CFG)
  vb = ct.vec_reset(ct.home_keys(3, 5, 'cpu'), plain)
  acts = torch.from_numpy(
      np.random.RandomState(1).randint(0, 17, size=(K, 5)).astype(np.int32))
  va, oa, fa = ct.vec_step_group_obs(va, acts, CFG, 2, core)
  vb, ob, fb = ct.vec_step_group_obs(vb, acts, plain, 2, core)
  assert torch.equal(fa, fb) and torch.equal(oa.reward, ob.reward)
  assert torch.equal(va.env.ent.etype, vb.env.ent.etype)
