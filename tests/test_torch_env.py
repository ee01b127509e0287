"""The slice as a whole: the port's ``vec_step_group`` against the JAX
package's, from the same home keys and actions.

13 envs, ``reset_batch=4`` and an episode cap of 7 ticks, over 4 groups:
every env ends its episode in group 3, four reset at its end and nine stay
latched ``pending`` (overflow), four more reset after group 4.  Every leaf
must be equal after every group — key data, ``episode``, ``pending`` and
``tick`` included — and so must ``reward`` / ``done`` / ``dead`` /
``ended``.  The group is 3 ticks long: the JAX group kernel unrolls its
tick loop and runs in interpret mode on the CPU, whose compile time grows
steeply with the group.  Tolerance: none.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crafter_tpu import env as jenv
from crafter_tpu.config import EnvConfig as JaxConfig
import crafter_tpu_torch as ct
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


def test_vec_step_group_matches_jax():
  n, k, length, reset_batch = 13, 3, 7, 4
  jcfg = JaxConfig(length=length, balance_every=k, engine='pallas')
  cfg = ct.EnvConfig(length=length, balance_every=k)   # 'auto' on CPU
  vj = jax.jit(jenv.vec_reset, static_argnums=1)(jenv.home_keys(9, n), jcfg)
  vt = ct.vec_reset(ct.home_keys(9, n, 'cpu'), cfg)
  _assert_same(ct.to_numpy(vt), _to_numpy(vj), 'reset')
  group = jax.jit(lambda v, a: jenv.vec_step_group(v, a, jcfg, reset_batch))
  actions = np.random.RandomState(3).randint(0, 17, (4, k, n)).astype(
      np.int32)
  for g in range(4):
    vj, oj = group(vj, actions[g])
    vt, ot = ct.vec_step_group(vt, torch.from_numpy(actions[g]), cfg,
                               reset_batch)
    _assert_same(ct.to_numpy(vt), _to_numpy(vj), f'group {g}')
    _assert_same(ct.to_numpy(ot), _to_numpy(oj), f'outs {g}')
    if g == 2:
      assert int(vt.pending.sum()) > 0 and int(vt.episode.max()) == 2
  assert int((vt.episode == 2).sum()) == 8


def test_vec_reset_chunked_equals_vec_reset():
  cfg = ct.EnvConfig()
  keys = ct.home_keys(4, 10, 'cpu')
  a = ct.to_numpy(ct.vec_reset(keys, cfg))
  b = ct.to_numpy(ct.vec_reset_chunked(keys, cfg, chunk=4))

  def walk(x, y, p=''):
    for name in x:
      if isinstance(x[name], dict):
        walk(x[name], y[name], f'{p}.{name}')
      else:
        np.testing.assert_array_equal(x[name], y[name], err_msg=p + name)
  walk(a, b)


def test_entry_points_default_to_cuda():
  """The entry points place new tensors on the card unless told not to."""
  import inspect
  assert inspect.signature(ct.home_keys).parameters['device'].default == \
      'cuda'
  assert inspect.signature(ct.prng.key).parameters['device'].default == \
      'cuda'
  assert inspect.signature(ct.state_from_numpy).parameters[
      'device'].default == 'cuda'
  for entry in (ct.CrafterEnv, ct.VecEnv, ct.bake_atlas):
    assert inspect.signature(entry).parameters['device'].default == 'cuda', \
        entry
