"""The slice as a whole at the main path's group length: the port's
``vec_step_group`` with K = 10 ticks against the JAX package's.

13 envs, ``reset_batch=4`` and an episode cap of 25 ticks, over 3 groups:
every env ends its episode in group 3, four reset at its end and nine stay
latched ``pending`` (overflow).  The JAX side runs its ``vec_step_group``
group as that function's ``jnp`` engine does, one jitted ``vec_step`` a
tick with the balance on the last (bit-identical to its group kernel,
``tests/test_step.py``): the group kernel in interpret mode compiles for
over a minute at K = 10 on a CPU.  Every leaf must be equal after every
group, and so must ``reward`` / ``done`` / ``dead`` / ``ended``.
Tolerance: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crafter_tpu import env as jenv
from crafter_tpu.config import EnvConfig as JaxConfig
import crafter_tpu_torch as ct
from one_thread import one_torch_thread  # noqa: F401
from test_torch_env import _assert_same, _to_numpy


def test_vec_step_group_k10_matches_jax():
  n, length, reset_batch = 13, 25, 4
  jcfg = JaxConfig(length=length, engine='jnp')
  cfg = ct.EnvConfig(length=length)                  # 'auto' on CPU
  k = cfg.balance_every
  assert k == jcfg.balance_every == 10
  vj = jax.jit(jenv.vec_reset, static_argnums=1)(jenv.home_keys(9, n), jcfg)
  vt = ct.vec_reset(ct.home_keys(9, n, 'cpu'), cfg)
  tick = jax.jit(lambda v, a, last: jenv.vec_step(
      v, a, jcfg, reset_batch, reset_every=k, balance=last),
      static_argnums=2)
  actions = np.random.RandomState(5).randint(0, 17, (3, k, n)).astype(
      np.int32)
  for g in range(3):
    outs = []
    for i in range(k):
      vj, out, _ = tick(vj, actions[g, i], i == k - 1)
      outs.append(out)
    oj = jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
    vt, ot = ct.vec_step_group(vt, torch.from_numpy(actions[g]), cfg,
                               reset_batch)
    _assert_same(ct.to_numpy(vt), _to_numpy(vj), f'group {g}')
    _assert_same(ct.to_numpy(ot), _to_numpy(oj), f'outs {g}')
  assert int(ot.ended.sum()) == n
  assert int(vt.pending.sum()) == n - reset_batch
  assert int((vt.episode == 2).sum()) == reset_batch
