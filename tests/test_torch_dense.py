"""The port's plain tick on states packed with entities, against the JAX
package's ``step`` (``jax.vmap`` of the jnp engine, the function its Pallas
tick kernel is held to).

8 seeded dense states (``dense_states.dense_states``: players at corners,
edges and inside, some asleep; cows, zombies ready to strike, reloaded
skeletons, arrows in four directions in front of tables and furnaces,
plants, dying mobs) and the 5 hand-built scenes of ``test_torch_step.py``
go through 3 ticks in one batch of 13, without balance.  Every leaf of the
state and every output must be equal after every tick, for
``env.step_batch`` (on the CPU its tick is the twin ``tick_plain``) and
for the group's twin (``step_group_plain``, K = 3), whose occupancy must
be the OR of the JAX states after ticks 0 and 1.  The events the kernels'
checks need must happen: a skeleton shoots, an arrow hits, a zombie
strikes, a player wakes, an entity outside every window stays.
Tolerance: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crafter_tpu import state as jstate
from crafter_tpu import step as jstep
from crafter_tpu.config import EnvConfig as JaxConfig
from crafter_tpu_torch import convert, rules
from crafter_tpu_torch import step as step_lib
from crafter_tpu_torch.config import EnvConfig
from crafter_tpu_torch.env import step_batch
import dense_states
from one_thread import one_torch_thread  # noqa: F401
from test_torch_step import _assert_same, _to_numpy

CFG = EnvConfig(noise_mode='fast')
TICKS = 3
N_DENSE = 8


def _concat(trees):
  if isinstance(trees[0], dict):
    return {k: _concat([t[k] for t in trees]) for k in trees[0]}
  return np.concatenate(trees)


def _to_jax(tree, cls=jstate.State):
  kw = {}
  for name, v in tree.items():
    if isinstance(v, dict):
      kw[name] = _to_jax(v, {'ent': jstate.EntMaps,
                             'player': jstate.Player}[name])
    elif name == 'key':
      kw[name] = jax.random.wrap_key_data(jnp.asarray(v))
    else:
      kw[name] = jnp.asarray(v)
  return cls(**kw)


@pytest.fixture(scope='module')
def run():
  """The batch, its actions, and the JAX states and outputs tick by tick."""
  dense = dense_states.dense_states(N_DENSE, seed=11)
  scenes, scene_acts = dense_states.scene_states()
  tree = _concat([dense, scenes])
  rs = np.random.RandomState(12)
  acts = np.concatenate([rs.randint(0, 17, (TICKS, N_DENSE)),
                         np.concatenate([scene_acts, scene_acts[:1]])],
                        1).astype(np.int32)
  jcfg = JaxConfig()
  step = jax.jit(jax.vmap(lambda s, a: jstep.step(s, a, jcfg, False)))
  js = _to_jax(tree)
  states, outs = [], []
  for t in range(TICKS):
    js, out = step(js, jnp.asarray(acts[t]))
    states.append(_to_numpy(js))
    outs.append(_to_numpy(out))
  return tree, acts, states, outs


def test_step_batch_matches_jax_on_dense_states(run):
  tree, acts, states, outs = run
  ours = convert.state_from_numpy(tree, 'cpu')
  for t in range(TICKS):
    ours, out = step_batch(ours, torch.from_numpy(acts[t]), CFG,
                                    balance=False)
    _assert_same(convert.to_numpy(ours), states[t], f'tick {t}')
    _assert_same(convert.to_numpy(out), outs[t], f'out {t}')


def test_group_twin_matches_jax_on_dense_states(run):
  tree, acts, states, outs = run
  start = convert.state_from_numpy(tree, 'cpu')
  ours, raw, occ = step_lib.step_group_plain(start, torch.from_numpy(acts),
                                             CFG)
  got = convert.to_numpy(ours)
  # The group leaves chunk_touched to the group-end balance.
  np.testing.assert_array_equal(got.pop('chunk_touched'),
                                tree['chunk_touched'])
  _assert_same(got, states[-1], 'group')
  for name in ('reward', 'done', 'dead'):
    np.testing.assert_array_equal(
        getattr(raw, name).numpy(),
        np.stack([np.asarray(getattr(o, name)) for o in outs]), name)
  want_occ = (np.asarray(states[0].ent.etype) != 0) \
      | (np.asarray(states[1].ent.etype) != 0)
  np.testing.assert_array_equal(occ.numpy(), want_occ.astype(np.uint8))


def test_dense_states_hold_the_events(run):
  """Skeletons shoot, zombies strike, arrows hit, sleepers wake, and the
  entities outside every window stay where they are."""
  tree, acts, _, _ = run
  ours, _ = step_batch(convert.state_from_numpy(tree, 'cpu'),
                                torch.from_numpy(acts[0]), CFG,
                                balance=False)
  after = convert.to_numpy(ours)
  dense = lambda t: {k: dense(v) if isinstance(v, dict) else v[:N_DENSE]
                     for k, v in t.items()}
  before, after = dense(tree), dense(after)
  shots, strikes, hits = dense_states.tick_events(before, after, CFG.area,
                                                  CFG.update_distance)
  assert shots.sum() > 0 and strikes.sum() > 0 and hits.sum() > 0
  xs, ys = np.divmod(np.arange(CFG.area[0] * CFG.area[1]), CFG.area[1])
  pos = before['player']['pos']
  far = np.abs(xs - pos[:, :1]) + np.abs(ys - pos[:, 1:]) \
      > CFG.update_distance + 2
  et0, et1 = before['ent']['etype'], after['ent']['etype']
  assert (far & (et0 > rules.E_PLAYER)).any()
  np.testing.assert_array_equal(et1[far], et0[far])
  assert (before['player']['sleeping'] & ~after['player']['sleeping']).any()
