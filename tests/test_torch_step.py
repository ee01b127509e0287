"""The port's plain group tick and balance against the JAX package's
kernels, plus hand-built scenes from tests/test_step.py.

* ``step_group_plain`` against ``step_group_batch`` run in interpret mode,
  on 13 envs carried across with ``state_from_numpy``, over several
  successive groups.  The group here is 3 ticks long: the JAX kernel
  unrolls its tick loop, and interpret-mode compile time grows steeply
  with it; the tick code is the same for any K.
* ``balance_plain`` against ``_balance_pallas`` in interpret mode, with an
  injected occupancy plane, at night so the pass spawns; and at a day
  length of 200 with steps past 10000.
* The hash primitives and the daylight thresholds against JAX.

Tolerance everywhere: none (bitwise, rewards included).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crafter_tpu import env as jenv
from crafter_tpu import state as jstate
from crafter_tpu import step as jstep
from crafter_tpu.config import EnvConfig as JaxConfig
from crafter_tpu_torch import convert, rules, step_cuda
from crafter_tpu_torch import state as state_lib
from crafter_tpu_torch import step as step_lib
from crafter_tpu_torch.config import EnvConfig
from one_thread import one_torch_thread  # noqa: F401

A = rules.ACTION_ID
CFG = EnvConfig(noise_mode='fast')


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
def fresh13():
  """13 fresh JAX worlds as numpy (the JAX state, keys as key data)."""
  vs = jax.jit(jenv.vec_reset, static_argnums=1)(
      jenv.home_keys(9, 13), JaxConfig())
  return vs.env


def test_tick_seeds_and_hashes():
  rs = np.random.RandomState(0)
  kd = rs.randint(0, 2 ** 32, size=(64, 2), dtype=np.uint64).astype(np.uint32)
  steps = rs.randint(0, 20000, size=64).astype(np.int32)
  want = jax.vmap(jstep._tick_seeds)(jax.random.wrap_key_data(kd), steps)
  got = step_lib.tick_seeds(torch.from_numpy(kd.astype(np.int64)),
                            torch.from_numpy(steps))
  for w, g in zip(want, got):
    np.testing.assert_array_equal(np.asarray(w), g.numpy())
  seed = np.int32(rs.randint(-2 ** 31, 2 ** 31 - 1))
  x, y = np.meshgrid(np.arange(64, dtype=np.int32),
                     np.arange(64, dtype=np.int32), indexing='ij')
  for chan in (0, 1, 2):
    np.testing.assert_array_equal(
        np.asarray(jstep._cell_uniform_xy(seed, chan, x, y)),
        step_lib.cell_uniform_xy(torch.tensor(seed), chan,
                                 torch.from_numpy(x),
                                 torch.from_numpy(y)).numpy())
  s = rs.randint(-2 ** 31, 2 ** 31 - 1, size=1000).astype(np.int32)
  np.testing.assert_array_equal(np.asarray(jstep._seed_uniform(s)),
                                step_lib.seed_uniform(torch.from_numpy(s)))


def test_daylight_thresholds_match_jax():
  """The balance reads daylight only through int(3.5 - 3 * light) and
  int(1.5 + light); those agree with JAX at every step checked."""
  steps = np.arange(0, 60000, dtype=np.int32)
  ref = jax.jit(lambda s: jnp.stack([
      (3.5 - 3 * jstate.daylight(s, 300)).astype(jnp.int32),
      (1.5 + jstate.daylight(s, 300)).astype(jnp.int32)]))(steps)
  light = state_lib.daylight_plain(torch.from_numpy(steps), 300)
  ours = torch.stack([
      step_lib.fma32(-3.0, light, 3.5).to(torch.int32),
      (1.5 + light).to(torch.int32)])
  np.testing.assert_array_equal(np.asarray(ref), ours.numpy())


def test_group_tick_matches_step_group_batch(fresh13):
  k, n = 3, 13
  jcfg = JaxConfig(length=8)
  cfg = dataclasses.replace(CFG, length=8)
  group = jax.jit(lambda s, a: jstep.step_group_batch(s, a, jcfg))
  ref_state = fresh13
  ours = convert.state_from_numpy(_to_numpy(fresh13), 'cpu')
  rs = np.random.RandomState(4)
  dones = 0
  for g in range(4):
    acts = rs.randint(0, 17, size=(k, n)).astype(np.int32)
    ref_state, raw, occ = group(ref_state, acts)
    ours, oraw, oocc = step_lib.step_group_plain(ours, torch.from_numpy(acts),
                                                 cfg)
    _assert_same(convert.to_numpy(ours), _to_numpy(ref_state), f'group {g}')
    _assert_same(convert.to_numpy(oraw), _to_numpy(raw), f'raw {g}')
    np.testing.assert_array_equal(oocc.numpy(), np.asarray(occ))
    dones += int(oraw.done.sum())
  assert dones > 0   # the length cap fell inside the compared groups


def test_balance_matches_balance_pallas(fresh13):
  env = fresh13.replace(step=jnp.full((13,), 210, jnp.int32))   # night
  s_bal = jax.vmap(lambda kk, s: jstep._tick_seeds(kk, s)[2])(env.key,
                                                              env.step)
  occ = jax.random.bernoulli(jax.random.key(9), 0.2,
                             env.mat_map.shape).astype(jnp.uint8)
  ref = jax.jit(lambda e, s, o: jstep._balance_pallas(e, s, o, JaxConfig()))(
      env, s_bal, occ)
  ours_in = convert.state_from_numpy(_to_numpy(env), 'cpu')
  seeds = torch.from_numpy(np.array(s_bal))
  occ_t = torch.from_numpy(np.array(occ))
  ours = step_lib.balance_plain(ours_in, seeds, occ_t, CFG)
  _assert_same(convert.to_numpy(ours), _to_numpy(ref))
  # The pass must do something for the comparison to have teeth.
  assert (ours.ent.etype != ours_in.ent.etype).sum() > 0
  # On CPU tensors the kernel wrapper is the plain twin.
  again = step_cuda.balance(ours_in, seeds, occ_t, CFG)
  _assert_same(convert.to_numpy(again), _to_numpy(ref))


def test_balance_matches_balance_pallas_past_step_10000(fresh13):
  """At a day length of 200 and steps past 10000 (where the light was once
  off its table), day and night, with an occupancy plane."""
  jcfg, cfg = JaxConfig(day_length=200), EnvConfig(day_length=200)
  steps = np.array([10001, 10100, 10150, 10199, 12345, 15020, 19990, 20000,
                    29999, 10050, 10075, 11111, 13131], np.int32)
  env = fresh13.replace(step=jnp.asarray(steps))
  s_bal = jax.vmap(lambda kk, s: jstep._tick_seeds(kk, s)[2])(env.key,
                                                              env.step)
  occ = jax.random.bernoulli(jax.random.key(10), 0.1,
                             env.mat_map.shape).astype(jnp.uint8)
  ref = jax.jit(lambda e, s, o: jstep._balance_pallas(e, s, o, jcfg))(
      env, s_bal, occ)
  ours_in = convert.state_from_numpy(_to_numpy(env), 'cpu')
  ours = step_lib.balance_plain(ours_in, torch.from_numpy(np.array(s_bal)),
                                torch.from_numpy(np.array(occ)), cfg)
  _assert_same(convert.to_numpy(ours), _to_numpy(ref))
  assert (ours.ent.etype != ours_in.ent.etype).sum() > 0
  light = state_lib.daylight_plain(torch.from_numpy(steps), 200)
  assert bool((light < 0.5).any() and (light > 0.5).any())


# --- hand-built scenes (tests/test_step.py), one tick at a time ----------


def make_state(mat=rules.MAT_GRASS, player_pos=(32, 32)):
  c = 64 * 64
  st = state_lib.State(
      mat_map=torch.full((1, c), mat, dtype=torch.uint8),
      ent=state_lib.empty_ent_maps(CFG, 1, 'cpu'),
      player=state_lib.init_player(CFG, 1, 'cpu'),
      step=torch.zeros((1,), dtype=torch.int32),
      key=torch.tensor([[0, 0]], dtype=torch.int64),
      unlocked=torch.zeros((1, rules.N_ACHIEVEMENTS), dtype=torch.bool),
      env_last_health=torch.full((1,), 9, dtype=torch.int32),
      chunk_touched=torch.zeros((1, 6, 6), dtype=torch.bool))
  return add_entity(st, rules.E_PLAYER, player_pos, health=9)


def set_mat(st, pos, mat):
  st.mat_map[0, pos[0] * 64 + pos[1]] = mat
  return st


def add_entity(st, etype, pos, health=1, aux=0, facing=0):
  c = pos[0] * 64 + pos[1]
  st.ent.etype[0, c], st.ent.health[0, c] = etype, health
  st.ent.aux[0, c], st.ent.facing[0, c] = aux, facing
  if etype == rules.E_PLAYER:
    st.player.pos[0] = torch.tensor(pos)
  return st


def etype_at(st, pos):
  return int(st.ent.etype[0, pos[0] * 64 + pos[1]])


def run(st, action):
  st, raw, _ = step_lib.step_group_plain(
      st, torch.tensor([[action]], dtype=torch.int32), CFG)
  return st, raw


def test_scene_move_and_facing():
  s, _ = run(make_state(), A['move_left'])
  assert tuple(s.player.pos[0].tolist()) == (31, 32)
  assert int(s.player.facing[0]) == rules.DIR_LEFT
  assert etype_at(s, (31, 32)) == rules.E_PLAYER
  assert etype_at(s, (32, 32)) == 0


def test_scene_arrow_flies_and_hits():
  st = add_entity(make_state(), rules.E_ARROW, (28, 28),
                  facing=rules.DIR_RIGHT)
  s, _ = run(st, A['noop'])
  assert etype_at(s, (29, 28)) == rules.E_ARROW
  assert int(s.ent.facing[0, 29 * 64 + 28]) == rules.DIR_RIGHT
  assert etype_at(s, (28, 28)) == 0
  st = add_entity(make_state(), rules.E_ARROW, (31, 32),
                  facing=rules.DIR_RIGHT)
  s, _ = run(st, A['noop'])
  assert int(s.player.inventory[0, rules.ITEM_HEALTH]) == 7
  assert etype_at(s, (31, 32)) == 0


def test_scene_zombie_attacks_adjacent():
  st = make_state(mat=rules.MAT_STONE)
  st = set_mat(set_mat(st, (32, 32), rules.MAT_GRASS), (32, 33),
               rules.MAT_GRASS)
  st = add_entity(st, rules.E_ZOMBIE, (32, 33), health=5)
  s, raw = run(st, A['noop'])
  assert int(s.player.inventory[0, rules.ITEM_HEALTH]) == 7
  assert int(s.ent.aux[0, 32 * 64 + 33]) == 5
  assert float(raw.reward[0, 0]) == pytest.approx(-0.2)
  s2, _ = run(s, A['noop'])
  assert int(s2.player.inventory[0, rules.ITEM_HEALTH]) == 7
  assert int(s2.ent.aux[0, 32 * 64 + 33]) == 4


def test_scene_zombies_spawn_at_night():
  st = make_state()
  st.chunk_touched[:] = True
  st.step[:] = 209
  k = 10
  for _ in range(6):
    st, _, occ = step_lib.step_group_plain(
        st, torch.zeros((k, 1), dtype=torch.int32), CFG)
    seed = step_lib.tick_seeds(st.key, st.step)[2]
    st = step_lib.balance_plain(st, seed, occ, CFG)
  assert int((st.ent.etype == rules.E_ZOMBIE).sum()) > 0
