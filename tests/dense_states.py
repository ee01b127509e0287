"""Seeded states that load the tick with work, for the tick kernels' checks.

States reached by stepping fresh worlds seldom hold a shooting skeleton, an
arrow flying into a table or a player at the world's edge, yet the update
window and the player phase of the tick kernels are easiest to get wrong
there.  :func:`dense_states` packs the player's update window with cows,
zombies (some next to the player, ready to strike), skeletons (some
reloaded), arrows in all four directions (some aimed at the player), ripe
and unripe plants and dying mobs, puts tables and furnaces in front of
arrows, spreads players over the corners, the edges and the interior, some
asleep, and leaves a few entities outside the window, which must not move.
:func:`scene_states` are the hand-built scenes of ``tests/test_torch_step.py``
as one batch.

Both return the state as a nested dict of numpy arrays in the port's
layout (``convert.state_from_numpy`` takes it; keys are uint32 key data),
and need neither JAX nor a card, so ``chip_smoke.py`` uses them too.
"""

import math

import numpy as np

from crafter_tpu_torch import rules

# Cell contents of the window, by weight: nothing, cow, zombie, skeleton,
# arrow, plant.
_KINDS = (0, rules.E_COW, rules.E_ZOMBIE, rules.E_SKELETON, rules.E_ARROW,
          rules.E_PLANT)
_KIND_P = (0.6, 0.07, 0.1, 0.08, 0.1, 0.05)
_MATS = (rules.MAT_GRASS, rules.MAT_SAND, rules.MAT_PATH, rules.MAT_WATER,
         rules.MAT_STONE, rules.MAT_TREE, rules.MAT_LAVA, rules.MAT_TABLE,
         rules.MAT_FURNACE)
_MAT_P = (0.55, 0.15, 0.1, 0.05, 0.05, 0.04, 0.02, 0.02, 0.02)


def _player_positions(w, h, rs):
  """Corners, a cell of each edge, next to an edge, then the interior."""
  fixed = [(0, 0), (0, h - 1), (w - 1, 0), (w - 1, h - 1),
           (0, h // 3), (w - 1, h // 2), (w // 3, 0), (w // 2, h - 1),
           (1, 1), (w - 2, h - 2)]
  while True:
    yield from fixed
    for _ in range(2 * len(fixed)):
      yield (int(rs.randint(0, w)), int(rs.randint(0, h)))


def _blank(n, w, h):
  c = w * h
  ncx, ncy = math.ceil(w / 12), math.ceil(h / 12)
  u8 = lambda: np.zeros((n, c), np.uint8)
  return {
      'mat_map': u8(),
      'ent': {'etype': u8(), 'health': u8(),
              'aux': np.zeros((n, c), np.int16), 'facing': u8()},
      'player': {
          'pos': np.zeros((n, 2), np.int32),
          'facing': np.zeros((n,), np.int32),
          'inventory': np.zeros((n, rules.N_ITEMS), np.int32),
          'achievements': np.zeros((n, rules.N_ACHIEVEMENTS), np.int32),
          'sleeping': np.zeros((n,), bool),
          'hunger': np.zeros((n,), np.int32),
          'thirst': np.zeros((n,), np.int32),
          'fatigue': np.zeros((n,), np.int32),
          'recover': np.zeros((n,), np.int32),
          'last_health': np.zeros((n,), np.int32)},
      'step': np.zeros((n,), np.int32),
      'key': np.zeros((n, 2), np.uint32),
      'unlocked': np.zeros((n, rules.N_ACHIEVEMENTS), bool),
      'env_last_health': np.zeros((n,), np.int32),
      'chunk_touched': np.zeros((n, ncx, ncy), bool),
  }


def dense_states(n, seed, area=(64, 64), update_distance=18):
  """``n`` seeded states, each with its player's update window packed."""
  rs = np.random.RandomState(seed)
  w, h = area
  s = _blank(n, w, h)
  ent, pl = s['ent'], s['player']
  s['mat_map'][:] = rs.choice(_MATS, size=(n, w * h), p=_MAT_P)
  xs, ys = np.divmod(np.arange(w * h), h)
  where = _player_positions(w, h, rs)
  for i in range(n):
    px, py = next(where)
    pdist = np.abs(xs - px) + np.abs(ys - py)
    near = pdist <= update_distance + 1
    far = ~near & (rs.rand(w * h) < 0.03)
    kind = np.where(near, rs.choice(_KINDS, size=w * h, p=_KIND_P), 0)
    kind[far] = rs.choice(_KINDS[1:], size=int(far.sum()))
    kind[pdist == 0] = rules.E_PLAYER
    hp = np.select([kind == rules.E_COW, kind == rules.E_ZOMBIE,
                    kind == rules.E_SKELETON, kind == rules.E_PLANT],
                   [3, 5, 3, 1], 0)
    mob = np.isin(kind, (rules.E_COW, rules.E_ZOMBIE, rules.E_SKELETON))
    hp[mob & (rs.rand(w * h) < 0.1)] = 0                   # dying
    aux = np.select(
        [kind == rules.E_ZOMBIE, kind == rules.E_SKELETON,
         kind == rules.E_PLANT],
        [rs.randint(0, 5, w * h),                         # cooldown 0..4
         rs.randint(0, 5, w * h) * (rs.rand(w * h) < 0.5),  # reload
         rs.randint(0, 600, w * h)], 0)                   # ripe above 300
    facing = rs.randint(0, 4, w * h)
    # Zombies next to the player, ready to strike; arrows aimed at it.
    for d, (dx, dy) in enumerate(rules.DIRS):
      x, y = px + dx, py + dy
      if 0 <= x < w and 0 <= y < h and rs.rand() < 0.4:
        kind[x * h + y] = rs.choice((rules.E_ZOMBIE, rules.E_ARROW))
        hp[x * h + y], aux[x * h + y] = 5, 0
        facing[x * h + y] = d ^ 1                          # toward the player
    ent_cells = kind > 0
    s['mat_map'][i, ent_cells] = rules.MAT_GRASS
    # Tables and furnaces in front of arrows.
    for cell in np.flatnonzero((kind == rules.E_ARROW)
                               & (rs.rand(w * h) < 0.4)):
      dx, dy = rules.DIRS[facing[cell]]
      x, y = xs[cell] + dx, ys[cell] + dy
      if 0 <= x < w and 0 <= y < h and kind[x * h + y] == 0:
        s['mat_map'][i, x * h + y] = rs.choice((rules.MAT_TABLE,
                                                rules.MAT_FURNACE))
    ent['etype'][i], ent['health'][i] = kind, hp
    ent['aux'][i], ent['facing'][i] = aux, facing * ent_cells
    pl['pos'][i] = px, py
  inv = rs.randint(0, 10, (n, rules.N_ITEMS))
  inv[:, rules.ITEM_HEALTH] = rs.randint(1, 10, n)
  inv[:, 13:] *= rs.rand(n, 3) < 0.3                       # swords
  pl['inventory'][:] = inv
  pl['facing'][:] = rs.randint(0, 4, n)
  pl['achievements'][:] = rs.randint(0, 2, (n, rules.N_ACHIEVEMENTS))
  pl['sleeping'][:] = rs.rand(n) < 0.25
  pl['hunger'][:] = rs.randint(0, 51, n)
  pl['thirst'][:] = rs.randint(0, 41, n)
  pl['fatigue'][:] = rs.randint(-20, 61, n)
  pl['recover'][:] = rs.randint(-30, 51, n)
  pl['last_health'][:] = rs.randint(0, 10, n)
  s['step'][:] = rs.randint(0, 9000, n)
  s['key'][:] = rs.randint(0, 2 ** 32, (n, 2), dtype=np.uint64)
  s['unlocked'][:] = (pl['achievements'] > 0) & (rs.rand(n, 1) < 0.5)
  s['env_last_health'][:] = rs.randint(0, 10, n)
  s['chunk_touched'][:] = rs.rand(*s['chunk_touched'].shape) < 0.5
  return s


def scene_states():
  """The hand-built scenes of ``tests/test_torch_step.py`` as one batch of
  64 x 64 worlds, with their actions ``(2, 5)`` for two ticks: a move, an
  arrow in flight, an arrow hitting the player, a zombie next to the
  player, and a grass world at dusk with every chunk touched."""
  w = h = 64
  n = 5
  s = _blank(n, w, h)
  s['mat_map'][:] = rules.MAT_GRASS
  s['env_last_health'][:] = 9
  s['player']['inventory'][:] = rules.TABLES.item_initial
  s['player']['facing'][:] = rules.DIR_DOWN
  s['player']['last_health'][:] = rules.TABLES.item_initial[rules.ITEM_HEALTH]
  s['player']['pos'][:] = 32, 32

  def put(i, etype, x, y, health=1, facing=0):
    c = x * h + y
    ent = s['ent']
    ent['etype'][i, c], ent['health'][i, c] = etype, health
    ent['facing'][i, c] = facing

  for i in range(n):
    put(i, rules.E_PLAYER, 32, 32, health=9)
  put(1, rules.E_ARROW, 28, 28, facing=rules.DIR_RIGHT)
  put(2, rules.E_ARROW, 31, 32, facing=rules.DIR_RIGHT)
  s['mat_map'][3] = rules.MAT_STONE
  s['mat_map'][3, [32 * h + 32, 32 * h + 33]] = rules.MAT_GRASS
  put(3, rules.E_ZOMBIE, 32, 33, health=5)
  s['chunk_touched'][4] = True
  s['step'][4] = 209
  actions = np.zeros((2, n), np.int32)
  actions[:, 0] = rules.ACTION_ID['move_left']
  return s, actions


def tick_events(before, after, area, update_distance):
  """What one tick did in each env, from the states before and after it
  (nested dicts of numpy arrays): ``(shots, strikes, hits)``, (N,) counts.

  * shots: reloaded skeletons that stayed put and reloaded to 4, which only
    an arrow they fired does;
  * strikes: zombies next to the player after the tick with their cooldown
    at 5, which only a strike sets (:func:`dense_states` starts them below);
  * hits: arrows within the update distance of the player (less the one
    cell it may move) whose target cell held an entity other than the
    player: such an arrow hits whatever the player does.
  """
  w, h = area
  xs, ys = np.divmod(np.arange(w * h), h)
  e0, e1 = before['ent'], after['ent']
  skel = (e0['etype'] == rules.E_SKELETON) & (e1['etype'] == rules.E_SKELETON)
  shots = (skel & (e0['aux'] == 0) & (e1['aux'] == 4)).sum(1)
  pos = after['player']['pos']
  near = np.abs(xs - pos[:, :1]) + np.abs(ys - pos[:, 1:]) <= 1
  strikes = ((e1['etype'] == rules.E_ZOMBIE) & (e1['aux'] == 5)
             & near).sum(1)
  pos = before['player']['pos']
  pdist = np.abs(xs - pos[:, :1]) + np.abs(ys - pos[:, 1:])
  hits = np.zeros(len(pos), np.int64)
  for d, (dx, dy) in enumerate(rules.DIRS):
    tx, ty = xs + dx, ys + dy
    inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    target = np.where(inside, tx * h + ty, 0)
    held = np.take_along_axis(e0['etype'], np.broadcast_to(
        target, e0['etype'].shape), 1) > rules.E_PLAYER
    hits += ((e0['etype'] == rules.E_ARROW) & (e0['facing'] == d)
             & (pdist < update_distance - 1) & inside & held).sum(1)
  return shots, strikes, hits


def balance_states(n, seed, area=(64, 64), chunk_size=(12, 12), base=64):
  """``n`` states for the balance kernel's checks: :func:`dense_states`
  (``base`` of them, tiled) with steps past 10000 (day and night at a day
  length of 200 or 300), ``chunk_touched`` for ``chunk_size`` with seven
  chunks in ten touched, and a third of the worlds all grass, so that the
  spawn picks land on every rank of a full chunk's members."""
  rs = np.random.RandomState(seed)
  tree = dense_states(min(n, base), seed, area)
  reps = -(-n // min(n, base))

  def tile(t):
    if isinstance(t, dict):
      return {k: tile(v) for k, v in t.items()}
    return np.ascontiguousarray(np.concatenate([t] * reps)[:n])

  tree = tile(tree)
  ncx, ncy = (math.ceil(a / c) for a, c in zip(area, chunk_size))
  tree['chunk_touched'] = rs.rand(n, ncx, ncy) < 0.7
  tree['step'] = rs.randint(10001, 30000, n).astype(np.int32)
  tree['key'] = rs.randint(0, 2 ** 32, (n, 2),
                           dtype=np.uint64).astype(np.uint32)
  tree['mat_map'][rs.rand(n) < 1 / 3] = rules.MAT_GRASS
  return tree
