"""Seed-exact parity engine — the bit-level correctness oracle (the port's
copy of ``crafter_tpu/parity.py``: numpy on the host, no PIL, no imageio).

North-star config 1 (BASELINE.json): a single env, fixed seed, whose
trajectory, rewards, achievements, semantic maps, and pixels match the
reference *exactly*.  The batched engine (step.py) is the product; this
module is the oracle it is validated against, and a drop-in ``Env`` for
anyone who needs bit-reproducibility with the original crafter.

The textures come from ``assets/textures.npz`` through the port's
``render._load`` and its nearest-neighbour resize ``render._resize`` (PIL's
``Image.NEAREST``, reproduced); the desaturation reproduces PIL's
``ImageEnhance.Color`` (see :func:`_desaturate`).

Design: one flat entity record plus per-kind tick functions dispatched from
a table — not the reference's class hierarchy — over a world kept as
(material grid, ordered entity registry, cell index, ordered chunk
registry).  What *is* deliberately identical is the **RNG consumption
order** of the reference's single MT19937 stream
(``np.random.RandomState``, reference: crafter/engine.py:33-35), including
every lazy short-circuit draw:

* worldgen: the OpenSimplex seed draw, then per-cell uniforms drawn only
  inside the branch that reaches them, x-major (crafter/worldgen.py:10-76);
* entity updates in insertion order with in-place world mutation
  (crafter/env.py:87-89), draws per the objects.py decision chains;
* chunk balancing every 10th step over chunks in *creation* order
  (crafter/env.py:90-95; the defaultdict grows in first-touch order,
  crafter/engine.py:36,57,78-79);
* the night-render noise draw from the *game* stream — observations perturb
  subsequent world randomness (crafter/engine.py:208-211), the parity trap
  documented in SURVEY.md §3.3.

One reference behavior is underdetermined: the despawn victim is indexed
out of a list built from a per-chunk ``set`` whose iteration order depends
on CPython object ids (crafter/engine.py:36 + crafter/env.py:162,176) and
is not reproducible even between two runs of the reference itself.  This
engine canonicalizes it to insertion order; the oracle test pins the
reference to the same choice with an order-preserving set (see PARITY.md).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np

from . import render, rules
from .ops import noise, noise_host

DIRS = dict(left=(-1, 0), right=(+1, 0), up=(0, -1), down=(0, +1))
ALL_DIRS = ((-1, 0), (+1, 0), (0, -1), (0, +1))  # objects.py:33-34


@dataclasses.dataclass
class Ent:
  """One world entity; ``ctr`` is the per-kind counter (zombie cooldown,
  skeleton reload, plant growth — objects.py:288,:321,:392)."""

  kind: str
  pos: Tuple[int, int]
  hp: int = 0
  ctr: int = 0
  facing: Tuple[int, int] = (0, 1)
  removed: bool = False
  eid: int = -1


class ParityEnv:
  """Reference-exact single env with the reference's Gym API
  (crafter/env.py:25-179 surface: reset/step/render + spaces)."""

  def __init__(self, area=(64, 64), view=(9, 9), size=(64, 64),
               reward=True, length=10000, seed=None):
    view = tuple(view) if hasattr(view, '__len__') else (view, view)
    size = tuple(size) if hasattr(size, '__len__') else (size, size)
    seed = np.random.randint(0, 2 ** 31 - 1) if seed is None else seed
    self._area = tuple(area)
    self._view = np.array(view)
    self._size = np.array(size)
    self._reward = reward
    self._length = length
    self._seed = seed
    self._episode = 0
    self._chunk_size = (12, 12)
    self._rules = rules.default_rules()
    self._walkable = tuple(self._rules['walkable'])
    item_rows = int(np.ceil(len(rules.ITEMS) / view[0]))
    self._local_grid = np.array([view[0], view[1] - item_rows])
    self._item_grid = np.array([view[0], item_rows])
    self._tex = _TextureStore()
    # Some libraries expect these attributes (env.py:54-56).
    self.reward_range = None
    self.metadata = None

  # -- spaces (env.py:58-68) ----------------------------------------------

  @property
  def observation_space(self):
    from .env import BoxSpace
    return BoxSpace(0, 255, tuple(self._size) + (3,), np.uint8)

  @property
  def action_space(self):
    from .env import DiscreteSpace
    return DiscreteSpace(rules.N_ACTIONS)

  @property
  def action_names(self):
    return list(rules.ACTIONS)

  # -- world primitives ---------------------------------------------------
  # The reference's World keeps an object list with index holes, a uint32
  # cell->index map, and a defaultdict(set) chunk index (engine.py:24-117).
  # Here: an insertion-ordered entity registry, a cell dict, and an
  # insertion-ordered chunk registry of insertion-ordered member dicts.

  def _chunk_key(self, pos):
    (x, y), (csx, csy) = pos, self._chunk_size  # engine.py:112-117
    xmin, ymin = (x // csx) * csx, (y // csy) * csy
    return (xmin, min(xmin + csx, self._area[0]),
            ymin, min(ymin + csy, self._area[1]))

  def _chunk_members(self, key):
    if key not in self._chunks:      # defaultdict first-touch (engine.py:36)
      self._chunks[key] = {}
    return self._chunks[key]

  def _add(self, ent: Ent):
    pos = (int(ent.pos[0]), int(ent.pos[1]))
    assert pos not in self._cell     # engine.py:53
    ent.pos = pos
    ent.eid = self._next_eid
    self._next_eid += 1
    self._ents[ent.eid] = ent
    self._cell[pos] = ent
    self._chunk_members(self._chunk_key(pos))[ent.eid] = ent

  def _remove(self, ent: Ent):
    if ent.removed:                  # engine.py:59-65
      return
    del self._cell[ent.pos]
    del self._chunk_members(self._chunk_key(ent.pos))[ent.eid]
    del self._ents[ent.eid]
    ent.removed = True

  def _relocate(self, ent: Ent, pos):
    if ent.removed:                  # engine.py:67-69 no-op for removed
      return
    pos = (int(pos[0]), int(pos[1]))
    assert pos not in self._cell
    del self._cell[ent.pos]
    self._cell[pos] = ent
    old_k, new_k = self._chunk_key(ent.pos), self._chunk_key(pos)
    if old_k != new_k:               # engine.py:77-79
      del self._chunk_members(old_k)[ent.eid]
      self._chunk_members(new_k)[ent.eid] = ent
    ent.pos = pos

  def _at(self, pos):
    """(material name | None, entity | None); (None, None) out of bounds
    (engine.py:88-93)."""
    x, y = int(pos[0]), int(pos[1])
    if not (0 <= x < self._area[0] and 0 <= y < self._area[1]):
      return None, None
    return rules.MATERIALS[self._mat[x, y] - 1] if self._mat[x, y] else None, \
        self._cell.get((x, y))

  def _set_mat(self, pos, name):
    self._mat[int(pos[0]), int(pos[1])] = rules.MAT_ID[name]

  def _is_free(self, pos, materials):
    mat, ent = self._at(pos)          # objects.py:44-47
    return ent is None and mat in materials

  def _try_move(self, ent: Ent, direction, materials):
    target = (ent.pos[0] + direction[0], ent.pos[1] + direction[1])
    if self._is_free(target, materials):   # objects.py:36-42
      self._relocate(ent, target)
      return True
    return False

  @staticmethod
  def _l1(a, b):
    return abs(a[0] - b[0]) + abs(a[1] - b[1])  # objects.py:49-52

  def _toward(self, src, dst, long_axis=True):
    offx, offy = dst[0] - src[0], dst[1] - src[1]  # objects.py:54-62
    if (abs(offx) > abs(offy)) if long_axis else (abs(offx) <= abs(offy)):
      return (int(np.sign(offx)), 0)
    return (0, int(np.sign(offy)))

  def _random_dir(self):
    return ALL_DIRS[self._rng.randint(0, 4)]  # objects.py:64-65

  def _hp(self, ent: Ent) -> int:
    return self._inventory['health'] if ent.kind == 'player' else ent.hp

  def _set_hp(self, ent: Ent, value):
    value = max(0, value)             # objects.py:28-30 floor-at-zero setter
    if ent.kind == 'player':
      self._inventory['health'] = value
    else:
      ent.hp = value

  # -- episode lifecycle (env.py:70-81) -----------------------------------

  def reset(self):
    center = (self._area[0] // 2, self._area[1] // 2)
    self._episode += 1
    self._tick = 0
    self._rng = np.random.RandomState(
        hash((self._seed, self._episode)) % (2 ** 31 - 1))   # env.py:74
    self._daylight = 0.0
    self._mat = np.zeros(self._area, np.uint8)
    self._ents: Dict[int, Ent] = {}
    self._cell: Dict[Tuple[int, int], Ent] = {}
    self._chunks: Dict[tuple, Dict[int, Ent]] = {}
    self._next_eid = 1
    self._update_time()
    self._player = Ent(kind='player', pos=center)
    self._inventory = {n: self._rules['items'][n]['initial']
                       for n in rules.ITEMS}
    self._achievements = {n: 0 for n in rules.ACHIEVEMENTS}
    self._facing = (0, 1)
    self._action = 'noop'
    self._sleeping = False
    self._last_health_wake = self._inventory['health']
    self._hunger = self._thirst = self._fatigue = self._recover = 0.0
    self._last_health = self._inventory['health']
    self._unlocked = set()
    self._add(self._player)
    self._generate_world()
    return self._obs()

  def step(self, action):
    self._tick += 1
    self._update_time()
    self._action = rules.ACTIONS[action]
    limit = 2 * int(self._view.max())        # env.py:87-89
    for ent in list(self._ents.values()):
      if self._l1(self._player.pos, ent.pos) < limit:
        _TICKS[ent.kind](self, ent)
    if self._tick % 10 == 0:                 # env.py:90-95
      for key in list(self._chunks.keys()):
        self._balance_chunk(key)
    obs = self._obs()
    reward = (self._inventory['health'] - self._last_health) / 10
    self._last_health = self._inventory['health']
    fresh = {n for n, c in self._achievements.items()
             if c > 0 and n not in self._unlocked}
    if fresh:                                # env.py:99-104
      self._unlocked |= fresh
      reward += 1.0
    dead = self._inventory['health'] <= 0
    done = dead or (self._length and self._tick >= self._length)
    info = {
        'inventory': self._inventory.copy(),
        'achievements': self._achievements.copy(),
        'discount': 1 - float(dead),
        'semantic': self._semantic(),
        'player_pos': np.array(self._player.pos),
        'reward': reward,
    }
    if not self._reward:
      reward = 0.0
    return obs, reward, bool(done), info

  def _update_time(self):
    progress = (self._tick / 300) % 1 + 0.3  # env.py:135-139
    self._daylight = 1 - np.abs(np.cos(np.pi * progress)) ** 3

  def _semantic(self):
    canvas = self._mat.copy()                # engine.py:260-264
    for ent in self._ents.values():
      canvas[ent.pos] = rules.N_MATERIALS + _KIND_ID[ent.kind]
    return canvas

  # -- worldgen (crafter/worldgen.py) -------------------------------------

  def _generate_world(self):
    w, h = self._area
    px, py = self._player.pos
    perm = noise.perm_from_java_seed(
        int(self._rng.randint(0, 2 ** 31 - 1)))       # worldgen.py:11
    xs = np.arange(w, dtype=np.float64)[:, None] + np.zeros((1, h))
    ys = np.arange(h, dtype=np.float64)[None, :] + np.zeros((w, 1))

    def n3(px_, py_, z):
      # noise3_walk_host: the ORIGINAL walk's numerics (bit-identical to
      # the PyPI opensimplex package) — the candidate-sum reformulation
      # deviates by ~1e-5 at ~4% of points (see ops/noise_host.py).
      pts = np.stack([px_, py_, np.full_like(px_, float(z))], -1)
      return noise_host.noise3_walk_host(pts, perm)

    # All noise channels, with the reference's exact float64 argument
    # arithmetic: _simplex divides the *already scaled* coordinates by the
    # octave size (worldgen.py:79-91), so e.g. the horizontal-tunnel call
    # `simplex(2*x, y/5, 7, 3)` evaluates noise3((2*x)/3, (y/5)/3, 7).
    start_n = n3(xs / 3, ys / 3, 8)
    water_n = n3(xs / 15, ys / 15, 3) + 0.15 * n3(xs / 5, ys / 5, 3)
    mountain_n = (n3(xs / 15, ys / 15, 0) + 0.3 * n3(xs / 5, ys / 5, 0)) / 1.3
    cave_n = n3(xs / 7, ys / 7, 6) / 1.0
    htun_n = n3((2 * xs) / 3, (ys / 5) / 3, 7) / 1.0
    vtun_n = n3((xs / 5) / 3, (2 * ys) / 3, 7) / 1.0
    coal_n = n3(xs / 8, ys / 8, 1) / 1.0
    iron_n = n3(xs / 6, ys / 6, 2) / 1.0
    lava_n = n3(xs / 5, ys / 5, 6) / 1.0
    sand_n = n3(xs / 9, ys / 9, 4) / 1.0
    tree_n = n3(xs / 7, ys / 7, 5) / 1.0

    dist = np.sqrt((xs - px) ** 2 + (ys - py) ** 2)
    start = 1 / (1 + np.exp(-(4 - dist + 2 * start_n)))  # worldgen.py:25-27
    water = water_n + 0.1 - 2 * start                    # worldgen.py:28-29
    mountain = mountain_n - 4 * start - 0.3 * water      # worldgen.py:30-31

    u = self._rng.uniform                  # lazy short-circuit draws below
    tunnels = np.zeros(self._area, bool)
    for x in range(w):                     # x-major scan (worldgen.py:13-15)
      for y in range(h):
        if start[x, y] > 0.5:
          m = 'grass'
        elif mountain[x, y] > 0.15:        # worldgen.py:34-52
          if cave_n[x, y] > 0.15 and mountain[x, y] > 0.3:
            m = 'path'
          elif htun_n[x, y] > 0.4:
            m, tunnels[x, y] = 'path', True
          elif vtun_n[x, y] > 0.4:
            m, tunnels[x, y] = 'path', True
          elif coal_n[x, y] > 0 and u() > 0.85:
            m = 'coal'
          elif iron_n[x, y] > 0.4 and u() > 0.75:
            m = 'iron'
          elif mountain[x, y] > 0.18 and u() > 0.994:
            m = 'diamond'
          elif mountain[x, y] > 0.3 and lava_n[x, y] > 0.35:
            m = 'lava'
          else:
            m = 'stone'
        elif 0.25 < water[x, y] <= 0.35 and sand_n[x, y] > -0.2:
          m = 'sand'
        elif 0.3 < water[x, y]:
          m = 'water'
        else:                              # worldgen.py:57-61
          m = 'tree' if tree_n[x, y] > 0 and u() > 0.8 else 'grass'
        self._mat[x, y] = rules.MAT_ID[m]

    for x in range(w):                     # worldgen.py:16-18, :64-76
      for y in range(h):
        mat, _ = self._at((x, y))
        if mat not in self._walkable:
          continue
        if dist[x, y] > 3 and mat == 'grass' and u() > 0.985:
          self._add(Ent(kind='cow', pos=(x, y), hp=3))
        elif dist[x, y] > 10 and u() > 0.993:
          self._add(Ent(kind='zombie', pos=(x, y), hp=5))
        elif mat == 'path' and tunnels[x, y] and u() > 0.95:
          self._add(Ent(kind='skeleton', pos=(x, y), hp=3))

  # -- player tick (objects.py:99-261) ------------------------------------

  def _tick_player(self, ent: Ent):
    target = (ent.pos[0] + self._facing[0], ent.pos[1] + self._facing[1])
    material, obj = self._at(target)
    action = self._action
    if self._sleeping:                     # objects.py:103-108
      if self._inventory['energy'] < self._rules['items']['energy']['max']:
        action = 'sleep'
      else:
        self._sleeping = False
        self._achievements['wake_up'] += 1
    if action.startswith('move_'):
      self._pl_move(action[len('move_'):])
    elif action == 'do' and obj is not None:
      self._pl_do_entity(obj)
    elif action == 'do':
      self._pl_do_material(target, material)
    elif action == 'sleep':
      if self._inventory['energy'] < self._rules['items']['energy']['max']:
        self._sleeping = True
    elif action.startswith('place_'):
      self._pl_place(action[len('place_'):], target, material)
    elif action.startswith('make_'):
      self._pl_make(action[len('make_'):])
    self._pl_life_stats()
    self._pl_regen()
    for name in self._inventory:           # objects.py:126-128 clamp
      self._inventory[name] = max(
          0, min(self._inventory[name], self._rules['items'][name]['max']))
    if self._inventory['health'] < self._last_health_wake:
      self._sleeping = False               # objects.py:169-172
    self._last_health_wake = self._inventory['health']

  def _pl_move(self, direction):
    self._facing = DIRS[direction]         # objects.py:174-179
    self._try_move(self._player, self._facing,
                   self._walkable + ('lava',))
    if self._at(self._player.pos)[0] == 'lava':
      self._set_hp(self._player, 0)

  def _pl_do_entity(self, obj: Ent):
    damage = max([1, self._inventory['wood_sword'] and 2,
                  self._inventory['stone_sword'] and 3,
                  self._inventory['iron_sword'] and 5])  # objects.py:182-187
    if obj.kind == 'plant':
      if obj.ctr > 300:                    # ripe (objects.py:188-192,:402)
        obj.ctr = 0
        self._inventory['food'] += 4
        self._achievements['eat_plant'] += 1
    if obj.kind == 'zombie':
      self._set_hp(obj, obj.hp - damage)
      if obj.hp <= 0:
        self._achievements['defeat_zombie'] += 1
    if obj.kind == 'skeleton':
      self._set_hp(obj, obj.hp - damage)
      if obj.hp <= 0:
        self._achievements['defeat_skeleton'] += 1
    if obj.kind == 'cow':
      self._set_hp(obj, obj.hp - damage)
      if obj.hp <= 0:                      # objects.py:205-212
        self._inventory['food'] += 6
        self._achievements['eat_cow'] += 1
        self._hunger = 0

  def _pl_do_material(self, target, material):
    if material == 'water':
      self._thirst = 0                     # objects.py:215-218
    info = self._rules['collect'].get(material)
    if not info:
      return
    for name, amount in info['require'].items():
      if self._inventory[name] < amount:
        return
    self._set_mat(target, info['leaves'])  # objects.py:225 before the draw
    if self._rng.uniform() <= info.get('probability', 1):
      for name, amount in info['receive'].items():
        self._inventory[name] += amount
        self._achievements[f'collect_{name}'] += 1

  def _pl_place(self, name, target, material):
    if self._at(target)[1] is not None:    # objects.py:231-249
      return
    info = self._rules['place'][name]
    if material not in info['where']:
      return
    if any(self._inventory[k] < v for k, v in info['uses'].items()):
      return
    for item, amount in info['uses'].items():
      self._inventory[item] -= amount
    if info['type'] == 'material':
      self._set_mat(target, name)
    else:                                  # plant joins the world mid-tick
      self._add(Ent(kind='plant', pos=target, hp=1))
    self._achievements[f'place_{name}'] += 1

  def _pl_make(self, name):
    x, y = self._player.pos                # engine.py:95-103 via numpy
    ids = set(self._mat[x - 1: x + 2, y - 1: y + 2].flatten().tolist())
    #   ^ the numpy negative-start slice is EMPTY at x==0/y==0 — the edge
    #     quirk the reference inherits; replicated by the same slicing.
    nearby = {rules.MATERIALS[i - 1] for i in ids if i}
    info = self._rules['make'][name]
    if not all(m in nearby for m in info['nearby']):
      return
    if any(self._inventory[k] < v for k, v in info['uses'].items()):
      return
    for item, amount in info['uses'].items():
      self._inventory[item] -= amount
    self._inventory[name] += info['gives']
    self._achievements[f'make_{name}'] += 1

  def _pl_life_stats(self):
    self._hunger += 0.5 if self._sleeping else 1   # objects.py:133-151
    if self._hunger > 25:
      self._hunger = 0
      self._inventory['food'] -= 1
    self._thirst += 0.5 if self._sleeping else 1
    if self._thirst > 20:
      self._thirst = 0
      self._inventory['drink'] -= 1
    if self._sleeping:
      self._fatigue = min(self._fatigue - 1, 0)
    else:
      self._fatigue += 1
    if self._fatigue < -10:
      self._fatigue = 0
      self._inventory['energy'] += 1
    if self._fatigue > 30:
      self._fatigue = 0
      self._inventory['energy'] -= 1

  def _pl_regen(self):
    necessities = (self._inventory['food'] > 0,
                   self._inventory['drink'] > 0,
                   self._inventory['energy'] > 0 or self._sleeping)
    if all(necessities):                   # objects.py:153-167
      self._recover += 2 if self._sleeping else 1
    else:
      self._recover -= 0.5 if self._sleeping else 1
    if self._recover > 25:
      self._recover = 0
      self._set_hp(self._player, self._inventory['health'] + 1)
    if self._recover < -15:
      self._recover = 0
      self._set_hp(self._player, self._inventory['health'] - 1)

  # -- mob ticks (objects.py:264-411) -------------------------------------

  def _tick_cow(self, ent: Ent):
    if ent.hp <= 0:                        # objects.py:274-279
      self._remove(ent)
    if self._rng.uniform() < 0.5:
      self._try_move(ent, self._random_dir(), self._walkable)

  def _tick_zombie(self, ent: Ent):
    if ent.hp <= 0:                        # objects.py:294-312
      self._remove(ent)
    dist = self._l1(ent.pos, self._player.pos)
    if dist <= 8 and self._rng.uniform() < 0.9:
      d = self._toward(ent.pos, self._player.pos, self._rng.uniform() < 0.8)
      self._try_move(ent, d, self._walkable)
    else:
      self._try_move(ent, self._random_dir(), self._walkable)
    if self._l1(ent.pos, self._player.pos) <= 1:
      if ent.ctr:                          # attack cooldown
        ent.ctr -= 1
      else:
        self._set_hp(self._player, self._inventory['health']
                     - (7 if self._sleeping else 2))
        ent.ctr = 5

  def _tick_skeleton(self, ent: Ent):
    if ent.hp <= 0:                        # objects.py:327-351
      self._remove(ent)
    ent.ctr = max(0, ent.ctr - 1)          # reload
    dist = self._l1(ent.pos, self._player.pos)
    if dist <= 3:
      d = self._toward(ent.pos, self._player.pos, self._rng.uniform() < 0.6)
      if self._try_move(ent, (-d[0], -d[1]), self._walkable):
        return
    if dist <= 5 and self._rng.uniform() < 0.5:
      d = self._toward(ent.pos, self._player.pos)
      if ent.ctr == 0 and d != (0, 0):     # _shoot (objects.py:343-351)
        pos = (ent.pos[0] + d[0], ent.pos[1] + d[1])
        if self._is_free(pos, self._walkable + ('water', 'lava')):
          self._add(Ent(kind='arrow', pos=pos, facing=d))
          ent.ctr = 4
    elif dist <= 8 and self._rng.uniform() < 0.3:
      d = self._toward(ent.pos, self._player.pos, self._rng.uniform() < 0.6)
      self._try_move(ent, d, self._walkable)
    elif self._rng.uniform() < 0.2:
      self._try_move(ent, self._random_dir(), self._walkable)

  def _tick_arrow(self, ent: Ent):
    target = (ent.pos[0] + ent.facing[0], ent.pos[1] + ent.facing[1])
    material, obj = self._at(target)       # objects.py:373-384
    arrow_walkable = self._walkable + ('water', 'lava')
    if obj is not None:
      self._set_hp(obj, self._hp(obj) - 2)
      self._remove(ent)
    elif material not in arrow_walkable:
      self._remove(ent)
      if material in ('table', 'furnace'):
        self._set_mat(target, 'path')
    else:
      self._try_move(ent, ent.facing, arrow_walkable)

  def _tick_plant(self, ent: Ent):
    ent.ctr += 1                           # objects.py:405-411
    neighbors = [self._at((ent.pos[0] + d[0], ent.pos[1] + d[1]))[1]
                 for d in ALL_DIRS]
    if any(n is not None and n.kind in ('zombie', 'skeleton', 'cow')
           for n in neighbors):
      self._set_hp(ent, ent.hp - 1)
    if ent.hp <= 0:
      self._remove(ent)

  # -- chunk balancing (env.py:141-179) -----------------------------------

  _BALANCE = (
      # kind, material, span, despan, spawn_p, despawn_p (env.py:143-155)
      ('zombie', 'grass', 6, 0, 0.3, 0.4),
      ('skeleton', 'path', 7, 7, 0.1, 0.1),
      ('cow', 'grass', 5, 5, 0.01, 0.1),
  )

  def _balance_chunk(self, key):
    light = self._daylight
    targets = dict(
        zombie=lambda space: (0 if space < 50 else 3.5 - 3 * light,
                              3.5 - 3 * light),
        skeleton=lambda space: (0 if space < 6 else 1, 2),
        cow=lambda space: (0 if space < 30 else 1, 1.5 + light))
    members = self._chunks[key]
    for kind, material, span, despan, spawn_p, despawn_p in self._BALANCE:
      creatures = [e for e in members.values() if e.kind == kind]
      xmin, xmax, ymin, ymax = key
      mask = self._mat[xmin:xmax, ymin:ymax] == rules.MAT_ID[material]
      tmin, tmax = targets[kind](mask.sum())
      if len(creatures) < int(tmin) and self._rng.uniform() < spawn_p:
        xs = np.tile(np.arange(xmin, xmax)[:, None], [1, ymax - ymin])[mask]
        ys = np.tile(np.arange(ymin, ymax)[None, :], [xmax - xmin, 1])[mask]
        i = self._rng.randint(0, len(xs))
        pos = (int(xs[i]), int(ys[i]))
        if (self._at(pos)[1] is None
            and self._l1(self._player.pos, pos) >= span):
          hp = dict(zombie=5, skeleton=3, cow=3)[kind]
          self._add(Ent(kind=kind, pos=pos, hp=hp))
      elif len(creatures) > int(tmax) and self._rng.uniform() < despawn_p:
        victim = creatures[self._rng.randint(0, len(creatures))]
        if self._l1(self._player.pos, victim.pos) >= despan:
          self._remove(victim)

  # -- rendering (engine.py:155-248, env.py:120-133) ----------------------

  def render(self, size=None):
    size = self._size if size is None else np.array(size)
    unit = size // self._view
    canvas = np.zeros(tuple(size) + (3,), np.uint8)
    local = self._render_local(unit)
    items = self._render_items(unit)
    view = np.concatenate([local, items], 1)
    border = (size - (size // self._view) * self._view) // 2
    (x, y), (w, h) = border, view.shape[:2]
    canvas[x: x + w, y: y + h] = view
    return canvas.transpose((1, 0, 2))

  def _obs(self):
    return self.render()

  def _render_local(self, unit):
    grid = self._local_grid
    offset = grid // 2
    center = np.array(self._player.pos)
    canvas = np.zeros(tuple(grid * unit) + (3,), np.uint8) + 127
    for x in range(grid[0]):               # engine.py:165-181
      for y in range(grid[1]):
        pos = center + np.array([x, y]) - offset
        if not (0 <= pos[0] < self._area[0] and 0 <= pos[1] < self._area[1]):
          continue
        tex = self._tex.get(self._at(pos)[0], unit)
        _blit(canvas, np.array([x, y]) * unit, tex, alpha=False)
    for ent in self._ents.values():
      pos = ent.pos - center + offset
      if not (0 <= pos[0] < grid[0] and 0 <= pos[1] < grid[1]):
        continue
      _blit(canvas, pos * unit, self._tex.get(_sprite(self, ent), unit),
            alpha=True)
    # Lighting (engine.py:189-196); the noise draw consumes game RNG.
    night = canvas
    if self._daylight < 0.5:
      noise = self._rng.uniform(32, 127, canvas.shape[:2])[..., None]
      mask = (2 * (0.5 - self._daylight)
              * _vignette(tuple(canvas.shape[:2]), 0.5)[..., None])
      night = (1 - mask) * night + mask * noise
    night = _desaturate(night, 0.4)
    night = 0.5 * night + 0.5 * np.array((0, 16, 64))
    canvas = self._daylight * canvas + (1 - self._daylight) * night
    if self._sleeping:                     # engine.py:198-202
      canvas = 0.5 * _desaturate(canvas, 0.0) + 0.5 * np.array((0, 0, 16))
    return canvas

  def _render_items(self, unit):
    grid = self._item_grid
    canvas = np.zeros(tuple(grid * unit) + (3,), np.uint8)
    for index, (item, amount) in enumerate(self._inventory.items()):
      if amount < 1:                       # engine.py:227-248
        continue
      pos = np.array([index % grid[0], index // grid[0]])
      _blit(canvas, (pos * unit + 0.1 * unit).astype(np.int32),
            self._tex.get(item, 0.8 * unit), alpha=True)
      text = str(amount) if amount in list(range(10)) else 'unknown'
      _blit(canvas, (pos * unit + 0.4 * unit).astype(np.int32),
            self._tex.get(text, 0.6 * unit), alpha=True)
    return canvas


def _sprite(env: ParityEnv, ent: Ent) -> str:
  if ent.kind == 'player':
    if env._sleeping:
      return 'player-sleep'
    return {(-1, 0): 'player-left', (1, 0): 'player-right',
            (0, -1): 'player-up', (0, 1): 'player-down'}[env._facing]
  if ent.kind == 'arrow':
    return {(-1, 0): 'arrow-left', (1, 0): 'arrow-right',
            (0, -1): 'arrow-up', (0, 1): 'arrow-down'}[ent.facing]
  if ent.kind == 'plant':
    return 'plant-ripe' if ent.ctr > 300 else 'plant'
  return ent.kind


_TICKS = {
    'player': ParityEnv._tick_player,
    'cow': ParityEnv._tick_cow,
    'zombie': ParityEnv._tick_zombie,
    'skeleton': ParityEnv._tick_skeleton,
    'arrow': ParityEnv._tick_arrow,
    'plant': ParityEnv._tick_plant,
}

# Semantic ids follow the reference registration order (env.py:47-49).
_KIND_ID = {'player': 0, 'cow': 1, 'zombie': 2, 'skeleton': 3, 'arrow': 4,
            'plant': 5}


class _TextureStore:
  """(name, size)-cached NEAREST-resized assets in (x, y) axis order
  (engine.py:120-142); material None renders 'unknown'."""

  def __init__(self):
    self._cache = {}

  def get(self, name, size):
    name = 'unknown' if name is None else name
    size = int(size[0]), int(size[1])
    if (name, size) not in self._cache:
      img = render._load(name)
      if img.shape[:2] != size:
        img = render._resize(img, size)
      self._cache[(name, size)] = img
    return self._cache[(name, size)]


def _blit(canvas, pos, texture, alpha):
  (x, y), (w, h) = pos, texture.shape[:2]  # engine.py:270-284
  if texture.shape[-1] == 4:
    if alpha:
      a = texture[..., 3:].astype(np.float32) / 255
      rgb = texture[..., :3].astype(np.float32) / 255
      cur = canvas[x: x + w, y: y + h].astype(np.float32) / 255
      texture = (255 * (a * rgb + (1 - a) * cur)).astype(np.uint8)
    else:
      texture = texture[..., :3]
  canvas[x: x + w, y: y + h] = texture


def _desaturate(canvas, factor):
  """PIL's ``ImageEnhance.Color(Image.fromarray(canvas.astype(np.uint8)))
  .enhance(factor)`` without PIL: the grey image is PIL's fixed-point luma
  (``render._luma_i``) in every channel, returned as it is at factor 0;
  otherwise each byte is ``trunc(L + f * (x - L))`` in float32 with ``f``
  the float32 factor, clamped to [0, 255] (PIL's Blend.c)."""
  x = canvas.astype(np.uint8)
  wide = x.astype(np.int32)
  luma = render._luma_i(wide[..., 0], wide[..., 1], wide[..., 2])
  grey = np.repeat(luma[..., None], 3, -1)
  if factor == 0.0:
    return grey.astype(np.uint8)
  grey = grey.astype(np.float32)
  out = grey + np.float32(factor) * (x.astype(np.float32) - grey)
  return np.clip(out, 0, 255).astype(np.uint8)


@functools.lru_cache(10)
def _vignette(shape, stddev):
  xs, ys = np.meshgrid(np.linspace(-1, 1, shape[0]),
                       np.linspace(-1, 1, shape[1]))
  return 1 - np.exp(-0.5 * (xs ** 2 + ys ** 2) / (stddev ** 2)).T
