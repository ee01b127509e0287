"""Frozen copy of the port's ``crafter_tpu_torch/rules.py`` for the
benchmark's reference: every call of a CUDA kernel replaced by its
plain twin, nothing imported from the port.  The port's own text
follows.

Game rules compiled into static lookup tables for the step kernels.

The port's own copy of ``crafter_tpu/rules.py`` (numpy only), kept so the
port imports nothing of the JAX package.

The reference keeps its rules as YAML loaded into Python dicts that the
object-oriented simulation branches on at every step
(``reference: crafter/data.yaml:1-102``, ``crafter/constants.py:5-8``).  A
TPU-native engine cannot branch per entity, so the same rules are compiled
here, once at import time, into dense integer tables that the jitted step
kernel indexes with gathers:

* ``COLLECT_*``   — per-material collect rules     (data.yaml:57-64)
* ``PLACE_*``     — per-place-action rules          (data.yaml:66-70)
* ``MAKE_*``      — per-recipe crafting rules       (data.yaml:72-78)
* ``WALKABLE_*``  — per-material walkability masks  (data.yaml:34-37 plus the
  player/arrow extensions at objects.py:96-97 and objects.py:369-371)
* achievement index maps                            (data.yaml:80-102)

The rule *data* lives in plain Python structures (`DEFAULT_RULES`) so users
can override rules the same way reference scripts mutate
``crafter.constants`` (e.g. run_gui.py:55-56); `compile_rules` freezes any
such ruleset into the dense tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Canonical enumerations.  Ids are stable and match the reference's implicit
# numbering: material id 0 is "none" (out of bounds), materials then appear in
# data.yaml order (crafter/engine.py:29 builds the same [None]+materials map).
# ---------------------------------------------------------------------------

ACTIONS: Tuple[str, ...] = (
    'noop', 'move_left', 'move_right', 'move_up', 'move_down', 'do', 'sleep',
    'place_stone', 'place_table', 'place_furnace', 'place_plant',
    'make_wood_pickaxe', 'make_stone_pickaxe', 'make_iron_pickaxe',
    'make_wood_sword', 'make_stone_sword', 'make_iron_sword',
)  # data.yaml:1-18

MATERIALS: Tuple[str, ...] = (
    'water', 'grass', 'stone', 'path', 'sand', 'tree', 'lava', 'coal',
    'iron', 'diamond', 'table', 'furnace',
)  # data.yaml:20-32

ITEMS: Tuple[str, ...] = (
    'health', 'food', 'drink', 'energy', 'sapling', 'wood', 'stone', 'coal',
    'iron', 'diamond', 'wood_pickaxe', 'stone_pickaxe', 'iron_pickaxe',
    'wood_sword', 'stone_sword', 'iron_sword',
)  # data.yaml:39-55

ACHIEVEMENTS: Tuple[str, ...] = (
    'collect_coal', 'collect_diamond', 'collect_drink', 'collect_iron',
    'collect_sapling', 'collect_stone', 'collect_wood', 'defeat_skeleton',
    'defeat_zombie', 'eat_cow', 'eat_plant', 'make_iron_pickaxe',
    'make_iron_sword', 'make_stone_pickaxe', 'make_stone_sword',
    'make_wood_pickaxe', 'make_wood_sword', 'place_furnace', 'place_plant',
    'place_stone', 'place_table', 'wake_up',
)  # data.yaml:80-102

# Material ids (0 = none / out of bounds).
MAT_NONE = 0
MAT_ID: Dict[str, int] = {name: i + 1 for i, name in enumerate(MATERIALS)}
MAT_WATER = MAT_ID['water']
MAT_GRASS = MAT_ID['grass']
MAT_STONE = MAT_ID['stone']
MAT_PATH = MAT_ID['path']
MAT_SAND = MAT_ID['sand']
MAT_TREE = MAT_ID['tree']
MAT_LAVA = MAT_ID['lava']
MAT_COAL = MAT_ID['coal']
MAT_IRON = MAT_ID['iron']
MAT_DIAMOND = MAT_ID['diamond']
MAT_TABLE = MAT_ID['table']
MAT_FURNACE = MAT_ID['furnace']
N_MATERIALS = len(MATERIALS) + 1  # including "none"

ITEM_ID: Dict[str, int] = {name: i for i, name in enumerate(ITEMS)}
N_ITEMS = len(ITEMS)
ITEM_HEALTH = ITEM_ID['health']
ITEM_FOOD = ITEM_ID['food']
ITEM_DRINK = ITEM_ID['drink']
ITEM_ENERGY = ITEM_ID['energy']
ITEM_SAPLING = ITEM_ID['sapling']

ACH_ID: Dict[str, int] = {name: i for i, name in enumerate(ACHIEVEMENTS)}
N_ACHIEVEMENTS = len(ACHIEVEMENTS)

ACTION_ID: Dict[str, int] = {name: i for i, name in enumerate(ACTIONS)}
N_ACTIONS = len(ACTIONS)
A_NOOP = ACTION_ID['noop']
A_DO = ACTION_ID['do']
A_SLEEP = ACTION_ID['sleep']

# Entity type ids.  Semantic-view ids are N_MATERIALS + (type - 1), matching
# the reference's registration order [Player, Cow, Zombie, Skeleton, Arrow,
# Plant] (crafter/env.py:47-49).
E_NONE = 0
E_PLAYER = 1
E_COW = 2
E_ZOMBIE = 3
E_SKELETON = 4
E_ARROW = 5
E_PLANT = 6
N_ENTITY_TYPES = 7
ENTITY_NAMES = ('none', 'player', 'cow', 'zombie', 'skeleton', 'arrow', 'plant')

# Direction encoding shared by facing and moves.  The order matches the
# reference's Object.all_dirs ((-1,0),(+1,0),(0,-1),(0,+1)) so random
# direction draws index the same table (objects.py:33-34, :64-65).
DIRS = np.array([(-1, 0), (1, 0), (0, -1), (0, 1)], np.int32)
DIR_LEFT, DIR_RIGHT, DIR_UP, DIR_DOWN = 0, 1, 2, 3

# ---------------------------------------------------------------------------
# Rule data (overridable).  Semantics transcribed from data.yaml:34-102.
# ---------------------------------------------------------------------------


def default_rules() -> dict:
  """The stock crafter ruleset as plain Python data (data.yaml:34-102)."""
  return dict(
      walkable=['grass', 'path', 'sand'],
      items={
          'health': dict(max=9, initial=9),
          'food': dict(max=9, initial=9),
          'drink': dict(max=9, initial=9),
          'energy': dict(max=9, initial=9),
          'sapling': dict(max=9, initial=0),
          'wood': dict(max=9, initial=0),
          'stone': dict(max=9, initial=0),
          'coal': dict(max=9, initial=0),
          'iron': dict(max=9, initial=0),
          'diamond': dict(max=9, initial=0),
          'wood_pickaxe': dict(max=9, initial=0),
          'stone_pickaxe': dict(max=9, initial=0),
          'iron_pickaxe': dict(max=9, initial=0),
          'wood_sword': dict(max=9, initial=0),
          'stone_sword': dict(max=9, initial=0),
          'iron_sword': dict(max=9, initial=0),
      },
      collect={
          'tree': dict(require={}, receive={'wood': 1}, leaves='grass'),
          'stone': dict(require={'wood_pickaxe': 1}, receive={'stone': 1},
                        leaves='path'),
          'coal': dict(require={'wood_pickaxe': 1}, receive={'coal': 1},
                       leaves='path'),
          'iron': dict(require={'stone_pickaxe': 1}, receive={'iron': 1},
                       leaves='path'),
          'diamond': dict(require={'iron_pickaxe': 1}, receive={'diamond': 1},
                          leaves='path'),
          'water': dict(require={}, receive={'drink': 1}, leaves='water'),
          'grass': dict(require={}, receive={'sapling': 1}, probability=0.1,
                        leaves='grass'),
      },
      place={
          'stone': dict(uses={'stone': 1},
                        where=['grass', 'sand', 'path', 'water', 'lava'],
                        type='material'),
          'table': dict(uses={'wood': 2}, where=['grass', 'sand', 'path'],
                        type='material'),
          'furnace': dict(uses={'stone': 4}, where=['grass', 'sand', 'path'],
                          type='material'),
          'plant': dict(uses={'sapling': 1}, where=['grass'], type='object'),
      },
      make={
          'wood_pickaxe': dict(uses={'wood': 1}, nearby=['table'], gives=1),
          'stone_pickaxe': dict(uses={'wood': 1, 'stone': 1},
                                nearby=['table'], gives=1),
          'iron_pickaxe': dict(uses={'wood': 1, 'coal': 1, 'iron': 1},
                               nearby=['table', 'furnace'], gives=1),
          'wood_sword': dict(uses={'wood': 1}, nearby=['table'], gives=1),
          'stone_sword': dict(uses={'wood': 1, 'stone': 1},
                              nearby=['table'], gives=1),
          'iron_sword': dict(uses={'wood': 1, 'coal': 1, 'iron': 1},
                             nearby=['table', 'furnace'], gives=1),
      },
  )


# ---------------------------------------------------------------------------
# Compiled tables.
# ---------------------------------------------------------------------------

PLACE_NAMES = ('stone', 'table', 'furnace', 'plant')  # action order 7..10
MAKE_NAMES = ('wood_pickaxe', 'stone_pickaxe', 'iron_pickaxe',
              'wood_sword', 'stone_sword', 'iron_sword')  # action order 11..16


@dataclasses.dataclass(frozen=True)
class RuleTables:
  """Dense rule tables consumed by the step kernel (all numpy, frozen)."""

  # Items.
  item_max: np.ndarray        # (16,) int32 — data.yaml:39-55
  item_initial: np.ndarray    # (16,) int32

  # Walkability per material id, per mover class.
  walkable_mob: np.ndarray    # (13,) bool — data.yaml:34-37
  walkable_player: np.ndarray  # (13,) bool — + lava (objects.py:96-97)
  walkable_arrow: np.ndarray  # (13,) bool — + water/lava (objects.py:369-371)

  # Collect rules per material id (data.yaml:57-64; objects.py:214-229).
  collectible: np.ndarray     # (13,) bool
  collect_require: np.ndarray  # (13, 16) int32 inventory requirements
  collect_receive: np.ndarray  # (13, 16) int32 items received
  collect_leaves: np.ndarray  # (13,) int32 material left behind
  collect_prob: np.ndarray    # (13,) float32 success probability
  collect_ach: np.ndarray     # (13,) int32 achievement id or -1

  # Place rules per place action index (data.yaml:66-70; objects.py:231-249).
  place_uses: np.ndarray      # (4, 16) int32 inventory cost
  place_where: np.ndarray     # (4, 13) bool allowed target material
  place_is_material: np.ndarray  # (4,) bool — material vs object placement
  place_material: np.ndarray  # (4,) int32 material id placed (or 0)
  place_entity: np.ndarray    # (4,) int32 entity type spawned (or 0)
  place_ach: np.ndarray       # (4,) int32 achievement id

  # Make rules per make action index (data.yaml:72-78; objects.py:251-261).
  make_uses: np.ndarray       # (6, 16) int32 inventory cost
  make_nearby: np.ndarray     # (6, 13) bool materials required within dist 1
  make_gives_item: np.ndarray  # (6,) int32 item id produced
  make_gives_count: np.ndarray  # (6,) int32 amount produced
  make_ach: np.ndarray        # (6,) int32 achievement id

  # Achievement id when collecting item i via the collect table (or -1).
  item_collect_ach: np.ndarray  # (16,) int32


def compile_rules(rules: dict | None = None) -> RuleTables:
  """Freeze a ruleset (shape of `default_rules()`) into dense tables."""
  rules = rules or default_rules()

  item_max = np.zeros((N_ITEMS,), np.int32)
  item_initial = np.zeros((N_ITEMS,), np.int32)
  for name, info in rules['items'].items():
    item_max[ITEM_ID[name]] = info['max']
    item_initial[ITEM_ID[name]] = info['initial']

  walkable_mob = np.zeros((N_MATERIALS,), bool)
  for name in rules['walkable']:
    walkable_mob[MAT_ID[name]] = True
  walkable_player = walkable_mob.copy()
  walkable_player[MAT_LAVA] = True   # objects.py:96-97
  walkable_arrow = walkable_mob.copy()
  walkable_arrow[[MAT_WATER, MAT_LAVA]] = True  # objects.py:369-371

  collectible = np.zeros((N_MATERIALS,), bool)
  collect_require = np.zeros((N_MATERIALS, N_ITEMS), np.int32)
  collect_receive = np.zeros((N_MATERIALS, N_ITEMS), np.int32)
  collect_leaves = np.zeros((N_MATERIALS,), np.int32)
  collect_prob = np.zeros((N_MATERIALS,), np.float32)
  collect_ach = np.full((N_MATERIALS,), -1, np.int32)
  item_collect_ach = np.full((N_ITEMS,), -1, np.int32)
  for mat, info in rules['collect'].items():
    mid = MAT_ID[mat]
    collectible[mid] = True
    for k, v in info['require'].items():
      collect_require[mid, ITEM_ID[k]] = v
    for k, v in info['receive'].items():
      collect_receive[mid, ITEM_ID[k]] = v
      # The reference unlocks `collect_{received item}` (objects.py:227-229).
      ach = ACH_ID.get(f'collect_{k}', -1)
      collect_ach[mid] = ach
      item_collect_ach[ITEM_ID[k]] = ach
    collect_leaves[mid] = MAT_ID[info['leaves']]
    collect_prob[mid] = info.get('probability', 1.0)

  place_uses = np.zeros((len(PLACE_NAMES), N_ITEMS), np.int32)
  place_where = np.zeros((len(PLACE_NAMES), N_MATERIALS), bool)
  place_is_material = np.zeros((len(PLACE_NAMES),), bool)
  place_material = np.zeros((len(PLACE_NAMES),), np.int32)
  place_entity = np.zeros((len(PLACE_NAMES),), np.int32)
  place_ach = np.zeros((len(PLACE_NAMES),), np.int32)
  for i, name in enumerate(PLACE_NAMES):
    info = rules['place'][name]
    for k, v in info['uses'].items():
      place_uses[i, ITEM_ID[k]] = v
    for mat in info['where']:
      place_where[i, MAT_ID[mat]] = True
    place_is_material[i] = info['type'] == 'material'
    if info['type'] == 'material':
      place_material[i] = MAT_ID[name]
    else:
      place_entity[i] = {'plant': E_PLANT}[name]
    place_ach[i] = ACH_ID[f'place_{name}']

  make_uses = np.zeros((len(MAKE_NAMES), N_ITEMS), np.int32)
  make_nearby = np.zeros((len(MAKE_NAMES), N_MATERIALS), bool)
  make_gives_item = np.zeros((len(MAKE_NAMES),), np.int32)
  make_gives_count = np.zeros((len(MAKE_NAMES),), np.int32)
  make_ach = np.zeros((len(MAKE_NAMES),), np.int32)
  for i, name in enumerate(MAKE_NAMES):
    info = rules['make'][name]
    for k, v in info['uses'].items():
      make_uses[i, ITEM_ID[k]] = v
    for mat in info['nearby']:
      make_nearby[i, MAT_ID[mat]] = True
    make_gives_item[i] = ITEM_ID[name]
    make_gives_count[i] = info['gives']
    make_ach[i] = ACH_ID[f'make_{name}']

  return RuleTables(
      item_max=item_max, item_initial=item_initial,
      walkable_mob=walkable_mob, walkable_player=walkable_player,
      walkable_arrow=walkable_arrow,
      collectible=collectible, collect_require=collect_require,
      collect_receive=collect_receive, collect_leaves=collect_leaves,
      collect_prob=collect_prob, collect_ach=collect_ach,
      place_uses=place_uses, place_where=place_where,
      place_is_material=place_is_material, place_material=place_material,
      place_entity=place_entity, place_ach=place_ach,
      make_uses=make_uses, make_nearby=make_nearby,
      make_gives_item=make_gives_item, make_gives_count=make_gives_count,
      make_ach=make_ach, item_collect_ach=item_collect_ach,
  )


TABLES = compile_rules()
_ON_OVERRIDE = []


def on_override(clear):
  """Register ``clear()`` to run whenever :func:`override_rules` swaps the
  tables; the caches built from them register their ``cache_clear``."""
  _ON_OVERRIDE.append(clear)
  return clear


def override_rules(mutate) -> RuleTables:
  """Swap the module-level tables with a mutated ruleset.

  The reference customizes rules by mutating ``crafter.constants`` globals
  before constructing envs (run_gui.py:55-56, run_random.py:21-22); the
  port mutates the rule *data* and recompiles the dense tables.  The
  caches derived from the tables (``step._tables``,
  ``step_cuda._rules_blob``) are cleared, so the plain step and the
  kernels read the new rules from the next call on:

      rules.override_rules(lambda r: r['items']['health'].update(
          max=5, initial=5))
  """
  global TABLES
  data = default_rules()
  mutate(data)
  TABLES = compile_rules(data)
  for clear in _ON_OVERRIDE:
    clear()
  return TABLES
