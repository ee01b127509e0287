"""Frozen copy of the port's ``crafter_tpu_torch/step.py`` for the
benchmark's reference: every call of a CUDA kernel replaced by its
plain twin, nothing imported from the port.  The port's own text
follows.

The simulation tick, the group of K ticks and the group-end balance —
plain PyTorch versions.

The port's counterpart of ``crafter_tpu/step.py`` for the main path: the
player phase (``_player_core``), the mob / arrow / plant phase
(``_mob_core``), the reward / done bookkeeping of a tick, a whole
balance-cadence group (``step_group_batch``) and the group-end chunk
balancing (``_balance_core``).  These are the plain twins of the CUDA
kernels in ``step_cuda.py`` and the reference the kernels are held to.

They port the JAX package's *results*, not its TPU idioms: one-hot
``read_at`` sums become gathers, rolls with masks become slice shifts, the
balance's bf16 one-hot matmuls become integer ``index_add`` counts and its
prefix-count ladders a cumulative sum in chunk order.  All integer
arithmetic is int32 with two's-complement wrap, like the JAX lanes.  The
functions work on ``(N, C)`` int32 planes with a leading env axis.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import rules
from . import state as state_lib
from .config import EnvConfig
from .fma import fma32
from .state import EntMaps, Player, State

DIRS = tuple((int(d[0]), int(d[1])) for d in rules.DIRS)
# Chunk balancing classes and parameters (env.py:143-155).
BAL_CLASSES = (rules.E_ZOMBIE, rules.E_SKELETON, rules.E_COW)
BAL_SPAN = (6, 7, 5)
BAL_DESPAN = (0, 7, 5)
BAL_SPAWN_P = (0.3, 0.1, 0.01)
BAL_DESPAWN_P = (0.4, 0.1, 0.1)
SPAWN_MEM = (3, 4, 3)       # spawn member set: grass, path, grass
TYPE_HEALTH = (0, 0, 3, 5, 3, 0, 1)
# float32 reciprocal of the reward's division by 10 (XLA folds it so).
INV10 = float(np.float32(1.0) / np.float32(10.0))


@dataclasses.dataclass
class StepOut:
  """Per-tick results, (K, N) leaves for a group."""

  reward: torch.Tensor   # float32
  done: torch.Tensor     # bool
  dead: torch.Tensor     # bool
  ended: torch.Tensor    # bool — the episode ended on this tick


@dataclasses.dataclass
class GroupSnaps:
  """Per-tick render snapshots of a group for ticks 0..K-2, tick-major (the
  group's last frame is rendered from the post-balance, post-reset state by
  the caller).  All the renderer reads of a cell is one byte: material id
  | cell sprite id << 4 (the ``render.pack_cells`` encoding)."""

  packed: torch.Tensor    # (K, N, C) uint8; row K-1 is left for the caller
  px: torch.Tensor        # (K-1, N) int32 player x
  py: torch.Tensor        # (K-1, N) int32 player y
  facing: torch.Tensor    # (K-1, N) int32 player facing
  sleeping: torch.Tensor  # (K-1, N) int32 0/1
  inv: torch.Tensor       # (K-1, N, 16) int32 inventory


# ---------------------------------------------------------------------------
# Hash primitives (step.py:125-166, 797-815) on wrapping int32 tensors.
# ---------------------------------------------------------------------------


def i32c(value: int) -> int:
  """A 32-bit constant as a Python int in int32 range (two's complement)."""
  return int(np.uint32(value).view(np.int32))


def srl(v: torch.Tensor, k: int) -> torch.Tensor:
  """Logical right shift of int32 values (torch's ``>>`` is arithmetic)."""
  return (v >> k) & ((1 << (32 - k)) - 1)


def fmix(v: torch.Tensor) -> torch.Tensor:
  v = v ^ srl(v, 16)
  v = v * i32c(0x7FEB352D)
  v = v ^ srl(v, 15)
  v = v * i32c(0x846CA68B)
  v = v ^ srl(v, 16)
  return v


def key_words_i32(key: torch.Tensor):
  """The two key words (N, 2) int64 as int32 bit patterns."""
  k = torch.where(key >= 2 ** 31, key - 2 ** 32, key).to(torch.int32)
  return k[..., 0], k[..., 1]


def tick_seeds(key: torch.Tensor, step: torch.Tensor):
  """Player / mob / balance int32 seeds from (episode key, step)."""
  k0, k1 = key_words_i32(key)
  base = fmix(k0 ^ fmix(k1 + step.to(torch.int32) * i32c(0x9E3779B9)))
  return (base, fmix(base + i32c(0x85EBCA6B)),
          fmix(base + i32c(0xC2B2AE35)))


def u24(bits: torch.Tensor) -> torch.Tensor:
  """float32 uniform in [0, 1) from the top 24 bits of an int32 word."""
  return srl(bits, 8).to(torch.float32) * (1.0 / (1 << 24))


def seed_uniform(seed: torch.Tensor) -> torch.Tensor:
  return u24(fmix(seed))


def cell_bits_plane(seed, chan: int, x, y) -> torch.Tensor:
  v = (seed + i32c(0x9E3779B9) * chan + x * i32c(0x85EBCA6B)
       + y * i32c(0xC2B2AE35))
  return fmix(fmix(v))


def cell_uniform_xy(seed, chan: int, x, y) -> torch.Tensor:
  return u24(cell_bits_plane(seed, chan, x, y))


# ---------------------------------------------------------------------------
# Rule tables as tensors.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tables(device: str):
  t = rules.TABLES
  i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
  b = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)
  need = lambda rows: np.asarray(
      [sum(1 << int(m) for m in np.flatnonzero(r)) for r in rows], np.int32)
  return dict(
      walk_player=b(t.walkable_player), walk_mob=b(t.walkable_mob),
      walk_arrow=b(t.walkable_arrow), collectible=b(t.collectible),
      collect_require=i32(t.collect_require),
      collect_receive=i32(t.collect_receive),
      collect_leaves=i32(t.collect_leaves),
      collect_prob=torch.as_tensor(np.asarray(t.collect_prob, np.float32),
                                   device=device),
      collect_ach=i32(t.collect_ach), place_uses=i32(t.place_uses),
      place_where=b(t.place_where), place_is_material=b(t.place_is_material),
      place_material=i32(t.place_material), place_ach=i32(t.place_ach),
      make_uses=i32(t.make_uses), make_need=i32(need(t.make_nearby)),
      make_gives_item=i32(t.make_gives_item),
      make_gives_count=i32(t.make_gives_count), make_ach=i32(t.make_ach),
      item_max=i32(t.item_max))


rules.on_override(_tables.cache_clear)


def _dirvec(idx: torch.Tensor):
  dx = torch.where(idx == 0, -1, torch.where(idx == 1, 1, 0))
  dy = torch.where(idx == 2, -1, torch.where(idx == 3, 1, 0))
  return dx.to(torch.int32), dy.to(torch.int32)


def _read_at(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """plane[n, idx[n]] per env, 0 where idx < 0."""
  v = plane.gather(1, idx.clamp_min(0).long()[:, None])[:, 0]
  return torch.where(idx >= 0, v, 0)


def _write_at(plane: torch.Tensor, idx, value, cond) -> None:
  """plane[n, idx[n]] = value[n] where cond[n] and idx[n] >= 0 (in place)."""
  ci = idx.clamp_min(0).long()[:, None]
  old = plane.gather(1, ci)[:, 0]
  new = torch.where(cond & (idx >= 0), value.to(plane.dtype), old)
  plane.scatter_(1, ci, new[:, None])


def _req_ok(need: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
  return ((inv >= need) | (need == 0)).all(1)


def _ach_add(ach, idx, cond):
  lane = torch.arange(ach.shape[1], device=ach.device)
  return ach + ((lane[None] == idx[:, None]) & cond[:, None]).to(ach.dtype)


def player_core(M, T, Hp, A, action, facing, px, py, sleeping, hunger,
                thirst, fatigue, recover, last_health, inv, ach, seed,
                cfg: EnvConfig):
  """Player.update (objects.py:99-131) for a batch of envs.

  ``M, T, Hp, A`` are (N, C) int32 planes and are updated in place; the
  per-env fields are (N,) tensors, ``inv`` (N, 16), ``ach`` (N, 22).
  Returns the player fields and the pending plant cell (-1 = none), as
  ``_player_core`` does.
  """
  t = rules.TABLES
  tab = _tables(str(M.device))
  w, h = cfg.area
  E, F_, D, H = (rules.ITEM_ENERGY, rules.ITEM_FOOD, rules.ITEM_DRINK,
                 rules.ITEM_HEALTH)
  energy_max = int(t.item_max[E])
  inv = inv.clone()

  full = inv[:, E] >= energy_max
  wake = sleeping & full
  action = torch.where(sleeping & ~full, rules.A_SLEEP, action)
  sleeping = sleeping & ~wake
  ach = _ach_add(ach, torch.full_like(action, rules.ACH_ID['wake_up']), wake)

  fdx, fdy = _dirvec(facing)
  tx, ty = px + fdx, py + fdy
  tin = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
  t_idx = torch.where(tin, tx * h + ty, -1)
  move_dir = (action - 1).clamp(0, 3)
  mdx, mdy = _dirvec(move_dir)
  mx, my = px + mdx, py + mdy
  m_in = (mx >= 0) & (mx < w) & (my >= 0) & (my < h)
  m_idx = torch.where(m_in, mx * h + my, -1)
  p_idx = px * h + py
  tmat = _read_at(M, t_idx)
  mtmat = _read_at(M, m_idx)
  heremat = _read_at(M, p_idx)
  ttype = _read_at(T, t_idx)
  thp = _read_at(Hp, t_idx)
  taux = _read_at(A, t_idx)
  t_occ = ttype > 0
  mt_occ = _read_at(T, m_idx) > 0

  is_move = (1 <= action) & (action <= 4)
  is_do = action == rules.A_DO
  is_sleep = action == rules.A_SLEEP
  is_place = (7 <= action) & (action <= 10)
  is_make = (11 <= action) & (action <= 16)

  # Move (objects.py:174-179): facing set even when blocked.
  facing = torch.where(is_move, move_dir, facing)
  can_move = is_move & m_in & tab['walk_player'][mtmat.long()] & ~mt_occ
  new_px = torch.where(can_move, mx, px)
  new_py = torch.where(can_move, my, py)
  new_idx = torch.where(can_move, m_idx, p_idx)
  _write_at(T, p_idx, torch.zeros_like(p_idx), can_move)
  _write_at(T, new_idx, torch.full_like(p_idx, rules.E_PLAYER), can_move)
  on_lava = is_move & (torch.where(can_move, mtmat, heremat)
                       == rules.MAT_LAVA)
  inv[:, H] = torch.where(on_lava, 0, inv[:, H])

  # Do on an entity (objects.py:181-213).
  do_obj = is_do & t_occ
  item = lambda name: inv[:, rules.ITEM_ID[name]]
  damage = torch.maximum(
      torch.maximum(torch.ones_like(action),
                    torch.where(item('wood_sword') > 0, 2, 0)),
      torch.maximum(torch.where(item('stone_sword') > 0, 3, 0),
                    torch.where(item('iron_sword') > 0, 5, 0)))
  eat_plant = do_obj & (ttype == rules.E_PLANT) & (taux > 300)
  _write_at(A, t_idx, torch.zeros_like(t_idx), eat_plant)
  hit_mob = do_obj & ((ttype == rules.E_ZOMBIE) | (ttype == rules.E_SKELETON)
                      | (ttype == rules.E_COW))
  hp_after = (thp - damage).clamp_min(0)
  _write_at(Hp, t_idx, hp_after, hit_mob)
  killed = hit_mob & (hp_after <= 0)
  eat_cow = killed & (ttype == rules.E_COW)
  inv[:, F_] += torch.where(eat_plant, 4, 0) + torch.where(eat_cow, 6, 0)
  for name, cond in (('eat_plant', eat_plant), ('eat_cow', eat_cow),
                     ('defeat_zombie', killed & (ttype == rules.E_ZOMBIE)),
                     ('defeat_skeleton',
                      killed & (ttype == rules.E_SKELETON))):
    ach = _ach_add(ach, torch.full_like(action, rules.ACH_ID[name]), cond)

  # Do on a material (objects.py:214-229).
  do_mat = is_do & ~t_occ
  drink_water = do_mat & (tmat == rules.MAT_WATER)
  ti = tmat.long()
  can_collect = (do_mat & tab['collectible'][ti]
                 & _req_ok(tab['collect_require'][ti], inv))
  _write_at(M, t_idx, tab['collect_leaves'][ti], can_collect)
  got = seed_uniform(seed) <= tab['collect_prob'][ti]
  receive = can_collect & got
  inv = inv + torch.where(receive[:, None], tab['collect_receive'][ti], 0)
  cach = tab['collect_ach'][ti]
  ach = _ach_add(ach, cach, receive & (cach >= 0))

  # Sleep (objects.py:117-119).
  sleeping = sleeping | (is_sleep & (inv[:, E] < energy_max))

  # Place (objects.py:231-249).
  pidx = (action - 7).clamp(0, 3).long()
  place_ok = (is_place & ~t_occ & tab['place_where'][pidx, ti]
              & _req_ok(tab['place_uses'][pidx], inv))
  inv = inv - torch.where(place_ok[:, None], tab['place_uses'][pidx], 0)
  pick_mat = tab['place_is_material'][pidx]
  _write_at(M, t_idx, tab['place_material'][pidx], place_ok & pick_mat)
  plant_spawn = place_ok & ~pick_mat
  ach = _ach_add(ach, tab['place_ach'][pidx], place_ok)

  # Make (objects.py:251-261): 3x3 nearby window, empty at the x==0 / y==0
  # edges (engine.py:95-103).
  midx = (action - 11).clamp(0, 5).long()
  present = torch.zeros_like(action)
  for ox in (-1, 0, 1):
    for oy in (-1, 0, 1):
      wx, wy = px + ox, py + oy
      ok = ((wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)
            & (px >= 1) & (py >= 1))
      m = _read_at(M, torch.where(ok, wx * h + wy, -1))
      present = present | torch.where(ok, 1 << m, 0)
  nearby_ok = (tab['make_need'][midx] & ~present) == 0
  make_ok = is_make & nearby_ok & _req_ok(tab['make_uses'][midx], inv)
  inv = inv - torch.where(make_ok[:, None], tab['make_uses'][midx], 0)
  lane16 = torch.arange(rules.N_ITEMS, device=inv.device)
  gives = ((lane16[None] == tab['make_gives_item'][midx][:, None])
           & make_ok[:, None])
  inv = inv + torch.where(gives, tab['make_gives_count'][midx][:, None], 0)
  ach = _ach_add(ach, tab['make_ach'][midx], make_ok)

  # Life stats in half units (objects.py:133-151).
  hunger = torch.where(eat_cow, 0, hunger) + torch.where(sleeping, 1, 2)
  food_tick = hunger > 50
  hunger = torch.where(food_tick, 0, hunger)
  inv[:, F_] -= food_tick.to(inv.dtype)
  thirst = torch.where(drink_water, 0, thirst) + torch.where(sleeping, 1, 2)
  drink_tick = thirst > 40
  thirst = torch.where(drink_tick, 0, thirst)
  inv[:, D] -= drink_tick.to(inv.dtype)
  fatigue = torch.where(sleeping, torch.clamp_max(fatigue - 2, 0),
                        fatigue + 2)
  gain_e = fatigue < -20
  lose_e = fatigue > 60
  fatigue = torch.where(gain_e | lose_e, 0, fatigue)
  inv[:, E] += gain_e.to(inv.dtype) - lose_e.to(inv.dtype)

  # Health regen / degen (objects.py:153-167).
  necessities = ((inv[:, F_] > 0) & (inv[:, D] > 0)
                 & ((inv[:, E] > 0) | sleeping))
  recover = recover + torch.where(
      necessities, torch.where(sleeping, 4, 2), torch.where(sleeping, -1, -2))
  regen = recover > 50
  degen = recover < -30
  recover = torch.where(regen | degen, 0, recover)
  inv[:, H] = (inv[:, H] + regen.to(inv.dtype)
               - degen.to(inv.dtype)).clamp_min(0)

  # Clamp, then wake on hurt (objects.py:126-131, :169-172).
  inv = torch.minimum(inv.clamp_min(0), tab['item_max'][None])
  hp = inv[:, H].clone()
  sleeping = sleeping & ~(hp < last_health)
  plant_idx = torch.where(plant_spawn, t_idx, -1)
  i32 = lambda v: v.to(torch.int32)
  return (i32(new_px), i32(new_py), i32(facing), sleeping, i32(hunger),
          i32(thirst), i32(fatigue), i32(recover), hp, inv, ach,
          i32(plant_idx))


# ---------------------------------------------------------------------------
# Mobs, arrows, plants (objects.py:264-411).
# ---------------------------------------------------------------------------


def _shift(a: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
  """out[:, x, y] = a[:, x - dx, y - dy], zero where that is off the grid."""
  out = torch.zeros_like(a)
  w, h = a.shape[-2:]
  out[:, max(dx, 0):w + min(dx, 0), max(dy, 0):h + min(dy, 0)] = \
      a[:, max(-dx, 0):w - max(dx, 0), max(-dy, 0):h - max(dy, 0)]
  return out


def _push(a, d):
  """out[c] = a[c - DIRS[d]]: content travels one cell along d."""
  return _shift(a, DIRS[d][0], DIRS[d][1])


def _pull(a, d):
  """out[c] = a[c + DIRS[d]]: what each cell sees at its dir-d neighbour."""
  return _shift(a, -DIRS[d][0], -DIRS[d][1])


def _mat_in(m: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
  return table[m.long()]


def _p10(p: float) -> int:
  """A probability as a 10-bit threshold (step.py:558)."""
  return int(round(p * 1024.0))


def mob_core(M, T, Hp, A, F, px, py, sleeping, seed, plant_idx,
             cfg: EnvConfig):
  """All non-player entities for one tick (``_mob_core``).

  Planes are (N, W, H) int32; per-env values (N,).  Returns the updated
  planes ``(M, T, Hp, A, F)`` and the player's damage (N,).
  """
  tab = _tables(str(M.device))
  w, h = cfg.area
  dev = M.device
  x = torch.arange(w, dtype=torch.int32, device=dev)[None, :, None]
  y = torch.arange(h, dtype=torch.int32, device=dev)[None, None, :]
  col = lambda v: v.reshape(-1, 1, 1)
  px, py, seed = col(px), col(py), col(seed)
  sleeping, plant_idx = col(sleeping), col(plant_idx)

  hb0 = cell_bits_plane(seed, 0, x, y)
  hb1 = cell_bits_plane(seed, 1, x, y)
  g0 = hb0 & 0x3FF
  g1 = srl(hb0, 10) & 0x3FF
  g2 = srl(hb0, 20) & 0x3FF
  dirbits = srl(hb0, 30)
  g3 = hb1 & 0x3FF
  g4 = srl(hb1, 10) & 0x3FF

  offx, offy = px - x, py - y
  x_longer = offx.abs() > offy.abs()
  sgnx, sgny = torch.sign(offx), torch.sign(offy)

  def toward(long_axis):
    use_x = long_axis == x_longer
    return torch.where(use_x, sgnx, 0), torch.where(use_x, 0, sgny)

  pdist = offx.abs() + offy.abs()
  cell = x * h + y
  pending = cell == plant_idx

  is_cow = T == rules.E_COW
  is_zom = T == rules.E_ZOMBIE
  is_skel = T == rules.E_SKELETON
  is_arrow = T == rules.E_ARROW
  is_plant = T == rules.E_PLANT
  active = (T > rules.E_PLAYER) & (pdist < cfg.update_distance)
  dying = active & (Hp <= 0) & (is_cow | is_zom | is_skel)

  # Decisions (source-cell domain).
  rdx, rdy = _dirvec(dirbits)
  cow_wants = g0 < _p10(0.5)
  chase = (pdist <= 8) & (g0 < _p10(0.9))
  twx, twy = toward(g1 < _p10(0.8))
  zx = torch.where(chase, twx, rdx)
  zy = torch.where(chase, twy, rdy)
  retreat = pdist <= 3
  rwx, rwy = toward(g0 < _p10(0.6))
  c_shoot = (pdist <= 5) & (g1 < _p10(0.5))
  c_approach = (pdist <= 8) & (g2 < _p10(0.3))
  c_walk = g3 < _p10(0.2)
  awx, awy = toward(g4 < _p10(0.6))
  appr = ~c_shoot & c_approach
  sox = torch.where(appr, awx, rdx)
  soy = torch.where(appr, awy, rdy)
  s_wants_other = ~c_shoot & (c_approach | c_walk)
  sx = torch.where(retreat, -rwx, sox)
  sy = torch.where(retreat, -rwy, soy)
  skel_wants = retreat | s_wants_other
  avx, avy = _dirvec(F)
  mvx = torch.where(is_zom, zx, torch.where(is_skel, sx,
                                            torch.where(is_arrow, avx, rdx)))
  mvy = torch.where(is_zom, zy, torch.where(is_skel, sy,
                                            torch.where(is_arrow, avy, rdy)))

  # Target-cell attributes.
  occ0 = (T > 0) | pending
  moving = (mvx != 0) | (mvy != 0)
  pdir = torch.where(mvx == -1, 0, torch.where(
      mvx == 1, 1, torch.where(mvy == -1, 2, 3)))
  bound = (x >= 1, x <= w - 2, y >= 1, y <= h - 2)
  tmat = torch.zeros_like(M)
  tocc = torch.zeros_like(pending)
  inside_t = torch.zeros_like(pending)
  for d in range(4):
    sel = moving & (pdir == d)
    tmat = torch.where(sel, _pull(M, d), tmat)
    tocc = tocc | (sel & _pull(occ0, d))
    inside_t = inside_t | (sel & bound[d])
  tmat = torch.where(moving, tmat, M)
  tocc = (moving & tocc) | (~moving & occ0)
  inside_t = inside_t | ~moving

  # Arrow impacts (objects.py:373-384), applied before the move.
  arrow_live = is_arrow & active
  a_hit = arrow_live & tocc
  a_block = arrow_live & ~a_hit & ~_mat_in(tmat, tab['walk_arrow'])
  smash_src = a_block & ((tmat == rules.MAT_TABLE)
                         | (tmat == rules.MAT_FURNACE))
  dmg = torch.zeros_like(M)
  smash = torch.zeros_like(pending)
  for d in range(4):
    along = F == d
    dmg = dmg + 2 * _push(a_hit & along, d).to(torch.int32)
    smash = smash | _push(smash_src & along, d)
  a_fly = arrow_live & ~a_hit & ~a_block
  player_dmg = dmg.reshape(dmg.shape[0], -1).gather(
      1, (px * h + py).reshape(-1, 1).long())[:, 0]
  Hp = (Hp - torch.where(T > rules.E_PLAYER, dmg, 0)).clamp_min(0)
  M = torch.where(smash, rules.MAT_PATH, M)

  wants = active & ~dying & (
      (is_cow & cow_wants) | is_zom | (is_skel & skel_wants) | a_fly)
  walk_ok = torch.where(is_arrow, _mat_in(tmat, tab['walk_arrow']),
                        _mat_in(tmat, tab['walk_mob']))
  feasible = inside_t & walk_ok & ~tocc
  valid = wants & feasible & moving

  # Plants grow, skeletons reload (objects.py:405-407, :320).
  reload = torch.where(active & is_skel, (A - 1).clamp_min(0), A)
  A = torch.where(active & is_plant, A + 1, A)
  A = torch.where(is_skel, reload, A)

  # Movement: each target takes the first claimant in direction order; the
  # winner's channels travel with it.
  winner = torch.full_like(M, -1)
  for d in range(4):
    claims = _push(valid & (pdir == d), d)
    winner = torch.where((winner < 0) & claims, d, winner)
  T1, F1, H1, A1 = T, F, Hp, A
  for d in range(4):
    won = winner == d
    T1 = torch.where(won, _push(T, d), T1)
    F1 = torch.where(won, _push(F & 3, d), F1)
    H1 = torch.where(won, _push(Hp, d), H1)
    A1 = torch.where(won, _push(A & 15, d), A1)
  success = torch.zeros_like(pending)
  for d in range(4):
    success = success | (_pull(winner == d, d) & valid & (pdir == d))
  T1 = torch.where(success, 0, T1)

  # Skeleton shooting decision (objects.py:330-351).
  s_moved = (dying & retreat & feasible) | (~dying & retreat & success)
  shoot = active & is_skel & ~s_moved & c_shoot & (reload == 0)
  shvx = torch.where(x_longer, sgnx, 0)
  shvy = torch.where(x_longer, 0, sgny)

  # Zombie melee (objects.py:302-312), post-move.
  z_adj = (T1 == rules.E_ZOMBIE) & (pdist <= 1)
  z_att = z_adj & (A1 == 0)
  A1 = torch.where(z_adj, torch.where(z_att, 5, A1 - 1), A1)
  zdmg = torch.where(z_att, torch.where(sleeping, 7, 2), 0)
  player_dmg = player_dmg + zdmg.flatten(1).sum(1, dtype=torch.int32)

  # Plant damage from adjacent mobs (objects.py:408-411).
  hostile = ((T1 == rules.E_COW) | (T1 == rules.E_ZOMBIE)
             | (T1 == rules.E_SKELETON))
  nbr_hostile = torch.zeros_like(pending)
  for d in range(4):
    nbr_hostile = nbr_hostile | _push(hostile, d)
  plant_hit = active & is_plant & nbr_hostile
  H1 = torch.where(plant_hit, (H1 - 1).clamp_min(0), H1)
  plant_dead = active & is_plant & (H1 <= 0)

  removed = dying | a_hit | a_block | plant_dead
  T1 = torch.where(removed, 0, T1)
  T1 = torch.where(pending, rules.E_PLANT, T1)
  H1 = torch.where(pending, 1, H1)
  A1 = torch.where(pending, 0, A1)

  # Arrow spawns (objects.py:344-351): the first shooter in direction order
  # takes a free, arrow-walkable cell; a shooter reloads on a real shot.
  spawn_free = (T1 == 0) & ~pending & _mat_in(M, tab['walk_arrow'])
  staken = torch.zeros_like(pending)
  arrow_ok_src = torch.zeros_like(pending)
  for d in range(4):
    spawn_d = shoot & (shvx == DIRS[d][0]) & (shvy == DIRS[d][1])
    win_d = _push(spawn_d, d) & spawn_free & ~staken
    staken = staken | win_d
    T1 = torch.where(win_d, rules.E_ARROW, T1)
    H1 = torch.where(win_d, 0, H1)
    A1 = torch.where(win_d, 0, A1)
    F1 = torch.where(win_d, d, F1)
    arrow_ok_src = arrow_ok_src | (_pull(win_d, d) & spawn_d)
  A1 = torch.where(arrow_ok_src, 4, A1)
  return M, T1, H1, A1, F1, player_dmg


# ---------------------------------------------------------------------------
# The group of K ticks (step.py:step_group_batch).
# ---------------------------------------------------------------------------


def _unpack(states: State, cfg: EnvConfig):
  """A state as the int32 working set of a tick: the five (N, W, H) grids
  (copies), the player scalars, inventory and achievements."""
  w, h = cfg.area
  n = states.step.shape[0]
  i32 = lambda v: v.to(torch.int32)
  grid = lambda v: i32(v).reshape(n, w, h).clone()
  grids = (grid(states.mat_map), grid(states.ent.etype),
           grid(states.ent.health), grid(states.ent.aux),
           grid(states.ent.facing))
  p = states.player
  scal = (i32(p.facing), i32(p.pos[:, 0]), i32(p.pos[:, 1]),
          p.sleeping.clone(), i32(p.hunger), i32(p.thirst), i32(p.fatigue),
          i32(p.recover), i32(p.last_health))
  return grids, scal, i32(p.inventory), i32(p.achievements)


def _repack(states: State, grids, scal, inv, ach, **fields) -> State:
  """The inverse of :func:`_unpack`, narrowing to the storage dtypes."""
  M, T, Hp, A, F = grids
  fac, px, py, slp, hu, th, fa, re, lh = scal
  n = M.shape[0]
  narrow = lambda g, ref: g.reshape(n, -1).to(ref.dtype)
  player = Player(pos=torch.stack([px, py], 1), facing=fac, inventory=inv,
                  achievements=ach, sleeping=slp, hunger=hu, thirst=th,
                  fatigue=fa, recover=re, last_health=lh)
  return dataclasses.replace(
      states, mat_map=narrow(M, states.mat_map),
      ent=EntMaps(etype=narrow(T, states.ent.etype),
                  health=narrow(Hp, states.ent.health),
                  aux=narrow(A, states.ent.aux),
                  facing=narrow(F, states.ent.facing)),
      player=player, **fields)


def _tick_core(grids, scal, inv, ach, action, s_player, s_mob,
               cfg: EnvConfig):
  """One tick of player phase + mob phase, the mob damage taken off the
  inventory's health.  Returns ``(grids, scal, inv, ach)``."""
  M, T, Hp, A, F = grids
  n = M.shape[0]
  flat = lambda g: g.view(n, -1)
  fac, px, py, slp, hu, th, fa, re, lh = scal
  (px, py, fac, slp, hu, th, fa, re, lh, inv, ach, plant_idx) = \
      player_core(flat(M), flat(T), flat(Hp), flat(A), action.to(torch.int32),
                  fac, px, py, slp, hu, th, fa, re, lh, inv, ach, s_player,
                  cfg)
  M, T, Hp, A, F, dmg = mob_core(M, T, Hp, A, F, px, py, slp, s_mob,
                                 plant_idx, cfg)
  inv = inv.clone()
  inv[:, rules.ITEM_HEALTH] = (inv[:, rules.ITEM_HEALTH] - dmg).clamp_min(0)
  return ((M, T, Hp, A, F), (fac, px, py, slp, hu, th, fa, re, lh), inv, ach)


def _reward_done(inv, ach, unl, elh, step_t, cfg: EnvConfig):
  """Reward, done and dead of a tick (env.py:97-107), with the updated
  unlocked flags and reward memory."""
  hp = inv[:, rules.ITEM_HEALTH]
  new_unlock = ((ach > 0) & ~unl).any(1)
  # (hp - elh) / 10 + bonus, fused as XLA fuses the reference.
  reward = fma32((hp - elh).to(torch.float32), INV10,
                 torch.where(new_unlock, 1.0, 0.0))
  dead = hp <= 0
  done = dead | (step_t >= cfg.length) if cfg.length else dead
  return reward, done, dead, unl | (ach > 0), hp


def tick_plain(states: State, actions: torch.Tensor, s_player: torch.Tensor,
               s_mob: torch.Tensor, cfg: EnvConfig) -> State:
  """One tick of player phase + mob phase for every env, given the tick's
  two seeds (N,) int32 (``_tick_pallas``'s function): planes and player
  updated, the mob damage applied to inventory health; step, reward memory
  and unlocked flags untouched (:func:`finish_tick` does those)."""
  grids, scal, inv, ach = _tick_core(*_unpack(states, cfg), actions,
                                     s_player, s_mob, cfg)
  return _repack(states, grids, scal, inv, ach)


def step_group_plain(states: State, actions: torch.Tensor, cfg: EnvConfig,
                     snapshots: bool = False):
  """K = ``actions.shape[0]`` ticks of every env, without balance or reset.

  ``actions`` (K, N) int.  Returns ``(states, raw, occ_pre)`` as
  ``step_group_batch`` does: ``raw`` holds (K, N) per-tick results before
  latching, ``occ_pre`` (N, C) uint8 is the OR of post-tick occupancy over
  ticks 0..K-2.  With ``snapshots`` a :class:`GroupSnaps` of the state after
  each tick t < K-1 follows.
  """
  from . import render as render_lib
  k, n = actions.shape
  if snapshots and k < 2:
    raise ValueError('snapshots need a group of at least 2 ticks')
  grids, scal, inv, ach = _unpack(states, cfg)
  elh = states.env_last_health.to(torch.int32)
  unl = states.unlocked
  step0 = states.step.to(torch.int32)
  k0, k1 = key_words_i32(states.key)
  occ = torch.zeros_like(grids[1])
  rews, dones, deads, snaps = [], [], [], []
  for t in range(k):
    step_t = step0 + (t + 1)
    base = fmix(k0 ^ fmix(k1 + step_t * i32c(0x9E3779B9)))
    s_mob = fmix(base + i32c(0x85EBCA6B))
    grids, scal, inv, ach = _tick_core(grids, scal, inv, ach, actions[t],
                                       base, s_mob, cfg)
    reward, done, dead, unl, elh = _reward_done(inv, ach, unl, elh, step_t,
                                                cfg)
    rews.append(reward)
    dones.append(done)
    deads.append(dead)
    if t < k - 1:
      occ = occ | grids[1]
      if snapshots:
        M, T, _, A, F = (g.reshape(n, -1) for g in grids)
        snaps.append((render_lib.pack_cells(M, T, A, F), scal[1], scal[2],
                      scal[0], scal[3].to(torch.int32), inv))
  states = _repack(states, grids, scal, inv, ach, step=step0 + k,
                   env_last_health=elh, unlocked=unl)
  done = torch.stack(dones)
  raw = StepOut(reward=torch.stack(rews), done=done, dead=torch.stack(deads),
                ended=done)
  occ_pre = (occ != 0).reshape(n, -1).to(torch.uint8)
  if not snapshots:
    return states, raw, occ_pre
  cols = [torch.stack(col) for col in zip(*snaps)]
  packed = torch.cat([cols[0], torch.empty_like(cols[0][:1])])
  return states, raw, occ_pre, GroupSnaps(packed, *cols[1:])


# ---------------------------------------------------------------------------
# The single tick (step.py:step_batch, _finish_tick).
# ---------------------------------------------------------------------------


def finish_tick(states: State, s_balance: torch.Tensor, cfg: EnvConfig,
                balance: bool | None):
  """Chunk balancing when asked, the touched-chunk update, reward and done
  of a tick (``_finish_tick`` for a batch).  ``balance=None`` balances the
  envs whose step is a multiple of ``cfg.balance_every``, by a select."""
  if balance is None or balance:
    balanced = balance_plain(states, s_balance, None, cfg)
    if balance is None:
      due = states.step % cfg.balance_every == 0
      pick = lambda new, old: torch.where(
          due.reshape((-1,) + (1,) * (old.ndim - 1)), new, old)
      ent = dataclasses.replace(
          states.ent, etype=pick(balanced.ent.etype, states.ent.etype),
          health=pick(balanced.ent.health, states.ent.health),
          aux=pick(balanced.ent.aux, states.ent.aux))
      balanced = dataclasses.replace(
          states, ent=ent, chunk_touched=pick(balanced.chunk_touched,
                                              states.chunk_touched))
    states = balanced
  # Chunks that hold an entity count as touched from now on (the
  # reference's defaultdict keys, engine.py:36, :57, :78-79).
  n = states.step.shape[0]
  chunk, _, _ = _chunk_layout(cfg, str(states.mat_map.device))
  ncx, ncy = cfg.n_chunks
  held = torch.zeros((n, ncx * ncy), dtype=torch.int32,
                     device=states.mat_map.device)
  held.index_add_(1, chunk, (states.ent.etype > 0).to(torch.int32))
  touched = states.chunk_touched | (held > 0).reshape(n, ncx, ncy)
  reward, done, dead, unl, hp = _reward_done(
      states.player.inventory, states.player.achievements, states.unlocked,
      states.env_last_health, states.step, cfg)
  states = dataclasses.replace(states, env_last_health=hp, unlocked=unl,
                               chunk_touched=touched)
  return states, StepOut(reward=reward, done=done, dead=dead, ended=done)


def step_batch(states: State, actions: torch.Tensor, cfg: EnvConfig,
               balance: bool | None = None):
  """One simulation tick of every env (env.py:83-118): ``actions`` (N,).

  ``balance``: None balances each env on its own cadence (every
  ``cfg.balance_every``-th step of the env); True / False force the phase
  on / off for this tick.  The tick itself is the tick kernel
  (``cfg.engine == 'plain'``: its twin :func:`tick_plain`).  Returns
  ``(states, out)`` with (N,) StepOut leaves.
  """
  step_ = states.step + 1
  s_player, s_mob, s_balance = tick_seeds(states.key, step_)
  states = dataclasses.replace(states, step=step_)
  states = tick_plain(states, actions, s_player, s_mob, cfg)
  return finish_tick(states, s_balance, cfg, balance)


# ---------------------------------------------------------------------------
# Group-end chunk balancing (step.py:_balance_core, env.py:141-179).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _chunk_layout(cfg: EnvConfig, device: str):
  """Cell -> chunk index (C,), and the permutation that lists cells chunk
  by chunk, x-major inside each chunk, with each chunk's start offset."""
  w, h = cfg.area
  (csx, csy), (ncx, ncy) = cfg.chunk_size, cfg.n_chunks
  xs, ys = np.divmod(np.arange(w * h), h)
  chunk = (xs // csx) * ncy + ys // csy
  order = np.argsort(chunk, kind='stable')
  starts = np.searchsorted(chunk[order], np.arange(ncx * ncy))
  as_t = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
  return as_t(chunk), as_t(order), as_t(starts)


def balance_core(M, T, Hp, A, occ, touched, light, px, py, seed,
                 cfg: EnvConfig):
  """Chunk balancing on (N, C) int32 planes.

  ``touched`` (N, NCH) bool, ``light`` (N,) float32, ``px, py, seed`` (N,)
  int32.  Despawn then spawn picks for zombie / skeleton / cow; each pick
  is the r-th member of its chunk in x-major cell order, r drawn per
  chunk.  Returns ``(T', Hp', A', touched')``.
  """
  w, h = cfg.area
  (ncx, ncy) = cfg.n_chunks
  nch = ncx * ncy
  n = M.shape[0]
  dev = M.device
  chunk, order, starts = _chunk_layout(cfg, str(dev))

  def csum(mask):
    out = torch.zeros((n, nch), dtype=torch.int32, device=dev)
    return out.index_add_(1, chunk, mask.to(torch.int32))

  def rank(mask):
    """Inclusive member count up to each cell inside its chunk."""
    cs = torch.cumsum(mask[:, order].to(torch.int32), 1, dtype=torch.int32)
    before = torch.where(starts > 0, cs[:, (starts - 1).clamp_min(0)], 0)
    out = torch.empty_like(cs)
    out[:, order] = cs - before[:, chunk[order]]
    return out

  touched = touched | (csum(occ != 0) > 0)
  mem = [T == e for e in BAL_CLASSES] + [M == rules.MAT_GRASS,
                                         M == rules.MAT_PATH]
  counts = [csum(m) for m in mem]
  grass_n, path_n = counts[3], counts[4]

  light = light[:, None]
  dark = fma32(-3.0, light, 3.5)             # 3.5 - 3 * light
  zero = torch.zeros_like(light)
  tmin = [torch.where(grass_n < 50, zero, dark),
          torch.where(path_n < 6, zero, zero + 1.0),
          torch.where(grass_n < 30, zero, zero + 1.0)]
  tmax = [zero + dark, zero + 2.0, zero + (1.5 + light)]
  gl = torch.arange(nch, dtype=torch.int32, device=dev)[None]
  seed = seed[:, None]

  def draw(j):
    return u24(fmix(fmix(seed + i32c(0x27D4EB2F) * j)))

  want_spawn, want_despawn = [], []
  for i in range(len(BAL_CLASSES)):
    ws = (touched & (counts[i] < tmin[i].to(torch.int32))
          & (draw(gl * 6 + (i * 2 + 1)) < BAL_SPAWN_P[i]))
    want_spawn.append(ws)
    want_despawn.append(
        touched & ~ws & (counts[i] > tmax[i].to(torch.int32))
        & (draw(gl * 6 + (i * 2 + 2)) < BAL_DESPAWN_P[i]))

  def rdraw(j, cnt):
    u = draw(6 * nch + 1 + gl * 6 + j)
    return torch.minimum(torch.floor(u * cnt.to(torch.float32)),
                         (cnt - 1).to(torch.float32)).to(torch.int32)

  pick_mem = [0, 1, 2] + list(SPAWN_MEM)
  r = [rdraw(j, counts[m]) for j, m in enumerate(pick_mem)]
  pref = [rank(m) for m in mem]
  xs = torch.arange(w * h, dtype=torch.int32, device=dev)[None]
  pdist = ((torch.div(xs, h, rounding_mode='floor') - px[:, None]).abs()
           + (xs % h - py[:, None]).abs())

  def pick(j, want):
    m = pick_mem[j]
    return (mem[m] & (pref[m] - 1 == r[j][:, chunk])
            & want[:, chunk])

  despawn = torch.zeros_like(mem[0])
  for i in range(len(BAL_CLASSES)):
    despawn = despawn | (pick(i, want_despawn[i]) & (pdist >= BAL_DESPAN[i]))
  T1 = torch.where(despawn & (T > rules.E_PLAYER), 0, T)
  Hp1, A1 = Hp, A
  for i, etype in enumerate(BAL_CLASSES):
    ok = pick(3 + i, want_spawn[i]) & (pdist >= BAL_SPAN[i]) & (T1 == 0)
    T1 = torch.where(ok, etype, T1)
    Hp1 = torch.where(ok, TYPE_HEALTH[etype], Hp1)
    A1 = torch.where(ok, 0, A1)
  touched = touched | (csum(T1 > 0) > 0)
  return T1, Hp1, A1, touched


def balance_plain(states: State, seeds: torch.Tensor,
                  occ_pre: torch.Tensor | None, cfg: EnvConfig) -> State:
  """Chunk balance of a batch (``_balance_pallas``'s function, and
  ``_balance_apply``'s): ``seeds`` (N,) int32 balance seeds, ``occ_pre``
  (N, C) occupancy OR of a group's earlier ticks, or None for none."""
  n = states.step.shape[0]
  if occ_pre is None:
    occ_pre = torch.zeros_like(states.ent.etype)
  ncx, ncy = cfg.n_chunks
  i32 = lambda v: v.to(torch.int32)
  light = state_lib.daylight(states.step, cfg.day_length)
  T1, H1, A1, tc = balance_core(
      i32(states.mat_map), i32(states.ent.etype), i32(states.ent.health),
      i32(states.ent.aux), i32(occ_pre),
      states.chunk_touched.reshape(n, ncx * ncy), light,
      i32(states.player.pos[:, 0]), i32(states.player.pos[:, 1]),
      i32(seeds), cfg)
  ent = dataclasses.replace(states.ent, etype=T1.to(torch.uint8),
                            health=H1.to(torch.uint8),
                            aux=A1.to(torch.int16))
  return dataclasses.replace(states, ent=ent,
                             chunk_touched=tc.reshape(n, ncx, ncy))
