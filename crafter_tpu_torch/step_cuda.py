"""Wrappers of the group-tick and balance kernels (``csrc/group_tick.cu``,
``csrc/balance.cu``).

* :func:`group_tick` replaces ``crafter_tpu/step.py:step_group_batch``
  (without render snapshots); plain twin ``step.step_group_plain``.
* :func:`balance` replaces ``crafter_tpu/step.py:_balance_pallas``; plain
  twin ``step.balance_plain``.

For CUDA tensors each wrapper launches its kernel; for CPU tensors it runs
the twin.  ``group_tick.launches`` / ``balance.launches`` count launches.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _build, rules
from . import state as state_lib
from . import step as step_lib
from .config import EnvConfig
from .state import EntMaps, Player, State

# Per-env int32 record the group kernel reads and writes (REC words):
# player scalars, step, reward memory, key words, inventory, achievements,
# unlocked flags.
REC_SCALARS = ('facing', 'px', 'py', 'sleeping', 'hunger', 'thirst',
               'fatigue', 'recover', 'last_health', 'step',
               'env_last_health', 'key0', 'key1')
REC = len(REC_SCALARS) + rules.N_ITEMS + 2 * rules.N_ACHIEVEMENTS
RULES_WORDS = 675   # length of the rules blob the kernel expects


def _mask(rows) -> np.ndarray:
  rows = np.atleast_2d(np.asarray(rows, bool))
  return np.asarray([sum(1 << int(m) for m in np.flatnonzero(r))
                     for r in rows], np.int32)


@functools.lru_cache(maxsize=None)
def _rules_blob(device: str) -> torch.Tensor:
  """The rule tables flattened in the order of group_tick.cu's offsets."""
  t = rules.TABLES
  i32 = lambda a: np.asarray(a, np.int32).reshape(-1)
  parts = [
      i32(t.item_max),                               # 0
      _mask(t.walkable_player), _mask(t.walkable_mob),  # 16, 17
      _mask(t.walkable_arrow), _mask(t.collectible),  # 18, 19
      i32(t.collect_require), i32(t.collect_receive),  # 20, 228
      i32(t.collect_leaves),                          # 436
      np.asarray(t.collect_prob, np.float32).view(np.int32),  # 449
      i32(t.collect_ach),                             # 462
      i32(t.place_uses), _mask(t.place_where),        # 475, 539
      i32(t.place_is_material), i32(t.place_material),  # 543, 547
      i32(t.place_ach),                               # 551
      i32(t.make_uses), _mask(t.make_nearby),         # 555, 651
      i32(t.make_gives_item), i32(t.make_gives_count),  # 657, 663
      i32(t.make_ach),                                # 669
  ]
  blob = np.concatenate(parts)
  if blob.size != RULES_WORDS:
    raise ValueError(f'rules blob has {blob.size} words, the kernel '
                     f'expects {RULES_WORDS}')
  return torch.as_tensor(blob, device=device)


def _stream(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def _contig(*ts):
  return [t.contiguous() for t in ts]


def group_tick(states: State, actions: torch.Tensor, cfg: EnvConfig):
  """K fused ticks; returns ``(states, raw, occ_pre)`` as
  ``step.step_group_plain`` does."""
  if not states.mat_map.is_cuda:
    return step_lib.step_group_plain(states, actions, cfg)
  out = _launch_group_tick(states, actions, cfg)
  group_tick.launches += 1
  return out


group_tick.launches = 0


def _launch_group_tick(states: State, actions: torch.Tensor, cfg: EnvConfig):
  w, h = cfg.area
  c = w * h
  k, n = actions.shape
  dev = states.mat_map.device
  p = states.player
  k0, k1 = step_lib.key_words_i32(states.key)
  col = lambda v: v.to(torch.int32).reshape(n, 1)
  rec_in = torch.cat(
      [col(p.facing), col(p.pos[:, 0]), col(p.pos[:, 1]), col(p.sleeping),
       col(p.hunger), col(p.thirst), col(p.fatigue), col(p.recover),
       col(p.last_health), col(states.step), col(states.env_last_health),
       col(k0), col(k1), p.inventory.to(torch.int32),
       p.achievements.to(torch.int32), states.unlocked.to(torch.int32)], 1)
  planes = _contig(states.mat_map, states.ent.etype, states.ent.health,
                   states.ent.aux, states.ent.facing)
  for pl, dt in zip(planes, (torch.uint8, torch.uint8, torch.uint8,
                             torch.int16, torch.uint8)):
    if pl.dtype != dt or pl.shape != (n, c):
      raise TypeError(f'plane {pl.dtype} {tuple(pl.shape)}: want {dt} '
                      f'({n}, {c})')
  acts = actions.to(torch.int32).contiguous()
  outs = [torch.empty_like(pl) for pl in planes]
  occ = torch.empty((n, c), dtype=torch.uint8, device=dev)
  rec_out = torch.empty_like(rec_in)
  reward = torch.empty((k, n), dtype=torch.float32, device=dev)
  done = torch.empty((k, n), dtype=torch.bool, device=dev)
  dead = torch.empty((k, n), dtype=torch.bool, device=dev)
  lib = _build.library()
  ptrs = [t.data_ptr() for t in (*planes, acts, rec_in, _rules_blob(str(dev)),
                                 *outs, occ, rec_out, reward, done, dead)]
  _build.check(lib.crafter_group_tick(
      *ptrs, n, k, w, h, int(cfg.length or 0), cfg.update_distance,
      _stream(acts)), 'group_tick')

  s = len(REC_SCALARS)
  ni, na = rules.N_ITEMS, rules.N_ACHIEVEMENTS
  r = lambda name: rec_out[:, REC_SCALARS.index(name)]
  player = Player(
      pos=torch.stack([r('px'), r('py')], 1), facing=r('facing'),
      inventory=rec_out[:, s:s + ni].clone(),
      achievements=rec_out[:, s + ni:s + ni + na].clone(),
      sleeping=r('sleeping') != 0, hunger=r('hunger'), thirst=r('thirst'),
      fatigue=r('fatigue'), recover=r('recover'),
      last_health=r('last_health'))
  states = dataclasses.replace(
      states, mat_map=outs[0],
      ent=EntMaps(etype=outs[1], health=outs[2], aux=outs[3],
                  facing=outs[4]),
      player=player, step=r('step'), env_last_health=r('env_last_health'),
      unlocked=rec_out[:, s + ni + na:] != 0)
  raw = step_lib.StepOut(reward=reward, done=done, dead=dead, ended=done)
  return states, raw, occ


def balance(states: State, seeds: torch.Tensor, occ_pre: torch.Tensor,
            cfg: EnvConfig) -> State:
  """Group-end chunk balancing; as ``step.balance_plain``."""
  if not states.mat_map.is_cuda:
    return step_lib.balance_plain(states, seeds, occ_pre, cfg)
  out = _launch_balance(states, seeds, occ_pre, cfg)
  balance.launches += 1
  return out


balance.launches = 0


def _launch_balance(states: State, seeds: torch.Tensor,
                    occ_pre: torch.Tensor, cfg: EnvConfig) -> State:
  w, h = cfg.area
  (csx, csy), (ncx, ncy) = cfg.chunk_size, cfg.n_chunks
  n = states.step.shape[0]
  dev = states.mat_map.device
  light = state_lib.daylight(states.step, cfg.day_length)
  i32 = lambda v: v.to(torch.int32).contiguous()
  ins = _contig(states.mat_map, states.ent.etype, states.ent.health,
                states.ent.aux, occ_pre.to(torch.uint8),
                states.chunk_touched.reshape(n, ncx * ncy))
  ins += [light.contiguous(), i32(states.player.pos[:, 0]),
          i32(states.player.pos[:, 1]), i32(seeds)]
  etype = torch.empty_like(ins[1])
  health = torch.empty_like(ins[2])
  aux = torch.empty_like(ins[3])
  touched = torch.empty_like(ins[5])
  lib = _build.library()
  _build.check(lib.crafter_balance(
      *[t.data_ptr() for t in (*ins, etype, health, aux, touched)],
      n, w, h, csx, csy, ncx, ncy, _stream(etype)), 'balance')
  return dataclasses.replace(
      states, ent=dataclasses.replace(states.ent, etype=etype, health=health,
                                      aux=aux),
      chunk_touched=touched.reshape(n, ncx, ncy))
