"""Wrappers of the group-tick, tick and balance kernels
(``csrc/group_tick.cu``, ``csrc/balance.cu``).

* :func:`group_tick` replaces ``crafter_tpu/step.py:step_group_batch``,
  render snapshots included; plain twin ``step.step_group_plain``.
* :func:`tick` replaces ``crafter_tpu/step.py:_tick_pallas``; plain twin
  ``step.tick_plain``.
* :func:`balance` replaces ``crafter_tpu/step.py:_balance_pallas``; plain
  twin ``step.balance_plain``.

For CUDA tensors each wrapper launches its kernel; for CPU tensors it runs
the twin.  The wrappers are where the port makes that choice (with
``render_cuda``, ``ops/noise_cuda`` and ``prng``): their callers call them
on either device.  ``group_tick.launches`` / ``tick.launches`` /
``balance.launches`` count launches.  :func:`occupancy` reports how many
blocks of the group or tick kernel an SM holds.  ``group_tick(...,
geometry=(threads, min_blocks))`` launches a geometry variant of the group
kernel (``_build.library(geometry=...)``), the counterpart of
``step_group_batch(..., block=)``; it gives the same results.
"""

from __future__ import annotations

import ctypes
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


rules.on_override(_rules_blob.cache_clear)


def _stream(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def _contig(*ts):
  return [t.contiguous() for t in ts]


# The state's tensors the kernels read the record from, in record order
# (group_tick.cu:RecIn): (owner, field, words).
REC_FIELDS = (('player', 'facing', 1), ('player', 'pos', 2),
              ('player', 'sleeping', 1), ('player', 'hunger', 1),
              ('player', 'thirst', 1), ('player', 'fatigue', 1),
              ('player', 'recover', 1), ('player', 'last_health', 1),
              ('state', 'step', 1), ('state', 'env_last_health', 1),
              ('state', 'key', 2), ('player', 'inventory', rules.N_ITEMS),
              ('player', 'achievements', rules.N_ACHIEVEMENTS),
              ('state', 'unlocked', rules.N_ACHIEVEMENTS))
_KIND = {torch.int32: 0, torch.bool: 1, torch.uint8: 1, torch.int64: 2}


def _record_in(states: State):
  """Where the kernels read each env's record (group_tick.cu:RecIn, three
  int64 words a field: pointer, stride between envs, element kind) and the
  tensors to keep alive until the launch: the state's own, converted only
  where their type or layout is not one the kernels read."""
  n = states.step.shape[0]
  words, keep = [], []
  for owner, name, width in REC_FIELDS:
    t = getattr(states.player if owner == 'player' else states, name)
    if t.dtype not in _KIND:
      t = t.to(torch.int32)
    if t.shape[0] != n or t.numel() != n * width:
      raise TypeError(f'{name} {tuple(t.shape)}: want {n} envs of {width}')
    if t.dim() == 2 and t.stride(1) != 1:
      t = t.contiguous()
    words += (t.data_ptr(), t.stride(0), _KIND[t.dtype])
    keep.append(t)
  return (ctypes.c_longlong * len(words))(*words), keep


def _planes(states: State, cfg: EnvConfig):
  """The five channel planes, checked and contiguous."""
  n, c = states.step.shape[0], cfg.area[0] * cfg.area[1]
  planes = _contig(states.mat_map, states.ent.etype, states.ent.health,
                   states.ent.aux, states.ent.facing)
  for pl, dt in zip(planes, (torch.uint8, torch.uint8, torch.uint8,
                             torch.int16, torch.uint8)):
    if pl.dtype != dt or pl.shape != (n, c):
      raise TypeError(f'plane {pl.dtype} {tuple(pl.shape)}: want {dt} '
                      f'({n}, {c})')
  return planes


def _state_from(states: State, outs, rec_out: torch.Tensor, **fields) -> State:
  """The state after a kernel: its output planes, and the player as views
  of the record it wrote."""
  s = len(REC_SCALARS)
  ni, na = rules.N_ITEMS, rules.N_ACHIEVEMENTS
  r = lambda name: rec_out[:, REC_SCALARS.index(name)]
  px = REC_SCALARS.index('px')
  player = Player(
      pos=rec_out[:, px:px + 2], facing=r('facing'),
      inventory=rec_out[:, s:s + ni],
      achievements=rec_out[:, s + ni:s + ni + na],
      sleeping=r('sleeping') != 0, hunger=r('hunger'), thirst=r('thirst'),
      fatigue=r('fatigue'), recover=r('recover'),
      last_health=r('last_health'))
  return dataclasses.replace(
      states, mat_map=outs[0],
      ent=EntMaps(etype=outs[1], health=outs[2], aux=outs[3],
                  facing=outs[4]),
      player=player, **fields)


def group_tick(states: State, actions: torch.Tensor, cfg: EnvConfig,
               snapshots: bool = False, geometry=None):
  """K fused ticks; returns ``(states, raw, occ_pre)``, and a
  ``step.GroupSnaps`` after them with ``snapshots``, as
  ``step.step_group_plain`` does.  ``geometry``: ``(threads, min_blocks)``
  of a variant build of the kernel, None for the shipped one; the plain
  twin has no geometry, so CPU tensors refuse one."""
  if not states.mat_map.is_cuda:
    if geometry is not None:
      raise ValueError('geometry is a build of the CUDA kernel; the plain '
                       'group step on the CPU has none')
    return step_lib.step_group_plain(states, actions, cfg, snapshots)
  out = _launch_group_tick(states, actions, cfg, snapshots, geometry)
  group_tick.launches += 1
  return out


group_tick.launches = 0


def _launch_group_tick(states: State, actions: torch.Tensor, cfg: EnvConfig,
                       snapshots: bool, geometry=None):
  w, h = cfg.area
  c = w * h
  k, n = actions.shape
  if snapshots and k < 2:
    raise ValueError('snapshots need a group of at least 2 ticks')
  dev = states.mat_map.device
  rec_in, keep = _record_in(states)
  planes = _planes(states, cfg)
  acts = actions.to(torch.int32).contiguous()
  outs = [torch.empty_like(pl) for pl in planes]
  occ = torch.empty((n, c), dtype=torch.uint8, device=dev)
  rec_out = torch.empty((n, REC), dtype=torch.int32, device=dev)
  reward = torch.empty((k, n), dtype=torch.float32, device=dev)
  done = torch.empty((k, n), dtype=torch.bool, device=dev)
  dead = torch.empty((k, n), dtype=torch.bool, device=dev)
  snaps = None
  if snapshots:
    col = lambda: torch.empty((k - 1, n), dtype=torch.int32, device=dev)
    snaps = step_lib.GroupSnaps(
        packed=torch.empty((k, n, c), dtype=torch.uint8, device=dev),
        px=col(), py=col(), facing=col(), sleeping=col(),
        inv=torch.empty((k - 1, n, rules.N_ITEMS), dtype=torch.int32,
                        device=dev))
  snap_ptrs = ([t.data_ptr() for _, t in state_lib.leaves(snaps)]
               if snapshots else [None] * 6)
  lib = _build.library(geometry)
  ptrs = [t.data_ptr() for t in (*planes, acts)]
  ptrs += [ctypes.addressof(rec_in)]
  ptrs += [t.data_ptr() for t in (_rules_blob(str(dev)), *outs, occ, rec_out,
                                  reward, done, dead)]
  _build.check(lib.crafter_group_tick(
      *ptrs, *snap_ptrs, n, k, w, h, int(cfg.length or 0),
      cfg.update_distance, _stream(acts)), 'group_tick')
  r = lambda name: rec_out[:, REC_SCALARS.index(name)]
  s = len(REC_SCALARS) + rules.N_ITEMS + rules.N_ACHIEVEMENTS
  states = _state_from(states, outs, rec_out, step=r('step'),
                       env_last_health=r('env_last_health'),
                       unlocked=rec_out[:, s:] != 0)
  raw = step_lib.StepOut(reward=reward, done=done, dead=dead, ended=done)
  if snapshots:
    return states, raw, occ, snaps
  return states, raw, occ


def tick(states: State, actions: torch.Tensor, s_player: torch.Tensor,
         s_mob: torch.Tensor, cfg: EnvConfig) -> State:
  """One tick of player phase + mob phase with the tick's seeds given; as
  ``step.tick_plain``."""
  if not states.mat_map.is_cuda:
    return step_lib.tick_plain(states, actions, s_player, s_mob, cfg)
  out = _launch_tick(states, actions, s_player, s_mob, cfg)
  tick.launches += 1
  return out


tick.launches = 0


def _launch_tick(states: State, actions, s_player, s_mob, cfg: EnvConfig):
  w, h = cfg.area
  n = states.step.shape[0]
  dev = states.mat_map.device
  cols = [v.to(torch.int32).contiguous() for v in (actions, s_player, s_mob)]
  for v in cols:
    if v.shape != (n,) or v.device != dev:
      raise ValueError(f'per-env column {tuple(v.shape)} on {v.device}: '
                       f'want ({n},) on {dev}')
  rec_in, keep = _record_in(states)
  planes = _planes(states, cfg)
  outs = [torch.empty_like(pl) for pl in planes]
  rec_out = torch.empty((n, REC), dtype=torch.int32, device=dev)
  lib = _build.library()
  ptrs = [t.data_ptr() for t in (*planes, *cols)]
  ptrs += [ctypes.addressof(rec_in)]
  ptrs += [t.data_ptr() for t in (_rules_blob(str(dev)), *outs, rec_out)]
  _build.check(lib.crafter_tick(*ptrs, n, w, h, cfg.update_distance,
                                _stream(rec_out)), 'tick')
  return _state_from(states, outs, rec_out)


def occupancy(cfg: EnvConfig, kernel: str = 'group',
              geometry=None) -> tuple[int, int]:
  """``(blocks per SM, shared bytes per block)`` of the group kernel
  (``kernel='group'``) or the tick kernel (``'tick'``) for ``cfg``'s area
  and update window, from the CUDA occupancy calculator; of the variant
  build of ``geometry`` when one is given."""
  blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
  w, h = cfg.area
  _build.check(_build.library(geometry).crafter_tick_occupancy(
      ('group', 'tick').index(kernel), w, h, cfg.update_distance,
      ctypes.byref(blocks), ctypes.byref(smem)), f'{kernel} occupancy')
  return blocks.value, smem.value


def balance_occupancy(cfg: EnvConfig) -> tuple[int, int]:
  """``(blocks per SM, shared bytes per block)`` of the balance kernel for
  ``cfg``'s area and chunks, from the CUDA occupancy calculator."""
  blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
  (w, h), (ncx, ncy) = cfg.area, cfg.n_chunks
  _build.check(_build.library().crafter_balance_occupancy(
      w, h, ncx * ncy, ctypes.byref(blocks), ctypes.byref(smem)),
      'balance occupancy')
  return blocks.value, smem.value


def balance(states: State, seeds: torch.Tensor,
            occ_pre: torch.Tensor | None, cfg: EnvConfig) -> State:
  """Chunk balancing (``occ_pre`` None: no earlier occupancy to fold in);
  as ``step.balance_plain``."""
  if not states.mat_map.is_cuda:
    return step_lib.balance_plain(states, seeds, occ_pre, cfg)
  out = _launch_balance(states, seeds, occ_pre, cfg)
  balance.launches += 1
  return out


balance.launches = 0


def _launch_balance(states: State, seeds: torch.Tensor,
                    occ_pre: torch.Tensor | None, cfg: EnvConfig) -> State:
  """One launch: the kernel reads the state in place (the player's
  position, the steps and the seeds with their strides; ``occ_pre`` None
  as a null pointer) and computes the light from the steps itself."""
  w, h = cfg.area
  (csx, csy), (ncx, ncy) = cfg.chunk_size, cfg.n_chunks
  n, c = states.step.shape[0], w * h
  dev = states.mat_map.device
  ent, pos = states.ent, states.player.pos
  # (name, tensor, dtypes, shape, must be contiguous)
  for name, t, dtypes, shape, dense in (
      ('mat_map', states.mat_map, (torch.uint8,), (n, c), True),
      ('etype', ent.etype, (torch.uint8,), (n, c), True),
      ('health', ent.health, (torch.uint8,), (n, c), True),
      ('aux', ent.aux, (torch.int16,), (n, c), True),
      ('occ_pre', occ_pre, (torch.uint8, torch.bool), (n, c), True),
      ('chunk_touched', states.chunk_touched, (torch.bool,), (n, ncx, ncy),
       True),
      ('step', states.step, (torch.int32,), (n,), False),
      ('pos', pos, (torch.int32,), (n, 2), False),
      ('seeds', seeds, (torch.int32,), (n,), False)):
    if t is None:
      continue
    if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != shape:
      raise TypeError(f'balance: {name} is {t.dtype} {tuple(t.shape)} on '
                      f'{t.device}; want {dtypes[0]} {shape} on {dev}')
    if dense and not t.is_contiguous():
      raise TypeError(f'balance: {name} must be contiguous')
  etype = torch.empty_like(ent.etype)
  health = torch.empty_like(ent.health)
  aux = torch.empty_like(ent.aux)
  touched = torch.empty_like(states.chunk_touched)
  ptrs = [t.data_ptr() for t in (states.mat_map, ent.etype, ent.health,
                                 ent.aux, etype, health, aux)]
  occ_ptr = None if occ_pre is None else occ_pre.data_ptr()
  # 16-byte loads and stores of a column's 16 cells where all allow them.
  vec = int(h % 16 == 0 and all(p % 16 == 0 for p in ptrs + [occ_ptr or 0]))
  _build.check(_build.library().crafter_balance(
      *ptrs[:4], occ_ptr, states.chunk_touched.data_ptr(),
      states.step.data_ptr(), states.step.stride(0), pos.data_ptr(),
      pos.stride(0), pos.stride(1), seeds.data_ptr(), seeds.stride(0),
      *ptrs[4:], touched.data_ptr(), n, w, h, csx, csy, ncx, ncy, vec,
      state_lib.inv_day(cfg.day_length), _stream(etype)), 'balance')
  return dataclasses.replace(
      states, ent=dataclasses.replace(ent, etype=etype, health=health,
                                      aux=aux),
      chunk_touched=touched)
