"""The batched engine loop: N envs stepped a balance-cadence group at a time,
with group-end chunk balancing and partial-batch auto-reset.

The port's counterpart of the state-only main path of ``crafter_tpu/env.py``
(``VecState``, ``home_keys``, ``vec_reset``, ``vec_reset_chunked``,
``vec_step_group``, ``_group_finish``, ``_reset_pass``).  For the same keys
and actions it produces the JAX package's states leaf for leaf.

``cfg.engine`` picks the group tick and balance backend ('auto':
the CUDA kernels for CUDA tensors, 'plain': the PyTorch twins);
``cfg.noise_mode`` the worldgen noise backend likewise.
"""

from __future__ import annotations

import dataclasses

import torch

from . import prng, rules
from . import step as step_lib
from . import step_cuda, worldgen
from .config import EnvConfig
from .state import EntMaps, Player, State


@dataclasses.dataclass
class VecState:
  """Batched env state plus per-env reset bookkeeping."""

  env: State
  episode: torch.Tensor   # (N,) int32 episodes started
  home_key: torch.Tensor  # (N, 2) int64 per-env base key words
  tick: torch.Tensor      # () int32 global tick counter
  pending: torch.Tensor   # (N,) bool finished but not yet reset


def home_keys(seed: int, num_envs: int, device='cuda') -> torch.Tensor:
  """Per-env base keys: ``fold_in(key(seed), i)`` for i < num_envs."""
  return prng.fold_in(prng.key(seed, device)[None].expand(num_envs, 2),
                      torch.arange(num_envs, device=device))


def vec_reset(home_key: torch.Tensor, cfg: EnvConfig) -> VecState:
  """Fresh worlds for a batch of home keys (episode 1 of each env)."""
  n = home_key.shape[0]
  dev = home_key.device
  env = worldgen.generate_world(prng.fold_in(home_key, 1), cfg)
  return VecState(env=env,
                  episode=torch.ones((n,), dtype=torch.int32, device=dev),
                  home_key=home_key,
                  tick=torch.zeros((), dtype=torch.int32, device=dev),
                  pending=torch.zeros((n,), dtype=torch.bool, device=dev))


def vec_reset_chunked(home_key: torch.Tensor, cfg: EnvConfig,
                      chunk: int = 512) -> VecState:
  """:func:`vec_reset` in slices of ``chunk`` envs, bounding the peak
  memory of worldgen's intermediates."""
  n = home_key.shape[0]
  pieces = [vec_reset(home_key[i:i + chunk], cfg) for i in range(0, n, chunk)]
  if len(pieces) == 1:
    return pieces[0]

  def cat(*xs):
    if dataclasses.is_dataclass(xs[0]):
      return type(xs[0])(**{f.name: cat(*(getattr(x, f.name) for x in xs))
                            for f in dataclasses.fields(xs[0])})
    return xs[0] if xs[0].ndim == 0 else torch.cat(xs)

  return cat(*pieces)


def vec_step_group(vs: VecState, actions: torch.Tensor, cfg: EnvConfig,
                   reset_batch: int):
  """One balance-cadence group (K = cfg.balance_every ticks): the fused
  group tick, then group-end balance and one reset pass.

  ``actions`` (K, N) int.  Returns ``(vs, outs)`` with (K, N) StepOut
  leaves.
  """
  k = cfg.balance_every
  if actions.shape[0] != k:
    raise ValueError(f'actions {tuple(actions.shape)}: want ({k}, N)')
  if cfg.engine == 'plain':
    env, raw, occ_pre = step_lib.step_group_plain(vs.env, actions, cfg)
  else:
    env, raw, occ_pre = step_cuda.group_tick(vs.env, actions, cfg)
  return _group_finish(vs, env, raw, occ_pre, cfg, reset_batch)


def _group_finish(vs: VecState, env: State, raw: step_lib.StepOut,
                  occ_pre: torch.Tensor, cfg: EnvConfig, reset_batch: int):
  """Latch dones, group-end balance, reset pass."""
  k = cfg.balance_every
  # done_t = pending_0 | any(raw_done_{<=t}); `ended` pulses once.
  cum = torch.cumsum(raw.done.to(torch.int32), 0) > 0
  done = vs.pending[None] | cum
  prev = torch.cat([vs.pending[None], done[:-1]], 0)
  outs = dataclasses.replace(raw, done=done, ended=raw.done & ~prev)
  s_bal = step_lib.tick_seeds(env.key, env.step)[2]
  if cfg.engine == 'plain':
    env = step_lib.balance_plain(env, s_bal, occ_pre, cfg)
  else:
    env = step_cuda.balance(env, s_bal, occ_pre, cfg)
  env, episode, pending = _reset_pass(env, done[-1], vs.episode,
                                      vs.home_key, cfg, reset_batch)
  vs = VecState(env=env, episode=episode, home_key=vs.home_key,
                tick=vs.tick + k, pending=pending)
  return vs, outs


def _reset_pass(env: State, done: torch.Tensor, episode: torch.Tensor,
                home_key: torch.Tensor, cfg: EnvConfig, reset_batch: int):
  """Replace up to ``reset_batch`` finished envs with fresh worlds.

  The first ``reset_batch`` finished envs by index reset (overflow waits
  for the next pass).  Worldgen always runs ``reset_batch`` worlds; rows
  with no env behind them generate a throwaway world from zero key data,
  as the JAX package does.  Fresh rows reach their envs by an index gather
  and a select, with no host synchronisation.
  """
  r = reset_batch
  n = done.shape[0]
  dev = done.device
  rank = torch.cumsum(done.to(torch.int32), 0) - 1
  selected = done & (rank < r)
  ep_next = episode + 1

  # Row j of the reset batch is the env of rank j (index n: no env).
  rows = torch.full((r + 1,), n, dtype=torch.long, device=dev)
  rows.scatter_(0, torch.where(selected, rank, r).long(),
                torch.arange(n, device=dev))
  rows = rows[:r]
  has_env = rows < n
  src = rows.clamp_max(n - 1)
  gk = torch.where(has_env[:, None], home_key[src], 0)
  gep = torch.where(has_env, ep_next[src], 0)
  fresh = worldgen.generate_world(prng.fold_in(gk, gep), cfg)

  take = rank.clamp(0, r - 1).long()      # env -> its fresh row

  def merge(old, new):
    sel = selected.reshape((n,) + (1,) * (old.ndim - 1))
    return torch.where(sel, new.index_select(0, take), old)

  def sel(const, old):
    s = selected.reshape((n,) + (1,) * (old.ndim - 1))
    return torch.where(s, torch.as_tensor(const, dtype=old.dtype,
                                          device=dev), old)

  tables = rules.TABLES
  init_hp = int(tables.item_initial[rules.ITEM_HEALTH])
  p = env.player
  env = State(
      mat_map=merge(env.mat_map, fresh.mat_map),
      ent=EntMaps(etype=merge(env.ent.etype, fresh.ent.etype),
                  health=merge(env.ent.health, fresh.ent.health),
                  aux=sel(0, env.ent.aux), facing=sel(0, env.ent.facing)),
      player=Player(
          pos=sel(list(cfg.center), p.pos),
          facing=sel(rules.DIR_DOWN, p.facing),
          inventory=sel(tables.item_initial.tolist(), p.inventory),
          achievements=sel(0, p.achievements),
          sleeping=sel(False, p.sleeping),
          hunger=sel(0, p.hunger), thirst=sel(0, p.thirst),
          fatigue=sel(0, p.fatigue), recover=sel(0, p.recover),
          last_health=sel(init_hp, p.last_health)),
      step=sel(0, env.step),
      key=merge(env.key, fresh.key),
      unlocked=sel(False, env.unlocked),
      env_last_health=sel(init_hp, env.env_last_health),
      chunk_touched=merge(env.chunk_touched, fresh.chunk_touched))
  episode = torch.where(selected, ep_next, episode)
  return env, episode, done & ~selected
