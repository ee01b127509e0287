"""The batched env loop of the plain reference: reset, a balance-cadence
group of ticks and a single tick, each with the partial-batch auto-reset
pass.

The semantics are the port's (``crafter_tpu_torch/env.py``): the first
``reset_batch`` finished envs by index get a fresh world from their home
key and next episode number, the rest stay ``pending``.  Only the worlds of
the selected envs are made, in chunks, and everything runs in plain
PyTorch on whatever device the state is on.
"""

from __future__ import annotations

import dataclasses

import torch

from . import prng, rules
from . import step as step_lib
from . import worldgen
from .config import EnvConfig
from .state import EntMaps, Player, State

WORLD_CHUNK = 512   # worlds a worldgen call, which bounds its temporaries


@dataclasses.dataclass
class VecState:
  env: State
  episode: torch.Tensor   # (N,) int32
  home_key: torch.Tensor  # (N, 2) int64
  tick: torch.Tensor      # () int32, on the host
  pending: torch.Tensor   # (N,) bool


def home_keys(seed: int, num_envs: int, device) -> torch.Tensor:
  return prng.fold_in(prng.key(seed, device)[None].expand(num_envs, 2),
                      torch.arange(num_envs, device=device))


def generate_worlds(keys: torch.Tensor, cfg: EnvConfig) -> State:
  """``worldgen.generate_world`` in chunks of :data:`WORLD_CHUNK` keys."""
  parts = [worldgen.generate_world(keys[i:i + WORLD_CHUNK], cfg)
           for i in range(0, keys.shape[0], WORLD_CHUNK)]
  return cat_states(parts)


def cat_states(parts):
  if len(parts) == 1:
    return parts[0]

  def cat(*xs):
    if dataclasses.is_dataclass(xs[0]):
      return type(xs[0])(**{f.name: cat(*(getattr(x, f.name) for x in xs))
                            for f in dataclasses.fields(xs[0])})
    return xs[0] if xs[0].ndim == 0 else torch.cat(xs)

  return cat(*parts)


def first_worlds(home_key: torch.Tensor, cfg: EnvConfig) -> State:
  """Episode 1 of each home key: the worlds a reset starts from."""
  return generate_worlds(prng.fold_in(home_key, 1), cfg)


def reset_pass(env: State, done: torch.Tensor, episode: torch.Tensor,
               home_key: torch.Tensor, cfg: EnvConfig, reset_batch: int):
  n = done.shape[0]
  dev = done.device
  rank = torch.cumsum(done.to(torch.int32), 0) - 1
  selected = done & (rank < reset_batch)
  idx = torch.nonzero(selected).reshape(-1)        # in rank order
  if idx.numel() == 0:
    return env, episode, done
  ep_next = episode + 1
  fresh = generate_worlds(prng.fold_in(home_key[idx], ep_next[idx]), cfg)
  take = rank.clamp(0, idx.numel() - 1).long()

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


def step_group(vs: VecState, actions: torch.Tensor, cfg: EnvConfig,
               reset_batch: int, env_chunk: int = 8192):
  """One balance-cadence group: K ticks, the group-end balance and one
  reset pass.  ``actions`` (K, N).  The ticks and the balance run
  ``env_chunk`` envs at a time (envs do not interact there).  Returns
  ``(vs, outs)``, ``outs`` a :class:`step.StepOut` of (K, N) leaves."""
  n = actions.shape[1]
  envs, raws, occs = [], [], []
  for i in range(0, n, env_chunk):
    part = _rows(vs.env, slice(i, i + env_chunk))
    env, raw, occ = step_lib.step_group_plain(part, actions[:, i:i + env_chunk],
                                              cfg)
    s_bal = step_lib.tick_seeds(env.key, env.step)[2]
    envs.append(step_lib.balance_plain(env, s_bal, occ, cfg))
    raws.append(raw)
  env = cat_states(envs)
  raw = step_lib.StepOut(**{
      f.name: torch.cat([getattr(r, f.name) for r in raws], 1)
      for f in dataclasses.fields(step_lib.StepOut)})
  cum = torch.cumsum(raw.done.to(torch.int32), 0) > 0
  done = vs.pending[None] | cum
  prev = torch.cat([vs.pending[None], done[:-1]], 0)
  outs = dataclasses.replace(raw, done=done, ended=raw.done & ~prev)
  env, episode, pending = reset_pass(env, done[-1], vs.episode, vs.home_key,
                                     cfg, reset_batch)
  return VecState(env=env, episode=episode, home_key=vs.home_key,
                  tick=vs.tick + cfg.balance_every, pending=pending), outs


def step_tick(vs: VecState, actions: torch.Tensor, cfg: EnvConfig,
              reset_batch: int, reset_every: int = 1, balance=None):
  """One tick and a reset pass on every ``reset_every``-th tick.
  ``balance`` None balances on the global cadence (every
  ``cfg.balance_every``-th tick), True / False force it.  Returns ``(vs,
  out, stepped_env)``, ``stepped_env`` the state before the reset."""
  tick = vs.tick + 1
  if balance is None:
    balance = int(tick) % cfg.balance_every == 0
  env, out = step_lib.step_batch(vs.env, actions, cfg, balance=balance)
  stepped = env
  done = out.done | vs.pending
  out = dataclasses.replace(out, done=done, ended=out.done & ~vs.pending)
  if reset_every > 1 and int(tick) % reset_every != 0:
    episode, pending = vs.episode, done
  else:
    env, episode, pending = reset_pass(env, done, vs.episode, vs.home_key,
                                       cfg, reset_batch)
  return VecState(env=env, episode=episode, home_key=vs.home_key, tick=tick,
                  pending=pending), out, stepped


def _rows(tree, rows):
  if dataclasses.is_dataclass(tree):
    return type(tree)(**{f.name: _rows(getattr(tree, f.name), rows)
                         for f in dataclasses.fields(tree)})
  return tree[rows]
