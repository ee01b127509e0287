"""The batched engine: N envs in lockstep with partial-batch auto-reset,
stepped a balance-cadence group at a time (state only, or with one frame a
tick) or a tick at a time.

The port's counterpart of ``crafter_tpu/env.py``: ``CrafterEnv`` (the
functional core over batched states), the reference's single-env Gym API
``Env`` with its gymnasium adapter ``GymnasiumEnv`` and
``register_gym_envs``, ``VecState``, ``home_keys``, ``vec_reset``,
``vec_reset_chunked``, the group paths ``vec_step_group`` and
``vec_step_group_obs``, the per-tick ``vec_step`` / ``vec_step_k`` and
``VecEnv``.  For the same keys and actions it produces the JAX package's
states, results and frames leaf for leaf.

``vec_step`` and ``VecEnv`` also run on a mesh of ranks
(:mod:`crafter_tpu_torch.parallel`), each rank holding its rows of the
batch: the reset pass then keeps the one-process rule, the first
``reset_batch`` finished envs by global index, as the JAX package's
GSPMD-sharded ``vec_step`` does.

``cfg.engine`` picks the backend of the tick, group tick, balance and
render ('auto': the CUDA kernels for CUDA tensors, 'plain': the PyTorch
twins); ``cfg.noise_mode`` the worldgen noise backend likewise.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import prng, rules
from . import render as render_lib
from . import state as state_lib
from . import step as step_lib
from . import step_cuda, worldgen
from .config import DEFAULT_CONFIG, EnvConfig
from .state import EntMaps, Player, State
from .utils import profiling

try:  # Mirror the reference's optional gym dependency (env.py:11-22).
  import gymnasium as _gym
  DiscreteSpace = _gym.spaces.Discrete
  BoxSpace = _gym.spaces.Box
  _GymBase = _gym.Env
except ImportError:  # the spaces as plain records
  DiscreteSpace = collections.namedtuple('DiscreteSpace', 'n')
  BoxSpace = collections.namedtuple('BoxSpace', 'low, high, shape, dtype')
  _GymBase = object


class CrafterEnv:
  """The functional env core over batched states: every state leaf, key and
  action has a leading env axis (a single ``(2,)`` key makes a batch of
  one)."""

  def __init__(self, cfg: EnvConfig = DEFAULT_CONFIG, device='cuda'):
    self.cfg = cfg
    self.device = torch.device(device)
    self.atlas = render_lib.bake_atlas(cfg.size, cfg.view, cfg.item_rows,
                                       self.device)

  @property
  def num_actions(self) -> int:
    return rules.N_ACTIONS

  def reset(self, key: torch.Tensor):
    """Fresh worlds from (N, 2) key words: ``(state, obs)``."""
    key = key.to(self.device)
    state = worldgen.generate_world(key.reshape(-1, 2), self.cfg)
    return state, self.observe(state)

  def step(self, state: State, action: torch.Tensor):
    """One tick, balance on each env's own cadence: ``(state, obs, reward,
    done, info)``."""
    state, out = step_lib.step_batch(state, action, self.cfg)
    reward = out.reward if self.cfg.reward else torch.zeros_like(out.reward)
    return state, self.observe(state), reward, out.done, self.info(state, out)

  def observe(self, state: State) -> torch.Tensor:
    """Frames (N, H, W, 3) uint8."""
    return render_lib.render(state, self.cfg, self.atlas, self.cfg.size)

  observe_batch = observe

  def observe_px(self, state: State) -> torch.Tensor:
    """Raw packed pixel lanes (N, C) int32 ``r | g<<8 | b<<16``."""
    return render_lib.render_px_fields(
        state.mat_map, state.ent.etype, state.ent.aux, state.ent.facing,
        state.player.pos, state.player.facing, state.player.sleeping,
        state.player.inventory, state.step, state.key, self.cfg, self.atlas)

  def info(self, state: State, out: step_lib.StepOut) -> dict:
    """The reference's info dict, as tensors (env.py:108-115)."""
    return dict(
        inventory=state.player.inventory,
        achievements=state.player.achievements,
        discount=1.0 - out.dead.to(torch.float32),
        semantic=state_lib.semantic_view(state, self.cfg).to(torch.uint8),
        player_pos=state.player.pos,
        reward=out.reward,
        ended=out.ended)


class Env:
  """Gym-compatible single env mirroring the reference constructor
  (crafter/env.py:27-29): area/view/size/reward/length/seed, on
  ``device``.  A batch of one through :class:`CrafterEnv`; observations,
  rewards and info come back on the host as numpy and Python values."""

  def __init__(self, area=(64, 64), view=(9, 9), size=(64, 64),
               reward=True, length=10000, seed=None, device='cuda'):
    view = tuple(view) if hasattr(view, '__len__') else (view, view)
    size = tuple(size) if hasattr(size, '__len__') else (size, size)
    seed = np.random.randint(0, 2 ** 31 - 1) if seed is None else seed
    self.cfg = EnvConfig(area=tuple(area), view=view, size=size,
                         reward=reward, length=length)
    self.device = torch.device(device)
    self._core = CrafterEnv(self.cfg, self.device)
    self._seed = seed
    self._episode = 0
    self._state: Optional[State] = None
    # Some libraries expect these attributes (env.py:54-56).
    self.reward_range = None
    self.metadata = None

  @property
  def observation_space(self):
    return BoxSpace(0, 255, tuple(self.cfg.size) + (3,), np.uint8)

  @property
  def action_space(self):
    return DiscreteSpace(rules.N_ACTIONS)

  @property
  def action_names(self):
    return list(rules.ACTIONS)

  def reset(self):
    self._episode += 1
    key = prng.fold_in(prng.key(self._seed, self.device), self._episode)
    self._state, obs = self._core.reset(key[None])
    return obs[0].cpu().numpy()

  def step(self, action):
    action = torch.tensor([int(action)], dtype=torch.int32,
                          device=self.device)
    self._state, obs, reward, done, info = self._core.step(self._state,
                                                           action)
    info = {name: value[0].cpu().numpy() for name, value in info.items()}
    info = {
        'inventory': {name: int(info['inventory'][i])
                      for i, name in enumerate(rules.ITEMS)},
        'achievements': {name: int(info['achievements'][i])
                         for i, name in enumerate(rules.ACHIEVEMENTS)},
        'discount': float(info['discount']),
        'semantic': info['semantic'],
        'player_pos': info['player_pos'],
        'reward': float(info['reward']),
        # Beyond the reference dict: pulses once on the tick the episode
        # ends, as in the batched VecEnv (equal to `done` here).
        'ended': bool(info['ended']),
    }
    return obs[0].cpu().numpy(), float(reward[0]), bool(done[0]), info

  def render(self, size=None):
    """The current frame at ``size`` (an atlas baked and cached per
    size)."""
    size = tuple(size) if size is not None else self.cfg.size
    atlas = render_lib.bake_atlas(size, self.cfg.view, self.cfg.item_rows,
                                  self.device)
    return render_lib.render(self._state, self.cfg, atlas,
                             size)[0].cpu().numpy()


class GymnasiumEnv(_GymBase):
  """Gymnasium-API adapter (5-tuple step, seeded reset) over :class:`Env`.

  The reference registers `CrafterReward-v1`/`CrafterNoReward-v1` against
  the old gym API (crafter/__init__.py:4-17); this adapter exposes the same
  environments through the modern gymnasium contract.
  """

  metadata = {'render_modes': ['rgb_array']}
  render_mode = 'rgb_array'

  def __init__(self, reward=True, length=10000, seed=None, **kwargs):
    self._env = Env(reward=reward, length=length, seed=seed, **kwargs)
    self.observation_space = self._env.observation_space
    self.action_space = self._env.action_space

  def reset(self, *, seed=None, options=None):
    if seed is not None:
      self._env._seed = seed
      self._env._episode = 0
    return self._env.reset(), {}

  def step(self, action):
    obs, reward, done, info = self._env.step(action)
    terminated = bool(info['discount'] == 0.0)
    truncated = bool(done and not terminated)
    return obs, reward, terminated, truncated, info

  def render(self):
    return self._env.render()

  def close(self):
    pass


def register_gym_envs():
  """Register CrafterReward-v1 / CrafterNoReward-v1 (reference
  crafter/__init__.py:4-17) with gymnasium and, when it imports, the old
  gym, each id only if it is not registered yet."""
  ids = [('CrafterReward-v1', True), ('CrafterNoReward-v1', False)]
  try:
    import gymnasium
    for id_, reward in ids:
      if id_ not in gymnasium.registry:
        gymnasium.register(
            id=id_, entry_point='crafter_tpu_torch.env:GymnasiumEnv',
            max_episode_steps=10000, kwargs={'reward': reward})
  except ImportError:
    pass
  try:
    import gym
    registry = gym.envs.registry
    known = getattr(registry, 'env_specs', registry)
    for id_, reward in ids:
      if id_ not in known:
        gym.register(id=id_, entry_point='crafter_tpu_torch.env:Env',
                     max_episode_steps=10000, kwargs={'reward': reward})
  except ImportError:
    pass


@dataclasses.dataclass
class VecState:
  """Batched env state plus per-env reset bookkeeping."""

  env: State
  episode: torch.Tensor   # (N,) int32 episodes started
  home_key: torch.Tensor  # (N, 2) int64 per-env base key words
  tick: torch.Tensor      # () int32 global tick counter, kept on the host:
  #                         the cadence of balance and reset branches on it
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
                  tick=torch.zeros((), dtype=torch.int32),
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


def vec_step_group_obs(vs: VecState, actions: torch.Tensor, cfg: EnvConfig,
                       reset_batch: int, core: CrafterEnv):
  """:func:`vec_step_group` plus one observation frame per tick: the pixel
  path.

  Frames 0..K-2 come from the snapshots the group kernel writes after each
  tick, frame K-1 from the post-balance, post-reset state (finished envs
  show their next episode's first frame), all K*N in one batched render.
  Returns ``(vs, outs, obs)`` with ``obs`` (K, N, H, W, 3) uint8, ``obs[t]``
  the frame after tick t.
  """
  k = cfg.balance_every
  if actions.shape[0] != k:
    raise ValueError(f'actions {tuple(actions.shape)}: want ({k}, N)')
  n = actions.shape[1]
  key0, step0 = vs.env.key, vs.env.step   # episode keys: fixed over a group
  if cfg.engine == 'plain':
    env, raw, occ_pre, snaps = step_lib.step_group_plain(
        vs.env, actions, cfg, snapshots=True)
  else:
    env, raw, occ_pre, snaps = step_cuda.group_tick(vs.env, actions, cfg,
                                                    snapshots=True)
  vs, outs = _group_finish(vs, env, raw, occ_pre, cfg, reset_batch)

  # Rows are (tick 0..K-2) x N from the snapshots, then the N final frames:
  # (K, N) order.  The final frames' packed plane goes into the row the
  # kernel left free.
  fin = vs.env
  snaps.packed[k - 1] = render_lib.pack_cells(
      fin.mat_map, fin.ent.etype, fin.ent.aux, fin.ent.facing)
  km1 = k - 1
  steps_mid = (step0[None] + 1
               + torch.arange(km1, device=step0.device,
                              dtype=step0.dtype)[:, None])
  rows = lambda mid, last: torch.cat([mid.reshape((km1 * n,) + last.shape[1:]),
                                      last])
  steps = rows(steps_mid, fin.step)
  seeds = rows(render_lib.noise_seed(key0[None].expand(km1, n, 2), steps_mid),
               render_lib.noise_seed(fin.key, fin.step))
  obs = render_lib.render_frames(
      snaps.packed.reshape(k * n, -1),
      rows(torch.stack([snaps.px, snaps.py], -1), fin.player.pos),
      rows(snaps.facing, fin.player.facing),
      rows(snaps.sleeping, fin.player.sleeping.to(torch.int32)),
      rows(snaps.inv, fin.player.inventory), steps, seeds, cfg, core.atlas,
      cfg.size)
  return vs, outs, obs.reshape((k, n) + obs.shape[1:])


def vec_step(vs: VecState, actions: torch.Tensor, cfg: EnvConfig,
             reset_batch: int, reset_every: int = 1,
             balance: Optional[bool] = None, mesh=None):
  """One batched tick and a partial-batch auto-reset pass.

  Returns ``(vs, out, stepped_env)``: finished envs have been replaced in
  ``vs`` by fresh worlds (up to ``reset_batch`` a pass; the rest stay
  latched ``pending`` for the next pass), ``stepped_env`` is the state
  before the reset, for the terminal step's info.  ``reset_every``: run the
  reset pass on every that-many-th tick only.  ``balance``: None balances
  on the global cadence (every ``cfg.balance_every``-th tick), True / False
  force it for this tick.  Both cadences are branches on the host's tick
  count.  ``mesh``: ``vs`` holds this rank's rows of the batch, and the
  reset budget is global (see :func:`_reset_pass`).
  """
  tick = vs.tick + 1
  if balance is None:
    balance = int(tick) % cfg.balance_every == 0
  env, out = step_lib.step_batch(vs.env, actions, cfg, balance=balance)
  stepped_env = env
  # A pending env counts as done whatever this tick says (a dead env
  # stepped again can regenerate health); `ended` pulses only on the tick
  # an episode really finishes.
  done = out.done | vs.pending
  out = dataclasses.replace(out, done=done, ended=out.done & ~vs.pending)
  if reset_every > 1 and int(tick) % reset_every != 0:
    episode, pending = vs.episode, done   # skipped: everyone stays pending
  else:
    env, episode, pending = _reset_pass(env, done, vs.episode, vs.home_key,
                                        cfg, reset_batch, mesh)
  vs = VecState(env=env, episode=episode, home_key=vs.home_key, tick=tick,
                pending=pending)
  return vs, out, stepped_env


def vec_step_k(vs: VecState, actions: torch.Tensor, cfg: EnvConfig,
               reset_batch: int):
  """``cfg.balance_every`` ticks of :func:`vec_step` with the balance on the
  group's last tick.  ``actions`` (K, N); returns ``(vs, outs)`` with
  (K, N) StepOut leaves."""
  k = cfg.balance_every
  if actions.shape[0] != k:
    raise ValueError(f'actions {tuple(actions.shape)}: want ({k}, N)')
  outs = []
  for i in range(k):
    vs, out, _ = vec_step(vs, actions[i], cfg, reset_batch,
                          balance=(i == k - 1))
    outs.append(out)
  return vs, step_lib.StepOut(**{
      f.name: torch.stack([getattr(o, f.name) for o in outs])
      for f in dataclasses.fields(step_lib.StepOut)})


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


def _finished_below(count: torch.Tensor, mesh):
  """The finished envs on the ranks below this one, given this rank's
  ``count``: one SUM all-reduce of a ``(W,)`` int32 vector, with no host
  synchronisation on NCCL.  0 without a process group."""
  if mesh is None or mesh.group is None:
    return 0
  counts = torch.zeros((mesh.size,), dtype=torch.int32, device=count.device)
  counts[mesh.rank] = count
  dist.all_reduce(counts, group=mesh.group)
  return counts[:mesh.rank].sum()


def _reset_pass(env: State, done: torch.Tensor, episode: torch.Tensor,
                home_key: torch.Tensor, cfg: EnvConfig, reset_batch: int,
                mesh=None):
  """Replace up to ``reset_batch`` finished envs with fresh worlds.

  The first ``reset_batch`` finished envs by index reset (overflow waits
  for the next pass).  With a ``mesh`` the batch is this rank's rows and
  the index is global: one all-reduce of the ranks' finished counts tells
  the rank how many finished envs lie below its rows.  On the card
  worldgen runs ``min(reset_batch, n)`` worlds for the ``n`` rows at hand;
  rows with no env behind them generate a throwaway world from zero key
  data, as the JAX package does.  On the CPU it runs only the worlds of the
  selected envs (the plain worldgen costs seconds a pass there).  Each
  world derives from its env's home key and episode, so the worlds do not
  depend on the split into ranks or on the rows made.  Fresh rows reach
  their envs by an index gather and a select, with no host
  synchronisation on the card.  For a sink (``utils.profiling``) the pass
  is the ``reset_pass`` span and counts ``worlds_made`` and ``envs_reset``
  (the finished envs, at most the pass's budget).
  """
  with profiling.span('reset_pass'):
    n = done.shape[0]
    dev = done.device
    rank = torch.cumsum(done.to(torch.int32), 0) - 1
    finished = rank[-1] + 1
    budget = reset_batch - _finished_below(finished, mesh)
    selected = done & (rank < budget)
    profiling.count('envs_reset', finished, budget)
    r = min(reset_batch, n)
    ep_next = episode + 1

    # Row j of the reset batch is the env of rank j (index n: no env).
    rows = torch.full((r + 1,), n, dtype=torch.long, device=dev)
    rows.scatter_(0, torch.where(selected, rank, r).long(),
                  torch.arange(n, device=dev))
    rows = rows[:r]
    if dev.type == 'cpu':
      # Off the card a count stalls nothing: make only the rows that have an
      # env (a prefix), and no world when none finished.  The envs' worlds
      # are the same.
      r = int(selected.sum())
      rows = rows[:r]
    profiling.count('worlds_made', r)
    if r == 0:
      return env, episode, done
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


class VecEnv:
  """N lockstep envs on the device with partial-batch auto-reset.

  ``step(actions)`` returns the observation after the auto-reset, so a
  finished env hands back the first frame of its next episode; the terminal
  step's reward, done and info describe the episode that just ended.

  ``sharding``: a :class:`crafter_tpu_torch.parallel.Mesh`.  The instance
  then holds this rank's rows of the ``num_envs`` envs on the mesh's device
  (env ``i`` gets the same world whatever the rank count), ``step`` takes
  and returns those rows, and the reset budget ``reset_batch`` is global.
  """

  def __init__(self, num_envs: int, cfg: EnvConfig = DEFAULT_CONFIG,
               seed: int = 0, reset_batch: Optional[int] = None,
               device='cuda', sharding=None):
    self.num_envs = num_envs
    self.cfg = cfg
    self._mesh = sharding
    if sharding is not None:
      if torch.device(device).type != sharding.device.type:
        raise ValueError(f'device {device} is not the mesh\'s '
                         f'{sharding.device}')
      device = sharding.device
    self.device = torch.device(device)
    self.core = CrafterEnv(cfg, self.device)
    self.reset_batch = min(num_envs, reset_batch or max(32, num_envs // 128))
    self._home = home_keys(seed, num_envs, self.device)
    if sharding is not None:
      self._home = self._home[sharding.rows(num_envs)]
    self.state: Optional[VecState] = None
    self.single_observation_space = BoxSpace(
        0, 255, tuple(cfg.size) + (3,), np.uint8)
    self.single_action_space = DiscreteSpace(rules.N_ACTIONS)
    self.observation_space = self.single_observation_space
    self.action_space = self.single_action_space
    self.action_names = list(rules.ACTIONS)

  def reset(self) -> torch.Tensor:
    self.state = vec_reset_chunked(self._home, self.cfg)
    return self.core.observe_batch(self.state.env)

  def step(self, actions):
    actions = torch.as_tensor(actions, dtype=torch.int32, device=self.device)
    self.state, out, stepped = vec_step(self.state, actions, self.cfg,
                                        self.reset_batch, mesh=self._mesh)
    # info describes the terminal step (the state before the reset), obs
    # the state after it.
    info = self.core.info(stepped, out)
    obs = self.core.observe_batch(self.state.env)
    reward = out.reward if self.cfg.reward else torch.zeros_like(out.reward)
    return obs, reward, out.done, info
