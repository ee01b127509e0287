"""On-device PPO actor-learner, colocated with the batched env.

The port's counterpart of ``crafter_tpu/ppo.py``.  The whole loop (rollout,
GAE, minibatch SGD) works on the device-resident env batch, so no frame or
transition crosses to the host:

* the rollout is a ``torch.no_grad()`` loop of policy forward, env tick
  (``env.vec_step``) and render (``CrafterEnv.observe_batch``), writing into
  ``(T, N, ...)`` buffers allocated once per rollout;
* the learner gathers shuffled minibatches from those buffers, clips the
  gradients by their global norm and steps ``torch.optim.Adam``;
* the policy trunk computes in bfloat16 (``models/cnn.py``).

``PPOConfig.policy`` chooses the policy: NatureCNN (``'cnn'``, the default)
or the IMPALA ResNet-LSTM (``'impala_lstm'``, ``models/impala.py``).  The
recurrent policy carries its core's state across ticks and updates in the
state (``PPOState.carry``), zeroed where an episode starts; the rollout
stores the state it began with and each tick's core inputs, and the
learner draws minibatches of whole env sequences (``num_envs /
minibatches`` envs, reshuffled every epoch) and back-propagates through
the scan of each.

Where the JAX package scans, this module loops in Python.  The state's PRNG
key is a threefry key (``prng.py``), split exactly where the JAX package
splits it, so the minibatch partitions are the JAX package's for the same
key.  The policy and the optimizer are updated in place: a ``PPOState``
returned by ``train_step`` shares them with the state passed in.

``make_sharded_train`` runs the same update on a mesh of ranks
(:mod:`crafter_tpu_torch.parallel`), each holding its rows of the env
batch.  Where XLA derives the collectives from the global-mean loss, the
learner makes them explicit: the advantage statistics and the loss terms
are taken over the global minibatch, and the gradients are summed over the
ranks before the clip, so every rank takes the same Adam step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import prng, rules
from .config import DEFAULT_CONFIG, EnvConfig
from .env import CrafterEnv, VecState, home_keys, vec_reset_chunked, vec_step
from .models import CnnPolicy, CoreInputs, ImpalaLstmPolicy, LstmCarry
from .parallel.mesh import Mesh, psum_stats, replicate, shard_batch
from .utils import profiling


@dataclasses.dataclass(frozen=True)
class PPOConfig:
  """Hyperparameters mirroring SB3 PPO defaults (the parity anchor)."""

  num_envs: int = 64
  rollout_len: int = 64
  epochs: int = 3
  minibatches: int = 8
  gamma: float = 0.99
  gae_lambda: float = 0.95
  clip: float = 0.2
  vf_coef: float = 0.5
  ent_coef: float = 0.01
  lr: float = 3e-4
  max_grad_norm: float = 0.5
  reset_batch: int = 64
  seed: int = 0
  # Minibatch axis (see PPO._learn).  None or False: flatten (T, N) and
  # shuffle all samples.  True: permute the T rollout rows and take T/M rows,
  # every env, per minibatch (the scheme for an env batch sharded over
  # devices, where it keeps every gather local to a shard).
  # make_sharded_train resolves None to True on more than one rank.
  time_minibatch: Optional[bool] = None
  # Global-mode shuffle cadence.  'update' (default): one whole-batch gather
  # per update; the minibatch partition holds across the epochs and only the
  # visit order is drawn anew per epoch.  'epoch': SB3's reshuffle per epoch,
  # which gathers every minibatch from the rollout buffers again.  The
  # recurrent policy takes 'epoch' only: whole env sequences, reshuffled
  # per epoch.
  shuffle_per: str = 'update'
  # 'cnn' (NatureCNN) or 'impala_lstm' (the IMPALA ResNet-LSTM).
  policy: str = 'cnn'


@dataclasses.dataclass
class PPOState:
  params: CnnPolicy              # the policy; its parameters are float32
  opt_state: torch.optim.Adam    # the optimizer over ``params``
  vec: VecState
  obs: torch.Tensor        # (N, H, W, 3) uint8 current observations
  key: torch.Tensor        # (2,) int64 threefry key words
  update: int              # updates taken, kept on the host
  env_steps: int           # env steps taken, kept on the host
  # On-device episode accumulators: running length and return per env, so
  # stats cross update boundaries without host bookkeeping.
  ep_len: torch.Tensor     # (N,) int32
  ep_ret: torch.Tensor     # (N,) float32
  # The recurrent policy's carry after the last tick (None for NatureCNN).
  carry: Optional[LstmCarry] = None


@dataclasses.dataclass
class Transition:
  """A rollout: every leaf has leading (T, N) axes."""

  obs: torch.Tensor
  action: torch.Tensor
  logp: torch.Tensor
  value: torch.Tensor
  reward: torch.Tensor       # training reward (zero in the NoReward variant)
  done: torch.Tensor         # latched: stays true while awaiting auto-reset
  ended: torch.Tensor        # pulses once on the tick an episode finishes
  raw_reward: torch.Tensor   # info['reward']: what the stats accumulate
  achievements: torch.Tensor  # (T, N, 22) terminal-step counters for stats
  # The recurrent policy's state before the first tick and its per-tick
  # inputs (None for NatureCNN).
  core: Optional[CoreInputs] = None


POLICIES = ('cnn', 'impala_lstm')


def _no_carry(core, action, reward, done):
  return None


def _next_carry(core, action, reward, done) -> LstmCarry:
  """The recurrent core's carry after a tick: its state ``core`` and the
  tick's action, training reward and done flag."""
  return LstmCarry(h=core[0], c=core[1], action=action, reward=reward,
                   done=done)


def _core_inputs(carry: LstmCarry, traj: Transition) -> CoreInputs:
  """A rollout's core inputs: the state it began with, and per tick the
  action, reward and done flag of the tick before (the carry's for the
  first tick)."""
  shift = lambda first, x: torch.cat([first[None], x[:-1]])
  return CoreInputs(h=carry.h, c=carry.c,
                    prev_action=shift(carry.action, traj.action),
                    prev_reward=shift(carry.reward, traj.reward),
                    reset=shift(carry.done, traj.done))


class PPO:
  """``init`` and ``train_step`` for an env and a PPO configuration.

  ``mesh`` (see :func:`make_sharded_train`): the state holds this rank's
  rows of the ``cfg.num_envs`` envs, and the update is the one-process
  update of the whole batch.  Without one, a mesh of one rank: the whole
  batch, and no collective runs.
  """

  def __init__(self, env_cfg: EnvConfig = DEFAULT_CONFIG,
               cfg: PPOConfig = PPOConfig(), device='cuda',
               mesh: Optional[Mesh] = None):
    self.env_cfg = env_cfg
    self.cfg = cfg
    self.device = torch.device(device)
    self.core = CrafterEnv(env_cfg, self.device)
    self.mesh = mesh or Mesh(None, 0, 1, self.device)
    if cfg.policy not in POLICIES:
      raise ValueError(f'policy {cfg.policy!r} is not one of {POLICIES}')
    # The recurrent policy's branches, chosen here once: how a tick acts
    # and what it carries to the next.
    self.recurrent = cfg.policy == 'impala_lstm'
    if self.recurrent:
      if cfg.time_minibatch or cfg.shuffle_per != 'epoch':
        raise ValueError(
            'the recurrent policy learns on whole env sequences, reshuffled '
            'per epoch (shuffle_per=\'epoch\'): time_minibatch and the '
            'sample shuffle shuffle_per=\'update\' would cut them')
      if self.mesh.size > 1:
        raise ValueError('the recurrent policy runs on one rank')
      self._act, self._carry_on = self._act_recurrent, _next_carry
    else:
      self._act, self._carry_on = self._act_feedforward, _no_carry

  # -- initialization ------------------------------------------------------

  def init(self, key: torch.Tensor) -> PPOState:
    """A fresh training state from a (2,) threefry key (``prng.key``)."""
    key = key.to(self.device)
    k_param, _, k_run = prng.split(key, 3)
    gen = torch.Generator()
    gen.manual_seed(int(k_param[0]) << 31 ^ int(k_param[1]))
    # The frame is (H, W, 3) with size = (W, H).
    make = ImpalaLstmPolicy if self.recurrent else CnnPolicy
    policy = make(n_actions=rules.N_ACTIONS,
                  input_hw=(self.env_cfg.size[1], self.env_cfg.size[0]),
                  generator=gen, device=self.device)
    # One generator gives every rank the same policy; the broadcast makes
    # rank 0's the one.
    with torch.no_grad():
      for p, q in zip(policy.parameters(),
                      replicate(list(policy.parameters()), self.mesh)):
        p.copy_(q)
    home = home_keys(self.cfg.seed, self.cfg.num_envs,
                     self.device)[self.mesh.rows(self.cfg.num_envs)]
    opt = torch.optim.Adam(policy.parameters(), lr=self.cfg.lr, eps=1e-5)
    vec = vec_reset_chunked(home, self.env_cfg)
    obs = self.core.observe_batch(vec.env)
    n = home.shape[0]
    return PPOState(
        params=policy, opt_state=opt, vec=vec, obs=obs, key=k_run,
        update=0, env_steps=0,
        ep_len=torch.zeros((n,), dtype=torch.int32, device=self.device),
        ep_ret=torch.zeros((n,), dtype=torch.float32, device=self.device),
        carry=policy.zero_carry(n, self.device) if self.recurrent else None)

  # -- rollout -------------------------------------------------------------

  @torch.no_grad()
  def _rollout(self, ts: PPOState) -> Tuple[PPOState, Transition,
                                            torch.Tensor]:
    with profiling.span('rollout'):
      cfg, env_cfg = self.cfg, self.env_cfg
      k = env_cfg.balance_every
      t_len, n = cfg.rollout_len, ts.obs.shape[0]
      # When the rollout divides into whole balance-cadence groups, step the
      # env on the group cadence: balance on each group's last tick and one
      # reset pass per K ticks, sized K * reset_batch.  Same semantics as the
      # group path (env.vec_step_group); the policy still acts every tick on
      # that tick's frame.
      grouped = t_len % k == 0 and t_len >= k
      dev = self.device
      buf = lambda shape, dtype: torch.empty((t_len, n) + shape, dtype=dtype,
                                             device=dev)
      traj = Transition(
          obs=buf(tuple(ts.obs.shape[1:]), torch.uint8),
          action=buf((), torch.int64), logp=buf((), torch.float32),
          value=buf((), torch.float32), reward=buf((), torch.float32),
          done=buf((), torch.bool), ended=buf((), torch.bool),
          raw_reward=buf((), torch.float32),
          achievements=buf((rules.N_ACHIEVEMENTS,), torch.int32))
      vec, obs, key, carry = ts.vec, ts.obs, ts.key, ts.carry
      policy = ts.params
      rows = torch.arange(n, device=dev)
      # This rank's rows of the global draw, as (start, total).
      mine = (self.mesh.rows(cfg.num_envs).start, cfg.num_envs)
      for t in range(t_len):
        # Envs latched `pending` at tick start are finished episodes idling
        # for a reset slot (up to K-1 ticks on the group cadence): their
        # rewards this tick are post-terminal junk, so zero them for
        # training.  `done` stays latched true, so GAE already cuts the
        # bootstrap through these ticks; stats key on the one-shot `ended`.
        stale = vec.pending
        key, k_act = prng.split(key, 2)
        with profiling.span('policy'):
          out, core = self._act(policy, obs, carry)
          action = prng.categorical(k_act, out.logits, mine)
          logp = torch.log_softmax(out.logits, -1)[rows, action]
        if grouped:
          vec, env_out, stepped = vec_step(
              vec, action.to(torch.int32), env_cfg, k * cfg.reset_batch,
              reset_every=k, balance=(t % k == k - 1), mesh=self.mesh)
        else:
          vec, env_out, stepped = vec_step(vec, action.to(torch.int32),
                                           env_cfg, cfg.reset_batch,
                                           mesh=self.mesh)
        traj.obs[t] = obs
        traj.action[t] = action
        traj.logp[t] = logp
        traj.value[t] = out.value
        if env_cfg.reward:
          traj.reward[t] = torch.where(stale, 0.0, env_out.reward)
        else:
          traj.reward[t] = 0.0
        traj.done[t] = env_out.done
        traj.ended[t] = env_out.ended
        traj.raw_reward[t] = env_out.reward
        traj.achievements[t] = stepped.player.achievements
        carry = self._carry_on(core, action, traj.reward[t], env_out.done)
        obs = self.core.observe_batch(vec.env)
      last_value = self._act(policy, obs, carry)[0].value
      if self.recurrent:
        traj.core = _core_inputs(ts.carry, traj)
        if profiling.counting():
          profiling.count('state_resets', traj.core.reset.sum())
      ts = dataclasses.replace(ts, vec=vec, obs=obs, key=key, carry=carry,
                               env_steps=ts.env_steps + t_len * cfg.num_envs)
      return ts, traj, last_value

  @staticmethod
  def _act_feedforward(policy, obs, carry):
    return policy(obs), None

  @staticmethod
  def _act_recurrent(policy, obs, carry):
    return policy.step(obs, carry)

  # -- GAE -----------------------------------------------------------------

  @torch.no_grad()
  def _gae(self, traj: Transition, last_value: torch.Tensor):
    cfg = self.cfg
    adv = torch.empty_like(traj.value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(traj.value.shape[0] - 1, -1, -1):
      nonterm = 1.0 - traj.done[t].to(torch.float32)
      delta = traj.reward[t] + cfg.gamma * next_value * nonterm \
          - traj.value[t]
      gae = delta + cfg.gamma * cfg.gae_lambda * nonterm * gae
      adv[t] = gae
      next_value = traj.value[t]
    return adv, adv + traj.value

  # -- optimization --------------------------------------------------------

  def _loss(self, policy: CnnPolicy, batch):
    cfg = self.cfg
    obs, action, logp_old, adv, ret = batch[:5]
    if self.recurrent:
      # (T, B) sequences through the scan, then the samples flat.
      out = policy.sequence(obs, batch[5])
      out = type(out)(*(x.reshape((-1,) + x.shape[2:]) for x in out))
      action, logp_old, adv, ret = (x.reshape(-1)
                                    for x in (action, logp_old, adv, ret))
    else:
      out = policy(obs)
    logp_all = torch.log_softmax(out.logits, -1)
    logp = logp_all[torch.arange(action.shape[0], device=action.device),
                    action]
    # The rank's share of the global-minibatch mean (every rank holds as
    # many samples), and the global mean and population deviation of the
    # advantages, two-pass as jnp's std.
    count = adv.numel() * self.mesh.size
    avg = lambda x: x.sum() / count
    mu = psum_stats(adv.sum(), self.mesh) / count
    var = psum_stats(torch.square(adv - mu).sum(), self.mesh) / count
    adv = (adv - mu) / (torch.sqrt(var) + 1e-8)
    ratio = torch.exp(logp - logp_old)
    pg = -avg(torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv))
    v_loss = 0.5 * avg(torch.square(out.value - ret))
    entropy = -avg((torch.exp(logp_all) * logp_all).sum(-1))
    loss = pg + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    return loss, dict(pg_loss=pg, v_loss=v_loss, entropy=entropy)

  def _clip_grads(self, policy: CnnPolicy) -> None:
    """Scale the gradients to a global norm of at most ``max_grad_norm``:
    ``g / norm * max`` where the norm is not below the maximum, as optax
    does (no epsilon in the denominator), without reading the norm back."""
    grads = [p.grad for p in policy.parameters()]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < self.cfg.max_grad_norm
    for g in grads:
      g.copy_(torch.where(keep, g, g / norm * self.cfg.max_grad_norm))

  def _sum_grads(self, policy: CnnPolicy) -> None:
    """Each gradient summed over the ranks (one all-reduce of the flat
    gradients): the gradient of the global-mean loss, the same on every
    rank.  One rank holds it already."""
    if self.mesh.size == 1:
      return
    grads = [p.grad for p in policy.parameters()]
    flat = psum_stats(torch.cat([g.reshape(-1) for g in grads]), self.mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
      g.copy_(part.view_as(g))

  def _sgd_step(self, ts: PPOState, mb):
    ts.opt_state.zero_grad(set_to_none=True)
    loss, aux = self._loss(ts.params, mb)
    loss.backward()
    self._sum_grads(ts.params)
    self._clip_grads(ts.params)
    ts.opt_state.step()
    # This rank's shares of the global means.
    return dict(loss=loss.detach(),
                **{name: v.detach() for name, v in aux.items()})

  def _update(self, ts: PPOState):
    """One PPO update: rollout T steps, then E epochs of M minibatches."""
    cfg = self.cfg
    if self.recurrent:
      if cfg.num_envs % cfg.minibatches:
        raise ValueError('num_envs must divide into minibatches (env-axis '
                         'sequence minibatches)')
    elif cfg.time_minibatch:
      if cfg.rollout_len % cfg.minibatches:
        raise ValueError('rollout_len must divide into minibatches '
                         '(time-axis minibatching)')
    elif self.mesh.size > 1:
      raise ValueError('on more than one rank the minibatches must be '
                       'time-axis (time_minibatch=True): the global shuffle '
                       'mixes the ranks\' samples')
    elif (cfg.rollout_len * cfg.num_envs) % cfg.minibatches:
      raise ValueError('rollout size must divide into minibatches')
    ts, traj, last_value = self._rollout(ts)
    return self._learn(ts, traj, last_value)

  def _minibatch_indices(self, key: torch.Tensor):
    """The update's minibatches as index tensors, drawn as the JAX package
    draws them: ``(key, shuffle, epochs)``.

    ``shuffle`` is the whole-batch permutation applied once before the
    epochs (``shuffle_per='update'``) or None; ``epochs`` is a list, per
    epoch, of one index tensor per minibatch, into the shuffled flat batch,
    the flat batch, (``time_minibatch``) the rollout's time axis or (the
    recurrent policy) the env axis.
    """
    cfg = self.cfg
    time_mb = bool(cfg.time_minibatch)
    batch_n = cfg.rollout_len * cfg.num_envs
    shuffle, epochs = None, []
    if not time_mb and not self.recurrent and cfg.shuffle_per == 'update':
      mb_n = batch_n // cfg.minibatches
      key, k_perm = prng.split(key, 2)
      shuffle = prng.permutation(k_perm, batch_n)
      for _ in range(cfg.epochs):
        key, k_ord = prng.split(key, 2)
        order = prng.permutation(k_ord, cfg.minibatches).tolist()
        epochs.append([slice(j * mb_n, (j + 1) * mb_n) for j in order])
    else:
      perm_n = (cfg.num_envs if self.recurrent else
                cfg.rollout_len if time_mb else batch_n)
      for _ in range(cfg.epochs):
        key, k_perm = prng.split(key, 2)
        perm = prng.permutation(k_perm, perm_n)
        epochs.append(list(perm.reshape(cfg.minibatches, -1)))
    return key, shuffle, epochs

  def _learn(self, ts: PPOState, traj: Transition,
             last_value: torch.Tensor):
    """GAE and E epochs of M minibatches on a collected rollout.

    Global mode flattens (T, N) and shuffles all T*N samples (SB3's scheme);
    time-axis mode gathers T/M rollout rows per minibatch and flattens them
    time-major; the recurrent policy gathers N/M envs' whole sequences and
    their core inputs.
    """
    with profiling.span('learn'):
      cfg = self.cfg
      time_mb = bool(cfg.time_minibatch)
      adv, ret = self._gae(traj, last_value)
      data = (traj.obs, traj.action, traj.logp, adv, ret)
      if not time_mb and not self.recurrent:
        data = tuple(x.reshape((-1,) + x.shape[2:]) for x in data)
      key, shuffle, epochs = self._minibatch_indices(ts.key)
      if shuffle is not None:
        # One whole-batch gather; the epochs sweep contiguous slices of the
        # shuffled copy.
        data = tuple(x[shuffle] for x in data)
      sums, steps = None, 0
      for minibatches in epochs:
        for idx in minibatches:
          if self.recurrent:
            mb = tuple(x[:, idx] for x in data) + (traj.core.envs(idx),)
          else:
            mb = tuple(x[idx] for x in data)
          if time_mb:
            mb = tuple(x.reshape((-1,) + x.shape[2:]) for x in mb)
          metrics = self._sgd_step(ts, mb)
          sums = metrics if sums is None else {
              name: sums[name] + v for name, v in metrics.items()}
          steps += 1
      # The ranks' shares summed once an update (the mean over minibatches
      # is linear): one all-reduce of the float metrics, one of the count.
      names = list(sums) + ['reward_per_step']
      total = psum_stats(torch.stack(
          [sums[name] / steps for name in sums]
          + [traj.reward.sum() / (cfg.rollout_len * cfg.num_envs)]), self.mesh)
      metrics = dict(zip(names, total))
      metrics['episodes_done'] = psum_stats(traj.ended.sum(), self.mesh)
      ts = dataclasses.replace(ts, key=key, update=ts.update + 1)
      ts, stats = self._episode_stats(ts, traj)
      return ts, metrics, stats

  @torch.no_grad()
  def _episode_stats(self, ts: PPOState, traj: Transition):
    """Finished-episode records, accumulated and packed on the device.

    Episode length and return accumulate in the state; each update writes
    the episodes that finished during the rollout into a fixed (K,) buffer,
    so the host drains K * ~100 bytes once per update instead of looping
    over every (step, env) pair.
    """
    cfg = self.cfg
    length, ret = ts.ep_len, ts.ep_ret
    lens = torch.empty_like(traj.done, dtype=torch.int32)
    rets = torch.empty_like(traj.raw_reward)
    for t in range(traj.done.shape[0]):
      length = length + 1
      ret = ret + traj.raw_reward[t]
      lens[t], rets[t] = length, ret
      # Reset on the *latched* done: an env waiting for an auto-reset slot
      # re-zeroes every tick, so its waiting steps never leak into the next
      # episode's length or return.
      length = torch.where(traj.done[t], 0, length)
      ret = torch.where(traj.done[t], 0.0, ret)
    # Record on `ended` (one pulse per episode), not the latched `done`,
    # which would re-emit a waiting env's achievements every tick.
    ended = traj.ended.reshape(-1)
    # Buffer sized for the worst burst (all N envs finishing inside one
    # rollout at the length cap) plus steady-state churn.
    k = cfg.num_envs + cfg.num_envs * cfg.rollout_len // 16
    # Row k takes every record that is not kept (no episode, or overflow)
    # and is thrown away.
    slot = torch.where(ended, (torch.cumsum(ended, 0) - 1).clamp_max(k), k)

    def pack(x):
      out = torch.zeros((k + 1,) + x.shape[2:], dtype=x.dtype,
                        device=x.device)
      out[slot] = x.reshape((-1,) + x.shape[2:])
      return out[:k]

    count = ended.sum()
    stats = dict(
        count=count.clamp_max(k), dropped=(count - k).clamp_min(0),
        lengths=pack(lens), returns=pack(rets),
        achievements=pack(traj.achievements))
    return dataclasses.replace(ts, ep_len=length, ep_ret=ret), stats

  def train_step(self, ts: PPOState):
    """One update: ``(state, metrics)``."""
    ts, metrics, _ = self._update(ts)
    return ts, metrics

  def train_step_with_stats(self, ts: PPOState):
    """Like :meth:`train_step` but also returns the update's packed
    finished-episode records for the ``VecStatsRecorder``."""
    return self._update(ts)


def make_sharded_train(env_cfg: EnvConfig, cfg: PPOConfig, mesh: Mesh,
                       device='cuda'):
  """Training with the env batch sharded over the ranks of ``mesh``.

  Returns ``(ppo, init, train_step, shard_state)``, as the JAX package's
  ``make_sharded_train``.  The policy and the Adam state are replicated
  (one generator, then a broadcast from rank 0); the env state, frames and
  episode accumulators are this rank's rows of the ``cfg.num_envs`` envs.
  The rollout samples each rank's actions from its rows of the global draw
  and resets with the global budget, so it is the one-process rollout's;
  the learner minimises the global-mean loss and every rank takes the same
  step.  ``time_minibatch=None`` resolves to time-axis minibatches on more
  than one rank.  ``shard_state(ts)`` keeps this rank's rows of a
  one-process ``PPOState`` (a restored checkpoint, say).  ``device`` must
  name the mesh's device type.  As in the JAX package, the sharded surface
  is ``train_step``: ``train_step_with_stats`` would pack each rank's own
  episodes.
  """
  if torch.device(device).type != mesh.device.type:
    raise ValueError(f'device {device} is not the mesh\'s {mesh.device}')
  if cfg.policy != 'cnn':
    raise ValueError(f'make_sharded_train runs the cnn policy only, not '
                     f'{cfg.policy!r}: no recurrent path has run across '
                     'ranks')
  if cfg.time_minibatch is None:
    cfg = dataclasses.replace(cfg, time_minibatch=mesh.size > 1)
  ppo = PPO(env_cfg, cfg, device=mesh.device, mesh=mesh)

  def shard_state(ts: PPOState) -> PPOState:
    return shard_batch(ts, mesh, cfg.num_envs)

  return ppo, ppo.init, ppo.train_step, shard_state
