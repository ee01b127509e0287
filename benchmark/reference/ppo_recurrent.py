"""Recurrent PPO on the batched env in plain PyTorch: the reference of the
port's ``PPO.train_step_with_stats`` with the IMPALA ResNet-LSTM policy
(``impala_lstm.py``), a frozen copy of the update in the repository's
``tests/impala_lstm_ref.py`` with the rollout of ``ppo.py`` around it.

The rollout steps the reference env a tick at a time and the policy acts
on each tick's frame from its LSTM state, which carries across ticks and
updates; before each tick the state and the previous action and training
reward are multiplied by ``1 - done`` of the tick before (CleanRL's
``ppo_atari_lstm.py``).  The learner (PPO in place of IMPALA's V-trace, as
``ppo.py``'s) takes GAE, then per epoch one permutation of the envs, drawn
from the key chain as the port draws it, cut into ``minibatches`` groups;
each group's whole sequences run from the state the rollout began with,
back-propagated through the scan.  Everything runs with TF32 off.

On the card a minibatch is computed in blocks of ``block_envs`` envs so
that its activations fit: the advantages are normalised over the whole
minibatch first, then each block's sums of the loss terms over the
minibatch's sample count are back-propagated and their gradients add up,
which is the minibatch's gradient.

:func:`train` runs the first ``updates`` updates from a seed and weights
handed to it, as ``ppo.train`` does, and records the same quantities, the
first rollout's trunk features and core inputs, for :func:`core_logp`, and
the first minibatch's: its trunk features, core inputs and the scan's
log-probabilities of every action before any optimizer step, for
:func:`core_log_softmax`.
"""

from __future__ import annotations

import dataclasses

import torch

from . import env as env_lib
from . import impala_lstm
from . import prng
from . import render as render_lib
from .config import EnvConfig
from .ppo import Hyper, Record


@dataclasses.dataclass
class RecurrentRecord(Record):
  first_feat: torch.Tensor = None  # (T, N, WIDTH) the first rollout's trunk
  #                                  features
  first_core: dict = None          # its state before the first tick (h, c)
  #                                  and per-tick prev_action, prev_reward,
  #                                  reset
  scan_feat: torch.Tensor = None   # (T, B, WIDTH) the first minibatch's
  scan_core: dict = None           # its core inputs, as first_core's
  scan_logp: torch.Tensor = None   # (T, B, A) its scan's log-probabilities


def _core_dict(source: dict, envs=slice(None)) -> dict:
  """The core inputs of ``envs`` in ``source``: the state before the
  first tick and the per-tick previous action, reward and reset."""
  return {name: (source[name][envs] if name in ('h', 'c')
                 else source[name][:, envs])
          for name in ('h', 'c', 'prev_action', 'prev_reward', 'reset')}


@impala_lstm.float32_only
def core_log_softmax(params: dict, feat, core: dict,
                     precision: str = 'float32') -> torch.Tensor:
  """``(T, N, A)`` log-probabilities of every action from the LSTM and
  heads, in ``precision``, stepped over given trunk features ``feat``
  ``(T, N, WIDTH)`` and core inputs."""
  h, c = core['h'], core['c']
  out = []
  with torch.no_grad():
    for t in range(feat.shape[0]):
      logits, _, h, c = impala_lstm.step(
          params, feat[t], h, c, core['prev_action'][t],
          core['prev_reward'][t], core['reset'][t], precision)
      out.append(torch.log_softmax(logits, -1))
  return torch.stack(out)


def core_logp(params: dict, feat, core: dict, actions) -> torch.Tensor:
  """``(T, N)`` log-probabilities of ``actions`` from the float32 LSTM and
  heads stepped over given trunk features ``feat`` and core inputs."""
  return core_log_softmax(params, feat, core).gather(
      -1, actions[..., None])[..., 0]


def first_scan(params: dict, batch: dict, idx, trunk: str, scan: str,
               block_envs: int):
  """``(feat, core, logp)`` of the minibatch of envs ``idx``: its trunk
  features in ``trunk`` precision (in blocks of ``block_envs`` envs), its
  core inputs and the log-probabilities of every action from the scan in
  ``scan`` precision."""
  obs = batch['obs'][:, idx]
  with torch.no_grad():
    feat = torch.cat([impala_lstm.trunk(
        params, obs[:, lo:lo + block_envs].reshape((-1,) + obs.shape[2:]),
        trunk).reshape(obs.shape[0], -1, params['fc.bias'].shape[0])
        for lo in range(0, idx.shape[0], block_envs)], 1)
  core = _core_dict(batch, idx)
  return feat, core, core_log_softmax(params, feat, core, scan)


def _block_loss(params, mb: dict, adv, ret, hp: Hyper, count: int,
                trunk: str, core: str):
  """The sums of a block's PPO terms over ``count`` samples:
  ``(pg, v_loss, entropy)``, each differentiable."""
  logits, value, _ = impala_lstm.forward(
      params, mb['obs'], mb['h'], mb['c'], mb['prev_action'],
      mb['prev_reward'], mb['reset'], trunk, core)
  logp_all = torch.log_softmax(logits, -1)
  logp = logp_all.gather(-1, mb['action'][..., None])[..., 0]
  ratio = torch.exp(logp - mb['logp'])
  pg = -torch.minimum(ratio * adv, torch.clamp(
      ratio, 1 - hp.clip, 1 + hp.clip) * adv).sum() / count
  v_loss = 0.5 * torch.square(value - ret).sum() / count
  entropy = -(torch.exp(logp_all) * logp_all).sum() / count
  return pg, v_loss, entropy


def learn_minibatch(params: dict, batch: dict, adv, ret, idx, hp: Hyper,
                    block_envs: int, trunk: str = 'float32',
                    core: str = 'float32'):
  """The loss of the minibatch of envs ``idx``, its gradient left in the
  parameters' ``grad`` (unclipped): ``(loss, pg, v_loss, entropy)``."""
  adv, ret = adv[:, idx], ret[:, idx]
  adv = (adv - adv.mean()) / (torch.sqrt(torch.square(adv - adv.mean())
                                         .mean()) + 1e-8)
  count = adv.numel()
  sums = torch.zeros(3, device=adv.device)
  for lo in range(0, idx.shape[0], block_envs):
    part = idx[lo:lo + block_envs]
    mb = {name: (x[part] if name in ('h', 'c') else x[:, part])
          for name, x in batch.items()}
    pg, v_loss, entropy = _block_loss(
        params, mb, adv[:, lo:lo + block_envs], ret[:, lo:lo + block_envs],
        hp, count, trunk, core)
    (pg + hp.vf_coef * v_loss - hp.ent_coef * entropy).backward()
    sums += torch.stack([pg, v_loss, entropy]).detach()
  pg, v_loss, entropy = sums
  return pg + hp.vf_coef * v_loss - hp.ent_coef * entropy, pg, v_loss, entropy


def clip_grads(params: dict, max_norm: float) -> None:
  """The gradients scaled to a global norm of at most ``max_norm``, as
  optax clips them (no epsilon)."""
  grads = [p.grad for p in params.values()]
  norm = torch.linalg.vector_norm(
      torch.stack([torch.linalg.vector_norm(g) for g in grads]))
  with torch.no_grad():
    for g in grads:
      g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def gae(value, reward, done, last_value, gamma, lam):
  """Advantages and returns of ``(T, N)`` rollouts."""
  adv = torch.empty_like(value)
  running = torch.zeros_like(last_value)
  next_value = last_value
  for t in range(value.shape[0] - 1, -1, -1):
    nonterm = 1.0 - done[t].to(torch.float32)
    delta = reward[t] + gamma * next_value * nonterm - value[t]
    running = delta + gamma * lam * nonterm * running
    adv[t] = running
    next_value = value[t]
  return adv, adv + value


@impala_lstm.float32_only
def train(cfg: EnvConfig, hp: Hyper, seed: int, params0: dict, updates: int,
          actions=None, trunk: str = 'float32', core: str = 'float32',
          scan: str = None, block_envs: int = 0) -> Record:
  """``updates`` updates from ``seed`` and ``params0``; ``actions`` (one
  ``(T, N)`` tensor an update) are taken and judged instead of sampled.
  ``trunk='float8'`` and ``core='bfloat16'`` are the lower-precision
  controls (``impala_lstm``); ``core`` is the rollout's and learn's,
  ``scan`` (``core`` where None) learn's alone; ``block_envs`` 0 takes a
  minibatch whole."""
  scan = scan or core
  dev = params0[next(iter(params0))].device
  n, t_len = hp.num_envs, hp.rollout_len
  k = cfg.balance_every
  grouped = t_len % k == 0 and t_len >= k
  key = prng.split(prng.key(seed, dev), 3)[2]
  home = env_lib.home_keys(hp.seed, n, dev)
  vs = env_lib.VecState(
      env=env_lib.first_worlds(home, cfg),
      episode=torch.ones((n,), dtype=torch.int32, device=dev),
      home_key=home, tick=torch.zeros((), dtype=torch.int32),
      pending=torch.zeros((n,), dtype=torch.bool, device=dev))
  atlas = render_lib.bake_atlas(cfg.size, cfg.view, cfg.item_rows, dev)
  observe = lambda s: render_lib.render(s, cfg, atlas, cfg.size)
  obs = observe(vs.env)
  params = {name: p.detach().clone().requires_grad_(True)
            for name, p in params0.items()}
  opt = torch.optim.Adam(params.values(), lr=hp.lr, eps=1e-5)
  hidden = params['lstm_hh.weight'].shape[1]
  h = torch.zeros((n, hidden), device=dev)
  c = torch.zeros((n, hidden), device=dev)
  prev_action = torch.zeros((n,), dtype=torch.int64, device=dev)
  prev_reward = torch.zeros((n,), device=dev)
  prev_done = torch.ones((n,), dtype=torch.bool, device=dev)
  rows = torch.arange(n, device=dev)
  rec = RecurrentRecord([], [], 0.0, 0.0, None, {}, {}, [], 0.0)
  feats = []
  gap = torch.zeros((), device=dev)
  for u in range(updates):
    # -- rollout
    buf = lambda shape, dtype: torch.empty((t_len, n) + shape, dtype=dtype,
                                           device=dev)
    batch = dict(obs=buf(tuple(obs.shape[1:]), torch.uint8),
                 action=buf((), torch.int64), logp=buf((), torch.float32),
                 value=buf((), torch.float32), reward=buf((), torch.float32),
                 done=buf((), torch.bool), prev_action=buf((), torch.int64),
                 prev_reward=buf((), torch.float32),
                 reset=buf((), torch.bool), h=h, c=c)
    with torch.no_grad():
      for t in range(t_len):
        stale = vs.pending
        key, k_act = prng.split(key, 2)
        feat = impala_lstm.trunk(params, obs, trunk)
        if u == 0:
          feats.append(feat)
        logits, value, h, c = impala_lstm.step(
            params, feat, h, c, prev_action, prev_reward, prev_done, core)
        u01 = prng.uniform(k_act, tuple(logits.shape), (0, n)).clamp_min(
            torch.finfo(torch.float32).tiny)
        score = -torch.log(-torch.log(u01)) + logits
        if actions is None:
          action = torch.argmax(score, -1)
        else:
          action = actions[u][t].to(dev).long()
          gap = torch.maximum(gap, (score.amax(-1) - score[rows, action]).max())
        if grouped:
          vs, out, _ = env_lib.step_tick(vs, action.to(torch.int32), cfg,
                                         k * hp.reset_batch, reset_every=k,
                                         balance=(t % k == k - 1))
        else:
          vs, out, _ = env_lib.step_tick(vs, action.to(torch.int32), cfg,
                                         hp.reset_batch)
        reward = torch.where(stale, 0.0, out.reward) if cfg.reward else \
            torch.zeros_like(out.reward)
        for name, x in (('obs', obs), ('action', action),
                        ('logp', torch.log_softmax(logits, -1)[rows, action]),
                        ('value', value), ('reward', reward),
                        ('done', out.done), ('prev_action', prev_action),
                        ('prev_reward', prev_reward), ('reset', prev_done)):
          batch[name][t] = x
        prev_action, prev_reward, prev_done = action, reward, out.done
        obs = observe(vs.env)
      last_value = impala_lstm.step(
          params, impala_lstm.trunk(params, obs, trunk), h, c, prev_action,
          prev_reward, prev_done, core)[1]
      h, c = h.float(), c.float()
      adv, ret = gae(batch['value'], batch['reward'], batch['done'],
                     last_value, hp.gamma, hp.gae_lambda)
    rec.actions.append(batch['action'])
    if rec.first_logp is None:
      rec.first_logp = batch['logp'].clone()
      rec.first_feat = torch.stack(feats)
      rec.first_core = _core_dict(batch)
      del feats
    # -- learn
    del batch['value'], batch['done'], batch['reward']
    losses, scales = [], []
    for _ in range(hp.epochs):
      key, k_perm = prng.split(key, 2)
      perm = prng.permutation(k_perm, n)
      for idx in perm.reshape(hp.minibatches, -1):
        opt.zero_grad(set_to_none=True)
        if rec.scan_logp is None:
          rec.scan_feat, rec.scan_core, rec.scan_logp = first_scan(
              params, batch, idx, trunk, scan, block_envs or idx.shape[0])
        loss, pg, v_loss, entropy = learn_minibatch(
            params, batch, adv, ret, idx, hp, block_envs or idx.shape[0],
            trunk, scan)
        clip_grads(params, hp.max_grad_norm)
        losses.append(loss)
        scales.append(pg.abs() + hp.vf_coef * v_loss + hp.ent_coef * entropy)
        if not rec.first_grad:
          rec.first_grad = {name: p.grad.detach().clone()
                            for name, p in params.items()}
          rec.first_loss, rec.first_scale = float(losses[0]), float(scales[0])
        opt.step()
    del batch
    rec.losses.append(float(torch.stack(losses).mean()))
    rec.loss_scales.append(float(torch.stack(scales).mean()))
  rec.params = {name: p.detach().clone() for name, p in params.items()}
  rec.action_gap = float(gap)
  return rec
