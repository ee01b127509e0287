"""PPO on the batched env in plain PyTorch: the reference of the port's
``PPO.train_step_with_stats`` (rollout, GAE, minibatch SGD with Adam).

Schulman et al. 2017 (arXiv:1707.06347) with the port's settings: the
clipped surrogate, a value loss and an entropy bonus, advantages
normalised per minibatch, gradients clipped by their global norm as optax
clips them, Adam with eps 1e-5.  The rollout steps the reference env a
tick at a time (``env.step_tick``) and renders each tick's frame with the
plain renderer; the threefry key chain, the Gumbel-max sampler and the
minibatch permutations are drawn as the port draws them.

:func:`train` runs the first ``updates`` updates from a seed and weights
handed to it.  With ``actions`` (one ``(T, N)`` tensor an update) it takes
those actions instead of sampling, and records for each the widest gap by
which its Gumbel-perturbed logit lies below the best one: the actions are
the program's outputs, judged here, and the env then follows the same
trajectory on both sides.
"""

from __future__ import annotations

import dataclasses

import torch

from . import env as env_lib
from . import policy as policy_lib
from . import prng
from . import render as render_lib
from .config import EnvConfig


@dataclasses.dataclass(frozen=True)
class Hyper:
  num_envs: int
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
  reset_batch: int = 32
  seed: int = 0


@dataclasses.dataclass
class Record:
  losses: list            # each update's mean loss over its minibatches
  loss_scales: list       # |pg| + vf * v + ent * H, the same mean
  first_loss: float       # the first minibatch's loss
  first_scale: float      # and its scale
  first_logp: torch.Tensor  # (T, N) log-probability of each action of the
  #                           first rollout, from the first weights
  first_grad: dict        # the first minibatch's clipped gradient
  params: dict            # after the last update
  actions: list           # (T, N) int64 an update
  action_gap: float       # widest gap of the given actions (0 if sampled)


def _minibatches(key, hp: Hyper):
  batch_n = hp.rollout_len * hp.num_envs
  mb_n = batch_n // hp.minibatches
  key, k_perm = prng.split(key, 2)
  shuffle = prng.permutation(k_perm, batch_n)
  epochs = []
  for _ in range(hp.epochs):
    key, k_ord = prng.split(key, 2)
    order = prng.permutation(k_ord, hp.minibatches).tolist()
    epochs.append([slice(j * mb_n, (j + 1) * mb_n) for j in order])
  return key, shuffle, epochs


def train(cfg: EnvConfig, hp: Hyper, seed: int, params0: dict, updates: int,
          actions=None, trunk: str = 'float32') -> Record:
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
  rows = torch.arange(n, device=dev)
  rec = Record([], [], 0.0, 0.0, None, {}, {}, [], 0.0)
  gap = torch.zeros((), device=dev)
  for u in range(updates):
    # -- rollout
    buf = lambda shape, dtype: torch.empty((t_len, n) + shape, dtype=dtype,
                                           device=dev)
    t_obs = buf(tuple(obs.shape[1:]), torch.uint8)
    t_act, t_logp, t_val, t_rew = (buf((), torch.int64), buf((), torch.float32),
                                   buf((), torch.float32),
                                   buf((), torch.float32))
    t_done = buf((), torch.bool)
    with torch.no_grad():
      for t in range(t_len):
        stale = vs.pending
        key, k_act = prng.split(key, 2)
        logits, value = policy_lib.forward(params, obs, trunk)
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
        t_obs[t] = obs
        t_act[t] = action
        t_logp[t] = torch.log_softmax(logits, -1)[rows, action]
        t_val[t] = value
        t_rew[t] = torch.where(stale, 0.0, out.reward) if cfg.reward else 0.0
        t_done[t] = out.done
        obs = observe(vs.env)
      last_value = policy_lib.forward(params, obs, trunk)[1]
      # -- GAE
      adv = torch.empty_like(t_val)
      gae = torch.zeros_like(last_value)
      next_value = last_value
      for t in range(t_len - 1, -1, -1):
        nonterm = 1.0 - t_done[t].to(torch.float32)
        delta = t_rew[t] + hp.gamma * next_value * nonterm - t_val[t]
        gae = delta + hp.gamma * hp.gae_lambda * nonterm * gae
        adv[t] = gae
        next_value = t_val[t]
      ret = adv + t_val
    rec.actions.append(t_act)
    if rec.first_logp is None:
      rec.first_logp = t_logp.clone()
    # -- learn
    data = tuple(x.reshape((-1,) + x.shape[2:])
                 for x in (t_obs, t_act, t_logp, adv, ret))
    key, shuffle, epochs = _minibatches(key, hp)
    data = tuple(x[shuffle] for x in data)
    del t_obs
    losses, scales = [], []
    for minibatches in epochs:
      for idx in minibatches:
        ob, act, logp_old, a, r = (x[idx] for x in data)
        opt.zero_grad(set_to_none=True)
        logits, value = policy_lib.forward(params, ob, trunk)
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all[torch.arange(act.shape[0], device=dev), act]
        a = (a - a.mean()) / (torch.sqrt(torch.square(a - a.mean()).mean())
                              + 1e-8)
        ratio = torch.exp(logp - logp_old)
        pg = -torch.minimum(ratio * a, torch.clamp(
            ratio, 1 - hp.clip, 1 + hp.clip) * a).mean()
        v_loss = 0.5 * torch.square(value - r).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        loss = pg + hp.vf_coef * v_loss - hp.ent_coef * entropy
        loss.backward()
        grads = [p.grad for p in params.values()]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        with torch.no_grad():
          for g in grads:
            g.copy_(torch.where(norm < hp.max_grad_norm, g,
                                g / norm * hp.max_grad_norm))
        losses.append(loss.detach())
        scales.append((pg.abs() + hp.vf_coef * v_loss
                       + hp.ent_coef * entropy).detach())
        if not rec.first_grad:
          rec.first_grad = {name: p.grad.detach().clone()
                            for name, p in params.items()}
          rec.first_loss, rec.first_scale = float(losses[0]), float(scales[0])
        opt.step()
    rec.losses.append(float(torch.stack(losses).mean()))
    rec.loss_scales.append(float(torch.stack(scales).mean()))
  rec.params = {name: p.detach().clone() for name, p in params.items()}
  rec.action_gap = float(gap)
  return rec
