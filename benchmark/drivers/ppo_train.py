"""Driver of ``ppo.PPO.train_step_with_stats``: one PPO update a call (a
rollout of the per-tick env with the policy acting on every frame, GAE,
epochs of minibatch SGD with Adam) at the configuration's sizes.

Set-up builds one ``PPO`` and its state, puts the benchmark's weights into
the policy, and drives it through its first ``check.steps`` updates by the
same call the window makes; the window then goes on with that object.  The
check follows those first updates with the plain reference (``reference/
ppo.py``): each update's loss, the first gradient as Adam received it
(its first moment after one step, over 1 - beta1) and the parameters'
change over the first updates, the last two by the worst leaf's norm; and
the widest gap by which an action the program sampled lies below the best
Gumbel-perturbed logit of the reference.  Traffic parameters: ``check``
(``steps`` and the ``limits``).

``TINY`` holds the sizes at which the CPU tests run a cell of this driver
(``assumed`` replaces the sizes of the configuration of every such cell);
``fault(name)`` plants one of ``calibrate.FAULTS`` in ``ppo.PPO``."""

from __future__ import annotations

import contextlib

import torch

from benchmark import compare, faults, flops, programs, weights
from benchmark.reference import policy as ref_policy
from benchmark.reference import ppo as ref_ppo


class Driver:

  def __init__(self, ctx):
    from crafter_tpu_torch import prng, rules
    from crafter_tpu_torch.ppo import PPO, PPOConfig
    self.ctx = ctx
    config = ctx.cell.config
    sizes, hyper = config['assumed'], config['ppo']
    self.steps = int(ctx.cell.traffic['check']['steps'])
    self.env_cfg = programs.program_env_config(config)
    self.hyper = ref_ppo.Hyper(
        num_envs=sizes['num_envs'], rollout_len=sizes['rollout_len'],
        epochs=sizes['epochs'], minibatches=sizes['minibatches'],
        reset_batch=sizes['reset_batch'], seed=ctx.seed, **hyper)
    self.ppo = PPO(self.env_cfg, PPOConfig(
        num_envs=sizes['num_envs'], rollout_len=sizes['rollout_len'],
        epochs=sizes['epochs'], minibatches=sizes['minibatches'],
        reset_batch=sizes['reset_batch'], shuffle_per=sizes['shuffle_per'],
        seed=ctx.seed, **hyper), device=ctx.device)
    policy = config['policy']
    kw = flops.policy_kwargs(policy, self.env_cfg.size, rules.N_ACTIONS)
    self.update_flops = flops.ppo_update_flops(
        sizes['num_envs'], sizes['rollout_len'], sizes['epochs'], **kw)
    self.work_per_call = sizes['num_envs'] * sizes['rollout_len']
    self.ticks_per_call = sizes['rollout_len']

    self.ts = self.ppo.init(prng.key(ctx.seed, ctx.device))
    named = dict(self.ts.params.named_parameters())
    shape_of = ref_policy.shapes(
        (self.env_cfg.size[1], self.env_cfg.size[0]), 3, policy['dense'],
        rules.N_ACTIONS)
    if {n: tuple(p.shape) for n, p in named.items()} != shape_of:
      raise ValueError('the program\'s policy is not the configuration\'s')
    self.weights = weights.init_params(shape_of, ctx.seed, ctx.device)
    with torch.no_grad():
      for name, p in named.items():
        p.copy_(self.weights[name])

    self.actions, self.handover, self.first_grad = [], None, None
    self.first_logp = self.first_loss = None
    learn, sgd_step = self.ppo._learn, self.ppo._sgd_step

    def marked_learn(ts, traj, last_value):
      self.handover = ctx.marks.mark()
      if len(self.actions) < self.steps:
        self.actions.append(traj.action.clone())
      if self.first_logp is None:
        self.first_logp = traj.logp.clone()
      return learn(ts, traj, last_value)

    def first_sgd_step(ts, mb):
      metrics = sgd_step(ts, mb)
      if self.first_loss is None:
        self.first_loss = metrics['loss']
      return metrics

    self.ppo._learn = marked_learn
    self.ppo._sgd_step = first_sgd_step
    opt = self.ts.opt_state

    def first_step(optimizer, *_):
      if self.first_grad is None:
        beta1 = optimizer.param_groups[0]['betas'][0]
        self.first_grad = {
            n: optimizer.state[p]['exp_avg'] / (1 - beta1)
            for n, p in named.items() if 'exp_avg' in optimizer.state[p]}

    hook = opt.register_step_post_hook(first_step)
    losses = []
    for _ in range(self.steps):
      self.ts, metrics, _ = self.ppo.train_step_with_stats(self.ts)
      losses.append(metrics['loss'])
    hook.remove()
    self.ppo._sgd_step = sgd_step
    self.losses = [float(v) for v in losses]
    self.first_loss = float(self.first_loss)
    self.params = {n: p.detach().clone() for n, p in named.items()}

  def call(self):
    start = self.ctx.marks.mark()
    self.ts, _, _ = self.ppo.train_step_with_stats(self.ts)
    end = self.ctx.marks.mark()
    spans = self.ctx.spans
    spans.add('rollout', start, self.handover)
    spans.add('learn', self.handover, end)
    spans.add('update', start, end)

  def release(self):
    self.ts = self.ppo = None

  def checks(self, variant: str = 'program') -> list:
    ctx = self.ctx
    limits = ctx.cell.traffic['check']['limits']
    ref_cfg = programs.reference_env_config(ctx.cell.config, 'program')
    got = dict(losses=self.losses, first_loss=self.first_loss,
               first_logp=self.first_logp, first_grad=self.first_grad or {},
               params=self.params, actions=self.actions)
    if variant == 'control':
      ctl = ref_ppo.train(ref_cfg, self.hyper, ctx.seed, self.weights,
                          self.steps, trunk='float8')
      got = {name: getattr(ctl, name) for name in got}
    names = ('loss_gap', 'first_loss_gap', 'grad_gap', 'grad_diff',
             'change_gap', 'logp_gap', 'action_gap')
    if len(got['actions']) < self.steps:
      return [(name, None, limits[name]) for name in names]
    ref = ref_ppo.train(ref_cfg, self.hyper, ctx.seed, self.weights,
                        self.steps, actions=got['actions'])
    change = lambda params: {n: params[n] - self.weights[n] for n in params}
    values = dict(
        loss_gap=max(abs(g - w) / s for g, w, s in
                     zip(got['losses'], ref.losses, ref.loss_scales)),
        first_loss_gap=abs(got['first_loss'] - ref.first_loss)
        / ref.first_scale,
        grad_gap=compare.norm_gap(got['first_grad'], ref.first_grad,
                                  ref.first_grad),
        grad_diff=compare.norm_diff(got['first_grad'], ref.first_grad,
                                    ref.first_grad),
        change_gap=compare.norm_gap(change(got['params']),
                                    change(ref.params), ref.first_grad),
        logp_gap=float((got['first_logp'] - ref.first_logp).abs().mean()),
        action_gap=ref.action_gap)
    return [(name, values[name], limits[name]) for name in names]


TINY = dict(
    traffic=dict(trace_calls=1),
    check=dict(steps=2),
    assumed=dict(num_envs=8, rollout_len=4, epochs=1, minibatches=2,
                 reset_batch=2))


@contextlib.contextmanager
def fault(name: str):
  """Plant fault ``name`` in ``ppo.PPO`` for the block: ``unchanged`` an
  SGD step that computes the gradient and never steps the optimizer,
  ``half_batch`` the loss and its mean over the first half of each
  minibatch, ``altered`` one sampled action of each tick of the rollout
  moved to the next action."""
  import crafter_tpu_torch.ppo as ct_ppo
  if name == 'unchanged':
    def no_step(original):
      def sgd_step(self, ts, mb):
        ts.opt_state.zero_grad(set_to_none=True)
        loss, aux = self._loss(ts.params, mb)
        loss.backward()
        return dict(loss=loss.detach(),
                    **{k: v.detach() for k, v in aux.items()})
      return sgd_step
    undo = faults.patch(ct_ppo.PPO, '_sgd_step', no_step)
  elif name == 'half_batch':
    def half_loss(original):
      def loss(self, policy, batch):
        return original(self, policy,
                        tuple(x[:x.shape[0] // 2] for x in batch))
      return loss
    undo = faults.patch(ct_ppo.PPO, '_loss', half_loss)
  else:
    def altered(original):
      def categorical(key, logits, rows=None):
        action = original(key, logits, rows)
        action[0] = (action[0] + 1) % logits.shape[-1]
        return action
      return categorical
    undo = faults.patch(ct_ppo.prng, 'categorical', altered)
  try:
    yield
  finally:
    undo()
