"""Driver of ``ppo.PPO.train_step_with_stats`` with the recurrent IMPALA
ResNet-LSTM policy (``PPOConfig(policy='impala_lstm')``): one PPO update a
call (a rollout of the per-tick env with the policy acting on every frame
from its LSTM state, GAE, epochs of minibatches of whole env sequences with
back-propagation through the scan, Adam) at the configuration's sizes.

Set-up and the check are ``ppo_train.py``'s: one ``PPO`` and its state,
the benchmark's weights in the policy, the first ``check.steps`` updates
made by the same call the window makes, then compared with the plain
reference (``reference/ppo_recurrent.py``, which computes each minibatch
in blocks of ``check.block_envs`` envs) by the same seven numbers, and two
that hold the recurrent core apart from the bfloat16 trunk, whose error the
seven see and which hides a core in a lower precision:

* ``core_gap``: the mean gap between the first rollout's log-probabilities
  and those of the reference's float32 LSTM and heads stepped over the
  trunk features the program computed in that rollout and its core inputs;
* ``scan_gap``: the same for learn's scan, over the log-probabilities of
  every action of the first minibatch (before any optimizer step), the
  reference stepped over the trunk features learn computed for it.  A scan
  that does not cover the minibatch's whole ``num_envs / minibatches``
  sequences reads ``inf``.

The variants of ``checks``: 'program', 'control' (the reference with a
float8 trunk in the program's place), 'control_lstm' (the reference with
its LSTM and heads in bfloat16, in the rollout and in learn) and
'control_scan' (the reference with learn's scan alone in bfloat16).

``TINY`` holds the sizes at which the CPU tests run a cell of this driver;
``fault(name)`` plants one of ``calibrate.FAULTS`` in ``ppo.PPO``'s
recurrent path."""

from __future__ import annotations

import contextlib

import torch

from benchmark import compare, faults, flops_impala, programs, weights
from benchmark.drivers import ppo_train
from benchmark.reference import impala_lstm as ref_impala
from benchmark.reference import ppo as ref_ppo
from benchmark.reference import ppo_recurrent as ref_recurrent

NAMES = ('loss_gap', 'first_loss_gap', 'grad_gap', 'grad_diff', 'change_gap',
         'logp_gap', 'action_gap', 'core_gap', 'scan_gap')
# The reference's keyword arguments of each lower-precision control.
CONTROLS = {'control': {'trunk': 'float8'},
            'control_lstm': {'core': 'bfloat16'},
            'control_scan': {'scan': 'bfloat16'}}


class Driver(ppo_train.Driver):
  """``ppo_train.Driver`` (its ``call`` and ``release``) over the recurrent
  policy and its reference."""

  def __init__(self, ctx):
    from crafter_tpu_torch import prng, rules
    from crafter_tpu_torch.ppo import PPO, PPOConfig
    self.ctx = ctx
    config = ctx.cell.config
    sizes, hyper, policy = config['assumed'], config['ppo'], config['policy']
    check = ctx.cell.traffic['check']
    self.steps, self.block_envs = int(check['steps']), int(check['block_envs'])
    self.env_cfg = programs.program_env_config(config)
    self.hyper = ref_ppo.Hyper(
        num_envs=sizes['num_envs'], rollout_len=sizes['rollout_len'],
        epochs=sizes['epochs'], minibatches=sizes['minibatches'],
        reset_batch=sizes['reset_batch'], seed=ctx.seed, **hyper)
    self.ppo = PPO(self.env_cfg, PPOConfig(
        num_envs=sizes['num_envs'], rollout_len=sizes['rollout_len'],
        epochs=sizes['epochs'], minibatches=sizes['minibatches'],
        reset_batch=sizes['reset_batch'], shuffle_per=sizes['shuffle_per'],
        seed=ctx.seed, policy='impala_lstm', **hyper), device=ctx.device)
    widths = dict(stacks=tuple(policy['stacks']), blocks=policy['res_blocks'],
                  width=policy['fc'], hidden=policy['lstm'])
    input_hw = (self.env_cfg.size[1], self.env_cfg.size[0])
    self.update_flops = flops_impala.ppo_update_flops(
        sizes['num_envs'], sizes['rollout_len'], sizes['epochs'],
        input_hw=input_hw, n_actions=rules.N_ACTIONS, **widths)
    self.work_per_call = sizes['num_envs'] * sizes['rollout_len']
    self.ticks_per_call = sizes['rollout_len']

    self.ts = self.ppo.init(prng.key(ctx.seed, ctx.device))
    named = dict(self.ts.params.named_parameters())
    shape_of = ref_impala.shapes(input_hw, rules.N_ACTIONS, **widths)
    if {n: tuple(p.shape) for n, p in named.items()} != shape_of:
      raise ValueError('the program\'s policy is not the configuration\'s')
    self.weights = weights.init_params(shape_of, ctx.seed, ctx.device)
    with torch.no_grad():
      for name, p in named.items():
        p.copy_(self.weights[name])

    self.actions, self.handover, self.first_grad = [], None, None
    self.first_logp = self.first_loss = self.first_core = None
    self.scan = {}
    # The trunk features of the first rollout, for core_gap, and of the
    # first minibatch with its core inputs and scan, for scan_gap.
    policy, feats = self.ts.params, []

    def kept_trunk(obs):
      feat = type(policy).trunk(policy, obs)
      if self.first_core is None:
        if len(feats) < self.ticks_per_call:
          feats.append(feat)
      elif 'feat' not in self.scan:
        self.scan['feat'] = feat.detach()
      return feat

    def kept_sequence(obs, core):
      out = type(policy).sequence(policy, obs, core)
      if 'logp' not in self.scan:
        self.scan['feat'] = self.scan['feat'].reshape(obs.shape[:2] + (-1,))
        self.scan['core'] = dict(vars(core))
        self.scan['logp'] = torch.log_softmax(out.logits.detach(), -1)
      return out

    policy.trunk, policy.sequence = kept_trunk, kept_sequence
    learn, sgd_step = self.ppo._learn, self.ppo._sgd_step

    def marked_learn(ts, traj, last_value):
      self.handover = ctx.marks.mark()
      if len(self.actions) < self.steps:
        self.actions.append(traj.action.clone())
      if self.first_logp is None:
        self.first_logp = traj.logp.clone()
        self.first_core = dict(vars(traj.core))
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
    del policy.trunk, policy.sequence
    self.first_feat = torch.stack(feats)
    self.ppo._sgd_step = sgd_step
    self.losses = [float(v) for v in losses]
    self.first_loss = float(self.first_loss)
    self.params = {n: p.detach().clone() for n, p in named.items()}

  def _reference(self, **kw):
    ctx = self.ctx
    ref_cfg = programs.reference_env_config(ctx.cell.config, 'program')
    return ref_recurrent.train(ref_cfg, self.hyper, ctx.seed, self.weights,
                               self.steps, block_envs=self.block_envs, **kw)

  def checks(self, variant: str = 'program') -> list:
    limits = self.ctx.cell.traffic['check']['limits']
    got = dict(losses=self.losses, first_loss=self.first_loss,
               first_logp=self.first_logp, first_grad=self.first_grad or {},
               params=self.params, actions=self.actions,
               first_feat=self.first_feat, first_core=self.first_core,
               scan_feat=self.scan.get('feat'),
               scan_core=self.scan.get('core'),
               scan_logp=self.scan.get('logp'))
    if variant in CONTROLS:
      ctl = self._reference(**CONTROLS[variant])
      got = {name: getattr(ctl, name) for name in got}
    if len(got['actions']) < self.steps:
      return [(name, None, limits[name]) for name in NAMES]
    ref = self._reference(actions=got['actions'])
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
        action_gap=ref.action_gap,
        core_gap=float((got['first_logp'] - ref_recurrent.core_logp(
            self.weights, got['first_feat'], got['first_core'],
            got['actions'][0])).abs().mean()),
        scan_gap=self.scan_gap(got))
    return [(name, values[name], limits[name]) for name in NAMES]

  def scan_gap(self, got: dict) -> float:
    """The mean gap between the first minibatch's scan log-probabilities
    in ``got`` and the reference's float32 core's over its features and
    core inputs; ``inf`` where the scan left out some of the minibatch's
    sequences."""
    logp = got['scan_logp']
    if logp is None or logp.shape[1] != (self.hyper.num_envs
                                         // self.hyper.minibatches):
      return float('inf')
    return float((logp - ref_recurrent.core_log_softmax(
        self.weights, got['scan_feat'], got['scan_core'])).abs().mean())


TINY = dict(
    traffic=dict(trace_calls=1),
    check=dict(steps=2, block_envs=2),
    assumed=dict(num_envs=8, rollout_len=4, epochs=1, minibatches=2,
                 reset_batch=2))


def fault(name: str):
  """The context manager that plants fault ``name`` in ``ppo.PPO`` for a
  block: ``ppo_train.fault``'s ``unchanged`` (an SGD step that never steps
  the optimizer) and ``altered`` (one sampled action of each tick moved to
  the next action), and ``half_batch``, the loss and its mean over the
  first half of each minibatch's envs."""
  return _half_batch() if name == 'half_batch' else ppo_train.fault(name)


@contextlib.contextmanager
def _half_batch():
  import crafter_tpu_torch.ppo as ct_ppo

  def half_loss(original):
    def loss(self, policy, batch):
      half = slice(0, batch[0].shape[1] // 2)
      return original(self, policy, tuple(x[:, half] for x in batch[:5])
                      + (batch[5].envs(half),))
    return loss

  undo = faults.patch(ct_ppo.PPO, '_loss', half_loss)
  try:
    yield
  finally:
    undo()
