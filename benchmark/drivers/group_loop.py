"""Driver of ``env.vec_step_group``: whole balance-cadence groups of the
state-only engine loop (the group tick, the group-end balance and one
reset pass a call), with actions from the traffic's generator.

Traffic parameters: ``num_envs``, ``reset_batch``, ``actions`` (see
``traffic.py``), ``warmup_calls``, and ``check``: ``init_envs`` (envs
whose first world is compared), ``calls`` groups drawn from the seed
among the first ``call_span`` of the window, each compared whole (every
leaf of the state after the group and every result of its ticks).

``TINY`` holds the sizes at which the CPU tests run a cell of this
driver; ``fault(name)`` plants one of ``calibrate.FAULTS`` under
``env.vec_step_group``."""

from __future__ import annotations

import contextlib

import torch

from benchmark import compare, faults, harness, programs
from benchmark.reference import env as ref_env
from benchmark.traffic import ActionStream


class Driver:

  def __init__(self, ctx):
    import crafter_tpu_torch.env as ct_env
    self.ct_env = ct_env
    self.ctx = ctx
    traffic, config = ctx.cell.traffic, ctx.cell.config
    self.cfg = programs.program_env_config(config)
    self.n = int(traffic['num_envs'])
    self.reset_batch = int(traffic['reset_batch'])
    k = self.cfg.balance_every
    self.ticks_per_call = k
    self.work_per_call = k * self.n
    check = traffic['check']
    self.init_index = harness.sample(ctx.seed, 'init', self.n,
                                     check['init_envs'])
    self.check_at = set(harness.sample(ctx.seed, 'calls', check['call_span'],
                                       check['calls']))
    self.kept = []
    self.count = 0
    self.actions = ActionStream(traffic['actions'], ctx.seed, (k, self.n),
                                ctx.device)
    self.vs = ct_env.vec_reset_chunked(
        ct_env.home_keys(ctx.seed, self.n, ctx.device), self.cfg)
    self.init_rows = compare.rows(
        self.vs.env, torch.tensor(self.init_index, device=ctx.device))
    for _ in range(int(traffic['warmup_calls'])):
      self.call()
    self.count = 0
    self.kept = []

  def call(self):
    actions = self.actions.next()
    vs_in = self.vs
    self.vs, outs = self.ct_env.vec_step_group(vs_in, actions, self.cfg,
                                               self.reset_batch)
    if self.count in self.check_at:
      self.kept.append((vs_in, actions, self.vs, outs))
    self.count += 1

  def release(self):
    self.vs = None

  def checks(self, variant: str = 'program') -> list:
    ctx = self.ctx
    config = ctx.cell.config
    limits = ctx.cell.traffic['check']['limits']
    init = programs.first_world_mismatch(
        self.init_rows, config, ctx.seed, self.n, self.init_index, variant,
        ctx.device)
    ref_cfg = programs.reference_env_config(config, 'program')
    ctl_cfg = programs.reference_env_config(config, 'control')
    state_bad = out_bad = 0
    for vs_in, actions, vs_out, outs in self.kept:
      vs_in = compare.to_reference(vs_in)
      want_vs, want_outs = ref_env.step_group(vs_in, actions, ref_cfg,
                                              self.reset_batch)
      if variant == 'control':
        vs_out, outs = ref_env.step_group(vs_in, actions, ctl_cfg,
                                          self.reset_batch)
      state_bad += compare.mismatch(compare.to_reference(vs_out), want_vs)
      out_bad += compare.mismatch(compare.to_reference(outs), want_outs)
    if len(self.kept) < len(self.check_at):
      state_bad = out_bad = None     # a group due for the check never ran
    return [('init_mismatch', init, limits['init_mismatch']),
            ('state_mismatch', state_bad, limits['state_mismatch']),
            ('output_mismatch', out_bad, limits['output_mismatch'])]


TINY = dict(
    traffic=dict(num_envs=8, reset_batch=4, warmup_calls=1, trace_calls=2),
    check=dict(init_envs=3, calls=2, call_span=2))


@contextlib.contextmanager
def fault(name: str):
  """Plant fault ``name`` under ``env.vec_step_group`` for the block:
  ``unchanged`` returns the state it was given, ``half_batch`` steps the
  first half of the envs and keeps the rest as they were, ``altered`` adds
  1 to one reward."""
  import crafter_tpu_torch.env as ct_env

  def group(original):
    def step(vs, actions, cfg, reset_batch):
      if name == 'half_batch':
        n = actions.shape[1]
        part, outs = original(faults.half(vs, n), actions[:, :n // 2], cfg,
                              reset_batch)
        return faults.join_half(part, vs, n), outs
      out_vs, outs = original(vs, actions, cfg, reset_batch)
      if name == 'unchanged':
        return vs, outs
      outs.reward[0, 0] += 1.0
      return out_vs, outs
    return step
  undo = faults.patch(ct_env, 'vec_step_group', group)
  try:
    yield
  finally:
    undo()
