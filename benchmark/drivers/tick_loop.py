"""Driver of ``env.VecEnv.step``: the batched-RL contract, one tick a call
with a frame an env (the tick kernel, the daylight and render kernels, a
reset pass every tick, the balance on every ``balance_every``-th tick),
with actions from the traffic's generator.

Traffic parameters: ``num_envs``, ``reset_batch``, ``actions``,
``warmup_calls``, and ``check``: ``init_envs`` (envs whose first world and
first frame are compared), ``calls`` ticks drawn from the seed among the
first ``call_span`` of the window, each compared whole (the state after the
tick, its reward and done, and every frame it returned).

``TINY`` holds the sizes at which the CPU tests run a cell of this
driver; ``fault(name)`` plants one of ``calibrate.FAULTS`` under
``env.vec_step``."""

from __future__ import annotations

import contextlib

import torch

from benchmark import compare, faults, harness, programs
from benchmark.reference import env as ref_env
from benchmark.reference import render as ref_render
from benchmark.traffic import ActionStream


class Driver:

  def __init__(self, ctx):
    import crafter_tpu_torch.env as ct_env
    self.ctx = ctx
    traffic, config = ctx.cell.traffic, ctx.cell.config
    self.cfg = programs.program_env_config(config)
    self.n = int(traffic['num_envs'])
    self.reset_batch = int(traffic['reset_batch'])
    self.ticks_per_call = 1
    self.work_per_call = self.n
    check = traffic['check']
    self.init_index = harness.sample(ctx.seed, 'init', self.n,
                                     check['init_envs'])
    self.check_at = set(harness.sample(ctx.seed, 'calls', check['call_span'],
                                       check['calls']))
    self.kept = []
    self.count = 0
    self.actions = ActionStream(traffic['actions'], ctx.seed, (self.n,),
                                ctx.device)
    self.env = ct_env.VecEnv(self.n, self.cfg, seed=ctx.seed,
                             reset_batch=self.reset_batch, device=ctx.device)
    if self.env.reset_batch != self.reset_batch:
      raise ValueError(f'VecEnv took reset_batch {self.env.reset_batch}')
    obs = self.env.reset()
    index = torch.tensor(self.init_index, device=ctx.device)
    self.init_rows = compare.rows(self.env.state.env, index)
    self.init_obs = obs[index]
    for _ in range(int(traffic['warmup_calls'])):
      self.call()
    self.count = 0
    self.kept = []

  def call(self):
    actions = self.actions.next()
    vs_in = self.env.state
    obs, reward, done, _ = self.env.step(actions)
    if self.count in self.check_at:
      self.kept.append((vs_in, actions, self.env.state, obs, reward, done))
    self.count += 1

  def release(self):
    self.env = None

  def checks(self, variant: str = 'program') -> list:
    ctx = self.ctx
    config = ctx.cell.config
    limits = ctx.cell.traffic['check']['limits']
    ref_cfg = programs.reference_env_config(config, 'program')
    ctl_cfg = programs.reference_env_config(config, 'control')
    atlas = ref_render.bake_atlas(ref_cfg.size, ref_cfg.view,
                                  ref_cfg.item_rows, ctx.device)
    frames = lambda env, cfg: ref_render.render(env, cfg, atlas, cfg.size)
    init = programs.first_world_mismatch(
        self.init_rows, config, ctx.seed, self.n, self.init_index, variant,
        ctx.device)
    frame_bad = 0
    home = ref_env.home_keys(ctx.seed, self.n, ctx.device)[
        torch.tensor(self.init_index, device=ctx.device)]
    want = frames(ref_env.first_worlds(home, ref_cfg), ref_cfg)
    got = self.init_obs
    if variant == 'control':
      got = frames(ref_env.first_worlds(home, ctl_cfg), ctl_cfg)
    frame_bad += compare.mismatch(got, want)
    state_bad = out_bad = 0
    for vs_in, actions, vs_out, obs, reward, done in self.kept:
      vs_in = compare.to_reference(vs_in)
      want_vs, want_out, _ = ref_env.step_tick(vs_in, actions, ref_cfg,
                                               self.reset_batch)
      if variant == 'control':
        vs_out, out, _ = ref_env.step_tick(vs_in, actions, ctl_cfg,
                                           self.reset_batch)
        obs, reward, done = frames(vs_out.env, ctl_cfg), out.reward, out.done
      state_bad += compare.mismatch(compare.to_reference(vs_out), want_vs)
      out_bad += (compare.mismatch(reward, want_out.reward)
                  + compare.mismatch(done, want_out.done))
      frame_bad += compare.mismatch(obs, frames(want_vs.env, ref_cfg))
    if len(self.kept) < len(self.check_at):
      state_bad = out_bad = frame_bad = None
    return [('init_mismatch', init, limits['init_mismatch']),
            ('state_mismatch', state_bad, limits['state_mismatch']),
            ('output_mismatch', out_bad, limits['output_mismatch']),
            ('frame_mismatch', frame_bad, limits['frame_mismatch'])]


TINY = dict(
    traffic=dict(num_envs=8, reset_batch=2, warmup_calls=2, trace_calls=2),
    check=dict(init_envs=3, calls=2, call_span=2))


@contextlib.contextmanager
def fault(name: str):
  """Plant fault ``name`` under ``env.vec_step`` for the block:
  ``unchanged`` returns the state it was given, ``half_batch`` steps the
  first half of the envs and keeps the rest as they were, ``altered`` adds
  1 to one reward."""
  import crafter_tpu_torch.env as ct_env

  def tick(original):
    def step(vs, actions, cfg, reset_batch, **kw):
      if name == 'half_batch':
        n = actions.shape[0]
        part, out, stepped = original(faults.half(vs, n), actions[:n // 2],
                                      cfg, max(1, reset_batch // 2), **kw)
        return faults.join_half(part, vs, n), out, stepped
      out_vs, out, stepped = original(vs, actions, cfg, reset_batch, **kw)
      if name == 'unchanged':
        return vs, out, stepped
      out.reward[0] += 1.0
      return out_vs, out, stepped
    return step
  undo = faults.patch(ct_env, 'vec_step', tick)
  try:
    yield
  finally:
    undo()
