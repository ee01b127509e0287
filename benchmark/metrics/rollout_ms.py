"""``rollout_ms``: the mean device-clock interval from a PPO update's start
to the CUDA event recorded where ``_learn`` starts (``ppo.PPO._rollout``:
policy forward, sampling, env tick and render, 64 ticks)."""

import statistics


def read(ctx):
  ms = ctx.spans.ms('rollout')
  return statistics.fmean(ms) if ms else None
