"""``learn_ms``: the mean device-clock interval from the event where
``ppo.PPO._learn`` starts to the update's end (GAE, epochs of minibatch
SGD, the episode statistics)."""

import statistics


def read(ctx):
  ms = ctx.spans.ms('learn')
  return statistics.fmean(ms) if ms else None
