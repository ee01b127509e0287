"""``train_mfu``: the policy's model FLOPs a PPO update (``flops.py``,
from NatureCNN's published shapes) over the mean update's seconds (CUDA
events) and the H100's bfloat16 dense peak (``peaks.py``), in %.  The
card's power limit is in the result's ``device``."""

import statistics

from benchmark import peaks


def read(ctx):
  ms = ctx.spans.ms('update')
  if not ms:
    return None
  seconds = statistics.fmean(ms) / 1e3
  return 100.0 * ctx.driver.update_flops / seconds / peaks.BF16_FLOPS
