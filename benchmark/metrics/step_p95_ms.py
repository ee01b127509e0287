"""``step_p95_ms``: the 95th percentile, over every call of the window, of
the device-clock interval between the CUDA events recorded after
consecutive calls (the first from an event before the first call).  A
stall of the host or of the device lengthens an interval."""

import numpy as np


def read(ctx):
  if len(ctx.call_ms) < 20:
    return None
  return float(np.percentile(ctx.call_ms, 95))
