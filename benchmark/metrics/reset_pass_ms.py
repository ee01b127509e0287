"""``reset_pass_ms``: the mean interval between CUDA events recorded just
before and just after each call of ``env._reset_pass`` in the window
(worldgen with the 2-D noise kernel, and the merge into the state).  No
synchronise: the interval is the device's time from the pass's first
operation to its last, host launch gaps included."""

import statistics


def install(ctx):
  import crafter_tpu_torch.env as ct_env
  from benchmark import harness

  def make(original):
    def reset_pass(*args, **kwargs):
      if not ctx.spans.recording:
        return original(*args, **kwargs)
      start = ctx.marks.mark()
      out = original(*args, **kwargs)
      ctx.spans.add('reset_pass', start, ctx.marks.mark())
      return out
    return reset_pass

  harness.wrap_attr(ctx, ct_env, '_reset_pass', make)


def read(ctx):
  ms = ctx.spans.ms('reset_pass')
  return statistics.fmean(ms) if ms else None
