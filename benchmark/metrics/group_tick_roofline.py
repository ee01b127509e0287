"""``group_tick_roofline``: the group kernel's byte bound over its mean
device time in the trace (``group_tick_kernel``), in %.  The bound is
every tensor a ``step_cuda.group_tick`` call takes and returns, read once
and written once, from their shapes and dtypes (a returned tensor that is
an input passed through is not counted again), over the HBM's 3.35 TB/s.
The kernel's work per cell is a few integer operations, far under the
bytes' time at the chip's integer rate, so bytes bound it."""

import statistics

from benchmark import harness, peaks

KERNEL = 'group_tick_kernel'


def install(ctx):
  import crafter_tpu_torch.step_cuda as step_cuda
  ctx.hooks['group_tick_bytes'] = []

  def make(original):
    def group_tick(*args, **kwargs):
      out = original(*args, **kwargs)
      if ctx.tracing:
        seen = set()
        read = harness.tensor_bytes(args, kwargs, seen=seen)
        ctx.hooks['group_tick_bytes'].append(
            read + harness.tensor_bytes(out, seen=seen))
      return out
    return group_tick

  harness.wrap_attr(ctx, step_cuda, 'group_tick', make)


def read(ctx):
  calls = ctx.hooks.get('group_tick_bytes')
  kernel_s = harness.kernel_mean_s(ctx, KERNEL)
  if not calls or not kernel_s:
    return None
  bound_s = statistics.fmean(calls) / peaks.HBM_BYTES_PER_S
  return 100.0 * bound_s / kernel_s
