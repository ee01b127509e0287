"""``render_roofline``: the render kernel's byte bound over its mean device
time in the trace (``render_kernel``), in %.  The bound is the frames
written once plus the window values, daylight, sleeping flags and noise
seeds of a ``render_cuda.render_win79`` call and the atlas's compact
tables read once, over the HBM's 3.35 TB/s."""

import statistics

from benchmark import harness, peaks

KERNEL = 'render_kernel'


def install(ctx):
  import crafter_tpu_torch.render_cuda as render_cuda
  ctx.hooks['render_bytes'] = []

  def make(original):
    def render_win79(win79, daylight, sleeping, seeds, atlas, *args,
                     **kwargs):
      out = original(win79, daylight, sleeping, seeds, atlas, *args,
                     **kwargs)
      if ctx.tracing:
        ctx.hooks['render_bytes'].append(harness.tensor_bytes(
            win79, daylight, sleeping, seeds, atlas.compact, out))
      return out
    return render_win79

  harness.wrap_attr(ctx, render_cuda, 'render_win79', make)


def read(ctx):
  calls = ctx.hooks.get('render_bytes')
  kernel_s = harness.kernel_mean_s(ctx, KERNEL)
  if not calls or not kernel_s:
    return None
  bound_s = statistics.fmean(calls) / peaks.HBM_BYTES_PER_S
  return 100.0 * bound_s / kernel_s
