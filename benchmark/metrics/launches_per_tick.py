"""``launches_per_tick.<kind>``: device operations (kernels, copies,
fills) the profiler recorded over the traced calls, per env tick they
stepped: the host's launch work, counted exactly."""


def read(ctx):
  t = ctx.trace
  if not t or t['device_ops'] == 0:
    return None
  return t['device_ops'] / t['ticks']
