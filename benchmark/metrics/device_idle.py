"""``device_idle.<kind>``: the share of the traced window (%) in which no
operation ran on the device: one minus the union of the profiler's kernel,
copy and fill intervals over the window's length."""


def read(ctx):
  t = ctx.trace
  if not t or t['window_s'] <= 0 or t['device_ops'] == 0:
    return None
  return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
