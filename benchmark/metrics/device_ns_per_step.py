"""``device_ns_per_step``: the device's busy nanoseconds per env-step: the
union of the kernel, copy and fill intervals that ``torch.profiler``
records over ``trace_calls`` calls, over the env-steps of those calls.
Where the host sets the loop's pace, the rate and the step times follow the
host's speed, which drifts from run to run and from machine to machine;
this is the device's own cost of a step, which they hide.  A ``--trace 0``
run makes the traced calls after its window has closed, so the window is
as it was without them."""

from benchmark import harness


def read(ctx):
  trace = ctx.trace or harness.traced(ctx,
                                      int(ctx.cell.traffic['trace_calls']))
  if not trace['device_ops']:
    return None
  steps = trace['ticks'] * ctx.driver.work_per_call // ctx.driver.ticks_per_call
  return 1e9 * trace['busy_s'] / steps
