"""``reset_idle_share.<kind>``: the share (%) of the device's idle time in
the traced segment that falls inside the program's ``reset_pass`` spans:
the idle intervals (the segment less the union of device operations) and
the union of the ``crafter.reset_pass`` ranges, intersected on the
profiler's clock.  None without device operations."""

from benchmark import program_spans

install = program_spans.install


def read(ctx):
  return program_spans.idle_share(ctx, 'reset_pass')
