"""``lstm_idle_share``: the share (%) of the device's idle time in the
traced segment that falls inside the program's recurrent-core spans, the
rollout's per-tick ``lstm`` and learn's ``lstm_scan``: the idle intervals
and the union of both spans' ranges, intersected on the profiler's clock
(``program_spans.idle_share`` over the two).  None without device
operations or without such a span."""

from benchmark import harness, program_spans

install = program_spans.install

SPANS = ('lstm', 'lstm_scan')


def read(ctx):
  reading = ctx.hooks.get(program_spans.KEY, {}).get('trace')
  if not reading:
    return None
  ranges = [r for name in SPANS for r in reading['ranges'].get(name, [])]
  idle = sum(end - start for start, end in reading['idle'])
  if not ranges or idle <= 0:
    return None
  return 100.0 * program_spans.overlap(reading['idle'],
                                       harness._union(ranges)) / idle
