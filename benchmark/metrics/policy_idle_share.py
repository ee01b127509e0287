"""``policy_idle_share``: the share (%) of the device's idle time in the
traced segment that falls inside the program's ``policy`` spans (the
rollout's per-tick forward, ``prng.categorical`` and ``log_softmax``),
intersected on the profiler's clock.  None without device operations."""

from benchmark import program_spans

install = program_spans.install


def read(ctx):
  return program_spans.idle_share(ctx, 'policy')
