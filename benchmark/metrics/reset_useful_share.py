"""``reset_useful_share``: envs reset over worlds made by the reset passes
of the window (%), from the program's counters ``envs_reset`` and
``worlds_made``.  On the card a pass makes ``min(reset_batch, n)`` worlds
whatever number of envs finished; the rest are thrown away."""

from benchmark import program_spans

install = program_spans.install


def read(ctx):
  made = program_spans.total(ctx, 'worlds_made')
  if not made:
    return None
  return 100.0 * program_spans.total(ctx, 'envs_reset') / made
