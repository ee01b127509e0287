"""``reset_host_ms``: the mean host milliseconds spent inside the program's
``reset_pass`` span (``env._reset_pass``) over the passes of the window:
the time the host takes to issue a pass.  Near ``reset_pass_ms``, issuing
the pass sets its pace; far under it, the device does."""

from benchmark import program_spans

install = program_spans.install


def read(ctx):
  return program_spans.host_ms(ctx, 'reset_pass')
