"""``worldgen_ms``: the mean device-clock interval of the program's
``generate_world`` span (``worldgen.generate_world``: threefry, the 2-D
noise kernel, the material and object passes) over the passes of the
window, between the CUDA events the span records with no synchronise.
``reset_pass_ms`` less this is the merge into the state."""

from benchmark import program_spans

install = program_spans.install


def read(ctx):
  return program_spans.device_ms(ctx, 'generate_world')
