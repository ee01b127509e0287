"""``setup_s``: seconds from the start of the process to the first timed
call (imports, the kernel library from the build cache, the program's
state, the warm-up)."""


def read(ctx):
  return ctx.setup_s
