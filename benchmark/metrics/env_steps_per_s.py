"""``env_steps_per_s``: env-steps of every call in the window over the
window's seconds, from its start to the synchronise after its last call
(host clock)."""


def read(ctx):
  return ctx.work / ctx.window_s if ctx.calls else None
