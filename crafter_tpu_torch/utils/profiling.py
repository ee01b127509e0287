"""Profiling helpers: a device trace and a host-side section timer (the
port's counterpart of ``crafter_tpu/utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import pathlib
import time


@contextlib.contextmanager
def trace(logdir: str):
  """Capture a ``torch.profiler`` trace of the host and, where there is
  one, the card: yields the profiler (``key_averages()`` for sums by
  kernel) and writes ``trace.json`` (Chrome / Perfetto format) into
  ``logdir`` on exit."""
  import torch
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  path = pathlib.Path(logdir)
  path.mkdir(parents=True, exist_ok=True)
  with torch.profiler.profile(activities=activities) as prof:
    yield prof
  prof.export_chrome_trace(str(path / 'trace.json'))


class Timer:
  """Tiny wall-clock section timer for host-side loops.  Device work is
  asynchronous: a section that should include it has to end in
  ``torch.cuda.synchronize()``."""

  def __init__(self):
    self.sections = {}

  @contextlib.contextmanager
  def section(self, name: str):
    t0 = time.perf_counter()
    try:
      yield
    finally:
      self.sections[name] = (self.sections.get(name, 0.0)
                             + time.perf_counter() - t0)

  def report(self) -> str:
    total = sum(self.sections.values()) or 1.0
    lines = [f'{name:<20} {dt:8.3f}s {100 * dt / total:5.1f}%'
             for name, dt in sorted(self.sections.items(),
                                    key=lambda kv: -kv[1])]
    return '\n'.join(lines)
