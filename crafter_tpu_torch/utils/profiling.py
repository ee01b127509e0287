"""Profiling helpers: a device trace and a host-side section timer (the
port's counterpart of ``crafter_tpu/utils/profiling.py``), the kernel
wrappers' launch counts, and the card's name and power limit, which every
number measured on a card is reported beside."""

from __future__ import annotations

import contextlib
import pathlib
import subprocess
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


def card_line() -> str:
  """The first card's name and power limit, as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


def tool_device(device: str, tool: str):
  """``(torch.device, card)`` for a tool run on ``device``: ``card`` is
  :func:`card_line` on a GPU and None on the CPU.  Stops the tool when
  ``device`` names CUDA and there is no card: a measurement never falls
  back to the CPU."""
  import torch
  dev = torch.device(device)
  if dev.type != 'cuda':
    return dev, None
  if not torch.cuda.is_available():
    raise SystemExit(f'{tool}: no CUDA device (torch.cuda.is_available() is '
                     'false); pass --device cpu to run the plain PyTorch '
                     'path on the CPU')
  return dev, card_line()


def counted_wrappers():
  """``(name, wrapper)`` of every kernel wrapper that counts its launches
  (``wrapper.launches``; the wrappers of the 3-D noise and the roll
  micro-bench, which no path of the package reaches, are left out)."""
  from .. import render_cuda, state, step_cuda
  from ..ops import noise_cuda
  return (('group_tick', step_cuda.group_tick), ('tick', step_cuda.tick),
          ('balance', step_cuda.balance), ('noise2', noise_cuda.noise2),
          ('render_win79', render_cuda.render_win79),
          ('daylight', state.daylight))


def zero_launches() -> None:
  """Sets the launch count of every wrapper of :func:`counted_wrappers` to
  0."""
  for _, fn in counted_wrappers():
    fn.launches = 0


def launches() -> dict:
  """The launches each wrapper of :func:`counted_wrappers` has counted
  since it was last set to 0."""
  return {name: fn.launches for name, fn in counted_wrappers()}
