"""The program's own spans and counters
(``crafter_tpu_torch.utils.profiling``), as the per-layer metrics read
them.

``install(ctx)`` sets a sink in the program for the rest of the run, so
only a ``--trace 1`` run whose cell reads one of these metrics turns the
program's spans on; the end-to-end runs leave them off.  In the window the
sink keeps each span's CUDA events under ``crafter.<name>`` in
``ctx.spans`` (the device's clock), its host seconds and the counts.  In
the traced segment the program's spans are ``crafter.<name>`` ranges in
the profiler's trace: a wrapper of ``harness.reduce_trace`` keeps their
union and the device's idle intervals, on the profiler's clock, and hands
``reduce_trace`` the trace's events less the device-side copies of those
ranges (the profiler's GPU user annotations, which are not operations),
so that the summary counts the same operations as a run without spans.

A program without ``set_sink`` (one older than its spans) leaves every
reading empty: the readers then return None.
"""

from __future__ import annotations

import statistics
import types

from benchmark import harness

KEY = 'program_spans'


class _Sink:
  """Keeps what the program hands it while the window records."""

  def __init__(self, ctx):
    self.ctx = ctx
    self.host_s = {}     # span name -> [host seconds]
    self.counts = {}     # counter name -> [(value, limit)]

  def mark(self):
    return self.ctx.marks.mark() if self.ctx.spans.recording else None

  def span(self, name, parent, call, start, end, host_s):
    if start is None or not self.ctx.spans.recording:
      return
    self.ctx.spans.add(f'crafter.{name}', start, end)
    self.host_s.setdefault(name, []).append(host_s)

  def count(self, name, value, limit=None):
    if self.ctx.spans.recording:
      self.counts.setdefault(name, []).append((value, limit))


def install(ctx) -> None:
  """Sets the sink and wraps ``harness.reduce_trace``, once a run."""
  if KEY in ctx.hooks:
    return
  ctx.hooks[KEY] = state = {'sink': None, 'trace': None}
  from crafter_tpu_torch.utils import profiling
  if not hasattr(profiling, 'set_sink'):
    return
  state['sink'] = _Sink(ctx)
  profiling.set_sink(state['sink'])
  ctx.cleanups.append(lambda: profiling.set_sink(None))

  def make(original):
    def reduce_trace(prof, window_s, *args, **kwargs):
      events, state['trace'] = split_trace(prof.events())
      kept = types.SimpleNamespace(events=lambda: events)
      return original(kept, window_s, *args, **kwargs)
    return reduce_trace

  harness.wrap_attr(ctx, harness, 'reduce_trace', make)


def split_trace(events):
  """``(operations, reading)`` of a profiler's events: the events that
  ``reduce_trace`` sums (all but the device-side annotations), and the
  device's idle intervals and each ``crafter.<name>`` range's union over
  the traced segment (first event to last), in seconds."""
  import torch
  cuda = torch.autograd.DeviceType.CUDA
  kept, device, ranges = [], [], {}
  lo = hi = None
  for e in events:
    start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
    lo = start if lo is None else min(lo, start)
    hi = end if hi is None else max(hi, end)
    on_device = e.device_type == cuda
    if on_device and getattr(e, 'is_user_annotation', False):
      continue
    kept.append(e)
    if on_device:
      device.append((start, end))
    elif e.name.startswith('crafter.'):
      ranges.setdefault(e.name[len('crafter.'):], []).append((start, end))
  if not device:
    return kept, None
  return kept, {'idle': idle_intervals(harness._union(device), lo, hi),
                'ranges': {n: harness._union(r) for n, r in ranges.items()}}


def idle_intervals(busy, lo, hi) -> list:
  """The gaps of merged ``busy`` intervals within ``[lo, hi]``."""
  gaps, at = [], lo
  for start, end in busy:
    if start > at:
      gaps.append([at, min(start, hi)])
    at = max(at, end)
  if at < hi:
    gaps.append([at, hi])
  return [g for g in gaps if g[1] > g[0]]


def overlap(a, b) -> float:
  """Total length of the intersection of two lists of merged, sorted
  intervals."""
  total, i, j = 0.0, 0, 0
  while i < len(a) and j < len(b):
    start = max(a[i][0], b[j][0])
    end = min(a[i][1], b[j][1])
    if end > start:
      total += end - start
    if a[i][1] < b[j][1]:
      i += 1
    else:
      j += 1
  return total


# -- what the readers take ---------------------------------------------------

def device_ms(ctx, name: str):
  """Mean device-clock milliseconds of the span ``name`` in the window."""
  ms = ctx.spans.ms(f'crafter.{name}')
  return statistics.fmean(ms) if ms else None


def host_ms(ctx, name: str):
  """Mean host milliseconds inside the span ``name`` in the window."""
  sink = ctx.hooks.get(KEY, {}).get('sink')
  seconds = sink.host_s.get(name) if sink else None
  return 1e3 * statistics.fmean(seconds) if seconds else None


def total(ctx, name: str):
  """The counter ``name`` summed over the window as the program defines a
  count (``profiling.counted``: one synchronise for the device scalars),
  or None when nothing was counted."""
  sink = ctx.hooks.get(KEY, {}).get('sink')
  pairs = sink.counts.get(name) if sink else None
  if not pairs:
    return None
  from crafter_tpu_torch.utils import profiling
  return profiling.counted(pairs)


def idle_share(ctx, name: str):
  """The share (%) of the device's idle time in the traced segment that
  falls inside the program's ``name`` spans, both on the profiler's clock;
  None without device operations or without such a span."""
  reading = ctx.hooks.get(KEY, {}).get('trace')
  if not reading or not reading['ranges'].get(name):
    return None
  idle = sum(end - start for start, end in reading['idle'])
  if idle <= 0:
    return None
  return 100.0 * overlap(reading['idle'], reading['ranges'][name]) / idle
