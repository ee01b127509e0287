"""Profiling helpers: a device trace (the port's counterpart of
``crafter_tpu/utils/profiling.py``), spans and counters inside the program
with a sink that collects them, the kernel wrappers' launch counts, and the
card's name and power limit, which every number measured on a card is
reported beside."""

from __future__ import annotations

import collections
import contextlib
import itertools
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


# -- spans and counters inside the program --------------------------------
#
# Off by default: while no sink is set, ``span`` hands back one shared null
# context and ``count`` returns at once, after a single check of ``_sink``.

_sink = None
_NULL = contextlib.nullcontext()
_open = []                   # (name, call) of the spans open, outermost first
_calls = itertools.count()


def set_sink(sink) -> None:
  """Turns the program's spans and counters on (``sink``) or off (None).

  A sink has ``mark()``, a point in time (a CUDA event recorded with no
  synchronise, or ``time.perf_counter()`` off the card);
  ``span(name, parent, call, start, end, host_s)``, called as a span
  closes, with the enclosing span's name (None for an outermost one), the
  id that every span of one outermost span shares, the marks taken as the
  span opened and closed, and the host seconds spent inside; and
  ``count(name, value, limit)``, see :func:`count`."""
  global _sink
  _sink = sink


def span(name: str):
  """A context manager around one layer of the program.  While a sink is
  set it opens ``torch.profiler.record_function('crafter.<name>')``, so
  that the span lands in a profiler trace on the clock of the device's
  kernels, and hands the sink its marks and host seconds; it adds no
  device operation and no synchronise."""
  if _sink is None:
    return _NULL
  return _span(_sink, name)


@contextlib.contextmanager
def _span(sink, name: str):
  import torch
  parent, call = _open[-1] if _open else (None, next(_calls))
  _open.append((name, call))
  try:
    with torch.profiler.record_function('crafter.' + name):
      start = sink.mark()
      t0 = time.perf_counter()
      yield
      host_s = time.perf_counter() - t0
      end = sink.mark()
  finally:
    _open.pop()
  sink.span(name, parent, call, start, end, host_s)


def count(name: str, value, limit=None) -> None:
  """Hands the sink ``value`` under ``name``: a host int, or a device
  scalar the program has already computed (read only once the sink sums
  its counts).  With a ``limit`` (an int or a device scalar) the count is
  ``min(value, limit)``, floored at 0, taken when summed: the program
  computes no minimum for it."""
  if _sink is not None:
    _sink.count(name, value, limit)


def counting() -> bool:
  """Whether a sink is set: a count whose value costs device work is
  computed only then."""
  return _sink is not None


def counted(pairs) -> int:
  """The sum of ``[(value, limit)]`` as :func:`count` defines it: device
  scalars are brought to the host together, with one synchronise."""
  import torch
  pairs = list(pairs)
  flat = [x for pair in pairs for x in pair]
  on_device = [x for x in flat if isinstance(x, torch.Tensor)]
  if on_device:
    host = iter(torch.stack([x.reshape(()).to(torch.int64)
                             for x in on_device]).tolist())
    flat = [next(host) if isinstance(x, torch.Tensor) else x for x in flat]
  total = 0
  for value, limit in zip(flat[::2], flat[1::2]):
    total += value if limit is None else max(0, min(value, limit))
  return total


class Collector:
  """A sink that keeps, per span name, the calls, the host milliseconds and
  the device milliseconds, and the sum of each counter: what
  ``run_random --profile`` reports.  Device milliseconds come from the
  pairs of CUDA events, folded in once ``query()`` reports them done, and
  counts are summed a batch at a time, so memory stays bounded.  ``device``: where the program runs (default: the card if
  there is one)."""

  FOLD_COUNTS = 4096

  def __init__(self, device=None):
    import torch
    if device is None:
      device = 'cuda' if torch.cuda.is_available() else 'cpu'
    self._cuda = torch.device(device).type == 'cuda'
    self.spans = {}       # name -> [calls, host ms, device ms]
    self.counters = {}    # name -> sum
    self._events = collections.deque()    # (row, start, end) not yet done
    self._counts = []                     # (name, value, limit) not summed

  def mark(self):
    if not self._cuda:
      return time.perf_counter()
    import torch
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event

  def span(self, name, parent, call, start, end, host_s) -> None:
    row = self.spans.setdefault(name, [0, 0.0, 0.0])
    row[0] += 1
    row[1] += 1e3 * host_s
    if self._cuda:
      self._events.append((row, start, end))
      self._fold_events(wait=False)
    else:
      row[2] += 1e3 * (end - start)

  def count(self, name, value, limit=None) -> None:
    self._counts.append((name, value, limit))
    if len(self._counts) >= self.FOLD_COUNTS:
      self._fold_counts()

  def _fold_events(self, wait: bool) -> None:
    # One stream: events complete in the order they were recorded.
    while self._events and (wait or self._events[0][2].query()):
      row, start, end = self._events.popleft()
      end.synchronize()
      row[2] += start.elapsed_time(end)

  def _fold_counts(self) -> None:
    names = {name for name, _, _ in self._counts}
    for name in names:
      self.counters[name] = self.counters.get(name, 0) + counted(
          (v, lim) for n, v, lim in self._counts if n == name)
    self._counts = []

  def report(self) -> str:
    """One line per span, most host time first, then one per counter by
    name; waits for the device's outstanding spans."""
    self._fold_events(wait=True)
    self._fold_counts()
    lines = [f'{name:<16} {calls:8d} calls  host {host:10.3f} ms  '
             f'device {dev:10.3f} ms'
             for name, (calls, host, dev) in sorted(
                 self.spans.items(), key=lambda kv: -kv[1][1])]
    lines += [f'{name:<16} {total:8d}'
              for name, total in sorted(self.counters.items())]
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
  from .. import prng_cuda, render_cuda, state, step_cuda
  from ..ops import noise_cuda
  return (('group_tick', step_cuda.group_tick), ('tick', step_cuda.tick),
          ('balance', step_cuda.balance), ('noise2', noise_cuda.noise2),
          ('render_win79', render_cuda.render_win79),
          ('daylight', state.daylight), ('threefry', prng_cuda.draw))


def zero_launches() -> None:
  """Sets the launch count of every wrapper of :func:`counted_wrappers` to
  0."""
  for _, fn in counted_wrappers():
    fn.launches = 0


def launches() -> dict:
  """The launches each wrapper of :func:`counted_wrappers` has counted
  since it was last set to 0."""
  return {name: fn.launches for name, fn in counted_wrappers()}
