"""The benchmark's general machinery: finding a cell's files by name,
timing marks, the measured window, the reduction of a profiler trace, the
check for JAX in the process and the result line.

Everything that belongs to one configuration, one traffic mix or one
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``benchmark/configs/<file>``: a configuration's sizes (the ``file`` of
  its entry);
* ``benchmark/workloads/<traffic>.json``: a traffic mix, naming its driver
  and holding its parameters and the limits of its check;
* ``benchmark/drivers/<driver>.py``: a ``Driver`` class that sets up the
  program, makes one call of its entry, and checks the calls it kept
  against the plain reference;
* ``benchmark/metrics/<name>.py``, or ``<prefix>.py`` for a metric named
  ``<prefix>.<suffix>``: a ``read(ctx)`` that returns the metric or None,
  and optionally an ``install(ctx)`` that wraps what it needs to watch.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import pathlib
import random
import sys
import time
from typing import Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'crafter_tpu')


@dataclasses.dataclass
class Cell:
  """One entry of ``workloads`` with the files it names."""

  name: str
  chips: int
  config: dict          # the configuration file, parsed
  traffic: dict         # the traffic file, parsed
  end_to_end: list      # the metric entries this cell reports
  per_layer: list


def load_json(path: pathlib.Path) -> dict:
  with open(path) as f:
    return json.load(f)


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
  bench = load_json(root / 'BENCHMARK.json')
  entry = next((w for w in bench['workloads'] if w['name'] == name), None)
  if entry is None:
    raise SystemExit(f'no workload named {name!r} in BENCHMARK.json')
  conf = next(c for c in bench['configs'] if c['name'] == entry['config'])
  mine = lambda m: name in m.get('workloads', [name])
  return Cell(
      name=name, chips=int(entry['chips']),
      config=load_json(root / conf['file']),
      traffic=load_json(root / 'benchmark' / 'workloads'
                        / f'{entry["traffic"]}.json'),
      end_to_end=[m for m in bench['end_to_end'] if mine(m)],
      per_layer=[m for m in bench['per_layer'] if mine(m)])


def load_module(kind: str, name: str, root: pathlib.Path = ROOT):
  """``benchmark/<kind>/<name>.py`` as a module; a dotted metric name falls
  back to the file of its first part."""
  folder = root / 'benchmark' / kind
  path = folder / f'{name}.py'
  if not path.exists():
    path = folder / f'{name.split(".")[0]}.py'
  spec = importlib.util.spec_from_file_location(
      f'benchmark_{kind}_{name.replace(".", "_").replace("-", "_")}', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def sample(seed: int, tag: str, population: int, count: int) -> list:
  """``count`` distinct indices below ``population``, drawn from the seed."""
  rng = random.Random(f'{seed}:{tag}')
  return sorted(rng.sample(range(population), min(count, population)))


class Marks:
  """Points in time on the device's stream (CUDA events, recorded with no
  synchronise) or, off the card, on the host clock."""

  def __init__(self, device):
    import torch
    self._cuda = torch.device(device).type == 'cuda'
    self._torch = torch

  def mark(self):
    if not self._cuda:
      return time.perf_counter()
    event = self._torch.cuda.Event(enable_timing=True)
    event.record()
    return event

  def ms(self, a, b) -> float:
    return a.elapsed_time(b) if self._cuda else (b - a) * 1e3

  def sync(self):
    if self._cuda:
      self._torch.cuda.synchronize()


class Spans:
  """Named intervals between marks, kept while ``recording`` is set:
  drivers and metric hooks add them, readers take their mean."""

  def __init__(self, marks: Marks):
    self.marks = marks
    self.recording = False
    self._pairs = {}

  def add(self, name: str, start, end) -> None:
    if self.recording:
      self._pairs.setdefault(name, []).append((start, end))

  def ms(self, name: str) -> list:
    return [self.marks.ms(a, b) for a, b in self._pairs.get(name, [])]


@dataclasses.dataclass
class Context:
  """What a metric reader reads: the cell, the window's counts and marks,
  the spans, the trace summary and what hooks left."""

  cell: Cell
  seed: int
  device: object
  marks: Marks
  spans: Spans
  driver: object = None
  setup_s: float = 0.0
  window_s: float = 0.0
  calls: int = 0
  call_ms: list = dataclasses.field(default_factory=list)
  trace: Optional[dict] = None
  tracing: bool = False
  check_s: float = 0.0
  hooks: dict = dataclasses.field(default_factory=dict)
  cleanups: list = dataclasses.field(default_factory=list)

  @property
  def work(self) -> int:
    return self.calls * self.driver.work_per_call


def wrap_attr(ctx: Context, owner, name: str, make) -> None:
  """Replace ``owner.name`` by ``make(original)`` until the run ends.  The
  wrapper carries the original's attributes (a kernel wrapper counts its
  launches on itself), and hands them back at the end."""
  original = getattr(owner, name)
  wrapped = functools.update_wrapper(make(original), original)

  def undo():
    setattr(owner, name, original)
    for key in list(original.__dict__):
      if key in wrapped.__dict__ and key != '__wrapped__':
        setattr(original, key, wrapped.__dict__[key])

  setattr(owner, name, wrapped)
  ctx.cleanups.append(undo)


# -- the profiler's trace ---------------------------------------------------

def _union(intervals):
  """Merged ``[(start, end)]`` of sorted-or-not intervals."""
  merged = []
  for start, end in sorted(intervals):
    if merged and start <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], end)
    else:
      merged.append([start, end])
  return merged


def reduce_trace(prof, window_s: float, top: int = 10) -> dict:
  """The device's busy time, operation count, time by operation name and
  idle gaps by what the host was doing, from a ``torch.profiler`` run
  (kept in memory).  Times in seconds."""
  import torch
  cuda = torch.autograd.DeviceType.CUDA
  device_ops, host_ops = [], []
  for e in prof.events():
    span = (e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
    (device_ops if e.device_type == cuda else host_ops).append(span)
  by_name = {}
  for start, end, name in device_ops:
    count, total = by_name.get(name, (0, 0.0))
    by_name[name] = (count + 1, total + (end - start))
  merged = _union([(s, e) for s, e, _ in device_ops])
  busy = sum(e - s for s, e in merged)
  # Each gap between device operations, named by the innermost host
  # operation running where it starts: one sweep over the host operations
  # in order of start, a stack of the open ones (they nest).
  host_ops.sort()
  gaps, stack, i = {}, [], 0
  for (_, prev_end), (next_start, _) in zip(merged, merged[1:]):
    while i < len(host_ops) and host_ops[i][0] <= prev_end:
      while stack and stack[-1][1] <= host_ops[i][0]:
        stack.pop()
      stack.append(host_ops[i])
      i += 1
    while stack and stack[-1][1] <= prev_end:
      stack.pop()
    name = stack[-1][2] if stack else 'python, no operator'
    gaps[name] = gaps.get(name, 0.0) + (next_start - prev_end)
  order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
  return dict(
      busy_s=busy, window_s=window_s, device_ops=len(device_ops),
      kernels=by_name,
      top_ops=[[n[:160], t] for n, (_, t) in sorted(
          by_name.items(), key=lambda kv: -kv[1][1])[:top]],
      idle_gaps=[[n[:160], t] for n, t in order(gaps)])


def traced(ctx: Context, calls: int) -> dict:
  """``calls`` further calls under ``torch.profiler``, reduced in memory."""
  import torch
  activities = [torch.profiler.ProfilerActivity.CPU]
  if ctx.device.type == 'cuda':
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  ctx.tracing = True
  with torch.profiler.profile(activities=activities) as prof:
    ctx.marks.sync()
    t = time.perf_counter()
    for _ in range(calls):
      ctx.driver.call()
    ctx.marks.sync()
    window_s = time.perf_counter() - t
  ctx.tracing = False
  summary = reduce_trace(prof, window_s)
  summary['ticks'] = calls * ctx.driver.ticks_per_call
  return summary


def kernel_mean_s(ctx: Context, fragment: str) -> Optional[float]:
  """Mean device seconds of the traced launches whose name holds
  ``fragment``, or None when the trace recorded none."""
  if not ctx.trace:
    return None
  hits = [(c, t) for n, (c, t) in ctx.trace['kernels'].items()
          if fragment in n]
  count = sum(c for c, _ in hits)
  return sum(t for _, t in hits) / count if count else None


def tensor_bytes(*trees, seen=None) -> int:
  """Bytes of every distinct tensor in ``trees`` (dataclasses, tuples,
  lists and dicts are walked; a tensor whose storage was already counted
  is not counted again)."""
  import torch
  seen = set() if seen is None else seen
  total = 0
  stack = list(trees)
  while stack:
    x = stack.pop()
    if isinstance(x, torch.Tensor):
      key = (x.data_ptr(), x.nbytes)
      if key not in seen:
        seen.add(key)
        total += x.nbytes
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
      stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    elif isinstance(x, (tuple, list)):
      stack.extend(x)
    elif isinstance(x, dict):
      stack.extend(x.values())
  return total


# -- the end of a run ------------------------------------------------------

def forbidden_modules() -> list:
  """Modules in this process whose top-level name is JAX's, its
  libraries' or the JAX package's (names compared whole)."""
  return sorted({m.split('.')[0] for m in sys.modules
                 if m.split('.')[0] in FORBIDDEN})


def judge(checks: list) -> tuple[bool, int]:
  """``(correct, failed)`` of ``[(name, value, limit)]``: a number
  that is missing or not finite fails."""
  failed = sum(1 for _, value, limit in checks
               if value is None or not value == value or value > limit)
  return failed == 0 and bool(checks), failed


def checks_text(checks: list) -> list:
  return [f'check {name}: {value!r} (limit {limit!r})'
          for name, value, limit in checks]
