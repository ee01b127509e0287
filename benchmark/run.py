"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, its traffic mix, its driver and its metric
readers are found by name (``harness.py``).  Set-up (imports, the kernel
library from the build cache in ``build/``, the program's state, the
warm-up) runs first; then the window: calls of the cell's entry for
``--seconds`` seconds, a CUDA event recorded after each with no
synchronise, and a synchronise at the end.  ``--trace 0`` reports the
cell's end-to-end metrics; ``--trace 1`` its per-layer metrics, from the
same window (spans between CUDA events) and from a ``torch.profiler``
trace, kept in memory, of ``trace_calls`` further calls (a reader of an
end-to-end metric that needs such a trace makes it itself, after the
window, in a ``--trace 0`` run: ``device_ns_per_step``).  Then the peak
memory is read, the program's state freed, and the calls that the cell's
``drivers/`` module kept are compared with the plain reference
(``reference/``): each number compared is printed beside its limit, as
the last lines on standard error and under ``checks``, the last key of the
result line.  ``attempted`` is
the calls of the window, ``failed`` the numbers compared that are missing
or over their limits; ``correct`` holds when none is.

Without a CUDA device, or with fewer than the cell asks for, the run
stops with exit code 2 and prints no result: it never falls back to the
CPU.  It stops with exit code 3 if JAX, its libraries or the JAX package
were loaded in this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

# Every build and kernel cache in fixed directories of the checkout, so
# that only a cell's first run there builds.
for _var, _dir in (('TRITON_CACHE_DIR', 'triton'),
                   ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('CUDA_CACHE_PATH', 'nv_compute_cache')):
  os.environ[_var] = str(ROOT / 'build' / _dir)

from benchmark import harness  # noqa: E402


def card_line() -> str:
  """The card's name and power limit as ``nvidia-smi`` reports them."""
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout
  except (OSError, subprocess.SubprocessError) as err:
    return f'nvidia-smi failed: {err}'
  return out.strip().splitlines()[0] if out.strip() else 'unknown'


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = 'cuda', root: pathlib.Path = ROOT,
             t0: float = T0, variant: str = 'program') -> dict:
  """Set up, measure and check one cell; returns the result record.
  ``device='cpu'`` and ``root`` are for the CPU tests; ``variant``
  'control' judges the reference computed in lower precision in the
  program's place (``calibrate.py``)."""
  import torch
  cell = harness.load_cell(name, root)
  torch.set_num_threads(2)
  dev = torch.device(device)
  marks = harness.Marks(dev)
  ctx = harness.Context(cell=cell, seed=seed, device=dev, marks=marks,
                        spans=harness.Spans(marks))
  if dev.type == 'cuda':
    torch.cuda.reset_peak_memory_stats()
  try:
    driver_mod = harness.load_module('drivers', cell.traffic['driver'], root)
    ctx.driver = driver_mod.Driver(ctx)
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m['name']: harness.load_module('metrics', m['name'], root)
               for m in metrics}
    for reader in readers.values():
      if hasattr(reader, 'install'):
        reader.install(ctx)
    marks.sync()

    # The window.
    driver = ctx.driver
    start = marks.mark()
    t_start = time.perf_counter()
    ctx.setup_s = t_start - t0
    deadline = t_start + seconds
    ctx.spans.recording = True
    after = [start]
    while time.perf_counter() < deadline:
      driver.call()
      after.append(marks.mark())
    marks.sync()
    ctx.window_s = time.perf_counter() - t_start
    ctx.spans.recording = False
    ctx.calls = len(after) - 1
    ctx.call_ms = [marks.ms(a, b) for a, b in zip(after, after[1:])]

    if trace:
      ctx.trace = harness.traced(ctx, int(cell.traffic['trace_calls']))
    values = {}
    for m in metrics:
      value = readers[m['name']].read(ctx)
      if value is not None:
        values[m['name']] = {'value': value, 'unit': m['unit']}
  finally:
    for undo in reversed(ctx.cleanups):
      undo()
  device_rec = {'platform': 'gpu' if dev.type == 'cuda' else dev.type,
                'kind': (torch.cuda.get_device_name(dev)
                         if dev.type == 'cuda' else 'cpu'),
                'count': cell.chips,
                'memory_peak_bytes': (torch.cuda.max_memory_allocated(dev)
                                      if dev.type == 'cuda' else 0)}
  if trace:
    device_rec.update(busy_s=ctx.trace['busy_s'],
                      window_s=ctx.trace['window_s'])
  found = harness.forbidden_modules()
  driver.release()
  if dev.type == 'cuda':
    torch.cuda.empty_cache()
  t_check = time.perf_counter()
  checks = driver.checks(variant)
  ctx.check_s = time.perf_counter() - t_check
  correct, failed = harness.judge(checks)
  rec = {'correct': correct, 'attempted': ctx.calls, 'failed': failed,
         'metrics': values, 'device': device_rec}
  if trace:
    rec['breakdown'] = {'device_ops': ctx.trace['top_ops'],
                        'idle_gaps': ctx.trace['idle_gaps']}
  rec['checks'] = {n: {'value': v, 'limit': lim} for n, v, lim in checks}
  rec['forbidden_modules'] = found
  rec['phases'] = {'setup_s': ctx.setup_s, 'window_s': ctx.window_s,
                   'check_s': ctx.check_s}
  return rec


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)
  cell = harness.load_cell(args.workload)
  import torch
  if not torch.cuda.is_available():
    print('benchmark: no CUDA device (torch.cuda.is_available() is false); '
          'a measurement never falls back to the CPU', file=sys.stderr)
    return 2
  if torch.cuda.device_count() < cell.chips:
    print(f'benchmark: {args.workload} needs {cell.chips} CUDA devices, '
          f'{torch.cuda.device_count()} found', file=sys.stderr)
    return 2
  card = card_line()
  print(f'card: {card}', file=sys.stderr, flush=True)
  rec = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
  found = sorted(set(rec.pop('forbidden_modules'))
                 | set(harness.forbidden_modules()))
  if found:
    print(f'benchmark: {", ".join(found)} loaded in the measuring process',
          file=sys.stderr)
    return 3
  rec['device']['power_limit'] = card.split(',')[-1].strip()
  print('phases: ' + ', '.join(f'{k} {v:.3f}' for k, v in
                              rec.pop('phases').items()), file=sys.stderr)
  checks = rec.pop('checks')
  rec['checks'] = checks
  for line in harness.checks_text([(n, c['value'], c['limit'])
                                   for n, c in checks.items()]):
    print(line, file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(rec), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
