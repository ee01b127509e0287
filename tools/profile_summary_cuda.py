"""Capture a device trace of the engine loop and print per-op timings.

The counterpart of ``tools/profile_summary.py`` for ``crafter_tpu_torch``:
``torch.profiler`` (``crafter_tpu_torch/utils/profiling.py:trace``) in
place of ``jax.profiler``, and a table of the top device ops by self time
(``key_averages()``) in place of the ``hlo_stats`` view, so a profile is
one command:

    python tools/profile_summary_cuda.py --num_envs 4096 --iters 20
    python tools/profile_summary_cuda.py --group      # the group kernel path
    python tools/profile_summary_cuda.py --render     # the pixel path
    python tools/profile_summary_cuda.py --trace logdir/profile_summary
    python tools/profile_summary_cuda.py --device cpu --num_envs 8 --iters 10

The loop mirrors the JAX tool's: groups of K = 10 ticks, the actions of a
group drawn from one key (``key, k = split(key)``, ``randint(k, (K, n))``),
each tick a ``vec_step`` with the balance on the group's last tick (by
default), or the group as one ``vec_step_group`` (``--group``) or
``vec_step_group_obs`` with a frame a tick (``--render``).  One warm-up
loop, then the same loop traced; the table is per tick of it (iters rounded
down to whole groups).  ``trace.json`` (Chrome / Perfetto) goes to
``--logdir``; ``--trace DIR`` prints the table of the ``trace.json`` in DIR
instead of running again.

The profiler loses kernel records at times, so the total device time it
prints is a floor.  On a GPU the record also holds the card's name and
power limit and the traced loop's kernel launches (counted from 0 after
the warm-up).  ``--device cpu`` runs the plain PyTorch versions on the CPU,
where the profiler sees no device and the table is empty; without a GPU
the default run stops with an error.
"""

import pathlib as _pathlib
import sys as _sys

# Runnable as a plain script: put the repo root on sys.path so
# crafter_tpu_torch imports without an installed package.
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402

# The trace's device-side event categories (kernels, copies, fills).
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def capture(num_envs: int, iters: int, trace_dir: str, group: bool = False,
            render: bool = False, device: str = 'cuda'):
  """Runs the traced loop.  Returns ``(ticks, rows, launches)``: the ticks
  the loop ran (iters rounded down to whole balance-cadence groups), which
  :func:`summarize` must use as the per-tick normaliser, the device ops
  (:func:`rows_from_profiler`) and the loop's kernel launches."""
  import torch
  from crafter_tpu_torch import prng
  from crafter_tpu_torch.config import EnvConfig
  from crafter_tpu_torch.env import (CrafterEnv, home_keys,
                                     vec_reset_chunked, vec_step,
                                     vec_step_group, vec_step_group_obs)
  from crafter_tpu_torch.utils import launches, trace, zero_launches

  dev = torch.device(device)
  cfg = EnvConfig(reward=False)
  core = CrafterEnv(cfg, dev) if render else None
  n = num_envs
  vs = vec_reset_chunked(home_keys(0, n, dev), cfg, chunk=min(n, 4096))
  rb = max(32, n // 128)
  kk = cfg.balance_every
  groups = max(iters // kk, 1)

  def loop(v, key):
    aggr = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(groups):
      key, k = prng.split(key, 2)
      a = prng.randint(k, 0, 17, (kk, n))
      if render:
        v, outs, obs = vec_step_group_obs(v, a, cfg, min(n, kk * rb), core)
        aggr += outs.done.sum() + obs[..., 0, 0, 0].sum()
      elif group:
        v, _outs = vec_step_group(v, a, cfg, min(n, kk * rb))
      else:
        for i in range(kk):
          v, _out, _ = vec_step(v, a[i], cfg, rb, balance=(i == kk - 1))
    return v, aggr

  key = prng.key(0, dev)
  v, aggr = loop(vs, key)
  # Host reads wait for the device; aggr also reads every frame batch.
  v.env.step.sum().item(); aggr.item()
  zero_launches()
  with trace(trace_dir) as prof:
    v, aggr = loop(v, key)
    v.env.step.sum().item(); aggr.item()
  return groups * kk, rows_from_profiler(prof), launches()


def rows_from_profiler(prof):
  """``[(name, self device us, occurrences)]`` of the device ops a finished
  ``torch.profiler`` run recorded, by ``key_averages()``."""
  import torch
  return [(e.key, e.self_device_time_total, e.count)
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]


def rows_from_trace(trace_dir: str):
  """The rows of :func:`rows_from_profiler` read back from the
  ``trace.json`` that ``utils.profiling.trace`` wrote into ``trace_dir``:
  its device events summed by name."""
  path = _pathlib.Path(trace_dir) / 'trace.json'
  events = json.loads(path.read_text())['traceEvents']
  sums = {}
  for ev in events:
    if ev.get('ph') == 'X' and ev.get('cat') in DEVICE_CATS:
      us, count = sums.get(ev['name'], (0.0, 0))
      sums[ev['name']] = (us + float(ev.get('dur', 0.0)), count + 1)
  return [(name, us, count) for name, (us, count) in sums.items()]


def summarize(rows, per: int, top: int, unit: str = 'tick'):
  """Prints the ``top`` device ops by self time, in ms per ``unit`` (the
  run's ``per`` units), their occurrences and names, and the total.
  Returns ``(top rows as dicts, total ms per unit)``."""
  rows = sorted(rows, key=lambda r: -r[1])
  total = sum(r[1] for r in rows) / per / 1000
  head = f'ms/{unit}'
  print(f'{head:>9} {"x":>5}  op')
  table = []
  for name, us, count in rows[:top]:
    ms = us / per / 1000
    print(f'{ms:9.4f} {count:5d}  {name[:96]}')
    table.append(dict(name=name, ms=ms, count=count))
  print(f'total device self time: {total:.4f} ms/{unit} (a floor: the '
        'profiler loses kernel records)')
  return table, total


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--num_envs', type=int, default=4096)
  parser.add_argument('--iters', type=int, default=20)
  parser.add_argument('--trace', type=str, default=None,
                      help='reparse the trace.json in this dir instead of '
                           'running')
  parser.add_argument('--logdir', type=str,
                      default='logdir/profile_summary',
                      help='where the run writes its trace.json')
  parser.add_argument('--top', type=int, default=20)
  parser.add_argument('--group', action='store_true',
                      help='profile the fused group-kernel path')
  parser.add_argument('--render', action='store_true',
                      help='profile the fused pixel path (group + frames)')
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  if args.trace:
    table, total = summarize(rows_from_trace(args.trace), args.iters,
                             args.top)
    rec = dict(ticks=args.iters, top=table, total_ms=total,
               trace=args.trace)
    print(json.dumps(rec), flush=True)
    return rec
  from crafter_tpu_torch.utils import tool_device
  dev, card = tool_device(args.device, 'profile_summary_cuda')
  ticks, rows, counts = capture(args.num_envs, args.iters, args.logdir,
                                args.group, args.render, args.device)
  table, total = summarize(rows, ticks, args.top)
  rec = dict(ticks=ticks, top=table, total_ms=total, trace=args.logdir,
             device=str(dev), card=card,
             launches=counts if dev.type == 'cuda' else None)
  print(json.dumps(rec), flush=True)
  return rec


if __name__ == '__main__':
  main()
