"""Benchmark of the PyTorch/CUDA port: env-steps/s of the batched engine on
one GPU.

The port's counterpart of ``bench.py:bench_engine``.  At 4096 envs of
``EnvConfig(reward=False)``, with ``reset_batch`` sized as ``bench.py``
sizes it (320 at 4096), it times the state-only engine loop (groups of
``vec_step_group``, K = 10 ticks each: the group tick, the group-end
balance and one reset pass; BASELINE config 2) and the pixel loop (groups of
``vec_step_group_obs``, a 64x64 frame every tick and env, a pixel of every
frame folded into the aggregate; BASELINE config 3).  Actions are drawn on
the device from a key, as ``bench.py`` draws them (``prng.split`` and
``prng.randint`` are ``jax.random``'s bit for bit).  Scans are rounded to
whole groups.

Each configuration: one warm-up scan, then three timed scans between CUDA
events.  After every scan each env must have advanced by the full scan or
reset into a new episode, or the bench raises.  The host's speed varies
between runs, so the best and the median of the repeats are both
reported.

Prints one JSON line: ``bench.py:orchestrate``'s keys (``metric``,
``value``, ``unit``, ``vs_baseline``, ``pixel_value``,
``pixel_vs_baseline``; the baseline is 1M env-steps/s), the medians
(``median_value``, ``pixel_median_value``), every repeat's rate, the
device and, on a GPU, the card's name and power limit as ``nvidia-smi``
reports them.

    python3 bench_cuda.py                      # 4096 envs on the GPU
    python3 bench_cuda.py --device cpu --envs 8 --ticks 20 --pixel-ticks 20

``--device cpu`` runs the plain PyTorch versions on the CPU (a smoke test:
its rates are the CPU's).  Without a GPU the default run stops with an
error.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BASELINE = 1_000_000   # env-steps/s, bench.py's north-star target
REPEATS = 3            # timed scans a configuration, as bench.py


def bench_engine(num_envs, scan_len, render, device):
  """``(best, median, every repeat)`` env-steps/s of one configuration."""
  import torch
  import crafter_tpu_torch as ct
  from crafter_tpu_torch import prng

  dev = torch.device(device)
  cfg = ct.EnvConfig(reward=False)
  core = ct.CrafterEnv(cfg, dev) if render else None
  kk = cfg.balance_every
  # bench.py:57-58: VecEnv's sizing, scaled to the group's K ticks.
  per_tick = min(num_envs, max(32, num_envs // 128))
  reset_batch = min(num_envs, kk * per_tick)
  scan_len = max(kk, scan_len // kk * kk)

  def loop(vs, key):
    aggr = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(scan_len // kk):
      key, k_act = prng.split(key, 2)
      actions = prng.randint(k_act, 0, 17, (kk, num_envs))
      if render:
        vs, outs, obs = ct.vec_step_group_obs(vs, actions, cfg, reset_batch,
                                              core)
        aggr += outs.done.sum() + obs[..., 0, 0, 0].sum()
      else:
        vs, outs = ct.vec_step_group(vs, actions, cfg, reset_batch)
        aggr += outs.done.sum()
    return vs, aggr

  def sync():
    if dev.type == 'cuda':
      torch.cuda.synchronize(dev)

  vs = ct.vec_reset_chunked(ct.home_keys(0, num_envs, dev), cfg)
  vs, _ = loop(vs, prng.key(0, dev))                   # warm-up
  sync()
  rates = []
  for r in range(REPEATS):
    if dev.type == 'cuda':
      start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      start.record()
      vs2, aggr = loop(vs, prng.key(r + 1, dev))
      end.record()
      sync()
      seconds = start.elapsed_time(end) / 1e3
    else:
      t0 = time.perf_counter()
      vs2, aggr = loop(vs, prng.key(r + 1, dev))
      seconds = time.perf_counter() - t0
    # Every env advanced by the full scan or reset into a new episode
    # (which rewinds its step count; episode counts only grow).
    stepped = (vs2.env.step - vs.env.step) == scan_len
    reset = vs2.episode > vs.episode
    bad = int((~(stepped | reset)).sum())
    if bad:
      raise RuntimeError(f'{bad} envs neither stepped nor reset')
    int(aggr)   # read, as bench.py reads its aggregate
    rates.append(num_envs * scan_len / seconds)
    vs = vs2
  return max(rates), statistics.median(rates), rates


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument('--envs', type=int, default=4096)
  ap.add_argument('--ticks', type=int, default=400,
                  help='ticks a scan, state-only')
  ap.add_argument('--pixel-ticks', type=int, default=200,
                  help='ticks a scan, pixel')
  ap.add_argument('--device', default='cuda')
  args = ap.parse_args(argv)
  sys.path.insert(0, str(Path(__file__).resolve().parent))
  import torch
  from crafter_tpu_torch.utils import tool_device
  dev, card = tool_device(args.device, 'bench_cuda')
  if dev.type == 'cuda':
    where = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
             'card': card}
  else:
    where = {'platform': 'cpu', 'kind': 'cpu', 'card': None}

  state = bench_engine(args.envs, args.ticks, False, args.device)
  pixel = bench_engine(args.envs, args.pixel_ticks, True, args.device)
  rec = {
      'metric': f'env-steps/s @ {args.envs} envs (state-only engine loop, '
                f'{where["kind"]})',
      'value': round(state[0]),
      'unit': 'env-steps/s',
      'vs_baseline': round(state[0] / BASELINE, 4),
      'pixel_value': round(pixel[0]),
      'pixel_vs_baseline': round(pixel[0] / BASELINE, 4),
      'median_value': round(state[1]),
      'pixel_median_value': round(pixel[1]),
      'repeats': {'state_only': state[2], 'pixel': pixel[2]},
      'device': where,
  }
  print(json.dumps(rec), flush=True)
  return rec


if __name__ == '__main__':
  main()
