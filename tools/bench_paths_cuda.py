"""Time the port's state-only, pixel and per-tick paths on one GPU, so that
two trees of the repository can be compared inside one call.

    python3 tools/bench_paths_cuda.py [--root DIR] [--groups 10] [--ticks 20]

Imports ``crafter_tpu_torch`` from DIR (default: this checkout; its kernels
are built there at first use) and, at 4096 envs, times groups of
``vec_step_group`` and of ``vec_step_group_obs`` (K = 10, ``reset_batch``
320, one frame per tick and env, random actions drawn on the card) and
``VecEnv.step`` calls (``reset_batch`` 32) between CUDA events after a
warm-up, then profiles 3 groups of each and 6 ticks (``torch.profiler``):
wall and device-busy ms, and the device time of the group and tick
kernels, the render kernel, the 2-D noise kernel and the balance kernel.
Prints one JSON line with the card's name and power limit.  Needs a GPU.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

N_ENVS, RESET_BATCH = 4096, 320


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument('--root', default=str(Path(__file__).resolve().parent.parent))
  ap.add_argument('--groups', type=int, default=10)
  ap.add_argument('--ticks', type=int, default=20)
  args = ap.parse_args()
  sys.path.insert(0, str(Path(args.root).resolve()))
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('bench_paths_cuda: needs a GPU')
  import crafter_tpu_torch as ct

  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  dev = torch.device('cuda')
  cfg = ct.EnvConfig(reward=False)
  k = cfg.balance_every
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)
  draw = lambda: torch.randint(0, 17, (k, N_ENVS), generator=gen, device=dev,
                               dtype=torch.int32)

  def events(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
      fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

  def profile(fn, reps):
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
      wall = (time.perf_counter() - t0) * 1e3 / reps
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    per_rep = lambda name: sum(e.self_device_time_total for e in dev_events
                               if name in e.key) / 1e3 / reps
    # Launches the profiler recorded, per call: it loses some at times.
    seen = lambda name: sum(e.count for e in dev_events if name in e.key) \
        / reps
    return {'wall_ms': wall, 'device_busy_ms': per_rep(''),
            'tick_kernels_ms': per_rep('tick_kernel'),
            'render_kernel_ms': per_rep('render_kernel'),
            'noise2_kernel_ms': per_rep('noise2'),
            'balance_kernel_ms': per_rep('balance_kernel'),
            'recorded_per_call': {name: seen(name) for name in (
                'tick_kernel', 'render_kernel', 'noise2', 'balance_kernel')}}

  box = [ct.vec_reset_chunked(ct.home_keys(0, N_ENVS, dev), cfg)]

  def group():
    box[0], _ = ct.vec_step_group(box[0], draw(), cfg, RESET_BATCH)

  core = ct.CrafterEnv(cfg, dev)

  def pixel_group():
    box[0], _, _ = ct.vec_step_group_obs(box[0], draw(), cfg, RESET_BATCH,
                                         core)

  out = {'root': args.root, 'card': card}
  out['state_only_ms_per_group'] = events(group, args.groups)
  out['state_only_profile'] = profile(group, 3)
  out['pixel_ms_per_group'] = events(pixel_group, args.groups)
  out['pixel_profile'] = profile(pixel_group, 3)
  venv = ct.VecEnv(N_ENVS, cfg, seed=3, device=dev)
  venv.reset()
  step = lambda: venv.step(draw()[0])
  out['per_tick_ms_per_tick'] = events(step, args.ticks)
  out['per_tick_profile'] = profile(step, 6)
  print(json.dumps(out))


if __name__ == '__main__':
  main()
