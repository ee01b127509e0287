"""Random-policy benchmark CLI (reference: crafter/run_random.py:1-48).

Prints reset time, steps/s, and resource counts like the reference harness,
plus the batched-engine throughput (use --envs for the vectorized run):

    python -m crafter_tpu_torch.run_random --steps 1000
    python -m crafter_tpu_torch.run_random --envs 4096 --steps 409600

Runs on the first CUDA device; ``--device cpu`` runs the plain PyTorch
versions of the kernels on the CPU.
"""

import argparse
import contextlib
import time

import numpy as np


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--seed', type=int, default=None)
  parser.add_argument('--area', nargs=2, type=int, default=(64, 64))
  parser.add_argument('--view', type=int, nargs=2, default=(9, 9))
  parser.add_argument('--length', type=int, default=10000)
  parser.add_argument('--health', type=int, default=9)
  parser.add_argument('--size', nargs=2, type=int, default=(64, 64))
  parser.add_argument('--steps', type=int, default=1000)
  parser.add_argument('--record', type=str, default=None,
                      help='record stats/video/episodes to this directory '
                           '(reference run_random.py:16,24)')
  parser.add_argument('--envs', type=int, default=0,
                      help='if >0, run the batched VecEnv instead')
  parser.add_argument('--profile', type=str, default=None,
                      help='write a torch.profiler trace to this directory')
  parser.add_argument('--device', type=str, default='cuda')
  args = parser.parse_args(argv)

  import torch
  import crafter_tpu_torch
  from crafter_tpu_torch import rules

  if args.device.startswith('cuda') and not torch.cuda.is_available():
    raise SystemExit(
        'run_random: no CUDA device found.  The engine runs on an NVIDIA '
        'GPU; pass --device cpu to run the plain PyTorch path on the CPU.')

  if args.health != 9:  # run_random.py:21-22 health override
    rules.override_rules(lambda r: r['items']['health'].update(
        max=args.health, initial=args.health))

  sync = (torch.cuda.synchronize if args.device.startswith('cuda')
          else lambda: None)
  if args.envs:
    from crafter_tpu_torch.env import VecEnv
    env = VecEnv(args.envs, seed=args.seed or 0, device=args.device)
    start = time.time()
    env.reset()
    sync()
    print(f'Batched reset time: {1e3 * (time.time() - start):.2f}ms '
          f'({args.envs} envs)')
    rng = np.random.default_rng(args.seed)
    profiler = contextlib.nullcontext()
    if args.profile:
      from crafter_tpu_torch.utils.profiling import trace
      profiler = trace(args.profile)
    start = time.time()
    steps = 0
    with profiler:
      while steps < args.steps:
        _, _, done, _ = env.step(rng.integers(0, 17, args.envs))
        steps += args.envs
      sync()
    duration = time.time() - start
    print(f'Step time: {1e3 * duration / steps:.4f}ms '
          f'({int(steps / duration)} env-steps/s)')
    return

  env = crafter_tpu_torch.Env(
      area=args.area, view=args.view, length=args.length, seed=args.seed,
      size=args.size, device=args.device)
  if args.record:
    from crafter_tpu_torch.recorder import Recorder
    env = Recorder(env, args.record)
  start = time.time()
  env.reset()
  print(f'Reset time: {1e3 * (time.time() - start):.2f}ms')
  start = time.time()
  steps = 0
  done = False
  rng = np.random.default_rng(args.seed)
  while steps < args.steps:
    if done:
      env.reset()
      done = False
    _, _, done, info = env.step(rng.integers(0, 17))
    steps += 1
  duration = time.time() - start
  step_time = duration / steps
  print(f'Step time: {1e3 * step_time:.2f}ms ({int(1 / step_time)} fps)')
  # Resource presence like run_random.py:40-43.
  semantic = info['semantic']
  for name in ('coal', 'iron', 'diamond'):
    count = int((semantic == rules.MAT_ID[name]).sum())
    print(f'{name.title()} count: {count}')


if __name__ == '__main__':
  main()
