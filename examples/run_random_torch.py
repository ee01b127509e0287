"""1M-step random agent with full recording on the port (the counterpart of
``examples/run_random.py``; reference: examples/run_random.py:1-29),
batched: one ``VecEnv`` loop of ``num_envs`` envs, numpy's
``default_rng(0)`` drawing the actions, a ``VecStatsRecorder`` writing one
``stats.jsonl`` line per finished episode.

    python examples/run_random_torch.py                 # on the GPU
    python examples/run_random_torch.py --device cpu --steps 2048 --envs 32
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

# Runnable as a plain script: put the repo root on sys.path so
# crafter_tpu_torch imports without an installed package.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from crafter_tpu_torch.env import VecEnv  # noqa: E402
from crafter_tpu_torch.recorder import VecStatsRecorder  # noqa: E402


def main(steps=1_000_000, num_envs=256, outdir='logdir/random',
         device='cuda'):
  if device.startswith('cuda') and not torch.cuda.is_available():
    raise SystemExit('run_random_torch: no CUDA device (pass --device cpu to '
                     'run the plain PyTorch path on the CPU)')
  env = VecEnv(num_envs, seed=0, device=device)
  recorder = VecStatsRecorder(num_envs, outdir)
  env.reset()
  rng = np.random.default_rng(0)
  done_steps = 0
  while done_steps < steps:
    actions = rng.integers(0, 17, num_envs)
    _, reward, done, info = env.step(actions)
    recorder.add(info['reward'].cpu().numpy(), done.cpu().numpy(),
                 info['achievements'].cpu().numpy(),
                 ended=info['ended'].cpu().numpy())
    done_steps += num_envs
  print('Recorded', done_steps, 'steps to', outdir)


if __name__ == '__main__':
  ap = argparse.ArgumentParser()
  ap.add_argument('--steps', type=int, default=1_000_000)
  ap.add_argument('--envs', type=int, default=256)
  ap.add_argument('--outdir', default='logdir/random')
  ap.add_argument('--device', default='cuda')
  args = ap.parse_args()
  main(args.steps, args.envs, args.outdir, args.device)
