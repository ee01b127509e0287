"""Time the render kernel of one tree of the repository on one GPU, so that
two trees can be compared inside one call.

    python3 tools/bench_render_cuda.py [--root DIR] [--tag NAME]

Imports ``crafter_tpu_torch`` from DIR (default: this checkout; its kernels
are built there at first use), makes 4096 fresh worlds and one pixel
group's 40960 frames of them (players anywhere, steps over a whole day, a
fifth asleep, inventories of 0..12) and times ``render_win79`` with 64x64
frames out on all 40960 and on the first 4096 frames: CUDA events around
20 calls, the median and the least of 7 such spans, after a warm-up.
Prints one line, with the card's name and power limit.  Run it for the
parent, the change, the change and the parent in one command to compare.
Needs a GPU.
"""

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

FRAMES = (40960, 4096)
SPANS, CALLS = 7, 20


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument('--root', default=str(Path(__file__).resolve().parent.parent))
  ap.add_argument('--tag', default='')
  args = ap.parse_args()
  sys.path.insert(0, str(Path(args.root).resolve()))
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('bench_render_cuda: needs a GPU')
  import crafter_tpu_torch as ct
  from crafter_tpu_torch import render_cuda

  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  dev = torch.device('cuda')
  cfg = ct.EnvConfig()
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)
  rnd = lambda hi, shape: torch.randint(0, hi, shape, generator=gen,
                                        device=dev, dtype=torch.int32)
  env = ct.vec_reset(ct.home_keys(1, 4096, dev), cfg).env
  b = FRAMES[0]
  reps = b // 4096
  packed = ct.pack_cells(env.mat_map, env.ent.etype, env.ent.aux,
                         env.ent.facing).repeat(reps, 1)
  win = ct.window_prep(packed, rnd(64, (b, 2)), rnd(4, (b,)),
                       rnd(5, (b,)) == 0, rnd(13, (b, 16)), cfg)
  steps = torch.arange(b, device=dev, dtype=torch.int32) % cfg.day_length
  light = ct.daylight(steps, cfg.day_length)
  sleeping = rnd(5, (b,)) == 0
  seeds = ct.noise_seed(env.key.repeat(reps, 1), steps)
  atlas = ct.bake_atlas(cfg.size, cfg.view, cfg.item_rows, dev)
  out = {}
  for n in FRAMES:
    call = lambda: render_cuda.render_win79(
        win[:n], light[:n], sleeping[:n], seeds[:n], atlas, cfg.size,
        'frames')
    call()
    torch.cuda.synchronize()
    spans = []
    for _ in range(SPANS):
      start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
      start.record()
      for _ in range(CALLS):
        call()
      end.record()
      torch.cuda.synchronize()
      spans.append(start.elapsed_time(end) / CALLS)
    out[n] = (statistics.median(spans), min(spans))
  print(args.tag, card, {n: f'median {m:.4f} min {lo:.4f} ms'
                         for n, (m, lo) in out.items()}, flush=True)


if __name__ == '__main__':
  main()
