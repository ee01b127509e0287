"""Random-policy baseline on the port: 1M env steps -> stats.jsonl -> Crafter
score.

The counterpart of ``tools/random_baseline.py`` for ``crafter_tpu_torch``.
Random actions over the per-tick ``vec_step`` loop at ``--envs`` envs of
``EnvConfig(reward=False)`` (reset budget ``max(32, n // 128)`` a tick),
one ``stats.jsonl`` line per finished episode (``VecStatsRecorder``), scored
by the reference's geometric-mean pipeline (``analysis.read_stats`` and
``crafter_score``).  Every draw is the JAX tool's: ``key, k = split(key)``
and ``randint(k, (n,), 0, 17)`` each tick through ``prng`` (``jax.random``'s
bits), so for a seed the two tools write the same ``stats.jsonl``.

The loop runs in chunks of K = 64 ticks: reward, done, ended and the
stepped state's achievements stay on the device for a chunk, cross to the
host once, and go to the recorder tick by tick in order (the JAX tool's one
dispatch a chunk).  It runs until ``steps + steps // 8`` env steps: the
score counts only episodes that finished inside the budget, and the last
ones are still running at the cutoff.

    python tools/random_baseline_cuda.py --steps 1000000 --envs 512 \\
        --outdir logdir/random
    python tools/random_baseline_cuda.py --seeds 3    # mean and std
    python tools/random_baseline_cuda.py --device cpu --envs 32 --steps 4096

Prints the JAX tool's two lines (env steps and rate; ``random: crafter
score X ± Y % (score file)``) and one JSON line with the score, the success
rate of every achievement, the rate, and on a GPU the card's name and power
limit and the timed loop's kernel launches (counted from 0 after the
initial reset).  The score file goes to ``scores/`` under the working
directory, as the JAX tool writes it.  ``--seeds N`` runs one subprocess a
seed into ``logdir/random_ci/<seed>`` and prints the JAX tool's JSON keys.
``--device cpu`` runs the plain PyTorch versions of the kernels; without a
GPU the default run stops with an error.
"""

import pathlib as _pathlib
import sys as _sys

# Runnable as a plain script: put the repo root on sys.path so
# crafter_tpu_torch imports without an installed package.
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

K = 64               # ticks a chunk: one host copy of the chunk's outputs
GOLDEN = 1.55        # the reference's random baseline, recomputed


def multi(argv):
  """``--seeds N``: N independent baselines, one subprocess a seed, and
  their mean ± std beside the reference's golden recompute.  Returns the
  printed record."""
  import numpy as np
  from crafter_tpu_torch.utils import tool_device
  ap = argparse.ArgumentParser()
  ap.add_argument('--seeds', type=int, required=True)
  ap.add_argument('--steps', type=int, default=1_000_000)
  ap.add_argument('--envs', type=int, default=512)
  ap.add_argument('--device', default='cuda')
  args = ap.parse_args(argv)
  card = tool_device(args.device, 'random_baseline_cuda')[1]
  scores, runs = [], []
  for seed in range(args.seeds):
    out = subprocess.run(
        [_sys.executable, __file__, '--steps', str(args.steps), '--envs',
         str(args.envs), '--seed', str(seed), '--device', args.device,
         '--outdir', f'logdir/random_ci/{seed}'],
        capture_output=True, text=True, timeout=1800)
    m = re.search(r'random: crafter score ([0-9.]+)', out.stdout)
    if out.returncode or not m:
      print(f'seed {seed} FAILED:\n{out.stdout}\n{out.stderr}',
            file=_sys.stderr)
      continue
    scores.append(float(m.group(1)))
    runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(f'seed {seed}: {scores[-1]:.3f}', flush=True)
  arr = np.array(scores)
  rec = dict(
      metric='random_crafter_score', seeds=len(arr),
      mean=round(float(arr.mean()), 3) if len(arr) else None,
      std=round(float(arr.std(ddof=1)), 3) if len(arr) > 1 else 0.0,
      values=[round(v, 3) for v in arr.tolist()],
      golden_recompute=GOLDEN, card=card,
      env_steps_per_s=[r['env_steps_per_s'] for r in runs])
  print(json.dumps(rec), flush=True)
  return rec


def main(argv=None):
  argv = _sys.argv[1:] if argv is None else list(argv)
  if '--seeds' in argv:
    return multi(argv)
  ap = argparse.ArgumentParser()
  ap.add_argument('--steps', type=int, default=1_000_000)
  ap.add_argument('--envs', type=int, default=512)
  ap.add_argument('--seed', type=int, default=0)
  ap.add_argument('--outdir', type=str, default='logdir/random')
  ap.add_argument('--device', default='cuda')
  args = ap.parse_args(argv)
  from crafter_tpu_torch.utils import tool_device
  dev, card = tool_device(args.device, 'random_baseline_cuda')

  import numpy as np
  import torch
  from crafter_tpu_torch import analysis, prng
  from crafter_tpu_torch.config import EnvConfig
  from crafter_tpu_torch.env import home_keys, vec_reset_chunked, vec_step
  from crafter_tpu_torch.recorder import VecStatsRecorder
  from crafter_tpu_torch.utils import launches, zero_launches

  n = args.envs
  cfg = EnvConfig(reward=False)
  rb = max(32, n // 128)
  vs = vec_reset_chunked(home_keys(args.seed, n, dev), cfg)
  rec = VecStatsRecorder(n, args.outdir)

  key = prng.key(args.seed, dev)
  zero_launches()
  t0 = time.perf_counter()
  steps = 0
  # Overshoot the budget by ~10%: the score pipeline only counts episodes
  # that *completed* within the logged steps (read_metrics.py:45-64
  # semantics), and the last episodes are still in flight at the cutoff.
  target = args.steps + args.steps // 8
  while steps < target:
    chunk = []
    for _ in range(K):
      key, k = prng.split(key, 2)
      a = prng.randint(k, 0, 17, (n,))
      vs, out, stepped = vec_step(vs, a, cfg, rb)
      chunk.append((out.reward, out.done, out.ended,
                    stepped.player.achievements))
    rew, done, ended, ach = (torch.stack(x).cpu().numpy()
                             for x in zip(*chunk))
    for t in range(K):
      rec.add(rew[t], done[t], ach[t], ended=ended[t])
    steps += n * K
  dt = time.perf_counter() - t0
  counts = launches() if dev.type == 'cuda' else None
  print(f'{steps} env steps in {dt:.1f}s ({steps / dt:,.0f} steps/s)')

  record = dict(metric='random_crafter_score', score=None, std=None,
                env_steps=steps, seconds=dt, env_steps_per_s=steps / dt,
                envs=n, seed=args.seed, budget=args.steps,
                device=str(dev), card=card, launches=counts)
  out = analysis.read_stats(args.outdir, 'scores', 'crafter_noreward',
                            'random', args.steps)
  if out is None:
    print('no complete episodes within budget')
  else:
    mean, std = analysis.crafter_score([out], args.steps)
    print(f'random: crafter score {float(mean[0]):.2f} '
          f'± {float(std[0]):.2f} % ({out})')
    run, = analysis.load_runs([out], args.steps)
    record.update(
        score=float(mean[0]), std=float(std[0]), score_file=str(out),
        episodes=len(run['length']),
        success_rates={name[len(analysis.ACH_PREFIX):]: float(rate)
                       for name, rate in analysis.run_success_rates(
                           run, args.steps).items()})
  print(json.dumps(record), flush=True)
  return record


if __name__ == '__main__':
  main()
