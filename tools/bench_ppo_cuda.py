"""End-to-end PPO throughput on the port at a given batch size.

The counterpart of ``tools/bench_ppo.py`` for ``crafter_tpu_torch``.
Measures the full training loop (rollout: env tick, pixel render, CNN
forward and sampling; GAE, epochs x minibatch SGD, on-device episode-stat
packing) on one GPU: ``PPOConfig(num_envs, rollout_len, minibatches,
epochs, reset_batch=max(32, n // 128))``, ``init(prng.key(0))``, one
warm-up ``train_step_with_stats``, then ``--updates`` timed updates.

Prints one JSON line with ``bench_ppo.py``'s keys (``metric``, ``value``,
``num_envs``, ``rollout``, ``updates``, ``compile_s``, ``episodes_done``,
``wall_s``).  ``compile_s`` is the first update's seconds: there is no
compile here, but the first call builds the CUDA kernels (when this
process has not built them yet) and lets cuDNN choose its convolution
algorithms.  Beyond them: the timed updates split into rollout and learn
ms (a CUDA event where the rollout hands over to the learner, as
``chip_smoke.py`` splits the training path), the device, and on a GPU the
card's name and power limit and the timed updates' kernel launches
(counted from 0 after the warm-up).  The clock stops at
``torch.cuda.synchronize()`` and a host read of the loss.

    python tools/bench_ppo_cuda.py --num_envs 4096 --updates 5
    python tools/bench_ppo_cuda.py --device cpu --num_envs 8 --rollout 8 \\
        --updates 1 --minibatches 2 --epochs 1

``--device cpu`` runs the plain PyTorch versions on the CPU (a smoke run:
its rates are the CPU's).  Without a GPU the default run stops with an
error.
"""

import pathlib as _pathlib
import sys as _sys

# Runnable as a plain script: put the repo root on sys.path so
# crafter_tpu_torch imports without an installed package.
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


class Marks:
  """Points in time on the device's stream (CUDA events) or, on the CPU,
  on the host clock; ``ms(a, b)`` between two marks."""

  def __init__(self, dev):
    import torch
    self._cuda = dev.type == 'cuda'
    self._torch = torch

  def mark(self):
    if not self._cuda:
      return time.perf_counter()
    event = self._torch.cuda.Event(enable_timing=True)
    event.record()
    return event

  def ms(self, a, b) -> float:
    return a.elapsed_time(b) if self._cuda else (b - a) * 1e3


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--num_envs', type=int, default=4096)
  parser.add_argument('--rollout', type=int, default=64)
  parser.add_argument('--updates', type=int, default=5)
  parser.add_argument('--minibatches', type=int, default=8)
  parser.add_argument('--epochs', type=int, default=3)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  from crafter_tpu_torch.utils import tool_device
  dev, card = tool_device(args.device, 'bench_ppo_cuda')

  import torch
  from crafter_tpu_torch import prng
  from crafter_tpu_torch.config import EnvConfig
  from crafter_tpu_torch.ppo import PPO, PPOConfig
  from crafter_tpu_torch.utils import launches, zero_launches

  def sync():
    if dev.type == 'cuda':
      torch.cuda.synchronize(dev)

  env_cfg = EnvConfig()
  cfg = PPOConfig(num_envs=args.num_envs, rollout_len=args.rollout,
                  minibatches=args.minibatches, epochs=args.epochs,
                  reset_batch=max(32, args.num_envs // 128))
  ppo = PPO(env_cfg, cfg, device=dev)
  ts = ppo.init(prng.key(0, dev))

  # A mark where each update's rollout hands over to the learner.
  marks = Marks(dev)
  handover = []
  learn = ppo._learn

  def marked_learn(*a):
    handover.append(marks.mark())
    return learn(*a)

  ppo._learn = marked_learn

  t0 = time.perf_counter()
  ts, metrics, stats = ppo.train_step_with_stats(ts)
  sync()
  float(metrics['loss'])   # host read: the update is done
  compile_s = time.perf_counter() - t0

  zero_launches()
  spans = []
  t0 = time.perf_counter()
  for _ in range(args.updates):
    start = marks.mark()
    ts, metrics, stats = ppo.train_step_with_stats(ts)
    spans.append((start, handover[-1], marks.mark()))
  sync()
  float(metrics['loss'])
  dt = time.perf_counter() - t0
  counts = launches() if dev.type == 'cuda' else None
  ppo._learn = learn
  update_ms = [marks.ms(a, c) for a, _, c in spans]
  rollout_ms = [marks.ms(a, b) for a, b, _ in spans]
  steps = args.updates * args.num_envs * args.rollout
  rec = dict(
      metric='ppo_env_steps_per_s', value=round(steps / dt),
      num_envs=args.num_envs, rollout=args.rollout,
      updates=args.updates, compile_s=round(compile_s, 1),
      episodes_done=int(stats['count']),
      wall_s=round(dt, 2),
      update_ms=update_ms, rollout_ms=rollout_ms,
      learn_ms=[u - r for u, r in zip(update_ms, rollout_ms)],
      device=str(dev), card=card, launches=counts)
  print(json.dumps(rec), flush=True)
  return rec


if __name__ == '__main__':
  main()
