"""Device-trace the PPO learn stage (GAE + SGD epochs) on the port and print
the top ops.

The counterpart of ``tools/profile_learn.py`` for ``crafter_tpu_torch``.
``tools/ppo_budget_cuda.py`` says WHICH stage is slow; this says WHY: the
table of ``tools/profile_summary_cuda.py`` (top device ops by self time,
per iteration) over ``--iters`` calls of ``PPO._learn`` on one rollout
(``--stage learn``), of ``PPO._rollout`` or of ``train_step`` (``--stage
rollout|full``), after one warm-up call:

    python tools/profile_learn_cuda.py --num_envs 4096 --rollout 64 --iters 3
    python tools/profile_learn_cuda.py --device cpu --num_envs 8 --rollout 4

``trace.json`` goes to ``--logdir``.  On a GPU the record also holds the
card's name and power limit and the traced calls' kernel launches (counted
from 0 after the warm-up).  ``--device cpu`` runs the plain PyTorch
versions on the CPU, where the table is empty; without a GPU the default
run stops with an error.
"""

import pathlib as _pathlib
import sys as _sys

_TOOLS = _pathlib.Path(__file__).resolve().parent
_sys.path.insert(0, str(_TOOLS.parent))
_sys.path.insert(0, str(_TOOLS))

import argparse  # noqa: E402
import json  # noqa: E402

from profile_summary_cuda import rows_from_profiler, summarize  # noqa: E402


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--num_envs', type=int, default=4096)
  parser.add_argument('--rollout', type=int, default=64)
  parser.add_argument('--iters', type=int, default=3)
  parser.add_argument('--top', type=int, default=25)
  parser.add_argument('--stage', choices=['learn', 'rollout', 'full'],
                      default='learn')
  parser.add_argument('--logdir', type=str, default='logdir/profile_learn',
                      help='where the run writes its trace.json')
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  from crafter_tpu_torch.utils import tool_device
  dev, card = tool_device(args.device, 'profile_learn_cuda')

  import torch
  from crafter_tpu_torch import prng
  from crafter_tpu_torch.config import EnvConfig
  from crafter_tpu_torch.ppo import PPO, PPOConfig
  from crafter_tpu_torch.utils import launches, trace, zero_launches

  def host(x):
    if dev.type == 'cuda':
      torch.cuda.synchronize(dev)
    return float(x)

  env_cfg = EnvConfig()
  cfg = PPOConfig(num_envs=args.num_envs, rollout_len=args.rollout,
                  reset_batch=max(32, args.num_envs // 128))
  ppo = PPO(env_cfg, cfg, device=dev)
  ts = ppo.init(prng.key(0, dev))
  host(ts.ep_len.sum())

  if args.stage == 'full':
    run = lambda: host(ppo.train_step(ts)[1]['loss'])
  elif args.stage == 'rollout':
    run = lambda: host(ppo._rollout(ts)[2].sum())
  else:
    _, traj, last_value = ppo._rollout(ts)
    run = lambda: host(ppo._learn(ts, traj, last_value)[1]['loss'])

  run()  # warm-up: kernel build, cuDNN's choice, allocator
  zero_launches()
  with trace(args.logdir) as prof:
    for _ in range(args.iters):
      run()
  counts = launches()
  table, total = summarize(rows_from_profiler(prof), args.iters, args.top,
                           unit='iter')
  rec = dict(stage=args.stage, iters=args.iters, top=table, total_ms=total,
             trace=args.logdir, device=str(dev), card=card,
             launches=counts if dev.type == 'cuda' else None)
  print(json.dumps(rec), flush=True)
  return rec


if __name__ == '__main__':
  main()
