"""North-star config 4 on the port: huge env batches sharded over ranks.

The counterpart of ``tools/demo_64k.py`` for ``crafter_tpu_torch``.  Runs the
engine at scale, each rank a process with its rows of the batch on its own
device: a sharded chunked reset of the rank's rows, then groups of
``parallel.mesh.make_sharded_group_step`` (K = 10 ticks, no collective)
with random actions drawn for the global (K, N) batch at the rank's rows,
the every-env check (each env stepped or reset), and the stats all-reduce
(``psum_stats`` of ``episodes_done`` and ``env_steps``).  Prints one JSON
line per batch size with ``demo_64k.py``'s keys, the backend, this rank's
kernel launches in the timed loop (0 on the CPU, where the wrappers run
their plain twins), and on a GPU the card's name and power limit.

    python tools/demo_64k_cuda.py --num_envs 65536 --steps 400
    python tools/demo_64k_cuda.py --sweep 4096,8192,16384,32768 --steps 400

Several ranks (one a process): pass each its ``--process_id`` with the same
``--coordinator host:port`` and ``--num_processes``, or start them with
``torchrun --nproc_per_node W tools/demo_64k_cuda.py``.  Two ranks on one
card need ``--backend gloo`` (NCCL refuses two ranks on one GPU); on the CPU,
``--device cpu`` (gloo).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def run_size(n, steps, cfg, mesh, backend, card):
  """One batch size: prints and returns its record."""
  import torch
  import torch.distributed as dist
  from crafter_tpu_torch import prng, prng_cuda, step_cuda
  from crafter_tpu_torch.env import home_keys, vec_reset_chunked
  from crafter_tpu_torch.ops import noise_cuda
  from crafter_tpu_torch.parallel.mesh import (make_sharded_group_step,
                                               psum_stats)

  kk = cfg.balance_every
  groups = max(steps // kk, 1)
  # A reset pass a group, sized for K ticks of deaths (~K*n/170 under a
  # random policy), as demo_64k.py.
  reset_batch = min(n, kk * max(32, n // 128))
  rows = mesh.rows(n)
  m = rows.stop - rows.start
  dev = mesh.device
  sync = torch.cuda.synchronize if dev.type == 'cuda' else (lambda: None)
  vs = vec_reset_chunked(home_keys(0, n, dev)[rows], cfg)
  gstep = make_sharded_group_step(mesh, cfg, reset_batch)
  counted = (('group_tick', step_cuda.group_tick),
             ('balance', step_cuda.balance), ('noise2', noise_cuda.noise2),
             ('threefry', prng_cuda.draw))

  def loop(vs, seed):
    key = prng.key(seed, dev)
    ended = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(groups):
      key, k_act = prng.split(key, 2)
      # This rank's columns of the global (K, N) draw.
      actions = prng.randint(k_act, 0, 17, (kk, m), rows=(rows.start, n),
                             axis=1)
      vs, outs = gstep(vs, actions)
      # `ended` pulses once per finished episode (no latched re-counts).
      ended += outs.ended.sum()
    return vs, ended

  vs1, ended = loop(vs, 0)               # warm-up
  psum_stats(ended, mesh).item()         # every rank done: the clock starts
  sync()
  for _, fn in counted:                  # count the timed loop's launches
    fn.launches = 0
  t0 = time.perf_counter()
  vs2, ended = loop(vs1, 1)
  # The stats all-reduce (config 4's "stats allreduce") doubles as the
  # barrier that ends the clock on every rank.
  stats = psum_stats({'episodes_done': ended,
                      'env_steps': m * groups * kk}, mesh)
  stats = {name: int(v) for name, v in stats.items()}
  dt = time.perf_counter() - t0
  stepped = (vs2.env.step - vs1.env.step) == groups * kk
  reset_ok = vs2.episode > vs1.episode
  bad = int((~(stepped | reset_ok)).sum())
  if bad:
    raise SystemExit(f'demo_64k_cuda: rank {mesh.rank}: {bad} envs neither '
                     'stepped nor reset')
  if stats['env_steps'] != n * groups * kk:
    raise SystemExit(f'demo_64k_cuda: env_steps {stats["env_steps"]} over the '
                     f'ranks, want {n * groups * kk}')
  rec = dict(
      metric='env_steps_per_s', value=round(stats['env_steps'] / dt),
      per_env=round(groups * kk / dt, 1), num_envs=n, steps=groups * kk,
      devices=mesh.size,
      processes=dist.get_world_size() if dist.is_initialized() else 1,
      episodes_done=stats['episodes_done'], wall_s=round(dt, 2),
      backend=backend, device=str(dev), card=card, rank=mesh.rank,
      launches={name: fn.launches for name, fn in counted})
  print(json.dumps(rec), flush=True)
  return rec


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--num_envs', type=int, default=65536)
  parser.add_argument('--sweep', type=str, default=None,
                      help='comma-separated batch sizes to sweep')
  parser.add_argument('--steps', type=int, default=400)
  parser.add_argument('--coordinator', type=str, default=None,
                      help='host:port of rank 0 (else torchrun\'s env://, '
                           'or one rank without a process group)')
  parser.add_argument('--num_processes', type=int, default=None)
  parser.add_argument('--process_id', type=int, default=None)
  parser.add_argument('--backend', type=str, default=None,
                      help='nccl (default on cuda) or gloo (default on cpu)')
  parser.add_argument('--device', type=str, default='cuda')
  args = parser.parse_args(argv)

  import os
  import torch.distributed as dist
  from crafter_tpu_torch.config import EnvConfig
  from crafter_tpu_torch.parallel.mesh import distributed_init, dp_mesh
  from crafter_tpu_torch.utils import tool_device

  _, card = tool_device(args.device, 'demo_64k_cuda')
  if args.coordinator or 'RANK' in os.environ:
    distributed_init(args.coordinator, args.num_processes, args.process_id,
                     args.backend, args.device)
  elif args.backend:
    raise SystemExit('demo_64k_cuda: --backend needs a process group '
                     '(--coordinator, or torchrun)')
  backend = dist.get_backend() if dist.is_initialized() else None
  mesh = dp_mesh(device=args.device)
  cfg = EnvConfig(reward=False)
  sizes = ([int(s) for s in args.sweep.split(',')] if args.sweep
           else [args.num_envs])
  recs = [run_size(n, args.steps, cfg, mesh, backend, card) for n in sizes]
  if dist.is_initialized():
    # No rank leaves while another may still be in a collective.
    dist.barrier()
    dist.destroy_process_group()
  return recs


if __name__ == '__main__':
  main()
