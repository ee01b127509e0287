"""One rank of a multi-process ``torch.distributed`` group of the port.

The counterpart of ``tools/dist_worker.py`` for ``crafter_tpu_torch``:

    python tools/dist_worker_cuda.py <process_id> <num_processes> <port> \
        [--device cpu] [--backend gloo]

Each process is one rank with one device.  The worker goes through the
multi-process code path: ``parallel.mesh.distributed_init`` over a TCP
coordinator on localhost, a mesh over every rank, a sharded ``VecEnv`` of
``4 * W`` envs (each rank its rows) for 5 no-op ticks, and all-reduces of
the env steps (which must total ``n * 5``) and of the players' health
(``psum_stats``, which must total ``9 * n``).  Prints ``DIST OK`` on
success.  Two ranks on one card need ``--backend gloo``.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('process_id', type=int)
  parser.add_argument('num_processes', type=int)
  parser.add_argument('port', type=int)
  parser.add_argument('--device', type=str, default='cuda')
  parser.add_argument('--backend', type=str, default=None)
  args = parser.parse_args(argv)

  import torch
  import torch.distributed as dist
  from crafter_tpu_torch.config import EnvConfig
  from crafter_tpu_torch.env import VecEnv
  from crafter_tpu_torch.parallel.mesh import (distributed_init, dp_mesh,
                                               psum_stats)

  distributed_init(f'localhost:{args.port}', args.num_processes,
                   args.process_id, args.backend, args.device)
  mesh = dp_mesh(args.num_processes, args.device)
  n = 4 * mesh.size  # envs, data-parallel over every rank
  steps = 5
  env = VecEnv(n, EnvConfig(), seed=0, reset_batch=4, device=args.device,
               sharding=mesh)
  env.reset()
  noop = torch.zeros((n // mesh.size,), dtype=torch.int32, device=mesh.device)
  for _ in range(steps):
    env.step(noop)   # no-op: no early deaths

  # Every env advanced in lockstep across the ranks.
  total_steps = int(psum_stats(env.state.env.step.sum(), mesh))
  if total_steps != n * steps:
    raise SystemExit(f'env steps {total_steps}, want {n * steps}')
  # The stats all-reduce: each rank's rows summed elementwise across the
  # ranks, so the grand total is its sum.
  total_hp = psum_stats(env.state.env.player.inventory[:, 0], mesh)
  if int(total_hp.sum()) != 9 * n:
    raise SystemExit(f'health {total_hp.tolist()}, want a total of {9 * n}')
  print(f'DIST OK process={args.process_id}/{args.num_processes} '
        f'backend={dist.get_backend()} device={mesh.device} envs={n}',
        flush=True)
  dist.barrier()
  dist.destroy_process_group()


if __name__ == '__main__':
  main()
