"""PPO training CLI: the reference's examples/run_ppo.py on the device.

Trains the CNN policy on the device-resident env batch and records
``stats.jsonl`` (through ``VecStatsRecorder``), so the analysis pipeline
scores the run exactly like any reference logdir:

    python -m crafter_tpu_torch.run_train --steps 1000000 \\
        --outdir logdir/ppo/0
    python -c "from crafter_tpu_torch import analysis; print( \\
        analysis.read_stats('logdir/ppo', 'scores', 'crafter_reward', 'ppo'))"

Checkpoints (parameters, optimizer state and the env batch, so training
resumes mid-episode with identical results) go to ``<outdir>/ckpt``.  Runs
on the first CUDA device; ``--device cpu`` runs the plain PyTorch versions
of the kernels on the CPU, for tests.
"""

import argparse
import pathlib
import time


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--outdir', type=str, default='logdir/ppo')
  parser.add_argument('--steps', type=int, default=1_000_000)
  parser.add_argument('--num_envs', type=int, default=64)
  parser.add_argument('--rollout', type=int, default=64)
  parser.add_argument('--lr', type=float, default=3e-4)
  parser.add_argument('--ent_coef', type=float, default=0.01)
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--ckpt_every', type=int, default=50)
  parser.add_argument('--log_every', type=int, default=5)
  parser.add_argument('--resume', action='store_true')
  parser.add_argument('--device', type=str, default='cuda')
  args = parser.parse_args(argv)

  import torch
  from crafter_tpu_torch import checkpoint as ckpt_lib
  from crafter_tpu_torch import prng
  from crafter_tpu_torch.config import EnvConfig
  from crafter_tpu_torch.ppo import PPO, PPOConfig
  from crafter_tpu_torch.recorder import VecStatsRecorder

  if args.device.startswith('cuda') and not torch.cuda.is_available():
    raise SystemExit(
        'run_train: no CUDA device found.  Training runs on an NVIDIA GPU; '
        'pass --device cpu to run the plain PyTorch path on the CPU.')

  outdir = pathlib.Path(args.outdir)
  outdir.mkdir(parents=True, exist_ok=True)
  env_cfg = EnvConfig()
  cfg = PPOConfig(num_envs=args.num_envs, rollout_len=args.rollout,
                  lr=args.lr, ent_coef=args.ent_coef, seed=args.seed,
                  reset_batch=min(64, args.num_envs))
  ppo = PPO(env_cfg, cfg, device=args.device)
  ts = ppo.init(prng.key(args.seed, args.device))
  ckpt = ckpt_lib.Checkpointer(outdir / 'ckpt')
  if args.resume:
    ts = ckpt.restore_latest(ts) or ts

  recorder = VecStatsRecorder(args.num_envs, outdir)
  steps_per_update = cfg.num_envs * cfg.rollout_len
  last = time.time()
  dropped = 0
  while ts.env_steps < args.steps:
    ts, metrics, stats = ppo.train_step_with_stats(ts)
    # Episode bookkeeping: finished episodes accumulate on the device
    # (ppo.PPO._episode_stats); the host drains the packed buffer once per
    # update, with no per-step per-env Python loop.
    count, drop = int(stats['count']), int(stats['dropped'])
    recorder.add_episodes(
        count, *(stats[name][:count].cpu().numpy()
                 for name in ('lengths', 'returns', 'achievements')))
    dropped += drop
    if drop:
      print(f'WARNING: episode buffer overflow, {drop} episodes '
            f'dropped this update ({dropped} total)', flush=True)
    if ts.update % args.log_every == 0:
      sps = args.log_every * steps_per_update / (time.time() - last)
      last = time.time()
      print(f'update {ts.update} steps {ts.env_steps} '
            f'loss {float(metrics["loss"]):.4f} '
            f'entropy {float(metrics["entropy"]):.3f} '
            f'reward/step {float(metrics["reward_per_step"]):.4f} '
            f'episodes {int(metrics["episodes_done"])} '
            f'({sps:,.0f} steps/s)', flush=True)
    if ts.update % args.ckpt_every == 0:
      ckpt.save(ts.update, ts)
  ckpt.save(ts.update, ts)
  print('Training done:', ts.env_steps, 'env steps')


if __name__ == '__main__':
  main()
