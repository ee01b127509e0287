"""Per-stage PPO budget on the port: where does a 4096-env update's wall time
go?

The counterpart of ``tools/ppo_budget.py`` for ``crafter_tpu_torch``.
Seven stages, each the best of ``--reps`` after one warm-up call, the clock
stopped by ``torch.cuda.synchronize()`` and a host read of the stage's
output:

  env_only   rollout_len env ticks (vec_step, no render, no model)
  env_render env ticks + a uint8 frame per tick (observe_batch)
  policy     rollout_len CNN forwards + action sampling on a fixed frame
  rollout    the real interleaved rollout (PPO._rollout)
  gae        the reverse loop alone (PPO._gae)
  learn      GAE + epochs x minibatch SGD + stat packing (PPO._learn)
  full       train_step end to end

The env stages step on the rollout's cadence: where ``rollout_len`` is a
multiple of K = ``balance_every``, a reset pass every K ticks sized
``K * reset_batch`` and the balance on a group's last tick; otherwise (64
ticks) a reset pass and the global balance cadence every tick.  Actions
are drawn as the JAX tool draws them (``key, ka = split(key)``,
``randint(ka, (n,), 0, 17)``).

Prints the JAX tool's table, its three derived lines and its JSON line,
which on a GPU also holds the card's name and power limit and each stage's
kernel launches over its timed reps (counted from 0 after its warm-up).

    python tools/ppo_budget_cuda.py --num_envs 4096 --rollout 64
    python tools/ppo_budget_cuda.py --device cpu --num_envs 8 --rollout 4 \\
        --minibatches 2 --epochs 1 --reps 1

``--device cpu`` runs the plain PyTorch versions on the CPU (a smoke run:
its times are the CPU's).  Without a GPU the default run stops with an
error.
"""

import pathlib as _pathlib
import sys as _sys

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

ROWS = (
    ('env_only', 'vec_step x T, no render'),
    ('env_render', 'env_only + uint8 frame per tick'),
    ('policy', 'CNN forward + sample x T (fixed frame)'),
    ('rollout', 'real interleave (env+render+policy)'),
    ('gae', 'reverse scan'),
    ('learn', 'GAE + SGD epochs + stat pack'),
    ('full', 'train_step'),
)


def timed(fn, barrier, reps=3, on_warm=None):
  """Best-of-reps wall time of fn(); barrier(out) must wait for the device
  and read a value of ``out`` on the host.  ``on_warm()`` runs after the
  warm-up call."""
  out = fn()
  barrier(out)  # warm-up: kernel build, cuDNN's choice, allocator
  if on_warm:
    on_warm()
  best = float('inf')
  for _ in range(reps):
    t0 = time.perf_counter()
    out = fn()
    barrier(out)
    best = min(best, time.perf_counter() - t0)
  return best


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--num_envs', type=int, default=4096)
  parser.add_argument('--rollout', type=int, default=64)
  parser.add_argument('--minibatches', type=int, default=8)
  parser.add_argument('--epochs', type=int, default=3)
  parser.add_argument('--reps', type=int, default=3)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  from crafter_tpu_torch.utils import tool_device
  dev, card = tool_device(args.device, 'ppo_budget_cuda')

  import torch
  from crafter_tpu_torch import prng
  from crafter_tpu_torch.config import EnvConfig
  from crafter_tpu_torch.env import vec_step
  from crafter_tpu_torch.ppo import PPO, PPOConfig
  from crafter_tpu_torch.utils import launches, zero_launches

  def host(x):
    """The barrier: wait for the device, then read ``x`` on the host."""
    if dev.type == 'cuda':
      torch.cuda.synchronize(dev)
    return float(x)

  env_cfg = EnvConfig()
  cfg = PPOConfig(num_envs=args.num_envs, rollout_len=args.rollout,
                  minibatches=args.minibatches, epochs=args.epochs,
                  reset_batch=max(32, args.num_envs // 128))
  ppo = PPO(env_cfg, cfg, device=dev)
  ts = ppo.init(prng.key(0, dev))
  host(ts.ep_len.sum())

  t, counts = {}, {}
  n, T = args.num_envs, args.rollout
  k = env_cfg.balance_every
  grouped = T % k == 0 and T >= k

  def stage(name, fn, barrier):
    t[name] = timed(fn, barrier, args.reps, zero_launches)
    counts[name] = launches()

  # -- env-only and env+render loops (the rollout's env portion) ----------
  def env_scan(render):
    def run():
      vec, key = ts.vec, prng.key(1, dev)
      aggr = torch.zeros((), dtype=torch.float32, device=dev)
      for i in range(T):
        key, ka = prng.split(key, 2)
        a = prng.randint(ka, 0, 17, (n,))
        if grouped:
          vec, out, _ = vec_step(vec, a, env_cfg, k * cfg.reset_batch,
                                 reset_every=k, balance=i % k == k - 1)
        else:
          vec, out, _ = vec_step(vec, a, env_cfg, cfg.reset_batch)
        aggr = aggr + out.reward.sum()
        if render:
          obs = ppo.core.observe_batch(vec.env)
          aggr = aggr + obs[..., 0].to(torch.int32).sum()
      return aggr
    return run

  stage('env_only', env_scan(render=False), host)
  stage('env_render', env_scan(render=True), host)

  # -- policy forward + sampling on a fixed frame batch --------------------
  @torch.no_grad()
  def f_policy():
    key, s = prng.key(2, dev), torch.zeros((), dtype=torch.int64,
                                           device=dev)
    for _ in range(T):
      key, ka = prng.split(key, 2)
      out = ts.params(ts.obs)
      a = prng.categorical(ka, out.logits)
      s = s + a.sum() + out.value.sum().to(torch.int32)
    return s

  stage('policy', f_policy, host)

  # -- the real rollout, GAE, learn, full ----------------------------------
  stage('rollout', lambda: ppo._rollout(ts), lambda o: host(o[2].sum()))
  _, traj, last_value = ppo._rollout(ts)
  stage('gae', lambda: ppo._gae(traj, last_value),
        lambda o: host(o[0].sum()))
  stage('learn', lambda: ppo._learn(ts, traj, last_value),
        lambda o: host(o[1]['loss']))
  stage('full', lambda: ppo.train_step(ts), lambda o: host(o[1]['loss']))

  steps = n * T
  print(f'{"stage":<12} {"ms":>9} {"steps/s":>12}  note')
  for name, note in ROWS:
    ms = t[name] * 1000
    print(f'{name:<12} {ms:9.1f} {steps / t[name]:12,.0f}  {note}')
  print(f'render share: {(t["env_render"] - t["env_only"]) * 1000:.1f} ms; '
        f'rollout overhead vs env_render+policy: '
        f'{(t["rollout"] - t["env_render"] - t["policy"]) * 1000:.1f} ms; '
        f'full-vs-rollout+learn gap: '
        f'{(t["full"] - t["rollout"] - t["learn"]) * 1000:.1f} ms')
  rec = {'num_envs': n, 'rollout_len': T,
         **{name: round(v * 1000, 1) for name, v in t.items()},
         'full_steps_per_s': round(steps / t['full']),
         'device': str(dev), 'card': card,
         'launches': counts if dev.type == 'cuda' else None}
  print(json.dumps(rec), flush=True)
  return rec


if __name__ == '__main__':
  main()
