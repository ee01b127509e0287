"""One rank of the port's sharding checks on the CPU (gloo), or with
``--world 1`` the one-process references they are held to.

    python tests/sharding_ranks.py --world W --rank R --port P --out FILE

``tests/test_torch_sharding.py`` starts every rank of W = 1, 2 and 4 side
by side and compares what they write.  Each run steps the cases below on
the port's plain twins (one PyTorch thread) and pickles a dict of numpy
arrays to ``FILE``; with W > 1 the rows come back whole through
``parallel.gather_batch``, so every rank writes the same global arrays
(and its own parameters):

* ``group`` / ``overflow``: ``make_sharded_group_step`` over GROUPS groups
  of 32 envs with reset budgets RB_GROUP and RB_OVERFLOW (W = 1:
  ``vec_step_group``);
* ``helpers``: ``shard_batch``, ``replicate``, ``psum_stats`` and
  ``gather_batch`` on small trees, and the health all-reduce;
* ``vecenv``: the sharded ``VecEnv`` (W = 1: ``VecEnv``) of VEC_ENVS envs
  over VEC_TICKS ticks with a global budget that overflows;
* ``train``: ``make_sharded_train`` (W = 1: ``PPO``) with a float32 policy:
  the first rollout's actions and full-batch gradients at the initial
  parameters, then one update.

Imports no JAX.
"""

import argparse
import dataclasses
import functools
import pathlib
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import crafter_tpu_torch as ct  # noqa: E402
from crafter_tpu_torch import prng  # noqa: E402
from crafter_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

# The group step: K = 3 ticks (the JAX side compiles K unrolled ticks), 32
# envs whose steps start spread over [0, 6), so that episodes of length 8
# end on different ticks and ranks.
GROUP_CFG = ct.EnvConfig(reward=False, length=8, balance_every=3)
GROUP_ENVS, GROUPS, GROUP_SEED = 32, 3, 21
RB_GROUP = 32       # no rank overflows at W = 2 or 4
RB_OVERFLOW = 4     # one slot a rank at W = 4: ranks overflow
# The VecEnv: every episode of 8 ticks ends at once, two reset a tick.
VEC_CFG = ct.EnvConfig(length=8)
VEC_ENVS, VEC_TICKS, VEC_RESET, VEC_SEED = 16, 30, 2, 3
# Training, at the sizes of tests/test_sharding.py, with episodes of 3
# ticks: all 16 end on tick 3 and the global budget of 8 overflows.
TRAIN_CFG = ct.PPOConfig(num_envs=16, rollout_len=4, epochs=2,
                         minibatches=2, reset_batch=8, time_minibatch=True)
TRAIN_ENV = ct.EnvConfig(length=3)
TRAIN_KEY = 3


@functools.lru_cache(maxsize=1)
def group_start():
  """The global state the group cases start from (the callers copy it)."""
  vs = ct.vec_reset(ct.home_keys(GROUP_SEED, GROUP_ENVS, 'cpu'), GROUP_CFG)
  steps = np.random.RandomState(1).randint(0, 6, GROUP_ENVS)
  env = dataclasses.replace(vs.env, step=torch.from_numpy(
      steps.astype(np.int32)))
  return dataclasses.replace(vs, env=env)


def group_actions():
  k = GROUP_CFG.balance_every
  return np.random.RandomState(4).randint(
      0, 17, (GROUPS * k, GROUP_ENVS)).astype(np.int32)


def vec_actions():
  return np.random.RandomState(9).randint(
      0, 17, (VEC_TICKS, VEC_ENVS)).astype(np.int32)


def run_group(mesh, reset_batch):
  n, k = GROUP_ENVS, GROUP_CFG.balance_every
  rows = mesh.rows(n)
  acts = torch.from_numpy(group_actions())
  if mesh.group is None:
    step = lambda vs, a: ct.vec_step_group(vs, a, GROUP_CFG, reset_batch)
  else:
    step = mesh_lib.make_sharded_group_step(mesh, GROUP_CFG, reset_batch)
  vs = mesh_lib.shard_batch(group_start(), mesh, n)
  outs = []
  for g in range(GROUPS):
    vs, out = step(vs, acts[g * k:(g + 1) * k, rows])
    outs.append(ct.to_numpy(mesh_lib.gather_batch(out, mesh, n, axis=1)))
  return dict(outs=outs, final=ct.to_numpy(mesh_lib.gather_batch(vs, mesh,
                                                                 n)))


def run_helpers(mesh):
  n = 16
  batch = dict(r=torch.arange(n, dtype=torch.float32),
               scalar=torch.tensor(2.0), pair=torch.arange(6).reshape(2, 3))
  local = mesh_lib.shard_batch(batch, mesh, n)
  total = mesh_lib.psum_stats(dict(x=local['r'].sum()[None], ranks=1,
                                   flags=torch.ones(3, dtype=torch.bool)),
                              mesh)
  mine = dict(v=torch.full((3,), float(mesh.rank)),
              b=torch.tensor([mesh.rank == 0, True]))
  start = mesh_lib.shard_batch(group_start(), mesh, GROUP_ENVS)
  hp = mesh_lib.psum_stats(start.env.player.inventory[:, 0], mesh)
  return dict(
      local_r=local['r'].numpy(), scalar=local['scalar'].numpy(),
      pair=local['pair'].numpy(),
      x=total['x'].numpy(), ranks=total['ranks'].numpy(),
      flags=total['flags'].numpy(),
      replicated={name: t.numpy()
                  for name, t in mesh_lib.replicate(mine, mesh).items()},
      gathered=mesh_lib.gather_batch(local, mesh, n)['r'].numpy(),
      health_total=int(hp.sum()), health_shape=tuple(hp.shape))


def run_vecenv(mesh):
  n = VEC_ENVS
  rows = mesh.rows(n)
  if mesh.group is None:
    env = ct.VecEnv(n, VEC_CFG, seed=VEC_SEED, reset_batch=VEC_RESET,
                    device='cpu')
  else:
    env = ct.VecEnv(n, VEC_CFG, seed=VEC_SEED, reset_batch=VEC_RESET,
                    device='cpu', sharding=mesh)
  gather = lambda tree: ct.to_numpy(mesh_lib.gather_batch(tree, mesh, n))
  first = gather(env.reset())
  acts = torch.from_numpy(vec_actions())
  ticks, pending = [], 0
  for t in range(VEC_TICKS):
    obs, reward, done, info = env.step(acts[t, rows])
    ticks.append(gather(dict(obs=obs, reward=reward, done=done, info=info)))
    pending = max(pending, int(mesh_lib.psum_stats(env.state.pending.sum(),
                                                   mesh)))
  return dict(first=first, ticks=ticks, max_pending=pending,
              state=gather(env.state))


def _differs(a, b) -> bool:
  """Whether two nested dicts of numpy arrays differ in any bit."""
  if isinstance(a, dict):
    return any(_differs(a[name], b[name]) for name in a)
  return (a.shape != b.shape or a.dtype != b.dtype
          or a.tobytes() != b.tobytes())


def run_train(mesh):
  cfg, n = TRAIN_CFG, TRAIN_CFG.num_envs
  one = ct.PPO(TRAIN_ENV, cfg, device='cpu')
  if mesh.group is None:
    ppo, init, train_step, shard_state = one, one.init, one.train_step, None
  else:
    ppo, init, train_step, shard_state = ct.make_sharded_train(
        TRAIN_ENV, cfg, mesh, device='cpu')
  ts = init(prng.key(TRAIN_KEY, 'cpu'))
  # shard_state keeps this rank's rows of a one-process state: the sharded
  # init's.
  shard_diffs = []
  if shard_state is not None:
    mine = shard_state(one.init(prng.key(TRAIN_KEY, 'cpu')))
    shard_diffs = [name for name in ('vec', 'obs', 'key', 'ep_len', 'ep_ret')
                   if _differs(ct.to_numpy(getattr(mine, name)),
                               ct.to_numpy(getattr(ts, name)))]
  policy = ts.params
  policy.compute_dtype = torch.float32
  params0 = {name: p.detach().numpy().copy()
             for name, p in policy.named_parameters()}
  # The loss and its gradient over the whole first rollout, no minibatches.
  _, traj, last_value = ppo._rollout(ts)
  actions = mesh_lib.gather_batch(traj.action, mesh, n, axis=1).numpy()
  adv, ret = ppo._gae(traj, last_value)
  flat = lambda x: x.reshape((-1,) + x.shape[2:])
  data = tuple(flat(x) for x in (traj.obs, traj.action, traj.logp, adv, ret))
  policy.zero_grad(set_to_none=True)
  loss, _ = ppo._loss(policy, data)
  loss.backward()
  ppo._sum_grads(policy)
  grads = {name: p.grad.numpy().copy()
           for name, p in policy.named_parameters()}
  full_loss = float(mesh_lib.psum_stats(loss.detach(), mesh))
  policy.zero_grad(set_to_none=True)
  ts2, metrics = train_step(ts)
  return dict(
      shard_diffs=shard_diffs, actions=actions, params0=params0, grads=grads,
      full_loss=full_loss,
      metrics={name: float(v) for name, v in metrics.items()},
      update=ts2.update, env_steps=ts2.env_steps,
      params={name: p.detach().numpy().copy()
              for name, p in ts2.params.named_parameters()},
      vec=ct.to_numpy(mesh_lib.gather_batch(ts2.vec, mesh, n)),
      obs=mesh_lib.gather_batch(ts2.obs, mesh, n).numpy(),
      ep_len=mesh_lib.gather_batch(ts2.ep_len, mesh, n).numpy())


def run_refusals(mesh):
  """What a sharded surface must refuse, as the messages it raised."""
  out = {}
  for name, fn in (
      ('global_shuffle', lambda: ct.make_sharded_train(
          ct.EnvConfig(), dataclasses.replace(TRAIN_CFG,
                                              time_minibatch=False),
          mesh, device='cpu')[0].train_step(None)),
      ('indivisible', lambda: mesh_lib.shard_batch(
          torch.zeros(3 * mesh.size + 1), mesh, 3 * mesh.size + 1)),
      ('wrong_device', lambda: ct.VecEnv(VEC_ENVS, VEC_CFG, device='cuda',
                                         sharding=mesh))):
    try:
      fn()
      out[name] = None
    except (ValueError, RuntimeError) as e:
      out[name] = f'{type(e).__name__}: {e}'
  return out


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument('--world', type=int, required=True)
  ap.add_argument('--rank', type=int, default=0)
  ap.add_argument('--port', type=int, default=0)
  ap.add_argument('--out', type=str, required=True)
  args = ap.parse_args(argv)
  torch.set_num_threads(1)
  if args.world > 1:
    mesh_lib.distributed_init(f'127.0.0.1:{args.port}', args.world,
                              args.rank, device='cpu')
  mesh = mesh_lib.dp_mesh(device='cpu')
  assert mesh.size == args.world and mesh.rank == args.rank, mesh
  res = dict(world=args.world, rank=args.rank)
  res['group'] = run_group(mesh, RB_GROUP)
  res['overflow'] = run_group(mesh, RB_OVERFLOW)
  res['helpers'] = run_helpers(mesh)
  if args.world <= 2:
    res['vecenv'] = run_vecenv(mesh)
    res['train'] = run_train(mesh)
  if args.world > 1:
    res['refusals'] = run_refusals(mesh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
  with open(args.out, 'wb') as f:
    pickle.dump(res, f)


if __name__ == '__main__':
  main()
