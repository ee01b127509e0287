"""The port's multi-device layer against the JAX package's, on the CPU.

The counterpart of ``tests/test_sharding.py``.  The port's ranks are gloo
processes (``tests/sharding_ranks.py``), every rank of W = 1, 2 and 4
started side by side while the JAX references are computed here on the
conftest's virtual devices; W = 1 runs the port's one-process surfaces.

* The sharded group step (``make_sharded_group_step``), W = 2 and 4, 32 envs
  over 3 groups with real resets: every ``outs`` leaf of every group and
  every leaf of the final state equal the port's one-process
  ``vec_step_group`` and JAX's ``make_sharded_group_step`` on a 2-device
  mesh (without an overflow JAX's sharded step is its one-device step for
  any mesh, which tests/test_sharding.py asserts); with a budget that ranks
  overflow (one slot a rank), W = 4 equals JAX's on a 4-device mesh.  K = 3
  ticks a group: JAX compiles K ticks unrolled.
* ``shard_batch``, ``replicate``, ``psum_stats``, ``gather_batch`` and the
  health all-reduce (``9 * n``).
* The sharded ``VecEnv``, W = 2, 16 envs, ``reset_batch=2``, every episode
  ending at tick 8 (the global budget overflows), 30 ticks: obs bytes,
  reward, done and every ``info`` entry equal the port's ``VecEnv`` and
  JAX's.
* ``make_sharded_train``, W = 2, at tests/test_sharding.py's sizes with a
  float32 policy and episodes of 3 ticks (the rollout's global reset budget
  overflows): the rollout's actions, and the env state, frames and episode
  lengths after one
  update equal the one-process ``PPO``'s and JAX's rollout from the same
  parameters, ``episodes_done`` too; loss within ``rtol=1e-4`` and the
  full-batch gradients at the initial parameters within ``rtol=1e-4,
  atol=5e-6 * scale`` (tests/test_sharding.py's tolerances: only the order
  of the float32 sums differs), against the one-process ``PPO``'s and
  against JAX's ``value_and_grad`` over its own rollout; the parameters
  bitwise equal on both ranks.
* Draws at a row offset (``prng``) equal slices of the whole draw, the
  port's and JAX's; the default draws are unchanged.

Tolerance: none, except the learner's float32 sums as stated.
"""

import concurrent.futures
import dataclasses
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crafter_tpu import env as jenv
from crafter_tpu import ppo as jppo
from crafter_tpu import rules as jrules
from crafter_tpu.config import EnvConfig as JaxConfig
from crafter_tpu.models import CnnPolicy as JaxPolicy
from crafter_tpu.parallel import mesh as jmesh
import crafter_tpu_torch as ct
from crafter_tpu_torch import prng
from crafter_tpu_torch.convert import policy_from_flax
from crafter_tpu_torch.parallel import mesh as mesh_lib
from one_thread import one_torch_thread  # noqa: F401
import sharding_ranks as sr

RANKS = pathlib.Path(sr.__file__)
WORLDS = (1, 2, 4)
TIMEOUT = 600


def _free_port() -> int:
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def _np(tree):
  """A JAX tree as numpy, PRNG keys as their uint32 key data."""
  def leaf(x):
    if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
      x = jax.random.key_data(x)
    return np.asarray(x)
  return jax.tree.map(leaf, tree)


def _same(ours, ref, path=''):
  """Every leaf of ``ours`` (nested dicts of numpy arrays) equal, dtype
  and all, to the leaf of that name in ``ref`` (dicts or attributes)."""
  for name, mine in ours.items():
    theirs = ref[name] if isinstance(ref, dict) else getattr(ref, name)
    if isinstance(mine, dict):
      _same(mine, theirs, f'{path}.{name}')
    else:
      theirs = np.asarray(theirs)
      assert mine.dtype == theirs.dtype, f'{path}.{name}'
      np.testing.assert_array_equal(mine, theirs, err_msg=f'{path}.{name}')


def _flax_from_port(state_dict):
  """The flax parameter tree of a port ``CnnPolicy`` state_dict (the
  inverse of ``policy_from_flax``)."""
  names = {'conv1': 'Conv_0', 'conv2': 'Conv_1', 'conv3': 'Conv_2',
           'dense': 'Dense_0', 'logits': 'Dense_1', 'value': 'Dense_2'}
  tree = {}
  for ours, theirs in names.items():
    w = state_dict[f'{ours}.weight'].numpy()
    w = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
    tree[theirs] = {'kernel': jnp.asarray(np.ascontiguousarray(w)),
                    'bias': jnp.asarray(state_dict[f'{ours}.bias'].numpy())}
  return {'params': tree}


def _start_ranks(tmp):
  """Every rank of every W, started side by side: {W: [(proc, out)]}."""
  env = dict(os.environ, OMP_NUM_THREADS='1')
  runs = {}
  for world in WORLDS:
    port = _free_port()
    runs[world] = []
    for rank in range(world):
      out = tmp / f'w{world}_r{rank}.pkl'
      log = open(tmp / f'w{world}_r{rank}.log', 'w')
      proc = subprocess.Popen(
          [sys.executable, str(RANKS), '--world', str(world), '--rank',
           str(rank), '--port', str(port), '--out', str(out)],
          stdout=log, stderr=subprocess.STDOUT, env=env,
          cwd=str(RANKS.parent.parent))
      log.close()
      runs[world].append((proc, out))
  return runs


def _collect(runs, tmp):
  results = {}
  try:
    for world, procs in runs.items():
      results[world] = []
      for rank, (proc, out) in enumerate(procs):
        proc.wait(timeout=TIMEOUT)
        log = (tmp / f'w{world}_r{rank}.log').read_text()
        assert proc.returncode == 0, (
            f'W={world} rank {rank} failed:\n{log[-4000:]}')
        with open(out, 'rb') as f:
          results[world].append(pickle.load(f))
  finally:
    for procs in runs.values():
      for proc, _ in procs:
        if proc.poll() is None:
          proc.kill()
          proc.wait()
  return results


def _jax_group(world, reset_batch):
  jcfg = JaxConfig(reward=False, length=sr.GROUP_CFG.length,
                   balance_every=sr.GROUP_CFG.balance_every)
  k, n = jcfg.balance_every, sr.GROUP_ENVS
  vs = jax.jit(lambda: jenv.vec_reset(jenv.home_keys(sr.GROUP_SEED, n),
                                      jcfg))()
  steps = sr.group_start().env.step.numpy()
  vs = vs.replace(env=vs.env.replace(step=jnp.asarray(steps)))
  mesh = jmesh.dp_mesh(world)
  step = jmesh.make_sharded_group_step(mesh, jcfg, reset_batch)
  vs = jmesh.shard_batch(vs, mesh, n)
  acts = sr.group_actions()
  outs = []
  for g in range(sr.GROUPS):
    vs, out = step(vs, acts[g * k:(g + 1) * k])
    outs.append(_np(out))
  return dict(outs=outs, final=_np(vs))


def _jax_vecenv():
  je = jenv.VecEnv(sr.VEC_ENVS, JaxConfig(length=sr.VEC_CFG.length),
                   seed=sr.VEC_SEED, reset_batch=sr.VEC_RESET)
  first = np.asarray(je.reset())
  ticks = []
  for acts in sr.vec_actions():
    obs, reward, done, info = je.step(acts)
    ticks.append(_np(dict(obs=obs, reward=reward, done=done, info=info)))
  return dict(first=first, ticks=ticks, state=_np(je.state))


def _jax_rollout():
  """JAX's rollout of the first update from the port's initial float32
  policy, the same key and the same worlds."""
  cfg = sr.TRAIN_CFG
  policy = ct.PPO(sr.TRAIN_ENV, cfg, device='cpu').init(
      prng.key(sr.TRAIN_KEY, 'cpu')).params
  flax_params = _flax_from_port(policy.state_dict())
  for name, t in policy_from_flax(_np(flax_params)).items():
    assert torch.equal(t, policy.state_dict()[name]), name
  # The JAX package has NatureCNN only: the port's policy field stays out.
  fields = dataclasses.asdict(cfg)
  assert fields.pop('policy') == 'cnn'
  ppo = jppo.PPO(JaxConfig(length=sr.TRAIN_ENV.length),
                 jppo.PPOConfig(**fields))
  ppo.model = JaxPolicy(n_actions=jrules.N_ACTIONS, compute_dtype=jnp.float32)
  ts = jax.jit(ppo.init)(jax.random.key(sr.TRAIN_KEY))
  ts = ts.replace(params=flax_params)
  ts, traj, last_value = jax.jit(ppo._rollout)(ts)

  def full_batch_grad(params, traj, last_value):
    # As tests/test_sharding.py: the loss over the whole rollout.
    adv, ret = ppo._gae(traj, last_value)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    data = jax.tree.map(flat, (traj.obs, traj.action, traj.logp, adv, ret))
    (loss, _), grads = jax.value_and_grad(ppo._loss, has_aux=True)(params,
                                                                   data)
    return loss, grads

  loss, grads = jax.jit(full_batch_grad)(flax_params, traj, last_value)
  return dict(vec=_np(ts.vec), obs=np.asarray(ts.obs),
              ep_done=int(traj.ended.sum()), actions=np.asarray(traj.action),
              full_loss=float(loss),
              grads={name: t.numpy()
                     for name, t in policy_from_flax(_np(grads)).items()})


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """The ranks' results and the JAX references: the ranks run while JAX
  computes."""
  tmp = tmp_path_factory.mktemp('sharding_ranks')
  started = _start_ranks(tmp)
  try:
    # Four independent JAX programs, compiled side by side.
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
      ref = dict(group=pool.submit(_jax_group, 2, sr.RB_GROUP),
                 overflow=pool.submit(_jax_group, 4, sr.RB_OVERFLOW),
                 vecenv=pool.submit(_jax_vecenv),
                 rollout=pool.submit(_jax_rollout))
      ref = {name: f.result() for name, f in ref.items()}
  finally:
    ranks = _collect(started, tmp)
  return ranks, ref


def _group_outs_equal(got, want, what):
  for g, (a, b) in enumerate(zip(got['outs'], want['outs'])):
    _same(a, b, f'{what} outs {g}')
  _same(got['final'], want['final'], f'{what} final')


@pytest.mark.parametrize('world', [2, 4])
def test_sharded_group_step_matches_one_process_and_jax(runs, world):
  ranks, ref = runs
  one = ranks[1][0]['group']
  assert int(one['final']['episode'].sum()) > sr.GROUP_ENVS  # real resets
  for rank, res in enumerate(ranks[world]):
    _group_outs_equal(res['group'], one, f'W={world} rank {rank} vs one')
    _group_outs_equal(res['group'], ref['group'], f'W={world} rank {rank} '
                      'vs JAX')


def test_sharded_group_step_overflow_matches_jax(runs):
  """One reset slot a rank: ranks overflow, their envs wait a group more,
  as JAX's per-shard budget makes them."""
  ranks, ref = runs
  for rank, res in enumerate(ranks[4]):
    _group_outs_equal(res['overflow'], ref['overflow'], f'rank {rank}')
  got, one = ranks[4][0]['overflow'], ranks[1][0]['overflow']
  assert got['final']['pending'].any()
  assert not np.array_equal(got['final']['episode'], one['final']['episode'])


@pytest.mark.parametrize('world', [2, 4])
def test_psum_stats_shard_batch_replicate_gather(runs, world):
  n = 16
  for rank, res in enumerate(runs[0][world]):
    h = res['helpers']
    m = n // world
    np.testing.assert_array_equal(h['local_r'],
                                  np.arange(rank * m, (rank + 1) * m))
    assert h['scalar'] == 2.0 and h['pair'].shape == (2, 3)
    assert float(h['x'][0]) == float(np.arange(n).sum())
    assert int(h['ranks']) == world
    np.testing.assert_array_equal(h['flags'], [world] * 3)
    np.testing.assert_array_equal(h['replicated']['v'], [0.0] * 3)
    np.testing.assert_array_equal(h['replicated']['b'], [True, True])
    np.testing.assert_array_equal(h['gathered'], np.arange(n))
    # Health summed elementwise across ranks: its total is 9 per env.
    assert h['health_total'] == 9 * sr.GROUP_ENVS
    assert h['health_shape'] == (sr.GROUP_ENVS // world,)


def test_sharded_vec_env_matches_one_process_and_jax(runs):
  ranks, ref = runs
  one, want = ranks[1][0]['vecenv'], ref['vecenv']
  # The global budget overflowed: all 16 envs finished at once, 2 a tick
  # reset.
  assert one['max_pending'] >= sr.VEC_ENVS - sr.VEC_RESET
  np.testing.assert_array_equal(one['first'], want['first'])
  for res in ranks[2]:
    got = res['vecenv']
    assert got['max_pending'] == one['max_pending']
    np.testing.assert_array_equal(got['first'], want['first'])
    for t, (a, b, c) in enumerate(zip(got['ticks'], one['ticks'],
                                      want['ticks'])):
      _same(a, b, f'tick {t} vs one')
      _same(a, c, f'tick {t} vs JAX')
    _same(got['state'], one['state'], 'state vs one')
    _same(got['state'], want['state'], 'state vs JAX')
  assert int(one['state']['episode'].max()) >= 3


def test_sharded_train_rollout_matches_one_process_and_jax(runs):
  ranks, ref = runs
  one, want = ranks[1][0]['train'], ref['rollout']
  for rank, res in enumerate(ranks[2]):
    got = res['train']
    assert got['update'] == 1
    assert got['env_steps'] == sr.TRAIN_CFG.num_envs * sr.TRAIN_CFG.rollout_len
    np.testing.assert_array_equal(got['actions'], one['actions'])
    np.testing.assert_array_equal(got['actions'], want['actions'])
    _same(got['vec'], one['vec'], f'rank {rank} vec vs one')
    _same(got['vec'], want['vec'], f'rank {rank} vec vs JAX')
    np.testing.assert_array_equal(got['obs'], one['obs'])
    np.testing.assert_array_equal(got['obs'], want['obs'])
    np.testing.assert_array_equal(got['ep_len'], one['ep_len'])
    assert got['metrics']['episodes_done'] == one['metrics']['episodes_done']
    assert got['metrics']['episodes_done'] == want['ep_done']
  # Every episode ended and the global budget overflowed.
  assert one['metrics']['episodes_done'] == sr.TRAIN_CFG.num_envs
  assert int(one['vec']['episode'].sum()) == 2 * sr.TRAIN_CFG.num_envs


def test_sharded_train_loss_and_gradients_match_one_process(runs):
  ranks, _ = runs
  one = ranks[1][0]['train']
  for rank, res in enumerate(ranks[2]):
    got = res['train']
    for name, p in one['params0'].items():
      np.testing.assert_array_equal(got['params0'][name], p, err_msg=name)
    np.testing.assert_allclose(got['full_loss'], one['full_loss'], rtol=1e-4)
    np.testing.assert_allclose(got['metrics']['loss'], one['metrics']['loss'],
                               rtol=1e-4)
    scale = max(float(np.abs(g).max()) for g in got['grads'].values())
    for name, g in one['grads'].items():
      np.testing.assert_allclose(got['grads'][name], g, rtol=1e-4,
                                 atol=5e-6 * scale, err_msg=name)
    assert set(got['metrics']) == set(one['metrics'])
    assert all(np.isfinite(v) for v in got['metrics'].values())


def test_sharded_train_loss_and_gradients_match_jax(runs):
  """The two ranks' full-batch loss and summed gradients at the initial
  parameters against JAX's ``value_and_grad`` of its ``_loss`` over its own
  rollout from the same parameters (the same actions and frames; logp,
  values and advantages each framework's float32), at
  tests/test_sharding.py's tolerances."""
  ranks, ref = runs
  want = ref['rollout']
  scale = max(float(np.abs(g).max()) for g in want['grads'].values())
  for rank, res in enumerate(ranks[2]):
    got = res['train']
    np.testing.assert_allclose(got['full_loss'], want['full_loss'], rtol=1e-4)
    assert set(got['grads']) == set(want['grads'])
    for name, g in want['grads'].items():
      np.testing.assert_allclose(got['grads'][name], g, rtol=1e-4,
                                 atol=5e-6 * scale,
                                 err_msg=f'rank {rank} {name}')


def test_shard_state_keeps_the_ranks_rows(runs):
  """``shard_state`` of a one-process state (a restored checkpoint, say)
  is each rank's state as the sharded ``init`` makes it."""
  for rank, res in enumerate(runs[0][2]):
    assert res['train']['shard_diffs'] == [], f'rank {rank}'


def test_sharded_train_parameters_equal_across_ranks(runs):
  ranks, _ = runs
  a, b = ranks[2][0]['train'], ranks[2][1]['train']
  for name, p in a['params'].items():
    np.testing.assert_array_equal(p, b['params'][name], err_msg=name)
    assert not np.array_equal(p, a['params0'][name]), name
  assert a['metrics'] == b['metrics']


def test_sharded_surfaces_refuse_what_they_cannot_do(runs):
  ranks, _ = runs
  for world in (2, 4):
    for rank, res in enumerate(ranks[world]):
      for name, msg in res['refusals'].items():
        assert msg is not None, f'W={world} rank {rank}: {name} passed'
  assert 'time_minibatch' in ranks[2][0]['refusals']['global_shuffle']


def test_one_rank_mesh_without_a_group():
  mesh = mesh_lib.dp_mesh(device='cpu')
  assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
  assert mesh.rows(7) == slice(0, 7)
  with pytest.raises(ValueError):
    mesh_lib.dp_mesh(2, device='cpu')
  if not torch.cuda.is_available():   # no fallback to the CPU
    with pytest.raises(RuntimeError):
      mesh_lib.dp_mesh(device='cuda')
    with pytest.raises(RuntimeError):
      mesh_lib.distributed_init('127.0.0.1:1', 1, 0, device='cuda')
  # A sharded VecEnv on a mesh of one rank is the VecEnv.
  cfg = ct.EnvConfig(length=4)
  a = ct.VecEnv(5, cfg, seed=2, reset_batch=2, device='cpu', sharding=mesh)
  b = ct.VecEnv(5, cfg, seed=2, reset_batch=2, device='cpu')
  np.testing.assert_array_equal(a.reset().numpy(), b.reset().numpy())
  for t in range(6):
    acts = torch.full((5,), t % 17, dtype=torch.int32)
    for x, y in zip(a.step(acts), b.step(acts)):
      _same({'v': ct.to_numpy(x)}, {'v': ct.to_numpy(y)}, f'tick {t}')
  assert int(b.state.episode.max()) >= 2


def _kd(key):
  return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize('shape, axis, start', [
    ((16, 17), 0, 8), ((32, 17), 0, 0), ((3, 32), 1, 16), ((3, 32), 1, 8),
    ((2, 12, 5), 1, 4)], ids=lambda v: str(v).replace(' ', ''))
def test_row_offset_draws_are_slices_of_the_whole_draw(shape, axis, start):
  """Half the rows along ``axis`` from ``start``, against the whole draw
  (the port's and JAX's, which the default call still equals)."""
  kj = jax.random.key(7)
  kt = torch.from_numpy(_kd(kj))
  total = shape[axis]
  local = list(shape)
  local[axis] = total // 2
  index = [slice(None)] * len(shape)
  index[axis] = slice(start, start + total // 2)
  index = tuple(index)
  rows = (start, total)
  for draw, jdraw in (
      (lambda **kw: prng.random_bits(kt, local if kw else shape, **kw),
       lambda: jax.random.bits(kj, shape, jnp.uint32)),
      (lambda **kw: prng.uniform(kt, local if kw else shape, **kw),
       lambda: jax.random.uniform(kj, shape)),
      (lambda **kw: prng.randint(kt, 0, 17, local if kw else shape, **kw),
       lambda: jax.random.randint(kj, shape, 0, 17))):
    whole = draw()
    part = draw(rows=rows, axis=axis)
    assert torch.equal(part, whole[index])
    want = np.asarray(jdraw()).astype(whole.numpy().dtype)
    np.testing.assert_array_equal(part.numpy(), want[index])


def test_categorical_at_a_row_offset():
  logits = torch.from_numpy(
      np.random.RandomState(0).randn(16, 17).astype(np.float32))
  key = prng.key(5, 'cpu')
  whole = prng.categorical(key, logits)
  for start in (0, 4, 8, 12):
    part = prng.categorical(key, logits[start:start + 4], rows=(start, 16))
    assert torch.equal(part, whole[start:start + 4])
  with pytest.raises(ValueError):
    prng.categorical(key, logits[:4], rows=(14, 16))
