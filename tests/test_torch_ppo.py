"""The port's training path against the JAX package's, on the CPU at tiny
sizes: policy, GAE, episode stats, loss and gradients, the clip and Adam
step, the minibatch index sets, one whole ``train_step``, the checkpoint
round trip and the CLI.

Inputs come from numpy seeds and go through both packages.  Tolerances:
the float32 policy, loss, gradients and optimizer step to 1e-5 (relative
for the last three), GAE to 1e-6, the bfloat16 policy to 2e-2 on logits and
values (the two frameworks round bfloat16 sums at other places); packed ==
uint8 policy outputs, episode stats, minibatch index sets, PRNG keys and env
state exactly.  The loss comparisons run both policies in float32 (a clone
with ``compute_dtype=float32``, the method of tests/test_sharding.py), so
that only summation order differs.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crafter_tpu import ppo as jppo
from crafter_tpu import rules as jrules
from crafter_tpu.config import EnvConfig as JaxConfig
from crafter_tpu.models import CnnPolicy as JaxPolicy
import crafter_tpu_torch as ct
from crafter_tpu_torch import checkpoint, prng, run_train
from crafter_tpu_torch.convert import policy_from_flax
from one_thread import one_torch_thread  # noqa: F401

T, N = 6, 5


def _np_tree(tree):
  return jax.tree.map(np.asarray, tree)


def _flax_params(seed, compute_dtype=jnp.float32, bias_scale=0.02):
  """Flax parameters with non-zero biases (flax initialises them to 0, which
  would hide a bias that is mapped wrongly)."""
  model = JaxPolicy(n_actions=17, compute_dtype=compute_dtype)
  params = model.init(jax.random.key(seed), jnp.zeros((1, 64, 64, 3),
                                                      jnp.uint8))
  rs = np.random.RandomState(seed)
  params = jax.tree.map(
      lambda x: x + bias_scale * rs.randn(*x.shape).astype(np.float32)
      if x.ndim == 1 else x, params)
  return model, params


def _port_policy(params, compute_dtype=torch.float32):
  policy = ct.CnnPolicy(compute_dtype=compute_dtype, device='cpu')
  policy.load_state_dict(policy_from_flax(_np_tree(params)))
  return policy


def _frames(seed, n):
  obs = np.random.RandomState(seed).randint(0, 256, size=(n, 64, 64, 3))
  obs = obs.astype(np.uint8)
  packed = (obs[..., 0].astype(np.int32) | obs[..., 1].astype(np.int32) << 8
            | obs[..., 2].astype(np.int32) << 16).reshape(n, 64 * 64)
  return obs, packed


def _grads_to_port(grads):
  """Flax gradient tree -> {parameter name: tensor} in the port's layout."""
  return policy_from_flax(_np_tree(grads))


# -- policy ----------------------------------------------------------------


@pytest.mark.parametrize('dtypes, atol', [
    ((jnp.float32, torch.float32), 1e-5),
    ((jnp.bfloat16, torch.bfloat16), 2e-2)], ids=['float32', 'bfloat16'])
def test_policy_matches_flax(dtypes, atol):
  model, params = _flax_params(0, dtypes[0])
  policy = _port_policy(params, dtypes[1])
  obs, packed = _frames(1, 6)
  want = model.apply(params, obs)
  want_px = model.apply(params, packed)
  with torch.no_grad():
    got = policy(torch.from_numpy(obs))
    got_px = policy(torch.from_numpy(packed))
  assert got.logits.shape == (6, 17) and got.value.shape == (6,)
  assert got.logits.dtype == got.value.dtype == torch.float32
  np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                             rtol=0, atol=atol)
  np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                             rtol=0, atol=atol)
  # Packed lanes and uint8 frames of the same pixels: equal bit for bit, in
  # both packages (tests/test_ppo.py:40).
  assert torch.equal(got.logits, got_px.logits)
  assert torch.equal(got.value, got_px.value)
  np.testing.assert_array_equal(np.asarray(want.logits),
                                np.asarray(want_px.logits))
  # Leading dims beyond one are kept.
  with torch.no_grad():
    two = policy(torch.from_numpy(obs).reshape(2, 3, 64, 64, 3))
  assert two.logits.shape == (2, 3, 17) and two.value.shape == (2, 3)
  assert torch.equal(two.logits.reshape(6, 17), got.logits)


def test_policy_init_is_lecun_normal():
  """The port's own init: truncated normal of variance 1/fan_in within two
  (untruncated) deviations, zero biases, the same policy from the same
  seed."""
  gen = torch.Generator()
  gen.manual_seed(3)
  policy = ct.CnnPolicy(device='cpu', generator=gen)
  gen.manual_seed(3)
  again = ct.CnnPolicy(device='cpu', generator=gen)
  for layer, twin in zip(policy.layers(), again.layers()):
    w = layer.weight.detach()
    fan_in = w[0].numel()
    assert torch.equal(w, twin.weight.detach())
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 / math.sqrt(fan_in)
    if w.numel() > 5000:
      assert abs(float(w.std()) * math.sqrt(fan_in) - 1) < 0.05
    assert not layer.bias.detach().any()
  assert {name for name, _ in policy.named_parameters()} == set(
      policy_from_flax(_np_tree(_flax_params(0)[1])))


# -- GAE and episode stats ---------------------------------------------------


def _trajectory(seed):
  """A random (T, N) trajectory with a latched ``done`` and a pulsed
  ``ended``, as numpy arrays."""
  rs = np.random.RandomState(seed)
  ended = rs.rand(T, N) < 0.25
  # An env stays done for a few ticks after its episode ended (waiting for
  # a reset slot).
  done = ended.copy()
  for t in range(1, T):
    done[t] |= done[t - 1] & (rs.rand(N) < 0.5) & ~ended[t]
  return dict(
      obs=np.zeros((T, N, 64, 64, 3), np.uint8),
      action=rs.randint(0, 17, size=(T, N)).astype(np.int32),
      logp=rs.randn(T, N).astype(np.float32),
      value=rs.randn(T, N).astype(np.float32),
      reward=rs.randn(T, N).astype(np.float32),
      done=done, ended=ended,
      raw_reward=rs.randn(T, N).astype(np.float32),
      achievements=rs.randint(0, 4, size=(T, N, 22)).astype(np.int32))


def _port_traj(arrays):
  as_tensor = lambda name, a: torch.from_numpy(
      a.astype(np.int64) if name == 'action' else a)
  return ct.Transition(**{name: as_tensor(name, a)
                          for name, a in arrays.items()})


def _pair(**kw):
  """A JAX PPO and the port's, on the CPU, of one configuration."""
  cfg = dict(num_envs=N, rollout_len=T, epochs=2, minibatches=3,
             reset_batch=2)
  cfg.update(kw)
  return (jppo.PPO(JaxConfig(), jppo.PPOConfig(**cfg)),
          ct.PPO(ct.EnvConfig(), ct.PPOConfig(**cfg), device='cpu'))


def test_config_fields_match():
  ours = {f.name: f.default for f in dataclasses.fields(ct.PPOConfig)}
  theirs = {f.name: f.default for f in dataclasses.fields(jppo.PPOConfig)}
  # The port's one field of its own: the choice of policy, NatureCNN (the
  # JAX package's only one) by default.
  assert ours.pop('policy') == 'cnn'
  assert ours == theirs


def test_gae_matches_jax():
  jp, tp = _pair()
  arrays = _trajectory(0)
  last = np.random.RandomState(9).randn(N).astype(np.float32)
  adv_j, ret_j = jax.jit(jp._gae)(jppo.Transition(**arrays), last)
  adv_t, ret_t = tp._gae(_port_traj(arrays), torch.from_numpy(last))
  np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), rtol=0,
                             atol=1e-6)
  np.testing.assert_allclose(ret_t.numpy(), np.asarray(ret_j), rtol=0,
                             atol=1e-6)


def _states(jp, tp, seed):
  """Training states that hold only what ``_learn`` and ``_episode_stats``
  read: no env batch."""
  rs = np.random.RandomState(seed)
  ep_len = rs.randint(0, 50, size=N).astype(np.int32)
  ep_ret = rs.randn(N).astype(np.float32)
  model, params = _flax_params(seed)
  jp.model = model                        # the float32 clone
  key = jax.random.split(jax.random.key(seed), 3)[2]
  ts_j = jppo.PPOState(
      params=params, opt_state=jp.tx.init(params), vec=None, obs=None,
      key=key, update=jnp.int32(0), env_steps=jnp.int32(0),
      ep_len=jnp.asarray(ep_len), ep_ret=jnp.asarray(ep_ret))
  policy = _port_policy(params)
  ts_t = ct.PPOState(
      params=policy,
      opt_state=torch.optim.Adam(policy.parameters(), lr=tp.cfg.lr, eps=1e-5),
      vec=None, obs=None,
      key=torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
          np.int64)),
      update=0, env_steps=0, ep_len=torch.from_numpy(ep_len),
      ep_ret=torch.from_numpy(ep_ret))
  return ts_j, ts_t


@pytest.mark.parametrize('claimed', [(4 * N, T), (1, 2)],
                         ids=['fits', 'overflows'])
def test_episode_stats_match_jax(claimed):
  """Exact: lengths, returns (sums in the same order), achievements, count
  and dropped; with a buffer of one row, records overflow and are dropped
  as JAX's scatter drops them."""
  jp, tp = _pair()
  arrays = _trajectory(1)
  # The buffer has num_envs + num_envs * rollout_len // 16 rows: claim a
  # larger batch than the trajectory holds, so that every episode fits, or
  # a smaller one, so that it overflows.
  sized = dict(num_envs=claimed[0], rollout_len=claimed[1])
  jp.cfg = dataclasses.replace(jp.cfg, **sized)
  tp.cfg = dataclasses.replace(tp.cfg, **sized)
  ts_j, ts_t = _states(jp, tp, 2)
  ts_j2, stats_j = jax.jit(jp._episode_stats)(ts_j, jppo.Transition(**arrays))
  ts_t2, stats_t = tp._episode_stats(ts_t, _port_traj(arrays))
  assert set(stats_t) == set(stats_j)
  for name in stats_j:
    np.testing.assert_array_equal(stats_t[name].numpy(),
                                  np.asarray(stats_j[name]), err_msg=name)
  np.testing.assert_array_equal(ts_t2.ep_len.numpy(), np.asarray(ts_j2.ep_len))
  np.testing.assert_array_equal(ts_t2.ep_ret.numpy(), np.asarray(ts_j2.ep_ret))
  total = int(arrays['ended'].sum())
  assert int(stats_t['count']) + int(stats_t['dropped']) == total > 1
  assert (int(stats_t['dropped']) > 0) == (claimed == (1, 2))


# -- loss, gradients, optimizer ---------------------------------------------


@pytest.fixture(scope='module')
def loss_case():
  """One batch through ``jax.value_and_grad(ppo._loss)`` and the port's
  ``_loss`` + backward, both through float32 policies."""
  jp, tp = _pair()
  ts_j, ts_t = _states(jp, tp, 4)
  rs = np.random.RandomState(5)
  b = 24
  obs, _ = _frames(6, b)
  batch = (obs, rs.randint(0, 17, size=b).astype(np.int32),
           (rs.randn(b) * 0.1 - math.log(17)).astype(np.float32),
           rs.randn(b).astype(np.float32), rs.randn(b).astype(np.float32))
  (loss_j, aux_j), grads_j = jax.jit(
      jax.value_and_grad(jp._loss, has_aux=True))(ts_j.params, batch)
  tbatch = tuple(torch.from_numpy(x.astype(np.int64) if i == 1 else x)
                 for i, x in enumerate(batch))
  loss_t, aux_t = tp._loss(ts_t.params, tbatch)
  loss_t.backward()
  return dict(jp=jp, tp=tp, ts_j=ts_j, ts_t=ts_t, loss=(loss_j, loss_t),
              aux=(aux_j, aux_t), grads_j=grads_j)


def test_loss_and_gradients_match_jax(loss_case):
  loss_j, loss_t = loss_case['loss']
  np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                             rtol=1e-5)
  aux_j, aux_t = loss_case['aux']
  assert set(aux_t) == set(aux_j) == {'pg_loss', 'v_loss', 'entropy'}
  for name in aux_j:
    # pg_loss is a mean of signed terms of order 1 that nearly cancel
    # (-0.002 here), so it also gets the terms' absolute 1e-6.
    np.testing.assert_allclose(float(aux_t[name].detach()),
                               float(aux_j[name]), rtol=1e-5, atol=1e-6,
                               err_msg=name)
  want = _grads_to_port(loss_case['grads_j'])
  for name, p in loss_case['ts_t'].params.named_parameters():
    scale = float(want[name].abs().max())
    assert scale > 0, name
    np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-5,
                               atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize('factor', [1.0, 1e-3], ids=['clipped', 'unclipped'])
def test_clip_and_adam_step_match_optax(loss_case, factor):
  """The gradients of the loss case (global norm above 0.5), and the same
  scaled down below it, through optax's chain and through the port's clip
  and ``torch.optim.Adam``, two steps each: parameters to 1e-5 relative."""
  jp, tp = loss_case['jp'], loss_case['tp']
  grads_j = jax.tree.map(lambda g: g * factor, loss_case['grads_j'])
  norm = float(optax.global_norm(grads_j))
  assert (norm > jp.cfg.max_grad_norm) == (factor == 1.0), norm
  params_j = loss_case['ts_j'].params
  opt_j = jp.tx.init(params_j)
  policy = _port_policy(params_j)
  opt_t = torch.optim.Adam(policy.parameters(), lr=tp.cfg.lr, eps=1e-5)
  grads_t = _grads_to_port(grads_j)
  for _ in range(2):
    updates, opt_j = jp.tx.update(grads_j, opt_j, params_j)
    params_j = optax.apply_updates(params_j, updates)
    for name, p in policy.named_parameters():
      p.grad = grads_t[name].clone()
    tp._clip_grads(policy)
    opt_t.step()
  want = policy_from_flax(_np_tree(params_j))
  before = policy_from_flax(_np_tree(loss_case['ts_j'].params))
  for name, p in policy.named_parameters():
    np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                               rtol=1e-5, atol=1e-7, err_msg=name)
    # Two Adam steps move every parameter by about 2 * lr.
    moved = (p.detach() - before[name]).abs().max()
    assert 1e-4 < float(moved) < 1e-3, name


# -- minibatch index sets ----------------------------------------------------


@pytest.mark.parametrize('mode', [
    dict(shuffle_per='update'), dict(shuffle_per='epoch'),
    dict(time_minibatch=True)], ids=['update', 'epoch', 'time'])
def test_minibatch_index_sets_match_jax(mode):
  """``_learn``'s minibatches for the same key, in all three shuffle modes.
  The action field of the trajectory carries each sample's index; a stand-in
  loss on the JAX side reports the indices of every minibatch it is given
  (in the order the scan visits them)."""
  jp, tp = _pair(**mode)
  ts_j, ts_t = _states(jp, tp, 7)
  arrays = _trajectory(3)
  arrays['action'] = np.arange(T * N, dtype=np.int32).reshape(T, N)
  seen = []

  def spy_loss(params, batch):
    jax.debug.callback(lambda ids: seen.append(np.asarray(ids)), batch[1],
                       ordered=False)
    zero = sum(jnp.sum(p) for p in jax.tree.leaves(params)) * 0.0
    return zero, dict(pg_loss=zero, v_loss=zero, entropy=zero)

  jp._loss = spy_loss
  last = np.zeros(N, np.float32)
  ts_j2, _, _ = jax.jit(jp._learn)(ts_j, jppo.Transition(**arrays), last)
  jax.effects_barrier()
  key, shuffle, epochs = tp._minibatch_indices(ts_t.key)
  ids = torch.arange(T * N).reshape(T, N)
  if not mode.get('time_minibatch'):
    ids = ids.reshape(-1)
  if shuffle is not None:
    ids = ids[shuffle]
  ours = [ids[idx].reshape(-1).numpy() for mbs in epochs for idx in mbs]
  assert len(ours) == len(seen) == jp.cfg.epochs * jp.cfg.minibatches
  # As sequences where the callbacks arrived in order, and as sets of
  # minibatches in any case.
  as_set = lambda batches: sorted(tuple(b.tolist()) for b in batches)
  assert as_set(ours) == as_set(seen)
  for epoch in range(jp.cfg.epochs):
    part = ours[epoch * jp.cfg.minibatches:(epoch + 1) * jp.cfg.minibatches]
    assert sorted(np.concatenate(part).tolist()) == list(range(T * N))
  np.testing.assert_array_equal(
      key.numpy(), np.asarray(jax.random.key_data(ts_j2.key)).astype(np.int64))


# -- one whole update ---------------------------------------------------------


@pytest.fixture(scope='module')
def whole_step():
  """One ``train_step`` of both packages from the same key, parameters and
  worlds, both policies in float32: 4 envs, a rollout of 4 ticks."""
  cfg = dict(num_envs=4, rollout_len=4, epochs=2, minibatches=2,
             reset_batch=2)
  jp = jppo.PPO(JaxConfig(), jppo.PPOConfig(**cfg))
  jp.model = JaxPolicy(n_actions=jrules.N_ACTIONS, compute_dtype=jnp.float32)
  tp = ct.PPO(ct.EnvConfig(), ct.PPOConfig(**cfg), device='cpu')
  ts_j = jax.jit(jp.init)(jax.random.key(0))
  ts_t = tp.init(prng.key(0, 'cpu'))
  ts_t.params.load_state_dict(policy_from_flax(_np_tree(ts_j.params)))
  ts_t.params.compute_dtype = torch.float32
  first = dict(obs=ts_t.obs.clone(), key=ts_t.key.clone(),
               obs_j=np.asarray(ts_j.obs),
               key_j=np.asarray(jax.random.key_data(ts_j.key)))
  ts_j2, metrics_j = jax.jit(jp.train_step)(ts_j)
  ts_t2, metrics_t = tp.train_step(ts_t)
  return dict(first=first, ts_j=ts_j2, ts_t=ts_t2, metrics_j=metrics_j,
              metrics_t=metrics_t)


def test_init_matches_jax(whole_step):
  first = whole_step['first']
  np.testing.assert_array_equal(first['obs'].numpy(), first['obs_j'])
  np.testing.assert_array_equal(first['key'].numpy(),
                                first['key_j'].astype(np.int64))


def test_train_step_matches_jax(whole_step):
  """Same actions (the sampler agrees wherever two perturbed logits are not
  within rounding of each other), so the same worlds, frames and keys
  exactly, and the same metrics to 1e-4 (float32 sums in another order
  through two Adam steps per epoch)."""
  ts_j, ts_t = whole_step['ts_j'], whole_step['ts_t']
  assert ts_t.update == int(ts_j.update) == 1
  assert ts_t.env_steps == int(ts_j.env_steps) == 16
  np.testing.assert_array_equal(ts_t.obs.numpy(), np.asarray(ts_j.obs))
  np.testing.assert_array_equal(
      ts_t.key.numpy(), np.asarray(jax.random.key_data(ts_j.key)).astype(
          np.int64))
  np.testing.assert_array_equal(ts_t.vec.env.mat_map.numpy(),
                                np.asarray(ts_j.vec.env.mat_map))
  np.testing.assert_array_equal(ts_t.vec.env.player.pos.numpy(),
                                np.asarray(ts_j.vec.env.player.pos))
  np.testing.assert_array_equal(ts_t.ep_len.numpy(), np.asarray(ts_j.ep_len))
  metrics_j, metrics_t = whole_step['metrics_j'], whole_step['metrics_t']
  assert set(metrics_t) == set(metrics_j)
  for name in metrics_j:
    np.testing.assert_allclose(float(metrics_t[name]), float(metrics_j[name]),
                               rtol=1e-4, atol=1e-5, err_msg=name)


def _snapshot(policy):
  return {name: p.detach().clone() for name, p in policy.named_parameters()}


@pytest.mark.parametrize('rollout_len', [4, 10], ids=['per_tick', 'grouped'])
def test_train_step_runs_counts_and_is_deterministic(rollout_len):
  """The checks of tests/test_ppo.py on the port (bfloat16 trunk), on the
  per-tick cadence and on the grouped one (a rollout of whole balance
  groups)."""
  cfg = ct.PPOConfig(num_envs=4, rollout_len=rollout_len, epochs=2,
                     minibatches=2, reset_batch=2)
  ppo = ct.PPO(ct.EnvConfig(), cfg, device='cpu')
  ts = ppo.init(prng.key(0, 'cpu'))
  with torch.no_grad():
    out = ts.params(ts.obs)
  probs = torch.softmax(out.logits, -1)
  entropy = float(-(probs * torch.log(probs + 1e-9)).sum(-1).mean())
  assert entropy > 0.9 * math.log(17)
  before = _snapshot(ts.params)
  tick0 = int(ts.vec.tick)
  ts, metrics, stats = ppo.train_step_with_stats(ts)
  assert ts.update == 1 and ts.env_steps == 4 * rollout_len
  assert int(ts.vec.tick) == tick0 + rollout_len
  for name in ('loss', 'pg_loss', 'v_loss', 'entropy', 'reward_per_step'):
    assert math.isfinite(float(metrics[name])), name
  assert 0 < float(metrics['entropy']) <= math.log(17) + 1e-6
  after = _snapshot(ts.params)
  assert all(not torch.equal(before[name], after[name]) for name in before)
  assert stats['lengths'].shape == (4 + 4 * rollout_len // 16,)
  assert int(stats['count']) + int(stats['dropped']) == int(
      metrics['episodes_done'])
  # Same seed twice: the same parameters, bit for bit.
  ts_b = ppo.init(prng.key(0, 'cpu'))
  ts_b, _ = ppo.train_step(ts_b)
  again = _snapshot(ts_b.params)
  assert all(torch.equal(after[name], again[name]) for name in after)


def test_update_rejects_indivisible_batches():
  ppo = ct.PPO(ct.EnvConfig(), ct.PPOConfig(num_envs=3, rollout_len=3,
                                            minibatches=2), device='cpu')
  with pytest.raises(ValueError):
    ppo._update(None)


# -- checkpoint and CLI ------------------------------------------------------


def test_checkpoint_round_trip_mid_episode(tmp_path):
  """Save after one update, take another; restore into a fresh state and
  take it again: identical parameters, worlds, frames, key and metrics."""
  cfg = ct.PPOConfig(num_envs=4, rollout_len=4, epochs=1, minibatches=2,
                     reset_batch=2)
  ppo = ct.PPO(ct.EnvConfig(), cfg, device='cpu')
  ts, _ = ppo.train_step(ppo.init(prng.key(1, 'cpu')))
  ck = checkpoint.Checkpointer(tmp_path / 'ck', keep=2)
  assert ck.latest_step is None and ck.restore_latest(ts) is None
  ck.save(ts.update, ts)
  ts_a, metrics_a = ppo.train_step(ts)
  fresh = ppo.init(prng.key(99, 'cpu'))       # other parameters and key
  restored = ck.restore_latest(fresh)
  assert restored.update == 1 and restored.env_steps == 16
  assert int(restored.vec.tick) == 4 and int(restored.vec.env.step[0]) == 4
  ts_b, metrics_b = ppo.train_step(restored)
  for (name, a), (_, b) in zip(ts_a.params.named_parameters(),
                               ts_b.params.named_parameters()):
    assert torch.equal(a, b), name
  for (path, a), (_, b) in zip(ct.state.leaves(ts_a.vec),
                               ct.state.leaves(ts_b.vec)):
    assert torch.equal(a, b), path
  assert torch.equal(ts_a.obs, ts_b.obs) and torch.equal(ts_a.key, ts_b.key)
  assert float(metrics_a['loss']) == float(metrics_b['loss'])
  # Step tracking and pruning (tests/test_checkpoint.py:33).
  state = {'x': torch.arange(4), 'n': 3, 'nested': [torch.ones(2), 2.5]}
  for step in (2, 5, 7):
    ck.save(step, state)
  assert ck.latest_step == 7
  assert sorted(p.name for p in (tmp_path / 'ck').iterdir()) == [
      'ckpt_0000000005.pt', 'ckpt_0000000007.pt']
  out = ck.restore_latest(state)
  assert torch.equal(out['x'], torch.arange(4)) and out['n'] == 3
  assert out['nested'][1] == 2.5


def test_run_train_cli_writes_stats_and_checkpoint(tmp_path, capsys):
  run_train.main(['--device', 'cpu', '--steps', '32', '--num_envs', '4',
                  '--rollout', '4', '--outdir', str(tmp_path), '--log_every',
                  '1'])
  text = capsys.readouterr().out
  assert 'update 2 steps 32' in text and 'Training done: 32' in text
  assert (tmp_path / 'stats.jsonl').exists()
  assert [p.name for p in (tmp_path / 'ckpt').iterdir()] == [
      'ckpt_0000000002.pt']
  # Resuming a finished run restores it and takes no further step.
  run_train.main(['--device', 'cpu', '--steps', '32', '--num_envs', '4',
                  '--rollout', '4', '--outdir', str(tmp_path), '--resume'])
  assert 'Training done: 32' in capsys.readouterr().out


def test_run_train_needs_a_card_unless_told(tmp_path):
  if torch.cuda.is_available():
    pytest.skip('this machine has a card')
  with pytest.raises(SystemExit, match='--device cpu'):
    run_train.main(['--outdir', str(tmp_path), '--steps', '1'])
