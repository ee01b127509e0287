"""The port's IMPALA ResNet-LSTM policy (``models/impala.py``) and its
recurrent PPO learner (``ppo.py``) against the plain float32 reference
``tests/impala_lstm_ref.py``, on the CPU at a tiny size (8 envs x 6 ticks,
with episodes ending mid-sequence), on seeded random weights with non-zero
biases (zero biases would hide a bias mapped wrongly).

Tolerances, each for its reason: the port's float32 clone
(``compute_dtype=float32``) to 1e-5, since the two compute the same
products in other groupings (the port projects the gates' inputs of every
tick at once); the bfloat16 trunk to 2e-2 on logits and values, as
``test_torch_ppo.py`` holds NatureCNN's (the trunk's activations are
rounded to 8 bits of mantissa); losses, gradients and the parameters after
an update to 1e-5 relative, summation order again.  The frozen copy in
``benchmark/reference/`` runs the same operations as this reference, but
for its blocks of envs, so it is held to it as tightly.
"""

import dataclasses
import math

import pytest
import torch

import crafter_tpu_torch as ct
from crafter_tpu_torch import checkpoint, prng, run_train
from crafter_tpu_torch.models import CoreInputs, LstmCarry
from crafter_tpu_torch.ppo import PPO, PPOConfig, Transition, _core_inputs
from crafter_tpu_torch.utils import profiling
import impala_lstm_ref as ref
from one_thread import one_torch_thread  # noqa: F401

T, N = 6, 8
HYPER = dict(gamma=0.99, gae_lambda=0.95, clip=0.2, vf_coef=0.5,
             ent_coef=0.01)


def _config(**kw):
  cfg = dict(num_envs=N, rollout_len=T, epochs=2, minibatches=2,
             reset_batch=2, policy='impala_lstm', shuffle_per='epoch')
  cfg.update(kw)
  return PPOConfig(**cfg)


def _policy(seed, compute_dtype=torch.float32):
  gen = torch.Generator().manual_seed(seed)
  policy = ct.ImpalaLstmPolicy(compute_dtype=compute_dtype, generator=gen,
                               device='cpu')
  with torch.no_grad():
    for name, p in policy.named_parameters():
      if name.endswith('.bias'):
        p.copy_(0.05 * torch.randn(p.shape, generator=gen))
  return policy


def _params(policy):
  return {n: p.detach().clone() for n, p in policy.named_parameters()}


def _inputs(seed, t_len=T, n=N):
  """Frames, a state and per-tick inputs with resets mid-sequence."""
  gen = torch.Generator().manual_seed(seed)
  obs = torch.randint(0, 256, (t_len, n, 64, 64, 3), generator=gen,
                      dtype=torch.uint8)
  reset = torch.rand((t_len, n), generator=gen) < 0.25
  reset[2, :2] = True
  core = CoreInputs(
      h=0.5 * torch.randn((n, 256), generator=gen),
      c=0.5 * torch.randn((n, 256), generator=gen),
      prev_action=torch.randint(0, 17, (t_len, n), generator=gen),
      prev_reward=2 * torch.randn((t_len, n), generator=gen), reset=reset)
  return obs, core


def _ref_forward(params, obs, core):
  return ref.forward(params, obs, core.h, core.c, core.prev_action,
                     core.prev_reward, core.reset)


# -- the policy ------------------------------------------------------------


@pytest.mark.parametrize('dtype, atol', [
    (torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
    ids=['float32', 'bfloat16'])
def test_sequence_and_steps_match_reference(dtype, atol):
  policy = _policy(0, dtype)
  assert {n: tuple(p.shape) for n, p in policy.named_parameters()} == \
      ref.shapes()
  obs, core = _inputs(1)
  logits, values, _ = _ref_forward(_params(policy), obs, core)
  with torch.no_grad():
    seq = policy.sequence(obs, core)
    steps, (h, c) = [], (core.h, core.c)
    for t in range(T):
      carry = LstmCarry(h, c, core.prev_action[t], core.prev_reward[t],
                        core.reset[t])
      out, (h, c) = policy.step(obs[t], carry)
      steps.append(out)
  assert seq.logits.shape == (T, N, 17) and seq.value.shape == (T, N)
  assert seq.logits.dtype == seq.value.dtype == torch.float32
  for got_logits, got_values in (
      (seq.logits, seq.value),
      (torch.stack([o.logits for o in steps]),
       torch.stack([o.value for o in steps]))):
    torch.testing.assert_close(got_logits, logits, rtol=0, atol=atol)
    torch.testing.assert_close(got_values, values, rtol=0, atol=atol)


def test_reset_starts_a_fresh_sequence():
  """From a tick whose predecessor ended an episode on, the outputs are
  those of a sequence started there from any state."""
  policy = _policy(2)
  obs, core = _inputs(3)
  core.reset[:] = False
  core.reset[3] = True
  fresh = CoreInputs(h=torch.randn(N, 256), c=torch.randn(N, 256),
                     prev_action=core.prev_action[3:],
                     prev_reward=core.prev_reward[3:],
                     reset=core.reset[3:])
  with torch.no_grad():
    whole = policy.sequence(obs, core)
    later = policy.sequence(obs[3:], fresh)
  # Summation order: the gates' inputs are projected for 6 ticks at once in
  # one and for 3 in the other.
  torch.testing.assert_close(whole.logits[3:], later.logits, rtol=0,
                             atol=1e-6)
  torch.testing.assert_close(whole.value[3:], later.value, rtol=0, atol=1e-6)
  assert not torch.allclose(whole.logits[:3], later.logits[:3], atol=1e-3)


def test_without_the_reset_mask_the_reference_disagrees():
  """The mask matters: the same inputs with no reset differ from the
  reference's outputs (with its resets) by far more than the tolerance."""
  policy = _policy(4)
  obs, core = _inputs(5)
  logits, values, _ = _ref_forward(_params(policy), obs, core)
  with torch.no_grad():
    masked = policy.sequence(obs, core)
    unmasked = policy.sequence(obs, dataclasses.replace(
        core, reset=torch.zeros_like(core.reset)))
  torch.testing.assert_close(masked.logits, logits, rtol=0, atol=1e-5)
  assert (unmasked.logits - logits).abs().max() > 100 * 1e-5
  assert (unmasked.value - values).abs().max() > 100 * 1e-5


# -- the learner -----------------------------------------------------------


def _transition(policy, seed):
  """A rollout by hand: frames, actions, the policy's own log-probabilities
  (so that the ratio starts at 1), values, rewards and dones, with the
  core inputs that the rollout would store."""
  gen = torch.Generator().manual_seed(seed)
  obs, _ = _inputs(seed)
  action = torch.randint(0, 17, (T, N), generator=gen)
  done = torch.rand((T, N), generator=gen) < 0.2
  reward = torch.randn((T, N), generator=gen)
  carry = LstmCarry(h=0.5 * torch.randn((N, 256), generator=gen),
                    c=0.5 * torch.randn((N, 256), generator=gen),
                    action=torch.randint(0, 17, (N,), generator=gen),
                    reward=torch.randn((N,), generator=gen),
                    done=torch.rand((N,), generator=gen) < 0.5)
  zeros = lambda *shape, dtype=torch.float32: torch.zeros(
      (T, N) + shape, dtype=dtype)
  traj = Transition(obs=obs, action=action, logp=zeros(),
                    value=torch.randn((T, N), generator=gen), reward=reward,
                    done=done, ended=zeros(dtype=torch.bool),
                    raw_reward=reward, achievements=zeros(22,
                                                          dtype=torch.int32))
  traj.core = _core_inputs(carry, traj)
  with torch.no_grad():
    out = policy.sequence(obs, traj.core)
    traj.logp = torch.log_softmax(out.logits, -1).gather(
        -1, action[..., None])[..., 0] + 0.01 * torch.randn(
            (T, N), generator=gen)
  return traj, torch.randn((N,), generator=gen)


def _ref_batch(traj):
  core = traj.core
  return dict(obs=traj.obs, action=traj.action, logp=traj.logp,
              value=traj.value, reward=traj.reward, done=traj.done,
              prev_action=core.prev_action, prev_reward=core.prev_reward,
              reset=core.reset, h=core.h, c=core.c)


@pytest.fixture(scope='module')
def learner():
  """A recurrent PPO on the CPU whose float32 policy holds seeded weights,
  and a state for it."""
  ppo = PPO(ct.EnvConfig(), _config(), device='cpu')
  ts = ppo.init(prng.key(5, 'cpu'))
  ts.params.compute_dtype = torch.float32
  with torch.no_grad():
    for p, q in zip(ts.params.parameters(), _policy(6).parameters()):
      p.copy_(q)
  return ppo, ts


def _rel(got, want):
  return float((got - want).norm() / want.norm())


def test_loss_and_gradients_match_reference(learner):
  ppo, ts = learner
  policy = ts.params
  traj, last_value = _transition(policy, 7)
  adv, ret = ppo._gae(traj, last_value)
  want_adv, want_ret = ref.gae(traj.value, traj.reward, traj.done,
                               last_value)
  torch.testing.assert_close(adv, want_adv, rtol=0, atol=1e-6)
  idx = torch.tensor([5, 0, 3, 6])
  mb = tuple(x[:, idx] for x in (traj.obs, traj.action, traj.logp, adv,
                                 ret)) + (traj.core.envs(idx),)
  policy.zero_grad(set_to_none=True)
  loss, aux = ppo._loss(policy, mb)
  loss.backward()
  params = {n: p.detach().clone().requires_grad_(True)
            for n, p in policy.named_parameters()}
  batch = {n: (x[idx] if n in ('h', 'c') else x[:, idx])
           for n, x in _ref_batch(traj).items()}
  want = ref.loss(params, batch, adv[:, idx], ret[:, idx],
                  **{k: HYPER[k] for k in ('clip', 'vf_coef', 'ent_coef')})
  want[0].backward()
  for got, expected in zip((loss, aux['pg_loss'], aux['v_loss'],
                            aux['entropy']), want):
    got, expected = float(got.detach()), float(expected.detach())
    assert abs(got - expected) <= 1e-5 * abs(expected)
  for name, p in policy.named_parameters():
    assert _rel(p.grad, params[name].grad) < 1e-5, name


def test_update_matches_reference(learner):
  """``_learn``: GAE, the env-axis minibatches of the key chain, the clip
  and Adam, as the reference's update over the same permutations."""
  ppo, ts = learner
  traj, last_value = _transition(ts.params, 8)
  _, _, epochs = ppo._minibatch_indices(ts.key)
  perms = [torch.cat(list(mbs)) for mbs in epochs]
  assert all(sorted(p.tolist()) == list(range(N)) for p in perms)
  assert [len(mbs) for mbs in epochs] == [2, 2]
  params = {n: p.detach().clone().requires_grad_(True)
            for n, p in ts.params.named_parameters()}
  opt = torch.optim.Adam(params.values(), lr=ppo.cfg.lr, eps=1e-5)
  losses, _ = ref.learn(params, opt, _ref_batch(traj), last_value, perms,
                        ppo.cfg.minibatches, **HYPER)
  before = _params(ts.params)
  ts2, metrics, _ = ppo._learn(ts, traj, last_value)
  assert ts2.update == ts.update + 1
  want_loss = float(torch.stack(losses).mean())
  assert abs(float(metrics['loss']) - want_loss) <= 1e-5 * abs(want_loss)
  for name, p in ts.params.named_parameters():
    assert _rel(p.detach() - before[name], params[name].detach()
                - before[name]) < 1e-5, name


def _ending_state(ppo, seed):
  """A fresh state in which envs 0 and 1 end their episodes on the rollout's
  third tick."""
  ts = ppo.init(prng.key(seed, 'cpu'))
  ts.vec.env.step[:2] = ppo.env_cfg.length - 3
  return ts


def test_rollout_log_probs_equal_the_learn_scan():
  """Before any optimizer step, the scan that learn runs over the stored
  core inputs gives the rollout's own per-tick log-probabilities, episodes
  that end mid-rollout included."""
  ppo = PPO(ct.EnvConfig(), _config(), device='cpu')
  ts = _ending_state(ppo, 9)
  ts.params.compute_dtype = torch.float32
  ts, traj, _ = ppo._rollout(ts)
  assert bool(traj.done[2, :2].all()) and bool(traj.core.reset[3, :2].all())
  assert bool(traj.core.reset[0].all())       # the first tick of a run
  with torch.no_grad():
    out = ts.params.sequence(traj.obs, traj.core)
  logp = torch.log_softmax(out.logits, -1).gather(
      -1, traj.action[..., None])[..., 0]
  torch.testing.assert_close(logp, traj.logp, rtol=0, atol=1e-5)
  assert torch.equal(ts.carry.action, traj.action[-1])
  assert torch.equal(ts.carry.done, traj.done[-1])


class _Counts:
  """A sink that keeps the counts it is handed."""

  def mark(self):
    return 0.0

  def span(self, *args):
    pass

  def __init__(self):
    self.counts = []

  def count(self, name, value, limit=None):
    self.counts.append((name, value, limit))

  def total(self, name):
    return profiling.counted((v, lim) for n, v, lim in self.counts
                             if n == name)


def test_counters_count_resets_and_steps():
  ppo = PPO(ct.EnvConfig(), _config(), device='cpu')
  ts = _ending_state(ppo, 10)
  kept = {}
  learn = ppo._learn

  def keep(ts, traj, last_value):
    kept['traj'] = traj
    return learn(ts, traj, last_value)

  ppo._learn = keep
  sink = _Counts()
  profiling.set_sink(sink)
  try:
    ppo.train_step(ts)
  finally:
    profiling.set_sink(None)
  traj = kept['traj']
  # Every carry starts zeroed, and envs 0 and 1 again after their ends.
  assert sink.total('state_resets') == int(traj.core.reset.sum()) == \
      N + int(traj.done[:-1].sum()) >= N + 2
  # A step a tick and one for the last value; the learn scans: a step a
  # tick of every minibatch of every epoch.
  cfg = ppo.cfg
  assert sink.total('lstm_steps') == T + 1 + cfg.epochs * cfg.minibatches * T


def test_train_step_runs_and_is_deterministic():
  ppo = PPO(ct.EnvConfig(), _config(), device='cpu')
  ts = ppo.init(prng.key(0, 'cpu'))
  assert ts.params.compute_dtype == torch.bfloat16
  before = _params(ts.params)
  ts, metrics, stats = ppo.train_step_with_stats(ts)
  assert ts.update == 1 and ts.env_steps == N * T
  for name in ('loss', 'pg_loss', 'v_loss', 'entropy', 'reward_per_step'):
    assert math.isfinite(float(metrics[name])), name
  after = _params(ts.params)
  assert all(not torch.equal(before[n], after[n]) for n in before)
  assert ts.carry.h.shape == (N, 256) and ts.carry.h.abs().sum() > 0
  again = ppo.init(prng.key(0, 'cpu'))
  again, _ = ppo.train_step(again)
  assert all(torch.equal(after[n], p.detach())
             for n, p in again.params.named_parameters())
  assert torch.equal(again.carry.h, ts.carry.h)


@pytest.mark.parametrize('kw', [
    dict(time_minibatch=True), dict(shuffle_per='update'),
    dict(policy='lstm')], ids=['time_minibatch', 'update', 'unknown'])
def test_refused_settings(kw):
  with pytest.raises(ValueError, match='time_minibatch|policy'):
    PPO(ct.EnvConfig(), _config(**kw), device='cpu')


def test_indivisible_envs_and_sharding_refused():
  ppo = PPO(ct.EnvConfig(), _config(num_envs=5), device='cpu')
  with pytest.raises(ValueError, match='num_envs'):
    ppo._update(None)
  mesh = ct.parallel.Mesh(None, 0, 1, torch.device('cpu'))
  with pytest.raises(ValueError, match='impala_lstm'):
    ct.make_sharded_train(ct.EnvConfig(), _config(), mesh, device='cpu')


# -- checkpoint and CLI ----------------------------------------------------


def test_checkpoint_round_trip_with_carry(tmp_path):
  """Save after one update, take another; restore into a fresh state and
  take it again: the carry, parameters, frames and key bit for bit."""
  ppo = PPO(ct.EnvConfig(), _config(epochs=1), device='cpu')
  ts, _ = ppo.train_step(ppo.init(prng.key(1, 'cpu')))
  ck = checkpoint.Checkpointer(tmp_path / 'ck')
  ck.save(ts.update, ts)
  saved = {f.name: getattr(ts.carry, f.name).clone()
           for f in dataclasses.fields(ts.carry)}
  ts_a, metrics_a = ppo.train_step(ts)
  restored = ck.restore_latest(ppo.init(prng.key(99, 'cpu')))
  for name, value in saved.items():
    got = getattr(restored.carry, name)
    assert got.dtype == value.dtype and torch.equal(got, value), name
  ts_b, metrics_b = ppo.train_step(restored)
  for f in dataclasses.fields(ts_a.carry):
    assert torch.equal(getattr(ts_a.carry, f.name),
                       getattr(ts_b.carry, f.name)), f.name
  for (name, a), (_, b) in zip(ts_a.params.named_parameters(),
                               ts_b.params.named_parameters()):
    assert torch.equal(a, b), name
  assert torch.equal(ts_a.obs, ts_b.obs) and torch.equal(ts_a.key, ts_b.key)
  assert float(metrics_a['loss']) == float(metrics_b['loss'])


def test_run_train_cli_trains_the_recurrent_policy(tmp_path, capsys):
  run_train.main(['--device', 'cpu', '--policy', 'impala_lstm', '--steps',
                  '32', '--num_envs', '8', '--rollout', '4', '--outdir',
                  str(tmp_path), '--log_every', '1'])
  text = capsys.readouterr().out
  assert 'update 1 steps 32' in text and 'Training done: 32' in text
  assert (tmp_path / 'stats.jsonl').exists()
  saved = torch.load(tmp_path / 'ckpt' / 'ckpt_0000000001.pt',
                     weights_only=True)
  assert saved['carry']['h'].shape == (8, 256)
  assert 'lstm_hh.weight' in saved['params']


# -- the benchmark's frozen copy -------------------------------------------


def test_frozen_copy_matches_this_reference():
  from benchmark.reference import impala_lstm as frozen
  from benchmark.reference import ppo as frozen_ppo
  from benchmark.reference import ppo_recurrent as frozen_learn
  policy = _policy(11)
  params = _params(policy)
  assert frozen.shapes() == ref.shapes()
  obs, core = _inputs(12)
  args = (obs, core.h, core.c, core.prev_action, core.prev_reward,
          core.reset)
  want = ref.forward(params, *args)
  got = frozen.forward(params, *args)
  for g, w in zip(got[:2] + got[2], want[:2] + want[2]):
    assert torch.equal(g, w)
  # The loss and gradient of one minibatch, in blocks of 3 envs there.
  traj, last_value = _transition(policy, 13)
  adv, ret = ref.gae(traj.value, traj.reward, traj.done, last_value)
  idx = torch.tensor([7, 1, 4, 2, 0])
  batch = _ref_batch(traj)
  leaves = lambda: {n: p.clone().requires_grad_(True)
                    for n, p in params.items()}
  mine = leaves()
  want = ref.loss(mine, {n: (x[idx] if n in ('h', 'c') else x[:, idx])
                         for n, x in batch.items()},
                  adv[:, idx], ret[:, idx])
  want[0].backward()
  theirs = leaves()
  hp = frozen_ppo.Hyper(num_envs=N, rollout_len=T, **HYPER)
  got = frozen_learn.learn_minibatch(theirs, batch, adv, ret, idx, hp, 3)
  for g, w in zip(got, want):
    g, w = float(g.detach()), float(w.detach())
    assert abs(g - w) <= 1e-5 * abs(w)
  for name in params:
    assert _rel(theirs[name].grad, mine[name].grad) < 1e-5, name
  # The core's log-probabilities over given features: the reference's.
  feat = ref.trunk(params, obs.reshape((-1, 64, 64, 3))).reshape(T, N, -1)
  action = torch.randint(0, 17, (T, N))
  logp = frozen_learn.core_logp(params, feat, dict(
      h=core.h, c=core.c, prev_action=core.prev_action,
      prev_reward=core.prev_reward, reset=core.reset), action)
  logits = ref.forward(params, *args)[0]
  assert torch.equal(logp, torch.log_softmax(logits, -1).gather(
      -1, action[..., None])[..., 0])


def test_frozen_first_scan_is_the_forward_over_a_minibatch():
  """The benchmark's record of a minibatch's scan: the reference's forward
  over those envs' sequences, whatever the block size; in bfloat16 the
  scan's log-probabilities move by more than the float32 rounding."""
  from benchmark.reference import ppo_recurrent as frozen_learn
  policy = _policy(14)
  params = _params(policy)
  traj, _ = _transition(policy, 15)
  batch = _ref_batch(traj)
  idx = torch.tensor([6, 0, 3, 5, 2])
  feat, core, logp = frozen_learn.first_scan(params, batch, idx, 'float32',
                                             'float32', 2)
  assert torch.equal(core['h'], batch['h'][idx])
  assert torch.equal(core['reset'], batch['reset'][:, idx])
  logits = ref.forward(params, batch['obs'][:, idx], core['h'], core['c'],
                       core['prev_action'], core['prev_reward'],
                       core['reset'])[0]
  # Blocks of 2 envs take the convolutions at another batch size than the
  # whole 5: float32 rounding of the same sums, far under 1e-5.
  assert torch.allclose(logp, torch.log_softmax(logits, -1), atol=1e-5)
  low = frozen_learn.core_log_softmax(params, feat, core, 'bfloat16')
  assert float((low - logp).abs().mean()) > 1e-5
