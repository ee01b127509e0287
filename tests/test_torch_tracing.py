"""The program's spans and counters (``crafter_tpu_torch.utils.profiling``)
on the CPU.

Off, the default, they leave no ``crafter.`` range in a profiler trace and
call no sink.  On, they change no result: 3 groups and 20 ticks of an
8-env ``VecState`` on the CPU (the plain twins) give the same states,
results and episodes leaf for leaf.  ``generate_world`` nests under
``reset_pass`` (parent and call id), ``envs_reset`` adds up to the
episodes started, and ``worlds_made`` follows the CPU's rule: only the
selected rows.  The card's
rule (``min(reset_batch, n)`` worlds a pass) and the device-operation count
with a sink set are checked in ``test_torch_cuda.py``.

The benchmark replaces ``step_cuda.group_tick`` and
``render_cuda.render_win79`` by setting the module attribute: the env
paths look both up at call time, so a counting stand-in sees each call.
"""

import dataclasses
import time

import pytest
import torch

import crafter_tpu_torch as ct
from crafter_tpu_torch import render_cuda, step_cuda
from crafter_tpu_torch.state import leaves
from crafter_tpu_torch.utils import profiling
from one_thread import one_torch_thread  # noqa: F401

N, GROUPS, TICKS = 8, 3, 20
GROUP_BATCH, TICK_BATCH = 4, 2
CFG = ct.EnvConfig(length=7)


class Recorder:
  """A sink that keeps every span and count it is handed."""

  def __init__(self):
    self.spans, self.counts = [], []

  def mark(self):
    return time.perf_counter()

  def span(self, name, parent, call, start, end, host_s):
    self.spans.append(dict(name=name, parent=parent, call=call, start=start,
                           end=end, host_s=host_s))

  def count(self, name, value, limit):
    self.counts.append((name, value, limit))


def _run(sink):
  """Snapshots of 3 groups and 20 ticks from fresh worlds, with ``sink``
  set while they run."""
  gen = torch.Generator().manual_seed(4)
  vs = ct.vec_reset(ct.home_keys(11, N, 'cpu'), CFG)
  snaps = [vs]
  profiling.set_sink(sink)
  try:
    for _ in range(GROUPS):
      actions = torch.randint(0, 17, (CFG.balance_every, N), generator=gen)
      vs, outs = ct.vec_step_group(vs, actions, CFG, GROUP_BATCH)
      snaps += [vs, outs]
    for _ in range(TICKS):
      actions = torch.randint(0, 17, (N,), generator=gen)
      vs, out, stepped = ct.vec_step(vs, actions, CFG, TICK_BATCH)
      snaps += [vs, out, stepped]
  finally:
    profiling.set_sink(None)
  return snaps


@pytest.fixture(scope='module')
def runs():
  sink = Recorder()
  return _run(None), _run(sink), sink


@pytest.mark.parametrize('entry', ['vec_step_group', 'vec_step'])
def test_no_sink_no_range_and_no_call(entry):
  assert profiling.span('reset_pass') is profiling.span('learn')
  assert profiling.count('envs_reset', 3) is None
  cfg = dataclasses.replace(CFG, balance_every=2)   # a short group
  vs = ct.vec_reset(ct.home_keys(2, 4, 'cpu'), cfg)
  vs.env.step.fill_(cfg.length - 1)     # every env finishes on this call

  def call():
    if entry == 'vec_step_group':
      return ct.vec_step_group(
          vs, torch.zeros((cfg.balance_every, 4), dtype=torch.int32), cfg, 4)
    return ct.vec_step(vs, torch.zeros((4,), dtype=torch.int32), cfg, 4)

  def ranges(sink):
    profiling.set_sink(sink)
    try:
      with torch.profiler.profile(
          activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    finally:
      profiling.set_sink(None)
    return {e.name for e in prof.events() if e.name.startswith('crafter.')}

  stub = Recorder()
  profiling.set_sink(stub)
  profiling.set_sink(None)
  assert ranges(None) == set()
  assert stub.spans == [] and stub.counts == []
  assert ranges(Recorder()) == {'crafter.reset_pass',
                                'crafter.generate_world'}


def test_sink_changes_no_result(runs):
  plain, spanned, sink = runs
  assert sink.spans
  assert len(plain) == len(spanned)
  for a, b in zip(plain, spanned):
    for (path, x), (_, y) in zip(leaves(a), leaves(b)):
      assert torch.equal(x, y), path


def test_generate_world_nests_under_reset_pass(runs):
  sink = runs[2]
  passes = [s for s in sink.spans if s['name'] == 'reset_pass']
  worlds = [s for s in sink.spans if s['name'] == 'generate_world']
  assert {s['name'] for s in sink.spans} == {'reset_pass', 'generate_world'}
  assert all(s['parent'] is None for s in passes)
  assert len({s['call'] for s in passes}) == len(passes) == GROUPS + TICKS
  by_call = {s['call']: s for s in passes}
  assert worlds
  for w in worlds:
    assert w['parent'] == 'reset_pass'
    outer = by_call[w['call']]
    assert outer['start'] <= w['start'] <= w['end'] <= outer['end']
    assert 0 <= w['host_s'] <= outer['host_s']


def test_envs_reset_sums_to_episodes_started(runs):
  plain, _, sink = runs
  envs_reset = [(v, lim) for n, v, lim in sink.counts if n == 'envs_reset']
  assert len(envs_reset) == GROUPS + TICKS
  started = int(plain[-3].episode.sum()) - int(plain[0].episode.sum())
  assert started > 0
  assert profiling.counted(envs_reset) == started


def test_worlds_made_follows_the_cpu_rule(runs):
  sink = runs[2]
  names = [n for n, _, _ in sink.counts]
  assert names == ['envs_reset', 'worlds_made'] * (GROUPS + TICKS)
  pairs = list(zip(sink.counts[::2], sink.counts[1::2]))
  budgets = [GROUP_BATCH] * GROUPS + [TICK_BATCH] * TICKS
  overflow = short = False
  for ((_, finished, budget), (_, made, limit)), batch in zip(pairs, budgets):
    assert budget == batch and limit is None and isinstance(made, int)
    assert made == min(int(finished), budget)
    overflow |= int(finished) > budget
    short |= made < batch
  assert overflow and short


def test_env_paths_call_the_wrappers_through_their_modules(monkeypatch):
  """One ``vec_step_group_obs`` group calls ``group_tick`` and
  ``render_win79`` once each, one ``VecEnv.step`` ``render_win79`` once,
  all through counting stand-ins set on the modules."""
  calls = {'group_tick': 0, 'render_win79': 0}

  def counting(module, name):
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
      calls[name] += 1
      return original(*args, **kwargs)
    monkeypatch.setattr(module, name, wrapper)

  counting(step_cuda, 'group_tick')
  counting(render_cuda, 'render_win79')
  cfg = ct.EnvConfig(length=7, balance_every=3)
  core = ct.CrafterEnv(cfg, 'cpu')
  vs = ct.vec_reset(ct.home_keys(5, 2, 'cpu'), cfg)
  actions = torch.zeros((cfg.balance_every, 2), dtype=torch.int32)
  ct.vec_step_group_obs(vs, actions, cfg, 2, core)
  assert calls == {'group_tick': 1, 'render_win79': 1}
  env = ct.VecEnv(2, cfg, seed=5, device='cpu')
  env.reset()
  calls['render_win79'] = 0
  env.step(torch.zeros((2,), dtype=torch.int32))
  assert calls == {'group_tick': 1, 'render_win79': 1}
