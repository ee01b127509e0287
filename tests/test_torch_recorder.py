"""The port's copies of ``recorder`` and ``analysis`` against the JAX
package's modules on the same arrays: the same ``stats.jsonl`` lines and the
same scores.  Tolerance: none (the same numpy code on the same inputs).
And the profiling helpers: a trace of CPU work is written, the timer adds
up its sections.
"""

import json
import time

import numpy as np
import pytest
import torch

from crafter_tpu import analysis as janalysis
from crafter_tpu import recorder as jrecorder
from crafter_tpu import rules as jrules
from crafter_tpu_torch import analysis, recorder, rules
from crafter_tpu_torch.utils import Timer, trace
from one_thread import one_torch_thread  # noqa: F401


def _episodes(seed, n):
  rs = np.random.RandomState(seed)
  return (rs.randint(1, 500, size=n).astype(np.int32),
          rs.randn(n).astype(np.float32) * 5,
          rs.randint(0, 3, size=(n, rules.N_ACHIEVEMENTS)).astype(np.int32))


def test_vec_stats_recorder_writes_the_same_lines(tmp_path):
  assert rules.ACHIEVEMENTS == jrules.ACHIEVEMENTS
  rs = np.random.RandomState(0)
  ours = recorder.VecStatsRecorder(5, tmp_path / 'ours')
  theirs = jrecorder.VecStatsRecorder(5, tmp_path / 'theirs')
  lens, rets, achs = _episodes(1, 9)
  for rec in (ours, theirs):
    rec.add_episodes(7, lens, rets, achs)   # only the first 7 are episodes
  # The per-step surface, with a latched done and a pulsed ended.
  for t in range(40):
    reward = rs.randn(5).astype(np.float32)
    ended = rs.rand(5) < 0.1
    done = ended | (rs.rand(5) < 0.1)
    ach = rs.randint(0, 2, size=(5, rules.N_ACHIEVEMENTS))
    for rec in (ours, theirs):
      rec.add(reward, done, ach, ended)
  a = (tmp_path / 'ours' / 'stats.jsonl').read_text()
  b = (tmp_path / 'theirs' / 'stats.jsonl').read_text()
  assert a == b and len(a.splitlines()) > 7
  row = json.loads(a.splitlines()[0])
  assert row['length'] == int(lens[0])
  assert set(row) == {'length', 'reward'} | {
      f'achievement_{name}' for name in rules.ACHIEVEMENTS}


@pytest.mark.parametrize('seed', [0, 1])
def test_analysis_scores_match(tmp_path, seed):
  budget = 3000
  for run in range(2):
    lens, rets, achs = _episodes(10 * seed + run, 40)
    rec = recorder.VecStatsRecorder(1, tmp_path / 'logs' / str(run))
    rec.add_episodes(40, lens, rets, achs)
  loaded = analysis.load_stats(tmp_path / 'logs' / '0' / 'stats.jsonl', budget)
  assert loaded == janalysis.load_stats(
      tmp_path / 'logs' / '0' / 'stats.jsonl', budget)
  a = analysis.read_stats(tmp_path / 'logs', tmp_path / 'a', 'task', 'ppo',
                          budget)
  b = janalysis.read_stats(tmp_path / 'logs', tmp_path / 'b', 'task', 'ppo',
                           budget)
  assert a.read_text() == b.read_text()
  runs = analysis.load_runs([a], budget)
  pa = analysis.compute_success_rates(runs, budget)
  pb = janalysis.compute_success_rates(janalysis.load_runs([b], budget),
                                       budget)
  np.testing.assert_array_equal(pa[0], pb[0])
  assert pa[1:] == pb[1:]
  np.testing.assert_array_equal(analysis.compute_scores(pa[0]),
                                janalysis.compute_scores(pb[0]))
  np.testing.assert_array_equal(analysis.crafter_score([a], budget),
                                janalysis.crafter_score([b], budget))
  xs = np.arange(50.0)
  np.testing.assert_array_equal(
      analysis.binning(xs, xs ** 2, np.arange(0, 60, 10))[1],
      janalysis.binning(xs, xs ** 2, np.arange(0, 60, 10))[1])


def test_stats_recorder_wrapper_matches(tmp_path):
  """The single-env ``StatsRecorder`` over a deterministic env double."""

  class FakeEnv:
    def __init__(self):
      self.t = 0

    def reset(self):
      self.t = 0
      return np.zeros((64, 64, 3), np.uint8)

    def step(self, action):
      self.t += 1
      ach = {name: int(self.t >= 2 and name == 'collect_wood')
             for name in rules.ACHIEVEMENTS}
      info = {'reward': float(self.t == 2), 'achievements': ach,
              'inventory': {name: 0 for name in rules.ITEMS},
              'discount': 1.0}
      return (np.zeros((64, 64, 3), np.uint8), info['reward'], self.t >= 3,
              info)

  for lib, name in ((recorder, 'ours'), (jrecorder, 'theirs')):
    env = lib.StatsRecorder(FakeEnv(), tmp_path / name)
    for _ in range(2):
      env.reset()
      done = False
      while not done:
        _, _, done, _ = env.step(0)
  assert ((tmp_path / 'ours' / 'stats.jsonl').read_text()
          == (tmp_path / 'theirs' / 'stats.jsonl').read_text())
  # The full recorder picks the same sinks in both packages.
  kinds = lambda lib, name: [type(sink).__name__ for sink in lib.Recorder(
      FakeEnv(), tmp_path / 'all' / name)._sinks]
  assert kinds(recorder, 'ours') == kinds(jrecorder, 'theirs') == [
      'StatsSink', 'VideoSink', 'TransitionSink']


def test_profiling_helpers(tmp_path):
  with trace(tmp_path / 'prof') as prof:
    torch.ones(64, 64) @ torch.ones(64, 64)
  events = json.loads((tmp_path / 'prof' / 'trace.json').read_text())
  assert events['traceEvents']
  assert any('mm' in e.key for e in prof.key_averages())
  timer = Timer()
  for _ in range(2):
    with timer.section('sleep'):
      time.sleep(0.01)
  with timer.section('nothing'):
    pass
  assert timer.sections['sleep'] >= 0.02 > timer.sections['nothing']
  assert timer.report().splitlines()[0].startswith('sleep')
