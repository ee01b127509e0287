"""The port's training-measurement tools on the CPU, at tiny sizes.

* ``tools/bench_ppo_cuda.py --device cpu``: ``bench_ppo.py``'s JSON keys,
  the timed updates split into rollout and learn.
* ``tools/ppo_budget_cuda.py --device cpu`` on both env-loop branches (a
  rollout of 4 ticks, the per-tick cadence; of 10, whole groups): the
  seven-stage table, the three derived lines and ``ppo_budget.py``'s JSON
  keys.
* ``tools/profile_summary_cuda.py --device cpu`` in its three modes: the
  table's shape (the CPU has no device rows), the ticks of whole groups,
  the trace written, and ``--trace`` giving the same table from it; the
  trace parser on a trace with device rows.
* ``tools/profile_learn_cuda.py --device cpu`` on its three stages.
* Without a card each default run stops with an error.
"""

import contextlib
import io
import json
import pathlib
import re
import runpy

import pytest
import torch

from one_thread import one_torch_thread  # noqa: F401

TOOLS = pathlib.Path(__file__).resolve().parent.parent / 'tools'
STAGES = ('env_only', 'env_render', 'policy', 'rollout', 'gae', 'learn',
          'full')
PPO = ['--num_envs', '8', '--minibatches', '2', '--epochs', '1',
       '--device', 'cpu']


def _tool(name):
  return runpy.run_path(str(TOOLS / f'{name}.py'), run_name=name)


def _run(name, argv):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    rec = _tool(name)['main'](argv)
  return rec, out.getvalue()


def _table(text):
  """The lines of a profile table: header, op rows, total."""
  lines = text.splitlines()
  start = next(i for i, line in enumerate(lines) if line.split()[:2] in (
      ['ms/tick', 'x'], ['ms/iter', 'x']))
  end = next(i for i, line in enumerate(lines)
             if line.startswith('total device self time: '))
  return lines[start:end + 1]


def test_bench_ppo_keys():
  rec, out = _run('bench_ppo_cuda', PPO + ['--rollout', '8', '--updates',
                                           '2'])
  assert json.loads(out.strip().splitlines()[-1]) == rec
  for key in ('metric', 'value', 'num_envs', 'rollout', 'updates',
              'compile_s', 'episodes_done', 'wall_s'):
    assert key in rec, key
  assert rec['metric'] == 'ppo_env_steps_per_s' and rec['value'] > 0
  assert (rec['num_envs'], rec['rollout'], rec['updates']) == (8, 8, 2)
  assert len(rec['update_ms']) == len(rec['rollout_ms']) == 2
  for u, r, learn in zip(rec['update_ms'], rec['rollout_ms'],
                         rec['learn_ms']):
    assert 0 < r < u and learn == pytest.approx(u - r)
  assert (rec['device'], rec['card'], rec['launches']) == ('cpu', None, None)


@pytest.mark.parametrize('rollout', [4, 10], ids=['per_tick', 'grouped'])
def test_ppo_budget_table(rollout):
  rec, out = _run('ppo_budget_cuda',
                  PPO + ['--rollout', str(rollout), '--reps', '1'])
  lines = out.strip().splitlines()
  assert json.loads(lines[-1]) == rec
  head = lines.index(next(line for line in lines
                          if line.split()[:3] == ['stage', 'ms', 'steps/s']))
  rows = lines[head + 1:head + 8]
  assert [row.split()[0] for row in rows] == list(STAGES)
  for row in rows:
    assert re.match(r'^\w+ +[\d.]+ +[\d,]+  \S', row), row
  assert re.match(r'^render share: -?[\d.]+ ms; rollout overhead vs '
                  r'env_render\+policy: -?[\d.]+ ms; full-vs-rollout\+learn '
                  r'gap: -?[\d.]+ ms$', lines[head + 8])
  assert (rec['num_envs'], rec['rollout_len']) == (8, rollout)
  for stage in STAGES:
    assert rec[stage] >= 0
  assert rec['full_steps_per_s'] > 0
  assert (rec['device'], rec['card'], rec['launches']) == ('cpu', None, None)


@pytest.mark.parametrize('mode', ['tick', 'group', 'render'])
def test_profile_summary_modes_and_reparse(tmp_path, mode):
  argv = ['--device', 'cpu', '--num_envs', '8', '--iters', '15', '--logdir',
          str(tmp_path)] + ([] if mode == 'tick' else [f'--{mode}'])
  rec, out = _run('profile_summary_cuda', argv)
  assert json.loads(out.strip().splitlines()[-1]) == rec
  assert rec['ticks'] == 10                 # whole groups of K = 10
  table = _table(out)
  assert table[0].split() == ['ms/tick', 'x', 'op']
  assert re.match(r'^total device self time: [\d.]+ ms/tick \(a floor',
                  table[-1])
  assert len(table) - 2 == len(rec['top'])  # no device rows on the CPU
  assert (rec['device'], rec['card'], rec['launches']) == ('cpu', None, None)
  events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
  assert any(ev.get('name') == 'aten::add' for ev in events)
  again, out2 = _run('profile_summary_cuda', ['--trace', str(tmp_path),
                                              '--iters', '10'])
  assert _table(out2) == table
  assert (again['top'], again['total_ms']) == (rec['top'], rec['total_ms'])


def test_profile_summary_reads_device_rows(tmp_path, capsys):
  """A trace with kernels, a copy and host events: the device events summed
  by name, ranked by self time, per tick."""
  events = [
      {'ph': 'X', 'cat': 'kernel', 'name': 'crafter_tick_kernel', 'dur': 160},
      {'ph': 'X', 'cat': 'kernel', 'name': 'crafter_tick_kernel', 'dur': 150},
      {'ph': 'X', 'cat': 'kernel', 'name': 'noise2_kernel', 'dur': 14},
      {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy DtoH', 'dur': 40},
      {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::add', 'dur': 900},
      {'ph': 'i', 'cat': 'kernel', 'name': 'marker'},
  ]
  (tmp_path / 'trace.json').write_text(json.dumps({'traceEvents': events}))
  tool = _tool('profile_summary_cuda')
  rows = tool['rows_from_trace'](str(tmp_path))
  assert sorted(rows) == [('Memcpy DtoH', 40.0, 1),
                          ('crafter_tick_kernel', 310.0, 2),
                          ('noise2_kernel', 14.0, 1)]
  table, total = tool['summarize'](rows, 2, 2)
  assert [r['name'] for r in table] == ['crafter_tick_kernel', 'Memcpy DtoH']
  assert table[0]['ms'] == pytest.approx(0.155) and table[0]['count'] == 2
  assert total == pytest.approx(0.182)
  out = capsys.readouterr().out.splitlines()
  assert out[1].split() == ['0.1550', '2', 'crafter_tick_kernel']
  assert out[-1].startswith('total device self time: 0.1820 ms/tick')


@pytest.mark.parametrize('stage', ['learn', 'rollout', 'full'])
def test_profile_learn_stages(tmp_path, stage):
  rec, out = _run('profile_learn_cuda', [
      '--device', 'cpu', '--num_envs', '8', '--rollout', '4', '--iters', '1',
      '--stage', stage, '--logdir', str(tmp_path)])
  assert json.loads(out.strip().splitlines()[-1]) == rec
  assert (rec['stage'], rec['iters']) == (stage, 1)
  table = _table(out)
  assert table[0].split() == ['ms/iter', 'x', 'op']
  assert table[-1].startswith('total device self time: ')
  assert (tmp_path / 'trace.json').is_file()


@pytest.mark.parametrize('name', ['bench_ppo_cuda', 'ppo_budget_cuda',
                                  'profile_summary_cuda',
                                  'profile_learn_cuda'])
def test_default_run_without_a_card_stops(name):
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default run would use it')
  with pytest.raises(SystemExit, match='no CUDA device'):
    _tool(name)['main']([])
