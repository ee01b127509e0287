"""Each driver, under each configuration it runs, runs a tiny cell on the
CPU's plain twins and gives the contract's record (one cell of each driver
and configuration that ``BENCHMARK.json`` names); without a card the
benchmark stops and prints none."""

import json
import subprocess
import sys

import pytest

from benchmark import harness, run
import tiny

KEYS = {'correct', 'attempted', 'failed', 'metrics', 'device'}
CELLS = sorted(tiny.cells_by_driver())


@pytest.mark.parametrize('name', CELLS)
@pytest.mark.parametrize('trace', [False, True])
def test_tiny_cell(tiny_root, name, trace):
  rec = run.run_cell(name, 2 ** 31 + 77, 2.0, trace, device='cpu',
                     root=tiny_root)
  assert KEYS <= set(rec)
  assert 'checks' in rec
  assert rec['attempted'] > 0 and rec['device']['count'] == 1
  cell = harness.load_cell(name, tiny_root)
  wanted = cell.per_layer if trace else cell.end_to_end
  for name_ in rec['metrics']:
    assert name_ in {m['name'] for m in wanted}
  if trace:
    assert {'busy_s', 'window_s'} <= set(rec['device'])
    assert set(rec['breakdown']) == {'device_ops', 'idle_gaps'}
  else:
    assert 'setup_s' in rec['metrics']
  if all(c['limit'] == 0 for c in rec['checks'].values()):
    assert rec['correct'], rec['checks']   # exact ones hold at any size
  json.dumps(rec)


def test_no_card_no_result():
  """A measuring run on a machine without a card exits non-zero and
  prints no result line."""
  proc = subprocess.run(
      [sys.executable, str(harness.BENCH_DIR / 'run.py'), '--workload',
       'group_state', '--seed', '1', '--seconds', '1', '--trace', '0'],
      capture_output=True, text=True, timeout=300,
      env={'CUDA_VISIBLE_DEVICES': '', 'PATH': '/usr/bin:/bin'})
  assert proc.returncode != 0
  assert proc.stdout.strip() == ''
  assert 'CUDA' in proc.stderr


@pytest.mark.cuda
def test_measures_on_the_card(card):
  proc = subprocess.run(
      [sys.executable, str(harness.BENCH_DIR / 'run.py'), '--workload',
       'group_state', '--seed', '3', '--seconds', '3', '--trace', '0'],
      capture_output=True, text=True, timeout=1200)
  assert proc.returncode == 0, proc.stderr[-2000:]
  rec = json.loads(proc.stdout.strip().splitlines()[-1])
  assert rec['correct'] and rec['device']['platform'] == 'gpu'
