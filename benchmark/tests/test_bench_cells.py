"""Every cell names files that exist; a new cell is data only."""

import json
import shutil

import pytest

from benchmark import harness, run
import tiny

BENCH = json.loads((harness.ROOT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCH['workloads']]


@pytest.mark.parametrize('name', CELLS)
def test_cell_files(name):
  cell = harness.load_cell(name)
  entry = next(w for w in BENCH['workloads'] if w['name'] == name)
  assert cell.config['name'] == entry['config']
  assert (harness.BENCH_DIR / 'drivers'
          / f'{cell.traffic["driver"]}.py').exists()
  driver = harness.load_module('drivers', cell.traffic['driver'])
  assert hasattr(driver, 'Driver')
  for metric in cell.end_to_end + cell.per_layer:
    assert hasattr(harness.load_module('metrics', metric['name']), 'read')
  names = {m['name'] for m in cell.end_to_end}
  assert 'setup_s' in names and len(names) >= 2
  assert cell.per_layer


def test_every_config_is_used_and_moves_are_reported():
  used = {w['config'] for w in BENCH['workloads']}
  assert used == {c['name'] for c in BENCH['configs']}
  for m in BENCH['per_layer']:
    target = next(e for e in BENCH['end_to_end'] if e['name'] == m['moves'])
    for cell in m['workloads']:
      assert cell in target.get('workloads', CELLS)


def test_a_new_cell_is_files_and_entries_only(tmp_path):
  """A throwaway traffic file and an entry in BENCHMARK.json make a cell
  that runs, with no edit to any file the benchmark has."""
  root = tiny.make_root(tmp_path)
  traffic = json.loads(
      (root / 'benchmark/workloads/group_state.json').read_text())
  traffic['actions'] = {'n': 17, 'weights': [1] * 16 + [8]}
  (root / 'benchmark/workloads/group_noop_heavy.json').write_text(
      json.dumps(traffic))
  shutil.copy(root / 'benchmark/metrics/launches_per_tick.py',
              root / 'benchmark/metrics/launches_per_group.py')
  bench = json.loads((root / 'BENCHMARK.json').read_text())
  bench['workloads'].append({
      'name': 'group_noop_heavy', 'config': 'crafter-reward-v1',
      'traffic': 'group_noop_heavy', 'chips': 1, 'why': 'test'})
  for m in bench['end_to_end']:
    if 'group_state' in m.get('workloads', []):
      m['workloads'].append('group_noop_heavy')
  bench['per_layer'].append({
      'name': 'launches_per_group', 'unit': 'ops/tick', 'better': 'lower',
      'source': 'device_trace', 'layer': 'env entry points',
      'moves': 'env_steps_per_s', 'workloads': ['group_noop_heavy']})
  (root / 'BENCHMARK.json').write_text(json.dumps(bench))
  rec = run.run_cell('group_noop_heavy', 5, 2.0, False, device='cpu',
                     root=root)
  assert rec['correct'], rec['checks']
  assert set(rec['metrics']) == {'env_steps_per_s', 'setup_s'}
  rec = run.run_cell('group_noop_heavy', 5, 1.0, True, device='cpu',
                     root=root)
  assert rec['correct'], rec['checks']
