"""Every cell names files that exist; a new cell is data only."""

import json
import shutil

import pytest

from benchmark import calibrate, harness, run
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


def _copy_of_the_benchmark(dest):
  dest.mkdir()
  shutil.copy(harness.ROOT / 'BENCHMARK.json', dest / 'BENCHMARK.json')
  shutil.copytree(harness.BENCH_DIR, dest / 'benchmark',
                  ignore=shutil.ignore_patterns('tests', '__pycache__'))
  return dest


def _add_cell(root, name, traffic, like='group_state'):
  """``traffic`` as ``workloads/<name>.json`` and a cell ``name`` of it in
  BENCHMARK.json, reporting what cell ``like`` reports."""
  (root / f'benchmark/workloads/{name}.json').write_text(json.dumps(traffic))
  bench = json.loads((root / 'BENCHMARK.json').read_text())
  bench['workloads'].append({
      'name': name, 'config': 'crafter-reward-v1', 'traffic': name,
      'chips': 1, 'why': 'test'})
  for m in bench['end_to_end'] + bench['per_layer']:
    if like in m.get('workloads', []):
      m['workloads'].append(name)
  (root / 'BENCHMARK.json').write_text(json.dumps(bench))


def _edited(root):
  """Files under ``root/benchmark`` that the repo's benchmark lacks or
  holds otherwise."""
  edited = []
  for path in (root / 'benchmark').rglob('*'):
    rel = path.relative_to(root / 'benchmark')
    if not path.is_file() or '__pycache__' in rel.parts:
      continue
    mine = harness.BENCH_DIR / rel
    if not mine.is_file() or mine.read_bytes() != path.read_bytes():
      edited.append(str(rel))
  return sorted(edited)


def test_a_new_cell_is_files_and_entries_only(tmp_path):
  """A throwaway traffic file and an entry in BENCHMARK.json make a cell
  that runs, with no edit to any file the benchmark has.  So does a cell
  with a driver of its own: its driver file (here a copy of group_loop's
  under a new name, bringing its ``TINY`` and ``fault``), a traffic file
  naming it and the entries are enough for the tiny sizes, for a correct
  run and for every planted fault to read not correct."""
  src = _copy_of_the_benchmark(tmp_path / 'src')
  shutil.copy(src / 'benchmark/drivers/group_loop.py',
              src / 'benchmark/drivers/group_loop_copy.py')
  traffic = json.loads(
      (src / 'benchmark/workloads/group_state.json').read_text())
  traffic['driver'] = 'group_loop_copy'
  _add_cell(src, 'group_copy', traffic)
  assert _edited(src) == ['drivers/group_loop_copy.py',
                          'workloads/group_copy.json']
  copy = tmp_path / 'tiny_copy'
  copy.mkdir()
  tiny.make_root(copy, src)
  sizes = harness.load_module('drivers', 'group_loop_copy', copy).TINY
  cut = harness.load_cell('group_copy', copy).traffic
  assert cut['num_envs'] == sizes['traffic']['num_envs'] < 4096
  assert cut['check']['init_envs'] == sizes['check']['init_envs']
  rec = run.run_cell('group_copy', 6, 2.0, False, device='cpu', root=copy)
  assert rec['correct'], rec['checks']
  for fault in calibrate.FAULTS:
    with calibrate.fault('group_loop_copy', fault, copy):
      rec = run.run_cell('group_copy', 6, 2.0, False, device='cpu',
                         root=copy)
    assert not rec['correct'], (fault, rec['checks'])

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
    if m['name'] == 'env_steps_per_s':
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


def test_a_driver_without_tiny_stops_make_root(tmp_path):
  """A cell whose driver gives no tiny sizes stops the fixture, naming the
  driver: it never runs at the cell's full size on the CPU."""
  src = _copy_of_the_benchmark(tmp_path / 'src')
  driver = (src / 'benchmark/drivers/group_loop.py').read_text()
  (src / 'benchmark/drivers/group_loop_untiny.py').write_text(
      driver[:driver.index('\nTINY = dict(')])
  traffic = json.loads(
      (src / 'benchmark/workloads/group_state.json').read_text())
  traffic['driver'] = 'group_loop_untiny'
  _add_cell(src, 'group_untiny', traffic)
  dest = tmp_path / 'tiny'
  dest.mkdir()
  with pytest.raises(LookupError, match='group_loop_untiny'):
    tiny.make_root(dest, src)
