"""The control and every fault a cell can have come out not correct: at
a size a CPU holds, through the whole run but the look for a card, in
one cell of each driver and configuration that ``BENCHMARK.json``
names."""

import pytest

from benchmark import calibrate, harness, run
import tiny

CELLS = tiny.cells_by_driver()


@pytest.mark.parametrize('name', sorted(CELLS))
@pytest.mark.parametrize('fault', calibrate.FAULTS)
def test_fault_is_not_correct(tiny_root, name, fault):
  with calibrate.fault(CELLS[name], fault, tiny_root):
    rec = run.run_cell(name, 1234, 2.0, False, device='cpu', root=tiny_root)
  assert not rec['correct'], rec['checks']


@pytest.mark.parametrize('name', sorted(CELLS))
def test_control_is_not_correct(tiny_root, name):
  rec = run.run_cell(name, 4321, 2.0, False, device='cpu', root=tiny_root,
                     variant='control')
  assert not rec['correct'], rec['checks']


def test_a_driver_without_fault_stops_calibrate(tmp_path):
  """A fault that a driver cannot plant stops the run, naming the driver:
  it never runs the program under a fault's name."""
  drivers = tmp_path / 'benchmark' / 'drivers'
  drivers.mkdir(parents=True)
  source = (harness.BENCH_DIR / 'drivers' / 'group_loop.py').read_text()
  cut = source[:source.index('@contextlib.contextmanager\ndef fault(')]
  (drivers / 'group_loop_nofault.py').write_text(cut)
  with pytest.raises(SystemExit, match='group_loop_nofault'):
    calibrate.fault('group_loop_nofault', 'unchanged', tmp_path)
  with pytest.raises(ValueError, match='unknown'):
    calibrate.fault('group_loop', 'unknown')


def test_missing_number_fails():
  assert harness.judge([('a', None, 0)]) == (False, 1)
  assert harness.judge([('a', float('nan'), 1.0)]) == (False, 1)
  assert harness.judge([('a', 0, 0), ('b', 0.5, 1.0)]) == (True, 0)
