"""The control and every fault a cell can have come out not correct: at
a size a CPU holds, through the whole run but the look for a card."""

import pytest

from benchmark import calibrate, harness, run

CELLS = {'group_state': 'group_loop', 'tick_pixel': 'tick_loop',
         'train_ppo': 'ppo_train'}


@pytest.mark.parametrize('name', sorted(CELLS))
@pytest.mark.parametrize('fault', calibrate.FAULTS)
def test_fault_is_not_correct(tiny_root, name, fault):
  with calibrate.fault(CELLS[name], fault):
    rec = run.run_cell(name, 1234, 2.0, False, device='cpu', root=tiny_root)
  assert not rec['correct'], rec['checks']


@pytest.mark.parametrize('name', sorted(CELLS))
def test_control_is_not_correct(tiny_root, name):
  rec = run.run_cell(name, 4321, 2.0, False, device='cpu', root=tiny_root,
                     variant='control')
  assert not rec['correct'], rec['checks']


def test_missing_number_fails():
  assert harness.judge([('a', None, 0)]) == (False, 1)
  assert harness.judge([('a', float('nan'), 1.0)]) == (False, 1)
  assert harness.judge([('a', 0, 0), ('b', 0.5, 1.0)]) == (True, 0)
