"""The metrics that read the program's own spans and counters
(``program_spans.py``): the interval arithmetic of the idle shares, the
readings of the tiny cells, and a run that leaves the program and the
harness as it found them, with or without spans in the program."""

import types

import pytest

from benchmark import harness, program_spans, run
from crafter_tpu_torch.utils import profiling

NEW = {'worldgen_ms', 'reset_host_ms', 'reset_useful_share'}


@pytest.mark.parametrize('idle,ranges,want', [
    ([[0, 10]], [[2, 4], [6, 7]], 3),          # ranges inside a gap
    ([[0, 2], [5, 9]], [[1, 6]], 2),           # a range across a busy stretch
    ([[0, 2], [5, 9]], [[2, 5]], 0),           # a range in the busy stretch
    ([[0, 2]], [[3, 4]], 0),                   # disjoint
    ([[1, 3], [4, 8]], [[0, 10]], 6),          # a range over everything
    ([], [[0, 1]], 0),
], ids=['nested', 'partial', 'busy', 'disjoint', 'covering', 'no-idle'])
def test_overlap(idle, ranges, want):
  assert program_spans.overlap(idle, ranges) == want
  assert program_spans.overlap(ranges, idle) == want


def test_idle_intervals():
  busy = [[1, 2], [4, 6]]
  assert program_spans.idle_intervals(busy, 0, 8) == [[0, 1], [2, 4], [6, 8]]
  assert program_spans.idle_intervals(busy, 1, 6) == [[2, 4]]
  assert program_spans.idle_intervals([], 0, 3) == [[0, 3]]


def _event(name, start, end, device=False, annotation=False):
  import torch
  kind = torch.autograd.DeviceType
  return types.SimpleNamespace(
      name=name, time_range=types.SimpleNamespace(start=start, end=end),
      device_type=kind.CUDA if device else kind.CPU,
      is_user_annotation=annotation)


def test_split_trace_drops_device_annotations():
  """The device's copy of a ``crafter.`` range is no operation: it leaves
  the events ``reduce_trace`` sums and the busy union alike."""
  events = [
      _event('crafter.reset_pass', 0, 10e6, annotation=True),
      _event('crafter.generate_world', 2e6, 6e6, annotation=True),
      _event('crafter.reset_pass', 3e6, 9e6, device=True, annotation=True),
      _event('kernel_a', 1e6, 3e6, device=True),
      _event('kernel_b', 7e6, 8e6, device=True),
      _event('aten::add', 0.5e6, 1e6),
  ]
  kept, reading = program_spans.split_trace(events)
  assert [e.name for e in kept] == [
      'crafter.reset_pass', 'crafter.generate_world', 'kernel_a', 'kernel_b',
      'aten::add']
  assert reading['idle'] == [[0, 1], [3, 7], [8, 10]]
  assert reading['ranges'] == {'reset_pass': [[0, 10]],
                               'generate_world': [[2, 6]]}
  assert program_spans.split_trace(events[:2] + events[-1:])[1] is None


def test_tiny_cells_read_the_program(tiny_root):
  before = harness.reduce_trace
  rec = run.run_cell('group_state_65k', 2 ** 31 + 5, 2.0, True, device='cpu',
                     root=tiny_root)
  assert rec['correct'], rec['checks']
  values = {k: v['value'] for k, v in rec['metrics'].items()}
  assert NEW <= set(values)
  # The CPU makes no world on a pass where no env finished, so the means
  # are over different passes here; on the card every pass makes worlds.
  assert values['worldgen_ms'] > 0 and values['reset_pass_ms'] > 0
  assert values['reset_host_ms'] > 0
  assert values['reset_useful_share'] == 100.0   # the CPU makes no throwaway
  # No device operations on the CPU: the idle shares have nothing to read.
  assert 'reset_idle_share.env' not in values
  rec = run.run_cell('train_ppo', 2 ** 31 + 6, 2.0, True, device='cpu',
                     root=tiny_root)
  assert not {'reset_idle_share.train', 'policy_idle_share'} & set(
      rec['metrics'])
  assert harness.reduce_trace is before
  assert profiling._sink is None


def test_a_program_without_spans_reads_nothing(tiny_root, monkeypatch):
  """Over a program older than its spans the new readers return None and
  the run goes on."""
  monkeypatch.delattr(profiling, 'set_sink')
  rec = run.run_cell('group_state_65k', 17, 1.0, True, device='cpu',
                     root=tiny_root)
  assert rec['correct'], rec['checks']
  assert not NEW & set(rec['metrics'])
  assert 'reset_pass_ms' in rec['metrics']
