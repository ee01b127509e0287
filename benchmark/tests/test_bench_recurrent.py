"""The recurrent cell's own pieces: the IMPALA ResNet-LSTM's FLOP count,
the recurrent-core readers on a tiny run and over a program path without
the core's spans, the bfloat16-LSTM control, and a reference that imports
nothing of the program."""

import json
import shutil

import pytest

from benchmark import flops_impala, harness, run
from test_bench_imports import _modules

CELL = 'train_ppo_impala_lstm'
CORE = {'lstm_scan_ms', 'lstm_idle_share', 'lstm_step_us'}


def test_impala_forward_flops():
  layers = dict(flops_impala.layer_flops())
  assert layers['stack0.conv'] == 64 * 64 * 16 * 27 * 2
  assert layers['stack0.res'] == 4 * 32 * 32 * 16 * 144 * 2
  assert layers['stack1.conv'] == 32 * 32 * 32 * 144 * 2
  assert layers['stack2.res'] == 4 * 8 * 8 * 32 * 288 * 2
  assert layers['fc'] == 2048 * 256 * 2
  assert layers['lstm'] == (256 + 17 + 1 + 256) * 1024 * 2
  assert layers['heads'] == 256 * 18 * 2
  assert sum(v for k, v in layers.items() if 'stack' in k) == 60_162_048
  assert flops_impala.forward_flops() == 62_305_280
  assert flops_impala.train_flops() == 3 * 62_305_280 - 3_538_944
  update = flops_impala.ppo_update_flops(4096, 64, 3)
  assert update == (65 * 4096 * 62_305_280
                    + 3 * 4096 * 64 * flops_impala.train_flops())
  assert 160e12 < update < 161e12


def test_tiny_cell_reads_the_core(tiny_root):
  rec = run.run_cell(CELL, 2 ** 31 + 9, 2.0, True, device='cpu',
                     root=tiny_root)
  values = {k: v['value'] for k, v in rec['metrics'].items()}
  assert {'lstm_scan_ms', 'lstm_step_us', 'train_mfu', 'learn_ms'} <= set(
      values)
  # Every scan of the tiny cell steps its 4 ticks, so a step is a quarter
  # of a scan's mean (on the host's clock here).
  ticks = harness.load_cell(CELL, tiny_root).config['assumed']['rollout_len']
  assert values['lstm_step_us'] == pytest.approx(
      1e3 * values['lstm_scan_ms'] / ticks)
  # No device operations on the CPU: the idle share has nothing to read.
  assert 'lstm_idle_share' not in values


def test_a_path_without_the_core_reads_nothing(tiny_root, tmp_path):
  """The core's readers over NatureCNN's training (as over a program that
  has no recurrent core) return nothing, and the run goes on."""
  root = tmp_path / 'root'
  shutil.copytree(tiny_root, root)
  bench = json.loads((root / 'BENCHMARK.json').read_text())
  for metric in bench['per_layer']:
    if metric['name'] in CORE:
      metric['workloads'].append('train_ppo')
  (root / 'BENCHMARK.json').write_text(json.dumps(bench))
  rec = run.run_cell('train_ppo', 2 ** 31 + 6, 1.0, True, device='cpu',
                     root=root)
  assert not CORE & set(rec['metrics'])
  assert 'learn_ms' in rec['metrics']


def test_the_bfloat16_lstm_control_is_not_correct(tiny_root):
  """The reference's LSTM and heads in bfloat16 in the program's place:
  the core's own number fails, whatever the others read."""
  rec = run.run_cell(CELL, 4321, 1.0, False, device='cpu', root=tiny_root,
                     variant='control_lstm')
  assert not rec['correct']
  core = rec['checks']['core_gap']
  assert core['value'] > core['limit']


def test_the_reference_imports_nothing_of_the_program():
  tops = _modules(
      f'import sys; sys.path.insert(0, {str(harness.ROOT)!r})\n'
      'from benchmark.reference import impala_lstm, ppo_recurrent\n'
      'from benchmark import flops_impala\n')
  assert 'torch' in tops
  assert not tops & ({'crafter_tpu_torch'} | set(harness.FORBIDDEN))


def test_the_bfloat16_scan_control_is_not_correct(tiny_root):
  """Learn's scan alone in bfloat16, the rollout's core in float32: the
  scan's number fails where the rollout's reads nothing."""
  rec = run.run_cell(CELL, 4322, 1.0, False, device='cpu', root=tiny_root,
                     variant='control_scan')
  assert not rec['correct']
  scan, core = rec['checks']['scan_gap'], rec['checks']['core_gap']
  assert scan['value'] > scan['limit']
  assert core['value'] <= core['limit']


def test_a_half_batch_scan_reads_inf(tiny_root):
  """A loss over half of each minibatch's envs leaves half of its
  sequences out of the scan, whatever the seed."""
  from benchmark import calibrate
  with calibrate.fault('ppo_recurrent', 'half_batch', tiny_root):
    rec = run.run_cell(CELL, 4323, 1.0, False, device='cpu', root=tiny_root)
  assert rec['checks']['scan_gap']['value'] == float('inf')
