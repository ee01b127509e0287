"""The port's ``plots`` against the JAX package's, on the repository's score
files (``scores/``).

Each ``print_*`` must give the JAX module's text character for character
(tolerance: none; the same numpy code on the same inputs), each ``plot_*``
must write its file, the CLI must print what the JAX CLI prints, and
importing the module must not import matplotlib.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from crafter_tpu import plots as jplots
from crafter_tpu_torch import plots
from one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
# A fresh interpreter with this checkout first, one PyTorch thread and
# matplotlib's file backend.
ENV = {**os.environ, 'PYTHONPATH': str(ROOT), 'MPLBACKEND': 'Agg',
       'JAX_PLATFORMS': 'cpu', 'OMP_NUM_THREADS': '1'}
SCORES = [ROOT / 'scores' / 'crafter_noreward-random.json',
          ROOT / 'scores' / 'crafter_reward-ppo.json']


@pytest.fixture(scope='module')
def agg():
  import matplotlib
  matplotlib.use('Agg')


@pytest.mark.parametrize('name', ['print_scores', 'print_spectrum',
                                  'print_reward'])
@pytest.mark.parametrize('budget', [1e6, 5e5])
def test_print_tables_equal_jax(name, budget, capsys):
  ours = getattr(plots, name)(SCORES, budget=budget)
  theirs = getattr(jplots, name)(SCORES, budget=budget)
  assert ours == theirs and ours.strip()
  out = capsys.readouterr().out
  assert out == ours + '\n' + theirs + '\n'


def test_print_spectrum_sorted_and_legend_equal_jax():
  legend = {'ppo': 'PPO', 'random': 'Random'}
  assert (plots.print_spectrum(SCORES, legend=legend, sort=True)
          == jplots.print_spectrum(SCORES, legend=legend, sort=True))
  assert (plots.print_scores(SCORES, legend=legend)
          == jplots.print_scores(SCORES, legend=legend))


@pytest.mark.parametrize('name', ['plot_scores', 'plot_spectrum',
                                  'plot_reward', 'plot_counts'])
def test_plot_writes_its_file(name, tmp_path, agg):
  import matplotlib.pyplot as plt
  out = tmp_path / 'sub' / f'{name}.png'
  assert getattr(plots, name)(SCORES, out) == out
  assert out.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
  plt.close('all')


def test_cli_tables_equal_jax_cli(tmp_path):
  def run(module):
    return subprocess.run(
        [sys.executable, '-m', module, 'tables', '--inpaths',
         *map(str, SCORES)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=ENV)
  ours, theirs = run('crafter_tpu_torch.plots'), run('crafter_tpu.plots')
  assert ours.returncode == 0, ours.stderr
  assert theirs.returncode == 0, theirs.stderr
  assert ours.stdout == theirs.stdout and ours.stdout.strip()


def test_cli_plot_saves(tmp_path):
  out = tmp_path / 'scores.png'
  proc = subprocess.run(
      [sys.executable, '-m', 'crafter_tpu_torch.plots', 'scores',
       '--inpaths', str(SCORES[1]), '--outpath', str(out)], cwd=ROOT,
      capture_output=True, text=True, timeout=300, env=ENV)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip() == f'Saved {out}'
  assert out.stat().st_size > 0


def test_import_does_not_load_matplotlib():
  code = ('import json, sys, crafter_tpu_torch.plots\n'
          'print(json.dumps(sorted(m for m in sys.modules '
          'if m.startswith("matplotlib"))))')
  proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                        capture_output=True, text=True, timeout=120, env=ENV)
  assert proc.returncode == 0, proc.stderr
  assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
