"""The port's evaluation tools on the CPU against the JAX package's.

* ``tools/random_baseline_cuda.py --device cpu --envs 32 --steps 4096``
  (3 chunks of 64 ticks, 20-odd finished episodes) and
  ``tools/random_baseline.py`` with the same arguments, run in this
  process: the same ``stats.jsonl`` line for line, the same printed score
  line, the same score JSON, the same env step count.
* ``tools/score_run_cuda.py`` and ``tools/score_run.py`` on that logdir:
  the same printed lines and the same score JSON.
* ``--seeds 2`` at a tiny size: the JAX tool's JSON keys, a score a seed.
* ``examples/run_random_torch.py`` and ``examples/run_random.py`` at 8
  envs over 48 ticks, episodes capped at 40 ticks: the same
  ``stats.jsonl``.
* Without a card the default runs stop with an error.

Tolerance: none (the port draws ``jax.random``'s bits, and its plain
paths equal the JAX package's leaf for leaf).
"""

import contextlib
import io
import json
import pathlib
import re
import runpy
import sys

import pytest
import torch

import crafter_tpu.utils
from one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARGS = ['--envs', '32', '--steps', '4096', '--seed', '0']


def _load(path):
  return runpy.run_path(str(ROOT / path), run_name=pathlib.Path(path).stem)


def _captured(fn, *args):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    ret = fn(*args)
  return ret, out.getvalue()


@pytest.fixture(scope='module')
def baselines(tmp_path_factory):
  """Both random baselines (JAX first) and both score tools in one working
  directory: ``(dir, {tool: (return value, stdout, score JSON)})``."""
  tmp = tmp_path_factory.mktemp('baselines')
  runs = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.chdir(tmp)
    # The JAX tool would point this process's compile cache elsewhere.
    mp.setattr(crafter_tpu.utils, 'enable_compile_cache', lambda *a: None)
    score = tmp / 'scores' / 'crafter_noreward-random.json'
    mp.setattr(sys, 'argv', ['random_baseline.py'] + ARGS
               + ['--outdir', str(tmp / 'jax')])
    runs['jax'] = _captured(_load('tools/random_baseline.py')['main']) \
        + (score.read_text(),)
    runs['port'] = _captured(
        _load('tools/random_baseline_cuda.py')['main'],
        ARGS + ['--outdir', str(tmp / 'port'), '--device', 'cpu']) \
        + (score.read_text(),)
    logdir = ['crafter_noreward', 'random', '4096']
    mp.setattr(sys, 'argv', ['score_run.py', str(tmp / 'jax')] + logdir)
    runs['jax_score'] = _captured(_load('tools/score_run.py')['main']) \
        + (score.read_text(),)
    score.unlink()
    runs['port_score'] = _captured(
        _load('tools/score_run_cuda.py')['main'],
        [str(tmp / 'port')] + logdir) + (score.read_text(),)
  return tmp, runs


def test_random_baseline_writes_the_jax_tools_stats(baselines):
  tmp, _ = baselines
  jax_lines = (tmp / 'jax' / 'stats.jsonl').read_text().splitlines()
  port_lines = (tmp / 'port' / 'stats.jsonl').read_text().splitlines()
  assert len(jax_lines) >= 20
  assert port_lines == jax_lines


def test_random_baseline_prints_the_jax_tools_score(baselines):
  _, runs = baselines
  rec, ours, our_json = runs['port']
  _, theirs, their_json = runs['jax']
  line = re.compile(r'^random: crafter score .*$', re.M)
  assert line.findall(ours) == line.findall(theirs) != []
  steps = re.compile(r'^(\d+) env steps in ', re.M)
  assert steps.findall(ours) == steps.findall(theirs) == ['6144']
  assert our_json == their_json
  assert json.loads(ours.strip().splitlines()[-1]) == rec
  assert rec['env_steps'] == 6144 and rec['device'] == 'cpu'
  assert rec['card'] is None and rec['launches'] is None
  assert f'{rec["score"]:.2f}' in line.findall(ours)[0]
  assert rec['episodes'] == len(json.loads(our_json)[0]['length'])
  assert len(rec['success_rates']) == 22
  assert rec['success_rates']['wake_up'] > 0


def test_score_run_matches_the_jax_tool(baselines):
  _, runs = baselines
  out, ours, our_json = runs['port_score']
  _, theirs, their_json = runs['jax_score']
  assert str(out) == 'scores/crafter_noreward-random.json'
  assert ours == theirs
  assert our_json == their_json == runs['port'][2]
  assert re.search(r'^random: crafter score ', ours, re.M)
  assert re.search(r'^Wake Up +[\d.]+%$', ours, re.M)


def test_score_run_without_runs(tmp_path, capsys):
  tool = _load('tools/score_run_cuda.py')
  assert tool['main']([str(tmp_path)]) is None
  assert capsys.readouterr().out.startswith('No complete runs found in')


def test_random_baseline_seeds(tmp_path, monkeypatch):
  """``--seeds 2``: one subprocess a seed into logdir/random_ci/<seed>,
  then the JAX tool's record."""
  monkeypatch.chdir(tmp_path)
  monkeypatch.setenv('OMP_NUM_THREADS', '1')
  rec, out = _captured(_load('tools/random_baseline_cuda.py')['main'],
                       ['--seeds', '2', '--envs', '8', '--steps', '1024',
                        '--device', 'cpu'])
  assert json.loads(out.strip().splitlines()[-1]) == rec
  assert set(rec) >= {'metric', 'seeds', 'mean', 'std', 'values',
                      'golden_recompute'}
  assert rec['metric'] == 'random_crafter_score' and rec['seeds'] == 2
  assert rec['golden_recompute'] == 1.55 and rec['card'] is None
  assert len(rec['values']) == 2 and rec['mean'] > 0
  for seed in (0, 1):
    assert (tmp_path / 'logdir' / 'random_ci' / str(seed)
            / 'stats.jsonl').read_text()
    assert re.search(rf'^seed {seed}: [\d.]+$', out, re.M)


def test_run_random_example_matches_the_jax_example(tmp_path, capsys,
                                                   monkeypatch):
  """Both examples with their ``VecEnv`` capped at 40 ticks an episode (so
  that every env finishes inside the run), 8 envs over 48 ticks."""
  import crafter_tpu.config
  import crafter_tpu.env
  import crafter_tpu_torch.env
  from crafter_tpu_torch.config import EnvConfig
  short = dict(length=40)

  class JaxShort(crafter_tpu.env.VecEnv):
    def __init__(self, num_envs, seed=0):
      super().__init__(num_envs, crafter_tpu.config.EnvConfig(**short),
                       seed=seed)

  class PortShort(crafter_tpu_torch.env.VecEnv):
    def __init__(self, num_envs, seed=0, device='cuda'):
      super().__init__(num_envs, EnvConfig(**short), seed=seed, device=device)

  monkeypatch.setattr(crafter_tpu.env, 'VecEnv', JaxShort)
  monkeypatch.setattr(crafter_tpu_torch.env, 'VecEnv', PortShort)
  steps, envs = 48 * 8, 8
  _load('examples/run_random.py')['main'](steps, envs, str(tmp_path / 'jax'))
  _load('examples/run_random_torch.py')['main'](
      steps, envs, str(tmp_path / 'port'), device='cpu')
  theirs = (tmp_path / 'jax' / 'stats.jsonl').read_text()
  ours = (tmp_path / 'port' / 'stats.jsonl').read_text()
  assert ours == theirs and len(theirs.splitlines()) >= envs
  out = capsys.readouterr().out.splitlines()
  assert out[-1] == f'Recorded {steps} steps to {tmp_path / "port"}'
  assert out[-2] == f'Recorded {steps} steps to {tmp_path / "jax"}'


@pytest.mark.parametrize('path, call', [
    ('tools/random_baseline_cuda.py', lambda m: m['main']([])),
    ('tools/random_baseline_cuda.py',
     lambda m: m['main'](['--seeds', '2'])),
    ('examples/run_random_torch.py', lambda m: m['main']()),
    ('examples/run_ppo_torch.py', lambda m: m['main']()),
])
def test_default_run_without_a_card_stops(path, call):
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default run would use it')
  with pytest.raises(SystemExit, match='no CUDA device'):
    call(_load(path))
