"""The port stands alone: ``crafter_tpu_torch``, ``chip_smoke.py``, the
port's bench ``bench_cuda.py``, the GPU tools ``tools/bench_roll_cuda.py``,
``tools/bench_paths_cuda.py`` and ``tools/bench_render_cuda.py``, the
multi-process tools ``tools/demo_64k_cuda.py`` and
``tools/dist_worker_cuda.py``, the evaluation and training-measurement
tools (``tools/random_baseline_cuda.py``, ``score_run_cuda.py``,
``bench_ppo_cuda.py``, ``ppo_budget_cuda.py``, ``profile_summary_cuda.py``,
``profile_learn_cuda.py``), the measuring tools
``tools/bench_obs_shuffle_cuda.py``, ``bench_unpack_cuda.py`` and
``sweep_group_block_cuda.py``, the examples ``examples/run_random_torch.py``
and ``examples/run_ppo_torch.py``, ``tests/sharding_ranks.py`` (the port's gloo
ranks of the sharding tests) and ``tests/dense_states.py`` and
``tests/parity_digest.py`` (which ``chip_smoke.py`` imports) import
neither JAX (nor flax, optax, orbax or chex) nor the JAX package nor an
image library (PIL, imageio: the card's
machine has none), checked both in a fresh interpreter (``sys.modules``
after importing every module) and by an AST scan of every import statement
in their sources.  pygame and matplotlib, which only ``run_gui`` and
``plots`` use, are imported inside their functions: importing every module
loads neither.

Inside the port the imports point one way: the import graph (module-level
and function-level imports alike) has no cycle, the data modules and the
step and render twins reach no ``*_cuda`` wrapper and no ``_build``, and
only ``config.py`` reads ``.engine``, whose one value is ``'auto'``."""

import ast
import functools
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / 'crafter_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'chex', 'crafter_tpu',
             'PIL', 'imageio')


SCRIPTS = [ROOT / 'chip_smoke.py', ROOT / 'bench_cuda.py',
           ROOT / 'tools' / 'bench_roll_cuda.py',
           ROOT / 'tools' / 'bench_paths_cuda.py',
           ROOT / 'tools' / 'bench_render_cuda.py',
           ROOT / 'tools' / 'demo_64k_cuda.py',
           ROOT / 'tools' / 'dist_worker_cuda.py',
           ROOT / 'tools' / 'random_baseline_cuda.py',
           ROOT / 'tools' / 'score_run_cuda.py',
           ROOT / 'tools' / 'bench_ppo_cuda.py',
           ROOT / 'tools' / 'ppo_budget_cuda.py',
           ROOT / 'tools' / 'profile_summary_cuda.py',
           ROOT / 'tools' / 'profile_learn_cuda.py',
           ROOT / 'tools' / 'bench_obs_shuffle_cuda.py',
           ROOT / 'tools' / 'bench_unpack_cuda.py',
           ROOT / 'tools' / 'sweep_group_block_cuda.py',
           ROOT / 'tools' / 'bench_threefry_cuda.py',
           ROOT / 'examples' / 'run_random_torch.py',
           ROOT / 'examples' / 'run_ppo_torch.py',
           ROOT / 'tests' / 'sharding_ranks.py',
           ROOT / 'tests' / 'dense_states.py',
           ROOT / 'tests' / 'parity_digest.py']
LAZY = ('pygame', 'matplotlib')


def _sources():
  return sorted(PORT.rglob('*.py')) + SCRIPTS


def _forbidden(module: str) -> bool:
  top = module.split('.')[0]
  return top in FORBIDDEN


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statements(path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
      names = [node.module or ''] if node.level == 0 else []
    else:
      continue
    bad = [n for n in names if _forbidden(n)]
    assert not bad, f'{path.name}:{node.lineno} imports {bad}'


@functools.lru_cache(maxsize=None)
def _loaded_modules():
  """``sys.modules`` of a fresh interpreter that imported every module of
  the port and ran every script's module level."""
  modules = sorted(
      'crafter_tpu_torch.' + str(p.relative_to(PORT).with_suffix(''))
      .replace('/', '.').replace('.__init__', '')
      for p in PORT.rglob('*.py'))
  code = (
      'import importlib, json, runpy, sys\n'
      f'for m in {modules!r}:\n'
      '  importlib.import_module(m.rstrip("."))\n'
      f'for script in {[str(p) for p in SCRIPTS]!r}:\n'
      '  runpy.run_path(script, run_name="imported")\n'
      'print(json.dumps(sorted(sys.modules)))\n')
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr
  return tuple(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_forbidden_modules_loaded():
  loaded = _loaded_modules()
  bad = [m for m in loaded if _forbidden(m)]
  assert not bad, bad
  for name in ('step_cuda', 'render_cuda', 'ops.noise_cuda', 'ops.roll_cuda',
               'ppo', 'models.cnn', 'checkpoint', 'run_train', 'parity',
               'ops.noise_host', 'run_random', 'run_terrain', 'run_gui',
               'plots', 'parallel', 'parallel.mesh'):
    assert f'crafter_tpu_torch.{name}' in loaded, name


def test_gui_and_plot_libraries_not_loaded():
  loaded = _loaded_modules()
  assert 'crafter_tpu_torch.run_gui' in loaded
  assert 'crafter_tpu_torch.plots' in loaded
  bad = [m for m in loaded if m.split('.')[0] in LAZY]
  assert not bad, bad


# -- the layering: the wrappers alone pick a kernel or its twin ------------
def _module_name(path: pathlib.Path) -> str:
  parts = ('crafter_tpu_torch',) + path.relative_to(PORT).with_suffix('').parts
  return '.'.join(parts[:-1] if parts[-1] == '__init__' else parts)


def _port_modules() -> dict:
  return {_module_name(p): p for p in sorted(PORT.rglob('*.py'))}


@functools.lru_cache(maxsize=None)
def _import_graph() -> dict:
  """Module -> the port's modules it imports, at module level or inside a
  function.  ``from . import x`` (and ``from .pkg import x``) is an edge to
  the submodule ``x`` where one exists, else to the package."""
  modules = _port_modules()
  graph = {}
  for name, path in modules.items():
    package = name if path.name == '__init__.py' else name.rpartition('.')[0]
    edges = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
      if isinstance(node, ast.Import):
        edges |= {a.name for a in node.names if a.name in modules}
      elif isinstance(node, ast.ImportFrom):
        base = node.module or ''
        if node.level:
          parts = package.split('.')[:package.count('.') + 2 - node.level]
          base = '.'.join(parts + ([node.module] if node.module else []))
        if base not in modules:
          continue
        for alias in node.names:
          sub = f'{base}.{alias.name}'
          edges.add(sub if sub in modules else base)
    graph[name] = edges - {name}
  return graph


def _reach(graph: dict, start: str) -> set:
  seen, todo = set(), [start]
  while todo:
    for nxt in graph[todo.pop()] - seen:
      seen.add(nxt)
      todo.append(nxt)
  return seen


def test_import_graph_resolves_relative_imports():
  graph = _import_graph()
  assert 'crafter_tpu_torch.step_cuda' in graph['crafter_tpu_torch.env']
  assert 'crafter_tpu_torch.utils.profiling' in graph['crafter_tpu_torch.env']
  assert 'crafter_tpu_torch._build' in graph['crafter_tpu_torch.ops.noise_cuda']
  assert 'crafter_tpu_torch.models' in graph['crafter_tpu_torch.ppo']


def test_port_imports_have_no_cycle():
  graph = _import_graph()
  cycles = sorted(m for m in graph if m in _reach(graph, m))
  assert not cycles, f'modules on an import cycle: {cycles}'


@pytest.mark.parametrize('module', ['rules', 'config', 'state', 'ops.fma',
                                    'step', 'render'])
def test_data_and_twins_reach_no_kernel_wrapper(module):
  """The data modules and the step and render twins reach neither the
  build nor a ``*_cuda`` wrapper, directly or through another module."""
  reached = _reach(_import_graph(), f'crafter_tpu_torch.{module}')
  bad = sorted(m for m in reached
               if m.endswith('_cuda') or m.endswith('._build'))
  assert not bad, f'{module} imports {bad}'


def test_only_config_reads_engine():
  """Only ``config.py`` reads an ``.engine`` attribute: the kernel or the
  twin is the wrappers' choice, by device."""
  readers = []
  for name, path in _port_modules().items():
    if name == 'crafter_tpu_torch.config':
      continue
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
      if isinstance(node, ast.Attribute) and node.attr == 'engine':
        readers.append(f'{path.relative_to(ROOT)}:{node.lineno}')
  assert not readers, readers


@pytest.mark.parametrize('engine', ['plain', 'pallas'])
def test_engine_other_than_auto_raises(engine):
  from crafter_tpu_torch.config import ENGINES, EnvConfig
  assert ENGINES == ('auto',)
  with pytest.raises(ValueError):
    EnvConfig(engine=engine)
