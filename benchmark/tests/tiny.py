"""A copy of the benchmark at sizes a CPU test can hold: the same files,
with every traffic mix and every training configuration cut to a few envs
and ticks.  The sizes are each driver's own (``TINY`` in
``benchmark/drivers/<driver>.py``): a cell with a new driver brings its
tiny sizes with it."""

from __future__ import annotations

import json
import pathlib
import shutil

from benchmark import harness

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def make_root(dest: pathlib.Path, src: pathlib.Path = ROOT) -> pathlib.Path:
  """``dest`` holding ``src``'s ``BENCHMARK.json`` and its ``benchmark/``,
  each traffic mix and each configuration of a cell whose driver gives
  ``assumed`` cut to the driver's ``TINY``."""
  shutil.copy(src / 'BENCHMARK.json', dest / 'BENCHMARK.json')
  shutil.copytree(src / 'benchmark', dest / 'benchmark',
                  ignore=shutil.ignore_patterns('tests', '__pycache__'))
  drivers, driver_of = {}, {}
  for path in sorted((dest / 'benchmark' / 'workloads').glob('*.json')):
    traffic = json.loads(path.read_text())
    driver = driver_of[path.stem] = traffic['driver']
    if driver not in drivers:
      module = harness.load_module('drivers', driver, dest)
      if not hasattr(module, 'TINY'):
        raise LookupError(f'benchmark/drivers/{driver}.py has no TINY: the '
                          'CPU tests have no size at which to run its cells')
      drivers[driver] = module.TINY
    sizes = drivers[driver]
    traffic.update(sizes['traffic'])
    traffic['check'].update(sizes['check'])
    path.write_text(json.dumps(traffic))
  bench = json.loads((dest / 'BENCHMARK.json').read_text())
  files = {c['name']: c['file'] for c in bench['configs']}
  cut = set()
  for cell in bench['workloads']:
    assumed = drivers[driver_of[cell['traffic']]].get('assumed')
    if assumed and files[cell['config']] not in cut:
      cut.add(files[cell['config']])
      path = dest / files[cell['config']]
      config = json.loads(path.read_text())
      config.setdefault('assumed', {}).update(assumed)
      path.write_text(json.dumps(config))
  return dest


def cells_by_driver(root: pathlib.Path = ROOT) -> dict:
  """The first cell of ``BENCHMARK.json`` for each driver and
  configuration, as ``{cell: driver}``: a cell for every way the tests can
  run a driver, and a new driver or configuration gets one without an
  edit."""
  firsts = {}
  for entry in harness.load_json(root / 'BENCHMARK.json')['workloads']:
    driver = harness.load_cell(entry['name'], root).traffic['driver']
    firsts.setdefault((driver, entry['config']), (entry['name'], driver))
  return dict(firsts.values())
