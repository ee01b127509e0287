"""Nothing the benchmark imports or runs loads JAX or the JAX package, and
the reference imports nothing of the program."""

import subprocess
import sys

from benchmark import harness

TINY = harness.BENCH_DIR / 'tests'


def _modules(code: str) -> set:
  out = subprocess.run(
      [sys.executable, '-c', code + '\nimport sys\n'
       'print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))'],
      capture_output=True, text=True, timeout=600, cwd=str(harness.ROOT),
      check=True).stdout
  return set(out.split())


def test_a_run_loads_no_jax(tmp_path):
  tops = _modules(
      f'import sys; sys.path[:0] = [{str(harness.ROOT)!r}, {str(TINY)!r}]\n'
      'import pathlib, tiny\n'
      'from benchmark import run, calibrate\n'
      f'root = tiny.make_root(pathlib.Path({str(tmp_path)!r}))\n'
      'for name in ("group_state", "train_ppo"):\n'
      '  run.run_cell(name, 1, 0.5, True, device="cpu", root=root)\n')
  assert 'crafter_tpu_torch' in tops
  assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
  tops = _modules(
      f'import sys; sys.path.insert(0, {str(harness.ROOT)!r})\n'
      'from benchmark.reference import (config, env, fma, noise, policy, '
      'ppo, prng, render, rules, state, step, worldgen)\n'
      'from benchmark import compare\n')
  assert 'torch' in tops
  assert not tops & ({'crafter_tpu_torch'} | set(harness.FORBIDDEN))
