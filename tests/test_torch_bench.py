"""The port's bench, ``bench_cuda.py``, on the CPU: ``--device cpu`` at 8
envs and 20 ticks prints one JSON line with ``bench.py:orchestrate``'s
keys, the medians and the device; the actions it draws are
``bench.py``'s (``jax.random``'s bits, tolerance none); and without a
card its default run stops with a message instead of falling back.
"""

import json
import pathlib
import runpy

import jax
import numpy as np
import pytest
import torch

from crafter_tpu_torch import prng
from one_thread import one_torch_thread  # noqa: F401

BENCH = pathlib.Path(__file__).resolve().parent.parent / 'bench_cuda.py'


@pytest.fixture(scope='module')
def bench():
  return runpy.run_path(str(BENCH), run_name='bench_cuda')


def test_bench_on_cpu_prints_the_keys(bench, capsys):
  rec = bench['main'](['--device', 'cpu', '--envs', '8', '--ticks', '20',
                       '--pixel-ticks', '20'])
  line = capsys.readouterr().out.strip().splitlines()[-1]
  assert json.loads(line) == rec
  # Exactly these keys, in this order: --sizes adds its own only there.
  assert list(rec) == ['metric', 'value', 'unit', 'vs_baseline',
                       'pixel_value', 'pixel_vs_baseline', 'median_value',
                       'pixel_median_value', 'repeats', 'device']
  assert rec['unit'] == 'env-steps/s' and '@ 8 envs' in rec['metric']
  assert rec['device'] == {'platform': 'cpu', 'kind': 'cpu', 'card': None}
  for name, best, median in (('state_only', 'value', 'median_value'),
                             ('pixel', 'pixel_value', 'pixel_median_value')):
    rates = rec['repeats'][name]
    assert len(rates) == 3 and min(rates) > 0
    assert rec[best] == round(max(rates)) >= rec[median] > 0
  assert rec['vs_baseline'] == round(rec['value'] / 1e6, 4)


def test_bench_draws_the_actions_of_bench_py():
  """``key, k_act = split(key); randint(k_act, (K, N), 0, 17)`` for three
  groups, in both libraries."""
  jkey, tkey = jax.random.key(4), prng.key(4, 'cpu')
  for _ in range(3):
    jkey, jact = jax.random.split(jkey)
    tkey, tact = prng.split(tkey, 2)
    want = np.asarray(jax.random.randint(jact, (10, 37), 0, 17))
    got = prng.randint(tact, 0, 17, (10, 37))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(tkey.numpy(),
                                np.asarray(jax.random.key_data(jkey)))


def test_bench_without_a_card_stops(bench):
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default run would time it')
  with pytest.raises(SystemExit, match='no CUDA device'):
    bench['main']([])
