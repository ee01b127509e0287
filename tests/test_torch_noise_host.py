"""The port's host noise (``ops/noise_host.py``, numpy float64) against the
JAX package's and the committed goldens.

Tolerance: none.  ``noise3_host`` and ``noise3_walk_host`` are compared
bitwise with the JAX package's copies on random points and on worldgen's
point grid; the walk also with ``tests/golden/opensimplex_golden.json``
(values of the PyPI ``opensimplex`` package), as ``tests/test_noise.py``
holds the JAX package's walk.
"""

import json
import pathlib

import numpy as np
import pytest

from crafter_tpu.ops import noise as jnoise
from crafter_tpu.ops import noise_host as jhost
from crafter_tpu_torch.ops import noise, noise_host
from one_thread import one_torch_thread  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / 'golden' / 'opensimplex_golden.json'


def _golden_records():
  data = json.loads(GOLDEN.read_text())
  return [(int(s), float.fromhex(x), float.fromhex(y), float.fromhex(z),
           float.fromhex(v)) for s, x, y, z, v in data['records']]


def _bits(a):
  return np.asarray(a, np.float64).view(np.int64)


def test_walk_matches_goldens_bitwise():
  by_seed = {}
  for seed, x, y, z, want in _golden_records():
    by_seed.setdefault(seed, []).append((x, y, z, want))
  assert len(by_seed) >= 2
  for seed, rows in by_seed.items():
    pts = np.array([[x, y, z] for x, y, z, _ in rows])
    want = np.array([w for *_, w in rows])
    got = noise_host.noise3_walk_host(pts, noise.perm_from_java_seed(seed))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize('fn', ['noise3_host', 'noise3_walk_host'])
@pytest.mark.parametrize('seed', [0, 42, 2 ** 31 - 2])
def test_host_noise_matches_jax_package(fn, seed):
  rng = np.random.default_rng(seed % 1000)
  pts = rng.uniform(-70, 70, (20000, 3))
  perm = noise.perm_from_java_seed(seed)
  np.testing.assert_array_equal(perm, jnoise.perm_from_java_seed(seed))
  np.testing.assert_array_equal(_bits(getattr(noise_host, fn)(pts, perm)),
                                _bits(getattr(jhost, fn)(pts, perm)))


def test_walk_on_worldgen_grid_matches_jax_package():
  """The parity engine's points: (x / size, y / size, z) on a 64 x 64 grid
  in float64, where many stretched coordinates sit on lattice planes."""
  xs, ys = np.meshgrid(np.arange(64.0), np.arange(64.0), indexing='ij')
  perm = noise.perm_from_java_seed(1234)
  for size, z in ((3, 8), (15, 3), (5, 0), (7, 6)):
    pts = np.stack([xs / size, ys / size, np.full_like(xs, float(z))], -1)
    np.testing.assert_array_equal(
        _bits(noise_host.noise3_walk_host(pts, perm)),
        _bits(jhost.noise3_walk_host(pts, perm)))


def test_candidate_sum_and_walk_differ_as_documented():
  rng = np.random.default_rng(5)
  pts = rng.uniform(-70, 70, (20000, 3))
  perm = noise.perm_from_java_seed(42)
  d = np.abs(noise_host.noise3_host(pts, perm)
             - noise_host.noise3_walk_host(pts, perm))
  assert d.max() < 2e-4
  assert 0.0 < float(np.mean(d > 1e-12)) < 0.10


def test_no_reexport_of_the_table():
  assert not hasattr(noise_host, 'perm_from_java_seed')
