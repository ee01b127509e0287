"""The port's threefry draws against ``jax.random``, bit for bit.

Every function the main path draws through (key, fold_in, split, randint,
uniform, permutation) over many seeds and shapes; tolerance: none (bitwise).
``categorical`` draws from JAX's uniform bits but takes this library's
logarithms for the Gumbel noise, so it must equal JAX's draw on at least
99.9% of 20000 rows and follow the softmax distribution (chi-square).

On CUDA keys the draws launch the threefry kernel (``prng_cuda``).  The
CPU tests check the draw geometry the wrapper passes it and that CPU keys
take the int64 twin; the tests marked ``cuda`` hold the kernel, and so its
counters, to the twin (``prng._counters``) bit for bit on the card, and to
``jax.random`` itself (``python -m pytest -m cuda
tests/test_torch_prng.py``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crafter_tpu_torch import prng, prng_cuda
from one_thread import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 7, 42, 12345, 2 ** 31 - 1]


def _kd(key):
  return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize('seed', SEEDS)
def test_key_fold_in_split(seed):
  kj, kt = jax.random.key(seed), prng.key(seed, 'cpu')
  np.testing.assert_array_equal(_kd(kj), kt.numpy())
  data = np.array([0, 1, 5, 0x5EED, 2 ** 31, 2 ** 32 - 1], np.uint32)
  want = _kd(jax.vmap(lambda d: jax.random.fold_in(kj, d))(data))
  got = prng.fold_in(kt[None].expand(len(data), 2),
                     torch.from_numpy(data.astype(np.int64)))
  np.testing.assert_array_equal(want, got.numpy())
  for num in (2, 3, 5):
    np.testing.assert_array_equal(_kd(jax.random.split(kj, num)),
                                  prng.split(kt, num).numpy())


def test_batched_home_keys():
  n = 300
  want = _kd(jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(
      jnp.arange(n)))
  got = prng.fold_in(prng.key(3, 'cpu')[None].expand(n, 2),
                     torch.arange(n))
  np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize('shape', [(), (7,), (4, 5, 3), (3, 64, 64)])
def test_uniform(shape):
  keys = jax.random.split(jax.random.key(11), 6)
  want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
  got = prng.uniform(torch.from_numpy(_kd(keys)), shape)
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize('maxval', [17, 2 ** 31 - 1])
def test_randint(maxval):
  keys = jax.random.split(jax.random.key(5), 64)
  want = np.asarray(jax.vmap(
      lambda k: jax.random.randint(k, (), 0, maxval))(keys))
  got = prng.randint(torch.from_numpy(_kd(keys)), 0, maxval)
  np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize('n', [1, 8, 16, 64, 256, 4096, 262144])
def test_permutation(n):
  for seed in (0, 3, 12345):
    # A key as training meets it: split off a run key.
    kj = jax.random.split(jax.random.key(seed), 3)[2]
    want = np.asarray(jax.random.permutation(kj, n))
    got = prng.permutation(torch.from_numpy(_kd(kj)), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(want, got.numpy())


def test_categorical_matches_jax_and_softmax():
  rows, n_act = 20000, 17
  logits = np.random.RandomState(0).randn(n_act).astype(np.float32)
  batch = np.broadcast_to(logits, (rows, n_act)).copy()
  kj = jax.random.key(21)
  want = np.asarray(jax.random.categorical(kj, batch))
  got = prng.categorical(torch.from_numpy(_kd(kj)),
                         torch.from_numpy(batch)).numpy()
  assert got.shape == (rows,) and got.min() >= 0 and got.max() < n_act
  assert (got == want).mean() >= 0.999
  # The draws follow softmax(logits): chi-square with 16 degrees of
  # freedom, whose 99.9th percentile is 39.25.
  probs = np.exp(logits - logits.max())
  probs /= probs.sum()
  counts = np.bincount(got, minlength=n_act)
  chi2 = ((counts - rows * probs) ** 2 / (rows * probs)).sum()
  assert chi2 < 39.25, chi2


# -- the threefry kernel (csrc/threefry.cu) behind prng on CUDA keys ------

SHARDS = [((3, 5), (2, 9), 0), ((4, 3, 5), (1, 7), 1), ((2, 5, 3), (4, 10), 1),
          ((6,), (0, 6), 0), ((4, 64, 64), (0, 4), 0), ((4096, 17), (512, 8192),
                                                         0)]


@pytest.mark.parametrize('shape', [(), (7,), (4096, 17), (4, 64, 64)],
                         ids=str)
def test_geometry_of_a_whole_draw(shape):
  size = int(np.prod(shape))
  assert prng_cuda.geometry(shape) == (1, size, 1, 0, size)


@pytest.mark.parametrize('shape,rows,axis', SHARDS, ids=str)
def test_geometry_of_a_shard(shape, rows, axis):
  geom = prng_cuda.geometry(shape, rows, axis)
  assert geom == (int(np.prod(shape[:axis])), shape[axis],
                  int(np.prod(shape[axis + 1:])), rows[0], rows[1])


def test_geometry_refuses_rows_outside_the_draw():
  for rows in [(5, 9), (-1, 9)]:
    with pytest.raises(ValueError):
      prng._counters((5,), rows, 0, 'cpu')
    with pytest.raises(ValueError):
      prng_cuda.geometry((5,), rows, 0)


def test_cpu_keys_take_the_twin(monkeypatch):
  """On CPU keys every draw runs the int64 twin and the kernel's wrapper
  counts no launch; the wrapper refuses CPU keys."""
  calls = []
  twin = prng.threefry2x32

  def counted(*words):
    calls.append(words[0].device.type)
    return twin(*words)

  monkeypatch.setattr(prng, 'threefry2x32', counted)
  before = (prng_cuda.draw.launches, dict(prng_cuda.draw.launches_by_mode))
  k = prng.key(3, 'cpu')
  keys = prng.split(k, 4)
  prng.fold_in(keys, 7)
  prng.fold_in(keys, torch.arange(4, dtype=torch.int32))
  prng.random_bits(keys, (3,))
  prng.uniform(keys, (2, 2), rows=(1, 5), axis=1)
  prng.randint(keys, 0, 9)
  prng.permutation(k, 16)
  prng.categorical(k, torch.zeros(8, 17))
  assert len(calls) >= 9 and set(calls) == {'cpu'}
  assert (prng_cuda.draw.launches,
          dict(prng_cuda.draw.launches_by_mode)) == before
  with pytest.raises(ValueError):
    prng_cuda.draw(keys, 'bits', prng_cuda.geometry((3,)))


def test_launch_counts_list_the_threefry_kernel():
  from crafter_tpu_torch import utils
  assert dict(utils.profiling.counted_wrappers())['threefry'] \
      is prng_cuda.draw
  prng_cuda.draw.launches = 5
  assert utils.launches()['threefry'] == 5
  utils.zero_launches()
  assert utils.launches()['threefry'] == 0


@pytest.fixture(scope='module')
def dev():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
  return torch.device('cuda')


def _twin_bits(keys, shape, rows=None, axis=0):
  """The int64 twin's bits on the keys' own device."""
  i = prng._counters(shape, rows, axis, keys.device)
  b0, b1 = prng.threefry2x32(keys[..., None, 0], keys[..., None, 1],
                             torch.zeros_like(i), i)
  return (b0 ^ b1).reshape(keys.shape[:-1] + tuple(shape))


def _twin_uniform(bits):
  return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _card_keys(dev, lead, seed):
  gen = torch.Generator(device=dev)
  gen.manual_seed(seed)
  return torch.randint(0, 2 ** 32, tuple(lead) + (2,), generator=gen,
                       dtype=torch.int64, device=dev)


@contextlib.contextmanager
def _launched(mode):
  """Asserts that the block launched the kernel once in ``mode``."""
  before = prng_cuda.draw.launches_by_mode[mode]
  yield
  assert prng_cuda.draw.launches_by_mode[mode] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize('keys_n', [1, 320, 5120])
def test_kernel_split_and_fold_in_match_twin(dev, keys_n):
  keys = _card_keys(dev, (keys_n,), keys_n)
  for num in (2, 3, 7):
    i = torch.arange(num, dtype=torch.int64, device=dev)
    b0, b1 = prng.threefry2x32(keys[:, None, 0], keys[:, None, 1],
                               torch.zeros_like(i), i)
    with _launched('split'):
      got = prng.split(keys, num)
    assert torch.equal(got, torch.stack([b0, b1], -1))
  data = _card_keys(dev, (keys_n,), 7)[:, 0] - 2 ** 31
  for d in (0x5EED, 2 ** 32 - 1, data, data.to(torch.int32)):
    words = torch.as_tensor(d, device=dev).to(torch.int64) & prng.MASK32
    b0, b1 = prng.threefry2x32(keys[:, 0], keys[:, 1],
                               torch.zeros_like(words), words)
    with _launched('fold_in'):
      got = prng.fold_in(keys, d)
    assert torch.equal(got, torch.stack([b0, b1], -1))


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(), (4096, 17), (4, 64, 64)], ids=str)
@pytest.mark.parametrize('keys_n', [1, 320, 5120])
def test_kernel_bits_and_uniform_match_twin(dev, keys_n, shape):
  keys = _card_keys(dev, (keys_n,), 11)
  want = _twin_bits(keys, shape)
  with _launched('bits'):
    got = prng.random_bits(keys, shape)
  assert got.dtype == torch.int64 and torch.equal(got, want)
  with _launched('uniform'):
    got = prng.uniform(keys, shape)
  assert got.dtype == torch.float32 and torch.equal(got, _twin_uniform(want))


def _jax_draws(words, data, shape):
  """``jax.random``'s split(3), fold_in (0x5EED and ``data``, uint32 a
  key), bits and uniform of ``shape`` for each key of ``words`` (K, 2)
  uint32, on JAX's CPU device: int64 / float32 numpy arrays."""
  with jax.default_device(jax.devices('cpu')[0]):
    kj = jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32))
    each = lambda fn, *args: np.asarray(jax.vmap(fn)(kj, *args))
    keys = lambda fn, *args: _kd(jax.vmap(fn)(kj, *args))
    return {
        'split': keys(lambda k: jax.random.split(k, 3)),
        'fold_in': keys(lambda k: jax.random.fold_in(k, 0x5EED)),
        'fold_in_data': keys(jax.random.fold_in, jnp.asarray(data)),
        'bits': each(lambda k: jax.random.bits(k, shape, jnp.uint32)).astype(
            np.int64),
        'uniform': each(lambda k: jax.random.uniform(k, shape))}


@pytest.mark.cuda
def test_kernel_draws_match_jax(dev):
  """The kernel against ``jax.random`` directly, at 320 keys and a world's
  material plane: a drift of the twin would not hide a fault of the
  kernel."""
  shape = (4, 64, 64)
  keys = _card_keys(dev, (320,), 19)
  data = (_card_keys(dev, (320,), 23)[:, 0] - 2 ** 31).to(torch.int32)
  want = _jax_draws(keys.cpu().numpy().astype(np.uint32),
                    data.cpu().numpy().astype(np.uint32), shape)
  got = {}
  for name, mode, draw in (
      ('split', 'split', lambda: prng.split(keys, 3)),
      ('fold_in', 'fold_in', lambda: prng.fold_in(keys, 0x5EED)),
      ('fold_in_data', 'fold_in', lambda: prng.fold_in(keys, data)),
      ('bits', 'bits', lambda: prng.random_bits(keys, shape)),
      ('uniform', 'uniform', lambda: prng.uniform(keys, shape))):
    with _launched(mode):
      got[name] = draw().cpu().numpy()
  for name, value in want.items():
    assert got[name].dtype == value.dtype, name
    np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,rows,axis', SHARDS, ids=str)
def test_kernel_shards_match_twin(dev, shape, rows, axis):
  keys = _card_keys(dev, (2, 3, 2), 13)
  want = _twin_bits(keys, shape, rows, axis)
  assert torch.equal(prng.random_bits(keys, shape, rows, axis), want)
  assert torch.equal(prng.uniform(keys, shape, rows, axis),
                     _twin_uniform(want))
  assert torch.equal(prng.split(keys, 3).cpu(), prng.split(keys.cpu(), 3))
  data = torch.arange(12, device=dev).reshape(2, 3, 2)
  assert torch.equal(prng.fold_in(keys, data).cpu(),
                     prng.fold_in(keys.cpu(), data.cpu()))
  # A strided column of a split, as worldgen draws from.
  sub = prng.split(keys, 3)[..., 1, :]
  assert torch.equal(prng.uniform(sub, shape, rows, axis),
                     _twin_uniform(_twin_bits(sub, shape, rows, axis)))


@pytest.mark.cuda
def test_randint_permutation_categorical_on_card_equal_cpu(dev):
  keys = _card_keys(dev, (320,), 17)
  before = prng_cuda.draw.launches
  got = prng.randint(keys, 0, 2 ** 31 - 1)
  assert prng_cuda.draw.launches == before + 3
  assert torch.equal(got.cpu(), prng.randint(keys.cpu(), 0, 2 ** 31 - 1))
  assert torch.equal(prng.randint(keys, 3, 17, (4, 6), rows=(2, 9)).cpu(),
                     prng.randint(keys.cpu(), 3, 17, (4, 6), rows=(2, 9)))
  k = keys[5]
  for n in (16, 4096, 262144):
    assert torch.equal(prng.permutation(k, n).cpu(),
                       prng.permutation(k.cpu(), n))
  logits = torch.randn(4096, 17, generator=torch.Generator().manual_seed(0))
  for rows in (None, (4096, 16384)):
    assert torch.equal(prng.categorical(k, logits.to(dev), rows).cpu(),
                       prng.categorical(k.cpu(), logits, rows))
