"""The port's last measuring tools on the CPU, against the JAX package's.

* ``tools/bench_obs_shuffle_cuda.py``: its frames and permutation at b = 64
  are ``jax.random.bits(key(0), (64, 12288), uint8)`` and
  ``jax.random.permutation(key(1), 64)`` exactly (tolerance none), drawn in
  row chunks or at once alike, its packed lanes the JAX tool's bitcast.
  Every case's sum at b = 64, M = 8 equals the float64 sum of the same
  bfloat16 values within a relative 1e-6 (three times it for
  ``flat_once3``); ``jnp``'s ``(x.astype(bfloat16) / 255.0).sum(dtype=
  float32)`` under ``jit`` on the same rows equals the float64 sum of the
  float32 products ``x * float32(1/255)`` within 1e-6: XLA's CPU compiler
  multiplies by the reciprocal and drops the bfloat16 rounding (its default
  ``xla_allow_excess_precision``), so the two libraries' sums differ by
  that rounding (1.3e-3 relative on these rows), which the test pins too.
* ``tools/bench_unpack_cuda.py``: ``u0`` and ``u1`` equal the JAX tool's
  (``tools/bench_unpack.py``, under ``jit``) bit for bit on numpy-seeded
  lanes, with and without the top byte set (the logical shifts); the tool
  at 16 frames prints the JAX tool's lines and holds the render's three
  formats equal.
* ``tools/sweep_group_block_cuda.py``: its action draws are
  ``jax.random``'s for two groups (tolerance none); ``--device cpu`` at 8
  envs and 2 groups prints the ``plain`` line after every env advanced by
  2 K; a bad geometry raises before ``nvcc`` runs.
* ``_build``: a geometry variant has its own cache key and directory, and
  its ``nvcc`` command carries both ``-D`` values and every default flag;
  the default build's flags and digest are what they were.
* ``bench_cuda.py --sizes``: falls back from a failing size to the next,
  prints one record naming it (today's keys and the children's launches),
  and prints ``bench.py``'s failure record and exits 1 when every size
  fails (``tests/test_torch_bench.py`` holds the keys without
  ``--sizes``).
* ``tools/bench_threefry_cuda.py``: its pass makes nine draws whose
  outputs hold the draws and bytes ``pass_work`` counts; ``--device cpu``
  at 2 worlds checks the planes against the twin and times the twin alone.
* Without a card every default run stops.
"""

import contextlib
import hashlib
import io
import json
import pathlib
import re
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crafter_tpu_torch as ct
from crafter_tpu_torch import _build, prng, step_cuda
from one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, M = 64, 8
SUM_RTOL = 1e-6


def _load(path):
  return runpy.run_path(str(ROOT / path), run_name=pathlib.Path(path).stem)


def _captured(fn, *args):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    ret = fn(*args)
  return ret, out.getvalue()


@pytest.fixture(scope='module')
def shuffle():
  return _load('tools/bench_obs_shuffle_cuda.py')


@pytest.fixture(scope='module')
def shuffle_data(shuffle):
  return shuffle['make_data'](B, 'cpu')


def test_obs_shuffle_draws_the_jax_tools_data(shuffle, shuffle_data):
  flat, nhwc, packed, perm = shuffle_data
  want = np.asarray(jax.random.bits(jax.random.key(0), (B, 12288), jnp.uint8))
  np.testing.assert_array_equal(flat.numpy(), want)
  np.testing.assert_array_equal(
      perm.numpy(), np.asarray(jax.random.permutation(jax.random.key(1), B)))
  assert nhwc.shape == (B, 64, 64, 3) and torch.equal(nhwc.reshape(B, -1),
                                                      flat)
  quad = np.concatenate([want.reshape(B, 4096, 3),
                         np.zeros((B, 4096, 1), np.uint8)], -1)
  np.testing.assert_array_equal(packed.numpy(),
                                quad.view(np.int32).reshape(B, 4096))
  for chunk in (7, 64):
    assert torch.equal(shuffle['make_data'](B, 'cpu', chunk=chunk)[0], flat)


@pytest.mark.parametrize('case', ['nhwc', 'flat', 'packed', 'epoch', 'contig',
                                  'nhwc_sorted', 'flat_sorted', 'flat_once3'])
def test_obs_shuffle_case_consumes_every_row(shuffle, shuffle_data, case):
  flat, nhwc, packed, perm = shuffle_data
  _, fn, layout, _ = next(c for c in shuffle['CASES'] if c[0] == case)
  data = {'nhwc': nhwc, 'flat': flat, 'packed': packed}[layout]
  got = float(fn(data, perm, M))
  want = (flat.to(torch.bfloat16) / 255.0).double().sum().item()
  want *= shuffle['EPOCHS'].get(case, 1)
  assert abs(got - want) <= SUM_RTOL * want, (got, want)


def test_obs_shuffle_jnp_sums_without_the_bfloat16_rounding(shuffle_data):
  flat = shuffle_data[0]
  x = flat.numpy()
  got = float(jax.jit(lambda x: (x.astype(jnp.bfloat16) / 255.0).sum(
      dtype=jnp.float32))(x))
  products = (x.astype(np.float32) * np.float32(1 / 255)).astype(
      np.float64).sum()
  assert abs(got - products) <= SUM_RTOL * products, (got, products)
  rounded = (flat.to(torch.bfloat16) / 255.0).double().sum().item()
  assert 1e-3 < abs(rounded - got) / got < 2e-3


def test_obs_shuffle_on_cpu_prints_the_jax_lines(shuffle):
  rec, out = _captured(shuffle['main'], ['--device', 'cpu', '--batch', '64',
                                         '--reps', '1'])
  names = [c[0] for c in shuffle['CASES']]
  lines = out.splitlines()
  for name, line in zip(names, lines):
    assert re.fullmatch(rf'{name:<8} +[0-9.]+ ms/epoch \( +[0-9.]+ ms per '
                        r'3-epoch update\)', line), line
  assert list(rec['ms']) == names and rec['card'] is None
  assert rec['bound_ms'] is None and rec['peak_bytes'] is None
  assert rec['sums']['flat_once3'] == pytest.approx(3 * rec['sums']['nhwc'],
                                                    rel=1e-6)


def test_obs_shuffle_check_stops_on_a_lost_row(shuffle):
  sums = {'nhwc': 100.0, 'flat': 100.0, 'flat_once3': 300.0}
  shuffle['check_sums'](sums)
  with pytest.raises(SystemExit, match='flat consumed'):
    shuffle['check_sums'](dict(sums, flat=99.9))


@pytest.fixture(scope='module')
def unpack_tools():
  return _load('tools/bench_unpack_cuda.py'), _load('tools/bench_unpack.py')


@pytest.mark.parametrize('top', [False, True], ids=['24bit', 'top_byte'])
@pytest.mark.parametrize('fn', ['u0', 'u1'])
def test_unpack_variants_equal_the_jax_tools(unpack_tools, fn, top):
  port, jax_tool = unpack_tools
  rs = np.random.RandomState(3)
  hi = 1 << 32 if top else 1 << 24
  px = (rs.randint(0, hi, (5, 4096), dtype=np.int64)
        - (1 << 31 if top else 0)).astype(np.int32)
  if top:
    assert (px < 0).any() and ((px >> 24) != 0).mean() > 0.9
  want = np.asarray(jax.jit(jax_tool[fn], static_argnums=1)(px, (64, 64)))
  got = port[fn](torch.from_numpy(px), (64, 64))
  assert got.dtype == torch.uint8
  np.testing.assert_array_equal(got.numpy(), want)


def test_unpack_on_cpu_checks_and_prints_the_jax_lines(unpack_tools):
  port, _ = unpack_tools
  rec, out = _captured(port['main'], ['16', '--device', 'cpu'])
  lines = out.splitlines()
  assert lines[0] == 'U0 == U1 bitwise on 16 frames'
  for name, line in zip(('ctl', 'U0', 'U1'), lines[1:4]):
    assert re.fullmatch(rf'{name}: [0-9.]+ ms / 16 frames \(incl. xor\+sum\)',
                        line), line
  assert 'frames == U0(packed) == U1(packed) == words' in lines[4]
  assert set(rec['render_ms']) == {'frames', 'packed', 'words'}
  assert rec['launches'] is None and rec['card'] is None


@pytest.fixture(scope='module')
def sweep():
  return _load('tools/sweep_group_block_cuda.py')


def test_sweep_draws_the_jax_tools_actions(sweep):
  jkey, want = jax.random.key(0), []
  for _ in range(2):
    jkey, k_act = jax.random.split(jkey)
    want.append(np.asarray(jax.random.randint(k_act, (10, 37), 0, 17)))
  tkey, got = sweep['draw_actions'](prng.key(0, 'cpu'), 10, 37, 2)
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), np.stack(want))
  np.testing.assert_array_equal(tkey.numpy(),
                                np.asarray(jax.random.key_data(jkey)))


def test_sweep_on_cpu_times_the_plain_group_step(sweep):
  rec, out = _captured(sweep['main'], ['8', '--groups', '2', '--device',
                                       'cpu'])
  assert re.fullmatch(r'plain: [0-9.]+ ms/tick \([0-9,]+k steps/s '
                      r'kernel-only loop\)\n', out), out
  assert rec['ticks'] == 2 * ct.EnvConfig().balance_every
  assert list(rec['variants']) == ['plain'] and rec['card'] is None
  with pytest.raises(SystemExit, match='geometry'):
    sweep['main'](['8', '256:4', '--device', 'cpu'])


def test_sweep_loop_advances_every_env(sweep):
  cfg = ct.EnvConfig(reward=False)
  env = ct.vec_reset(ct.home_keys(0, 3, 'cpu'), cfg).env
  actions = sweep['draw_actions'](prng.key(0, 'cpu'), 10, 3, 2)[1]
  out = sweep['loop'](env, actions, cfg)
  assert torch.equal(out[0].step - env.step,
                     torch.full((3,), 2 * cfg.balance_every,
                                dtype=env.step.dtype))


@pytest.mark.parametrize('geometry', [(100, 5), (32, 5), (1056, 1), (256, 0),
                                      (96, -1)])
def test_bad_geometry_raises_before_nvcc(sweep, geometry, monkeypatch):
  def no_nvcc():
    raise AssertionError('nvcc was looked up')
  monkeypatch.setattr(_build, '_nvcc', no_nvcc)
  for fn in (_build.build, _build.library, _build.out_dir):
    with pytest.raises(ValueError):
      fn(geometry)
  with pytest.raises(ValueError):
    sweep['parse_geometry']('{}:{}'.format(*geometry))


def test_geometry_refused_on_the_cpu():
  cfg = ct.EnvConfig(reward=False)
  env = ct.vec_reset(ct.home_keys(0, 2, 'cpu'), cfg).env
  acts = torch.zeros((3, 2), dtype=torch.int32)
  with pytest.raises(ValueError, match='geometry'):
    step_cuda.group_tick(env, acts, cfg, geometry=(256, 4))


FLAGS_BEFORE = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
                '-O3', '-fmad=false', '-Xptxas', '-v', '-Xcompiler', '-fPIC')


def test_variant_build_has_its_own_key_and_flags(tmp_path):
  default, variant = _build.out_dir(), _build.out_dir((512, 4))
  assert default != variant and variant.parent == default.parent
  assert variant.name == f'kernels-{_build._digest((512, 4))}-t512b4'
  assert _build._digest((512, 4)) != _build._digest((512, 3))
  assert _build.out_dir((256, 5)) == default     # the shipped geometry
  obj = tmp_path / 'group_tick.cu.o'
  cmd = _build.compile_command('nvcc', 'group_tick.cu', obj, (512, 4))
  src = str(_build.CSRC / 'group_tick.cu')
  assert cmd == ['nvcc', *FLAGS_BEFORE, '-DCRAFTER_GROUP_THREADS=512',
                 '-DCRAFTER_GROUP_MIN_BLOCKS=4', '-I', str(_build.CSRC),
                 '-c', src, '-o', str(obj)]
  assert _build.VARIANT_SOURCES == ('group_tick.cu',)


FAKE_NVCC = '''#!{python}
import pathlib, sys
args = sys.argv[1:]
out = pathlib.Path(args[args.index('-o') + 1])
if '-shared' in args:
  out.write_text('library of ' + ' '.join(args[args.index('-o') + 2:]))
else:
  out.write_text(' '.join(args))
  print("ptxas info    : Compiling entry function "
        "'_Z17group_tick_kernelILi64EEvv' for 'sm_90a'")
  print('ptxas info    : Function properties for '
        '_Z17group_tick_kernelILi64EEvv')
  print('    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads')
  threads = [a for a in args if a.startswith('-DCRAFTER_GROUP_THREADS=')]
  print('ptxas info    : Used %d registers, used 1 barriers'
        % (50 if threads else 48))
'''


def test_build_many_starts_every_compile_and_keeps_each_log(tmp_path,
                                                             monkeypatch):
  """The build's orchestration with a stand-in for nvcc: the default
  library from every source and a variant from group_tick.cu alone, each
  in its own directory with its own ptxas.log, which ptxas_usage reads."""
  import sys
  nvcc = tmp_path / 'nvcc'
  nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
  nvcc.chmod(0o755)
  monkeypatch.setattr(_build, 'BUILD_ROOT', tmp_path / 'build')
  monkeypatch.setattr(_build, '_nvcc', lambda: str(nvcc))
  default, variant = _build.build_many([None, (256, 4)])
  assert default.parent == _build.out_dir() and variant.parent.name.endswith(
      '-t256b4')
  assert default.read_text().count('.cu.o') == len(_build.SOURCES)
  assert variant.read_text().endswith('group_tick.cu.o')
  log = (variant.parent / 'ptxas.log').read_text()
  assert log.startswith('== group_tick.cu\n') and '== noise2.cu' not in log
  usage = _build.ptxas_usage((256, 4))
  assert usage == {'_Z17group_tick_kernelILi64EEvv': {
      'registers': 50, 'spill_stores': 4, 'spill_loads': 4}}
  assert _build.ptxas_usage()['_Z17group_tick_kernelILi64EEvv'][
      'registers'] == 48
  assert _build.build((256, 4)) == variant        # built once, then reused


def test_default_build_is_untouched(tmp_path):
  assert _build.FLAGS == FLAGS_BEFORE
  obj = tmp_path / 'noise2.cu.o'
  assert _build.compile_command('nvcc', 'noise2.cu', obj) == [
      'nvcc', *FLAGS_BEFORE, '-I', str(_build.CSRC), '-c',
      str(_build.CSRC / 'noise2.cu'), '-o', str(obj)]
  # The digest of the flags and every source's name and text, as before.
  h = hashlib.sha256(' '.join(FLAGS_BEFORE).encode())
  for name in sorted(p.name for p in _build.CSRC.iterdir()):
    h.update(name.encode())
    h.update((_build.CSRC / name).read_bytes())
  assert _build._digest() == h.hexdigest()[:16]
  assert _build.out_dir().name == f'kernels-{h.hexdigest()[:16]}'
  text = (_build.CSRC / 'group_tick.cu').read_text()
  assert '#define CRAFTER_GROUP_THREADS 256' in text
  assert '#define CRAFTER_GROUP_MIN_BLOCKS 5' in text


@pytest.fixture(scope='module')
def bench():
  return _load('bench_cuda.py')


TODAYS_KEYS = ['metric', 'value', 'unit', 'vs_baseline', 'pixel_value',
               'pixel_vs_baseline', 'median_value', 'pixel_median_value',
               'repeats', 'device']


def test_bench_sizes_falls_back_to_the_next_size(bench, capsys, monkeypatch):
  monkeypatch.setenv('OMP_NUM_THREADS', '1')
  rec = bench['main'](['--device', 'cpu', '--sizes', '0', '8', '--ticks',
                       '10', '--pixel-ticks', '10'])
  out, err = capsys.readouterr()
  lines = out.strip().splitlines()
  assert len(lines) == 1 and json.loads(lines[0]) == rec
  assert err.count('attempt N=0 failed: ValueError: 0 envs') == 2
  assert 'envs=8 state-only=' in err
  assert '@ 8 envs' in rec['metric'] and rec['value'] > 0
  assert list(rec) == TODAYS_KEYS + ['launches']
  assert rec['pixel_value'] > 0 and len(rec['repeats']['pixel']) == 3
  assert rec['launches'] == {'state_only': None, 'pixel': None}


def test_bench_sizes_all_failing_exits_1(bench, capsys, monkeypatch):
  monkeypatch.setenv('OMP_NUM_THREADS', '1')
  with pytest.raises(SystemExit) as exc:
    bench['main'](['--device', 'cpu', '--sizes', '0'])
  assert exc.value.code == 1
  out = capsys.readouterr().out.strip().splitlines()
  assert json.loads(out[-1]) == {'metric': 'env-steps/s (bench failed)',
                                 'value': 0, 'unit': 'env-steps/s',
                                 'vs_baseline': 0}


@pytest.fixture(scope='module')
def threefry():
  return _load('tools/bench_threefry_cuda.py')


def test_threefry_pass_work_counts_the_draws(threefry, monkeypatch):
  r, area = 3, (5, 4)
  keys = prng.split(prng.key(1, 'cpu'), r)
  blocks = []
  twin = prng.threefry2x32

  def counted(*words):
    out = twin(*words)
    blocks.append(out[0].numel())
    return out

  monkeypatch.setattr(prng, 'threefry2x32', counted)
  threefry['pass_draws'](keys, area)
  draws, nbytes = threefry['pass_work'](r, area)
  assert len(blocks) == 9 and sum(blocks) == draws
  # Every draw writes at least 4 bytes and each of 9 launches reads keys.
  assert nbytes >= 4 * draws + 9 * 16 * r


def test_threefry_bench_on_cpu_times_the_twin(threefry):
  rec, out = _captured(threefry['main'],
                       ['--device', 'cpu', '--worlds', '2', '--reps', '1'])
  row = rec['worlds'][2]
  assert (row['draws'], row['bytes']) == threefry['pass_work'](2)
  assert row['twin_ms'] > 0 and row['wrapper_ms'] > 0
  assert 'kernel_ms' not in row and rec['card'] is None
  assert out.startswith('2 worlds: ')


@pytest.mark.parametrize('tool,argv', [
    ('tools/bench_obs_shuffle_cuda.py', []),
    ('tools/bench_unpack_cuda.py', []),
    ('tools/sweep_group_block_cuda.py', []),
    ('bench_cuda.py', ['--sizes', '4096', '2048']),
    ('tools/bench_threefry_cuda.py', [])])
def test_default_runs_stop_without_a_card(tool, argv):
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default run would time it')
  with pytest.raises(SystemExit, match='no CUDA device'):
    _load(tool)['main'](argv)
