"""The port's renderer against the JAX package's, module by module.

* the committed textures against their PNGs;
* the baked atlas against the JAX ``bake_atlas`` for two render sizes (the
  port's per-pixel source index against ``argmax`` of the one-hot ``expand``);
* the port's float32 cosine against ``jax.jit(jnp.cos)`` on every float32
  of the daylight's domain, and ``daylight`` for steps 0..20000 at two day
  lengths (and negative and extreme int32 steps) against the jitted JAX
  function;
* ``noise_seed``, ``pack_cells``, ``window_prep`` against the JAX functions;
* ``render_frames`` in its three output formats against the JAX
  ``render_frames`` run as its Pallas kernel in interpret mode, on one batch
  of hand-built scenes: day, night (steps spread over 148..272), sleeping,
  a player at the map edge (gray tiles), arrows of every facing, ripe and
  unripe plants, inventory amounts 0 and above 9;
* frames picked because they tell the placement of each fused multiply-add
  apart, against the jitted JAX ``_render_core``.

Tolerance everywhere: none (every byte equal).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crafter_tpu import render as jrender
from crafter_tpu import state as jstate
from crafter_tpu.config import EnvConfig as JaxConfig
import crafter_tpu_torch as ct
from crafter_tpu_torch import render as render_lib
from crafter_tpu_torch import render_cuda, rules
from crafter_tpu_torch.ops.fma import cos32
from one_thread import one_torch_thread  # noqa: F401

CFG = ct.EnvConfig()
JCFG = JaxConfig()
C = 64 * 64
FORMATS = ('frames', 'packed', 'words')
T = torch.from_numpy


def test_textures_npz_equals_pngs():
  import imageio.v3 as iio
  tex = render_lib._textures()
  pngs = sorted(jrender.ASSETS.glob('*.png'))
  assert sorted(tex) == sorted(p.stem for p in pngs) and len(pngs) == 56
  for p in pngs:
    img = iio.imread(p.read_bytes())
    img = img.transpose((1, 0) + tuple(range(2, img.ndim)))
    assert tex[p.stem].dtype == np.uint8
    np.testing.assert_array_equal(tex[p.stem], img, err_msg=p.stem)
    np.testing.assert_array_equal(tex[p.stem], jrender._load(p.stem))


def test_cos32_equals_jitted_jax():
  """Every float32 in [float32(pi) * 0.3, float32(pi) * 1.3], the cosine's
  arguments in ``daylight``, and a sample of |x| < 120 (both glibc
  branches): bit for bit."""
  pi = np.float32(np.pi)
  lo = (pi * np.float32(0.3)).view(np.int32)
  hi = (pi * np.float32(1.3)).view(np.int32)
  jcos = jax.jit(jnp.cos)
  chunk = 1 << 21
  for start in range(int(lo), int(hi) + 1, chunk):
    x = np.arange(start, min(start + chunk, int(hi) + 1),
                  dtype=np.int32).view(np.float32)
    ours = cos32(T(x)).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.int32),
                                  np.asarray(jcos(x)).view(np.int32))
  wide = np.arange(0, 0x42F00000, 997, dtype=np.int32).view(np.float32)
  wide = np.concatenate([wide, -wide])
  np.testing.assert_array_equal(cos32(T(wide)).numpy().view(np.int32),
                                np.asarray(jcos(wide)).view(np.int32))


@pytest.mark.parametrize('day_length', [200, 300])
def test_daylight_equals_jitted_jax(day_length):
  steps = np.arange(0, 20001, dtype=np.int32)
  rng = np.random.default_rng(day_length)
  steps = np.concatenate([steps, np.arange(-300, 0, dtype=np.int32),
                          rng.integers(-2 ** 31, 2 ** 31, 4096,
                                       dtype=np.int64).astype(np.int32)])
  ref = np.asarray(jax.jit(lambda s: jstate.daylight(s, day_length))(steps))
  ours = ct.daylight(T(steps), day_length).numpy()
  assert ours.dtype == np.float32
  np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize('size', [(64, 64), (512, 512)], ids=str)
def test_atlas_equals_jax(size):
  ref = jrender.bake_atlas(size, JCFG.view, JCFG.item_rows)
  ours = ct.bake_atlas(size, CFG.view, CFG.item_rows, 'cpu')
  for name in ('mat_planes', 'spr_planes', 'vignette', 'view_mask'):
    got = getattr(ours, name).numpy()
    want = np.asarray(getattr(ref, name))
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)
  expand = np.asarray(ref.expand)
  assert set(np.unique(expand.sum(0))) <= {0, 1}
  src = np.where(expand.any(0), expand.argmax(0), -1)
  np.testing.assert_array_equal(ours.src.numpy(), src)


def test_nearest_resize_equals_pil():
  from PIL import Image
  img = render_lib._load('player-down')
  for size in [(1, 1), (3, 5), (5, 4), (7, 7), (16, 16), (33, 20), (56, 56)]:
    want = np.array(Image.fromarray(img).resize(size[::-1],
                                                resample=Image.NEAREST))
    np.testing.assert_array_equal(render_lib._resize(img, size), want,
                                  err_msg=str(size))


def test_noise_seed_equals_jax():
  rs = np.random.RandomState(0)
  kd = rs.randint(0, 2 ** 32, size=(64, 2), dtype=np.uint64).astype(np.uint32)
  steps = rs.randint(0, 20000, size=64).astype(np.int32)
  want = jax.vmap(jrender._noise_seed)(jax.random.wrap_key_data(kd), steps)
  got = ct.noise_seed(T(kd.astype(np.int64)), T(steps))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- one batch of hand-built scenes --------------------------------------


class each(list):
  """Marks a value of :func:`_scenes` that differs from row to row."""


def _scenes():
  """Field arrays of a batch of scenes and the frame rows of each case."""
  rs = np.random.RandomState(5)
  cases, rows = {}, []

  def add(case, n, **kw):
    cases[case] = list(range(len(rows), len(rows) + n))
    for i in range(n):
      row = dict(pos=(32, 32), step=0, sleeping=False, facing=rules.DIR_DOWN,
                 ents=[], inv={})
      row.update({k: (v[i] if isinstance(v, each) else v)
                  for k, v in kw.items()})
      rows.append(row)

  add('day', 2, step=each([0, 120]),
      ents=[(rules.E_COW, (31, 30), 0, 0), (rules.E_ZOMBIE, (34, 34), 0, 0),
            (rules.E_SKELETON, (30, 33), 0, 0)])
  add('night', 8, step=each([148, 166, 184, 202, 220, 238, 256, 272]),
      ents=[(rules.E_ZOMBIE, (33, 31), 0, 0)])
  add('sleeping', 2, sleeping=True, step=each([10, 215]))
  add('edge', 4, pos=each([(0, 0), (63, 63), (0, 40), (62, 1)]),
      step=each([0, 0, 0, 200]))
  add('arrows', 4, facing=each([0, 1, 2, 3]),
      ents=each([(rules.E_ARROW, (30, 32), 0, f)] for f in range(4)))
  add('plants', 2, ents=each([[(rules.E_PLANT, (32, 31), 301, 0)],
                              [(rules.E_PLANT, (32, 31), 10, 0)]]))
  add('inventory', 2, inv=each([dict(wood=0, stone=12, sapling=9),
                                dict(wood=3, coal=1, iron_pickaxe=1,
                                     health=0)]))
  b = len(rows)
  f = dict(
      mat_map=rs.randint(1, rules.N_MATERIALS, size=(b, C)).astype(np.uint8),
      etype=np.zeros((b, C), np.uint8), aux=np.zeros((b, C), np.int16),
      efacing=np.zeros((b, C), np.uint8),
      pos=np.asarray([r['pos'] for r in rows], np.int32),
      facing=np.asarray([r['facing'] for r in rows], np.int32),
      sleeping=np.asarray([r['sleeping'] for r in rows]),
      inventory=np.tile(np.asarray(rules.TABLES.item_initial, np.int32),
                        (b, 1)),
      step=np.asarray([r['step'] for r in rows], np.int32),
      key=rs.randint(0, 2 ** 32, size=(b, 2), dtype=np.uint64).astype(
          np.uint32))
  for i, r in enumerate(rows):
    x, y = r['pos']
    f['etype'][i, x * 64 + y] = rules.E_PLAYER
    for etype, (ex, ey), aux, fac in r['ents']:
      c = ex * 64 + ey
      f['etype'][i, c], f['aux'][i, c], f['efacing'][i, c] = etype, aux, fac
    for name, amount in r['inv'].items():
      f['inventory'][i, rules.ITEM_ID[name]] = amount
  return f, cases


@pytest.fixture(scope='module')
def scenes():
  """The scenes rendered by both packages in every output format."""
  f, cases = _scenes()
  atlas = jrender.bake_atlas(JCFG.size, JCFG.view, JCFG.item_rows)
  key = jax.random.wrap_key_data(f['key'])
  jpacked = jrender.pack_cells(f['mat_map'], f['etype'], f['aux'],
                               f['efacing'])
  jseeds = jax.vmap(jrender._noise_seed)(key, f['step'])
  jwin = jax.jit(jax.vmap(lambda pk, pp, pf, sl, inv: jrender._window_prep(
      pk, pp, pf, sl, inv, JCFG)))(jpacked, f['pos'], f['facing'],
                                   f['sleeping'], f['inventory'])
  ref = {
      fmt: np.asarray(jax.jit(lambda *a, fmt=fmt: jrender.render_frames(
          *a, JCFG, atlas, JCFG.size, out_format=fmt))(
              jpacked, f['pos'], f['facing'],
              f['sleeping'].astype(np.int32), f['inventory'], f['step'],
              jseeds))
      for fmt in FORMATS}
  tatlas = ct.bake_atlas(CFG.size, CFG.view, CFG.item_rows, 'cpu')
  packed = ct.pack_cells(T(f['mat_map']), T(f['etype']), T(f['aux']),
                         T(f['efacing']))
  seeds = ct.noise_seed(T(f['key'].astype(np.int64)), T(f['step']))
  win = ct.window_prep(packed, T(f['pos']), T(f['facing']), T(f['sleeping']),
                       T(f['inventory']), CFG)
  ours = {
      fmt: ct.render_frames(
          packed, T(f['pos']), T(f['facing']), T(f['sleeping']),
          T(f['inventory']), T(f['step']), seeds, CFG, tatlas, CFG.size,
          out_format=fmt).numpy()
      for fmt in FORMATS}
  return dict(f=f, cases=cases, ref=ref, ours=ours, tatlas=tatlas,
              packed=(packed.numpy(), np.asarray(jpacked)),
              seeds=(seeds.numpy(), np.asarray(jseeds)),
              win=(win.numpy(), np.asarray(jwin)))


@pytest.mark.parametrize('what', ['packed', 'seeds', 'win'])
def test_frame_inputs_equal_jax(scenes, what):
  """``pack_cells``, ``noise_seed`` and ``window_prep`` on the scenes."""
  ours, ref = scenes[what]
  assert ours.dtype == ref.dtype and ours.shape == ref.shape
  np.testing.assert_array_equal(ours, ref)
  if what == 'win':
    assert (ours[:, :63] & 15 == render_lib.GRAY_ID).any()   # edge tiles
    assert ours[:, 63:].max() == 9 and ours[:, 63:].min() == 0


@pytest.mark.parametrize('fmt', FORMATS)
def test_render_frames_equal_jax(scenes, fmt):
  ours, ref = scenes['ours'][fmt], scenes['ref'][fmt]
  assert ours.dtype == ref.dtype and ours.shape == ref.shape
  np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize('case', ['day', 'night', 'sleeping', 'edge',
                                  'arrows', 'plants', 'inventory'])
def test_scene_frames_equal_jax(scenes, case):
  rows = scenes['cases'][case]
  ours, ref = scenes['ours']['frames'][rows], scenes['ref']['frames'][rows]
  np.testing.assert_array_equal(ours, ref)
  # The case shows what it is meant to show.
  if case == 'night':
    light = ct.daylight(T(scenes['f']['step'][rows]), 300)
    assert (light < 0.5).all()
    assert (ours != scenes['ours']['frames'][0]).any()
  elif case in ('arrows', 'plants', 'inventory'):
    assert all((ours[0] != o).any() for o in ours[1:])
  elif case == 'edge':
    assert (ours[0][:7, :7] == ours[0][0, 0]).all()   # a flat gray tile


def test_render_single_env_and_wrappers(scenes):
  """One env without a leading axis, ``render_px_fields``, and the kernel
  wrapper on CPU tensors (its plain twin) give the batch's frames."""
  f, tatlas = scenes['f'], scenes['tatlas']
  i = scenes['cases']['night'][3]
  args = [torch.as_tensor(f[k][i]) for k in (
      'mat_map', 'etype', 'aux', 'efacing', 'pos', 'facing')] + [
      bool(f['sleeping'][i]), T(f['inventory'][i]), int(f['step'][i]),
      T(f['key'][i].astype(np.int64))]
  one = ct.render_fields(*args, CFG, tatlas, CFG.size)
  np.testing.assert_array_equal(one.numpy(), scenes['ours']['frames'][i])
  px = ct.render_px_fields(*args, CFG, tatlas)
  np.testing.assert_array_equal(px.numpy(), scenes['ours']['packed'][i])
  np.testing.assert_array_equal(ct.frame_image(px, CFG.size).numpy(),
                                one.numpy())
  win = T(scenes['win'][0])
  light = ct.daylight(T(f['step']), 300)
  got = render_cuda.render_win79(win, light, T(f['sleeping']),
                                 T(scenes['seeds'][0]), tatlas, CFG.size,
                                 'words')
  np.testing.assert_array_equal(got.numpy(), scenes['ours']['words'])
  assert render_cuda.render_win79.launches == 0   # no kernel on the CPU


def test_fused_multiply_adds_placed_as_xla():
  """Frames at which a wrong placement of a fused multiply-add in the night
  blend shows: found by rendering 8192 random night frames with each
  placement moved (noise scale-and-shift unfused; the other product of the
  noise blend fused, or none).  Held against the jitted ``_render_core``."""
  win, light, slp, seeds = _fma_frames()
  a = jrender.bake_atlas(JCFG.size, JCFG.view, JCFG.item_rows)
  ref = jax.jit(lambda w, d, s, sd: jrender._render_core(
      w, d[:, None], s[:, None], sd[:, None], a.mat_planes, a.spr_planes,
      a.expand, a.vignette, a.view_mask))(win, light, slp, seeds)
  ours = ct.render_win79_plain(
      T(win), T(light), T(slp), T(seeds),
      ct.bake_atlas(CFG.size, CFG.view, CFG.item_rows, 'cpu'))
  np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# --- the render kernel's compact tables -----------------------------------


@pytest.mark.parametrize('size', [(64, 64), (512, 512)], ids=str)
def test_compact_tables_expand_to_atlas(size):
  """The compact tables rebuild every per-pixel table of the atlas exactly
  (the atlas is held against JAX's by ``test_atlas_equals_jax``)."""
  atlas = ct.bake_atlas(size, CFG.view, CFG.item_rows, 'cpu')
  planes = render_lib.expand_compact(atlas.compact)
  for name in ('mat_planes', 'spr_planes', 'src', 'vignette', 'view_mask'):
    want = getattr(atlas, name)
    got = planes[name]
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.equal(got, want), name


def test_compact_tables_layout():
  """Each texture once: at 64 x 64 the tables take 69,812 bytes (the
  render kernel stages them in shared memory), every code word names a
  window value or none, and the view bit marks the view's tiles."""
  t = ct.bake_atlas(CFG.size, CFG.view, CFG.item_rows, 'cpu').compact
  nbytes = sum(x.numel() * x.element_size()
               for x in (t.mat_tex, t.spr_tex, t.item_tex, t.code,
                         t.vignette))
  assert nbytes == 69812
  assert t.mat_tex.shape == (rules.N_MATERIALS + 1, 49)
  assert t.item_tex.shape == (rules.N_ITEMS, render_lib.N_AMOUNTS, 49)
  src1, view, off = render_lib._code_fields(t.code)
  n_view = CFG.local_grid[0] * CFG.local_grid[1]
  assert int(src1.max()) == 79 and bool((src1[view] <= n_view).all())
  assert bool((src1[~view & (src1 > 0)] > n_view).all())
  assert int(off[view].max()) == 48
  assert int(off.max()) < t.item_tex.numel()
  assert int(view.sum()) == 63 * 49


@pytest.mark.parametrize('size,view', [((128, 128), (16, 16)),
                                       ((256, 256), (64, 64))], ids=str)
def test_compact_tables_for_whole_area_views(size, view):
  """A view of the whole area (run_terrain) has windows of 256 and 4048
  values: the code words' source field widens to 9 and 12 bits, the
  tables still expand to the atlas, and the render through them equals
  ``render_win79_plain`` by day, at night and asleep."""
  atlas = ct.bake_atlas(size, view, 1, 'cpu')
  t = atlas.compact
  assert t.n_win == view[0] * (view[1] - 1) + 16
  assert t.src_bits == t.n_win.bit_length()
  planes = render_lib.expand_compact(t)
  for name in ('mat_planes', 'spr_planes', 'src', 'vignette', 'view_mask'):
    assert torch.equal(planes[name], getattr(atlas, name)), name
  src1, view_bit, _ = render_lib._code_fields(t.code, t.src_bits)
  assert int(src1.max()) == t.n_win and int(view_bit.sum()) > 0
  rs = np.random.RandomState(sum(size))
  n = 6
  mid = rs.randint(0, 14, size=(n, t.n_win - 16))
  tex = np.where(rs.rand(n, t.n_win - 16) < 0.3,
                 rs.randint(1, 15, size=(n, t.n_win - 16)), 0)
  win = T(np.concatenate([mid | (tex << 4), rs.randint(0, 10, size=(n, 16))],
                         1).astype(np.int32))
  light = ct.daylight(T(np.array([20, 150, 200, 250, 100, 280], np.int32)),
                      300)
  slp = T(np.array([0, 0, 1, 0, 1, 0], np.int32))
  seeds = T(rs.randint(-2 ** 31, 2 ** 31 - 1, size=n).astype(np.int32))
  assert bool((light < 0.5).any()) and bool((light >= 0.5).any())
  want = ct.render_win79_plain(win, light, slp, seeds, atlas)
  assert torch.equal(render_lib.render_win79_compact(win, light, slp, seeds,
                                                     t), want)


def _fma_frames():
  """The frames of :func:`test_fused_multiply_adds_placed_as_xla`."""
  picks = {101: [961, 113, 187, 298], 104: [219, 598, 121, 536]}
  win, light, seeds = [], [], []
  for seed, rows in picks.items():
    rs = np.random.RandomState(seed)
    mid = rs.randint(0, 14, size=(1024, 63))
    tex = np.where(rs.rand(1024, 63) < 0.3,
                   rs.randint(1, 15, size=(1024, 63)), 0)
    w = np.concatenate([mid | (tex << 4), rs.randint(0, 10, size=(1024, 16))],
                       1).astype(np.int32)
    steps = rs.randint(160, 262, size=1024).astype(np.int32)
    sd = rs.randint(-2 ** 31, 2 ** 31 - 1, size=1024).astype(np.int32)
    win.append(w[rows])
    light.append(ct.daylight(T(steps[rows]), 300).numpy())
    seeds.append(sd[rows])
  win, light, seeds = map(np.concatenate, (win, light, seeds))
  return win, light, np.zeros(len(win), np.int32), seeds


@pytest.mark.parametrize('case', ['day', 'night', 'sleeping', 'edge', 'fma',
                                  'wild'])
def test_compact_render_equals_plain(scenes, case):
  """The plain render through the compact tables (the kernel's reads, and
  its skip of the noise by day) equals ``render_win79_plain`` on the
  scenes' day, night, sleeping and edge frames, on the fused-multiply-add
  frames, and on rows of arbitrary int32 window values."""
  tatlas = scenes['tatlas']
  if case == 'fma':
    win, light, slp, seeds = map(T, _fma_frames())
  elif case == 'wild':
    rs = np.random.RandomState(11)
    win = T(rs.randint(-2 ** 31, 2 ** 31 - 1, size=(16, 79)).astype(np.int32))
    light = ct.daylight(T(np.arange(0, 300, 19, dtype=np.int32)), 300)
    slp = T(np.arange(16, dtype=np.int32) % 3 == 0)
    seeds = T(rs.randint(-2 ** 31, 2 ** 31 - 1, size=16).astype(np.int32))
  else:
    rows = scenes['cases'][case]
    f = scenes['f']
    win = T(scenes['win'][0][rows])
    light = ct.daylight(T(f['step'][rows]), 300)
    slp = T(f['sleeping'][rows])
    seeds = T(scenes['seeds'][0][rows])
  want = ct.render_win79_plain(win, light, slp, seeds, tatlas)
  got = render_lib.render_win79_compact(win, light, slp, seeds,
                                        tatlas.compact)
  assert torch.equal(got, want)
  if case == 'night':
    assert bool((light < 0.5).all())
  elif case == 'day':
    assert bool((light >= 0.5).all())


def test_render_wrapper_rejects_unknown_instantiation(scenes):
  f, tatlas = scenes['f'], scenes['tatlas']
  with pytest.raises(ValueError, match='instantiation'):
    render_cuda.render_win79(T(scenes['win'][0]),
                             ct.daylight(T(f['step']), 300),
                             T(f['sleeping']), T(scenes['seeds'][0]), tatlas,
                             CFG.size, 'frames', instantiation='texture')
