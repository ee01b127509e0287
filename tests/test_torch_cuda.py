"""The CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc and skip without them.
Run on a GPU machine with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
The group and tick kernels are held on states stepped from fresh worlds,
on states packed with entities (``dense_states.py``, at 64 x 64 and on the
generic instantiation at 48 x 48) and on the hand-built scenes; the balance
kernel on such states at several chunk sizes and areas, the 3-D noise on
point counts, seeds and distances from the origin that reach each of its
branches.
Tolerance: none (bitwise), for every kernel.  The training step on the
card is held to its own checks (counts, finite metrics, launches): its
policy runs cuDNN's bfloat16 kernels, which no CPU run reproduces bit for
bit.
"""

import dataclasses
import math

import pytest
import torch

import crafter_tpu_torch as ct
from crafter_tpu_torch import convert
from crafter_tpu_torch import step as step_lib
from crafter_tpu_torch import render_cuda, step_cuda, worldgen
from crafter_tpu_torch.ops import noise, noise_cuda, roll_cuda
from crafter_tpu_torch import state as state_lib
from crafter_tpu_torch.state import leaves
import dense_states

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
  return torch.device('cuda')


def _assert_equal(a, b):
  for (pa, x), (_, y) in zip(leaves(a), leaves(b)):
    assert torch.equal(x, y.to(x.device)), pa


def test_kernels_match_plain_twins(dev):
  cfg = ct.EnvConfig()
  n = 96
  vs = ct.vec_reset(ct.home_keys(3, n, dev), cfg)
  gen = torch.Generator(device=dev)
  gen.manual_seed(1)
  for _ in range(4):
    acts = torch.randint(0, 17, (10, n), generator=gen, device=dev)
    got = step_cuda.group_tick(vs.env, acts, cfg)
    ref = step_lib.step_group_plain(vs.env, acts, cfg)
    for a, b in zip(got, ref):
      _assert_equal(a, b)
    seeds = step_lib.tick_seeds(got[0].key, got[0].step)[2]
    _assert_equal(step_cuda.balance(got[0], seeds, got[2], cfg),
                  step_lib.balance_plain(got[0], seeds, got[2], cfg))
    vs, _ = ct.vec_step_group(vs, acts, cfg, 32)
  pts, seeds = worldgen.noise_inputs(vs.env.key[:8], cfg)
  assert torch.equal(noise_cuda.noise2(pts, seeds),
                     noise.noise2_fast(pts, seeds))


def test_vec_step_group_kernel_path_equals_plain(dev):
  cfg = ct.EnvConfig(length=25)
  plain = dataclasses.replace(cfg, engine='plain', noise_mode='fast')
  va = ct.vec_reset(ct.home_keys(9, 13, dev), cfg)
  vb = ct.vec_reset(ct.home_keys(9, 13, dev), plain)
  vc = ct.vec_reset(ct.home_keys(9, 13, 'cpu'), cfg)
  gen = torch.Generator(device=dev)
  gen.manual_seed(2)
  for _ in range(3):
    acts = torch.randint(0, 17, (10, 13), generator=gen, device=dev)
    va, oa = ct.vec_step_group(va, acts, cfg, 4)
    vb, ob = ct.vec_step_group(vb, acts, plain, 4)
    vc, oc = ct.vec_step_group(vc, acts.cpu(), cfg, 4)
    _assert_equal(va, vb)
    _assert_equal(oa, ob)
    _assert_equal(va, vc)
    _assert_equal(oa, oc)


def test_worldgen_on_card_equals_cpu(dev):
  """The CPU worlds are held against the reference by the CPU tests; the
  card's, made through the noise kernel and the card's float32 math, must
  be the same in every leaf."""
  cfg = ct.EnvConfig()
  keys = ct.prng.fold_in(ct.home_keys(4, 320, dev), 1)
  before = noise_cuda.noise2.launches_by_rows.get(320, 0)
  _assert_equal(worldgen.generate_world(keys, cfg),
                worldgen.generate_world(keys.cpu(), cfg))
  # The card's worlds came through the kernel's shared form.
  assert noise_cuda.noise2.launches_by_rows[320] == before + 1


def test_compat_worldgen_on_card_equals_cpu(dev):
  """The 'compat' mode's permutation-table noise runs as plain PyTorch on
  the card (no kernel): its worlds must equal the CPU's, which the CPU
  tests hold to the JAX package, and it launches no 2-D noise kernel."""
  cfg = ct.EnvConfig(noise_mode='compat')
  keys = ct.prng.fold_in(ct.home_keys(6, 24, dev), 1)
  before = noise_cuda.noise2.launches
  _assert_equal(worldgen.generate_world(keys, cfg),
                worldgen.generate_world(keys.cpu(), cfg))
  assert noise_cuda.noise2.launches == before


def test_render_kernel_matches_plain_twin(dev):
  """Both outputs of the render kernel on frames of every kind: steps over
  a whole day (a share at night), a share sleeping, players at the edge."""
  cfg = ct.EnvConfig()
  n = 192
  vs = ct.vec_reset(ct.home_keys(5, n, dev), cfg)
  gen = torch.Generator(device=dev)
  gen.manual_seed(3)
  env = vs.env
  rnd = lambda hi: torch.randint(0, hi, (n,), generator=gen, device=dev,
                                 dtype=torch.int32)
  pos = torch.stack([rnd(64), rnd(64)], 1)
  pos[:8] = 0
  env = dataclasses.replace(
      env, step=rnd(300), player=dataclasses.replace(
          env.player, pos=pos, sleeping=rnd(4) == 0, facing=rnd(4)))
  atlas = ct.bake_atlas(cfg.size, cfg.view, cfg.item_rows, dev)
  win = ct.window_prep(
      ct.pack_cells(env.mat_map, env.ent.etype, env.ent.aux, env.ent.facing),
      env.player.pos, env.player.facing, env.player.sleeping,
      env.player.inventory, cfg)
  light = ct.daylight(env.step, cfg.day_length)
  seeds = ct.noise_seed(env.key, env.step)
  assert (light < 0.5).any() and env.player.sleeping.any()
  want = ct.render_win79_plain(win, light, env.player.sleeping, seeds, atlas)
  before = ct.render_win79.launches
  for fmt in ('packed', 'frames', 'words'):
    got = ct.render_win79(win, light, env.player.sleeping, seeds, atlas,
                          cfg.size, fmt)
    assert torch.equal(got, ct.render.format_pixels(want, cfg.size, fmt)), fmt
  assert ct.render_win79.launches == before + 3


def _frames(dev, n, night, seed):
  """``n`` frames of stepped worlds under players spread over the map (a
  share at its edge), a third asleep, all by day (``night`` False) or all
  at night (True), or over a whole day (None)."""
  cfg = ct.EnvConfig()
  gen = torch.Generator(device=dev)
  gen.manual_seed(seed)
  rnd = lambda hi, shape: torch.randint(0, hi, shape, generator=gen,
                                        device=dev, dtype=torch.int32)
  vs = ct.vec_reset(ct.home_keys(seed, 16, dev), cfg)
  env = vs.env
  pick = rnd(16, (n,)).long()
  packed = ct.pack_cells(env.mat_map, env.ent.etype, env.ent.aux,
                         env.ent.facing)[pick]
  pos = rnd(64, (n, 2))
  pos[::7] = 0
  slp = rnd(3, (n,)) == 0
  steps = rnd(300, (n,))
  if night is not None:
    steps = steps % 100 + (160 if night else 20)     # night: 148..272
  win = ct.window_prep(packed, pos, rnd(4, (n,)), slp, rnd(13, (n, 16)), cfg)
  light = ct.daylight(steps, cfg.day_length)
  if night is not None:
    assert bool(((light < 0.5) == night).all())
  return win, light, slp, ct.noise_seed(env.key[pick], steps)


@pytest.mark.parametrize('instantiation', ['shared', 'global'])
@pytest.mark.parametrize('n', [1, 13, 4097])
@pytest.mark.parametrize('night', [False, True, None], ids=['day', 'night',
                                                          'mixed'])
def test_render_instantiations_match_twin(dev, instantiation, n, night):
  """Both instantiations of the render kernel, in all three formats, on
  frame counts that do not divide a block's work, by day, at night and
  mixed: bit for bit the plain twin."""
  cfg = ct.EnvConfig()
  atlas = ct.bake_atlas(cfg.size, cfg.view, cfg.item_rows, dev)
  win, light, slp, seeds = _frames(dev, n, night, 10 + n)
  want = ct.render_win79_plain(win, light, slp, seeds, atlas)
  before = ct.render_win79.launches
  for fmt in ('packed', 'frames', 'words'):
    got = ct.render_win79(win, light, slp, seeds, atlas, cfg.size, fmt,
                          instantiation=instantiation)
    assert torch.equal(got, ct.render.format_pixels(want, cfg.size, fmt)), fmt
  assert ct.render_win79.launches == before + 3


@pytest.mark.parametrize('instantiation', ['shared', 'global'])
def test_render_daylight_outside_unit_interval(dev, instantiation):
  """Daylight outside [0, 1] takes the kernel's branch with conversion
  instructions (its floors may see negative arguments there): still the
  twin's bytes."""
  cfg = ct.EnvConfig()
  atlas = ct.bake_atlas(cfg.size, cfg.view, cfg.item_rows, dev)
  win, light, slp, seeds = _frames(dev, 13, None, 31)
  light = torch.tensor([-0.5, 1.25, 2.0, -3.0, 0.75] * 2 + [1.0, 0.0, 0.5],
                       device=dev)
  want = ct.render_win79_plain(win, light, slp, seeds, atlas)
  for fmt in ('packed', 'frames'):
    got = ct.render_win79(win, light, slp, seeds, atlas, cfg.size, fmt,
                          instantiation=instantiation)
    assert torch.equal(got, ct.render.format_pixels(want, cfg.size, fmt)), fmt


def _whole_area_frames(dev, area, size, n, seed):
  """``n`` frames of worlds viewed whole (view = area, run_terrain's
  shape): players anywhere, a third asleep, steps over a whole day."""
  cfg = ct.EnvConfig(area=area, view=area, size=size)
  gen = torch.Generator(device=dev)
  gen.manual_seed(seed)
  rnd = lambda hi, shape: torch.randint(0, hi, shape, generator=gen,
                                        device=dev, dtype=torch.int32)
  env = ct.vec_reset(ct.home_keys(seed, n, dev), cfg).env
  win = ct.window_prep(
      ct.pack_cells(env.mat_map, env.ent.etype, env.ent.aux, env.ent.facing),
      torch.stack([rnd(area[0], (n,)), rnd(area[1], (n,))], 1),
      rnd(4, (n,)), rnd(3, (n,)) == 0, rnd(13, (n, 16)), cfg)
  steps = rnd(300, (n,))
  atlas = ct.bake_atlas(size, cfg.view, cfg.item_rows, dev)
  return (win, ct.daylight(steps, cfg.day_length), rnd(3, (n,)) == 0,
          ct.noise_seed(env.key, steps), atlas, cfg)


@pytest.mark.parametrize('area,size,n', [((16, 16), (128, 128), 13),
                                         ((64, 64), (256, 256), 9),
                                         ((64, 64), (1024, 1024), 4)])
def test_render_kernel_whole_area_view(dev, area, size, n):
  """A view of the whole area (run_terrain): windows of one value a world
  cell and 16 (256 and 4048 here, past the 128 staged in shared memory
  and the 8-bit source field), both instantiations where they fit: bit
  for bit the twin."""
  win, light, slp, seeds, atlas, cfg = _whole_area_frames(dev, area, size, n,
                                                          area[0] + n)
  assert win.shape[1] == area[0] * (area[1] - 1) + 16 == atlas.compact.n_win
  want = ct.render_win79_plain(win, light, slp, seeds, atlas)
  before = ct.render_win79.launches
  insts = ['global'] + (['shared'] if render_cuda.occupancy(atlas)[0] else [])
  for inst in insts:
    for fmt in ('packed', 'frames'):
      got = ct.render_win79(win, light, slp, seeds, atlas, size, fmt,
                            instantiation=inst)
      assert torch.equal(got, ct.render.format_pixels(want, size, fmt)), (
          inst, fmt)
  assert ct.render_win79.launches == before + 2 * len(insts)
  with pytest.raises(ValueError, match='do not match the atlas'):
    ct.render_win79(win[:, :-1], light, slp, seeds, atlas, size)


def test_render_kernel_at_512(dev):
  """At 512 x 512 the tables do not fit in shared memory: 'auto' takes the
  global instantiation, and it equals the twin."""
  cfg = ct.EnvConfig(size=(512, 512))
  atlas = ct.bake_atlas(cfg.size, cfg.view, cfg.item_rows, dev)
  assert render_cuda.occupancy(atlas, True)[0] == 0
  assert render_cuda.occupancy(atlas, False)[0] >= 1
  blocks, smem = render_cuda.occupancy(
      ct.bake_atlas((64, 64), cfg.view, cfg.item_rows, dev), True)
  assert blocks >= 2 and smem > 48 * 1024, (blocks, smem)
  with pytest.raises(ValueError, match='shared memory'):
    render_cuda.render_win79(*_frames(dev, 2, None, 3), atlas, cfg.size,
                             instantiation='shared')
  win, light, slp, seeds = _frames(dev, 24, None, 4)
  want = ct.render_win79_plain(win, light, slp, seeds, atlas)
  for fmt in ('packed', 'frames'):
    got = ct.render_win79(win, light, slp, seeds, atlas, cfg.size, fmt)
    assert torch.equal(got, ct.render.format_pixels(want, cfg.size, fmt)), fmt


@pytest.mark.parametrize('worlds', [1, 32, 320])
def test_noise2_shared_kernel_matches_twin(dev, worlds):
  """The shared form of the 2-D noise kernel, as worldgen calls it, against
  its twin; and the per-point form on the same inputs expanded."""
  cfg = ct.EnvConfig()
  keys = ct.prng.fold_in(ct.home_keys(12, worlds, dev), 3)
  pts = worldgen.channel_points(cfg, dev).reshape(13, -1, 2)
  seeds = worldgen.noise_seeds(keys)
  before = dict(noise_cuda.noise2.launches_by_rows)
  got = noise_cuda.noise2(pts, seeds)
  assert torch.equal(got, noise.noise2_shared(pts, seeds))
  assert noise_cuda.noise2.launches_by_rows[worlds] == before.get(
      worlds, 0) + 1
  flat = noise_cuda.noise2(*worldgen.noise_inputs(keys, cfg))
  assert torch.equal(flat, got.reshape(-1))
  # Point counts that are not a multiple of the 4 a thread makes.
  odd = pts[:, :4093].contiguous()
  assert torch.equal(noise_cuda.noise2(odd, seeds),
                     noise.noise2_shared(odd, seeds))


def test_noise2_far_points_match_twin(dev):
  """Points whose base corner lies 2^22 or more from the origin take the
  kernel's branch with conversion instructions: still the twin's bits."""
  gen = torch.Generator(device=dev)
  gen.manual_seed(9)
  pts = (torch.rand(100003, 2, generator=gen, device=dev) - 0.5) \
      * torch.tensor([400.0, 3e7], device=dev)
  seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (100003,), generator=gen,
                        device=dev, dtype=torch.int32)
  assert bool((pts[:, 1].abs() > 2 ** 23).any())
  assert torch.equal(noise_cuda.noise2(pts, seeds),
                     noise.noise2_fast(pts, seeds))


def test_snapshots_and_tick_kernel_match_plain_twins(dev):
  cfg = ct.EnvConfig()
  n = 96
  vs = ct.vec_reset(ct.home_keys(6, n, dev), cfg)
  gen = torch.Generator(device=dev)
  gen.manual_seed(4)
  for _ in range(3):
    acts = torch.randint(0, 17, (10, n), generator=gen, device=dev)
    got = step_cuda.group_tick(vs.env, acts, cfg, snapshots=True)
    ref = step_lib.step_group_plain(vs.env, acts, cfg, snapshots=True)
    for a, b in zip(got[:3], ref[:3]):
      _assert_equal(a, b)
    assert torch.equal(got[3].packed[:-1], ref[3].packed[:-1])
    for name in ('px', 'py', 'facing', 'sleeping', 'inv'):
      assert torch.equal(getattr(got[3], name), getattr(ref[3], name)), name
    sp, sm, _ = step_lib.tick_seeds(vs.env.key, vs.env.step + 1)
    _assert_equal(step_cuda.tick(vs.env, acts[0], sp, sm, cfg),
                  step_lib.tick_plain(vs.env, acts[0], sp, sm, cfg))
    vs, _ = ct.vec_step_group(vs, acts, cfg, 32)


def test_pixel_and_per_tick_paths_on_card_equal_cpu(dev):
  cfg = ct.EnvConfig(length=25)
  ca, cb = ct.CrafterEnv(cfg, dev), ct.CrafterEnv(cfg, 'cpu')
  va = ct.vec_reset(ct.home_keys(9, 13, dev), cfg)
  vb = ct.vec_reset(ct.home_keys(9, 13, 'cpu'), cfg)
  gen = torch.Generator(device=dev)
  gen.manual_seed(5)
  for _ in range(3):
    acts = torch.randint(0, 17, (10, 13), generator=gen, device=dev)
    va, oa, fa = ct.vec_step_group_obs(va, acts, cfg, 4, ca)
    vb, ob, fb = ct.vec_step_group_obs(vb, acts.cpu(), cfg, 4, cb)
    _assert_equal(va, vb)
    _assert_equal(oa, ob)
    assert torch.equal(fa.cpu(), fb)
  ea = ct.VecEnv(13, cfg, seed=2, reset_batch=4, device=dev)
  eb = ct.VecEnv(13, cfg, seed=2, reset_batch=4, device='cpu')
  assert torch.equal(ea.reset().cpu(), eb.reset())
  for _ in range(30):
    acts = torch.randint(0, 17, (13,), generator=gen, device=dev)
    ra, rb = ea.step(acts), eb.step(acts.cpu())
    for x, y in zip(ra[:3], rb[:3]):
      assert torch.equal(x.cpu(), y)
    for name in ra[3]:
      assert torch.equal(ra[3][name].cpu(), rb[3][name]), name
  steps = torch.arange(0, 10001, dtype=torch.int32)
  assert torch.equal(ct.daylight(steps.to(dev), 300).cpu(),
                     ct.daylight(steps, 300))


def _check_tick_kernels(dev, cfg, tree, acts):
  """The group tick (K = acts.shape[0], with and without snapshots) and
  the tick kernel against their twins on the state ``tree``."""
  states = convert.state_from_numpy(tree, dev)
  acts = torch.as_tensor(acts, device=dev)
  for snaps in (False, True):
    got = step_cuda.group_tick(states, acts, cfg, snapshots=snaps)
    ref = step_lib.step_group_plain(states, acts, cfg, snapshots=snaps)
    for a, b in zip(got[:3], ref[:3]):
      _assert_equal(a, b)
    if snaps:
      assert torch.equal(got[3].packed[:-1], ref[3].packed[:-1])
      for name in ('px', 'py', 'facing', 'sleeping', 'inv'):
        assert torch.equal(getattr(got[3], name), getattr(ref[3], name))
  sp, sm, _ = step_lib.tick_seeds(states.key, states.step + 1)
  _assert_equal(step_cuda.tick(states, acts[0], sp, sm, cfg),
                step_lib.tick_plain(states, acts[0], sp, sm, cfg))


@pytest.mark.parametrize('area', [(64, 64), (48, 48)])
def test_tick_kernels_on_dense_states(dev, area):
  """States packed with entities; 48 x 48 runs the generic instantiation."""
  cfg = ct.EnvConfig(area=area)
  tree = dense_states.dense_states(128, 5, area, cfg.update_distance)
  gen = torch.Generator().manual_seed(8)
  acts = torch.randint(0, 17, (10, 128), generator=gen)
  _check_tick_kernels(dev, cfg, tree, acts)


def test_tick_kernels_on_scenes(dev):
  tree, acts = dense_states.scene_states()
  _check_tick_kernels(dev, ct.EnvConfig(), tree,
                      acts[[t % 2 for t in range(10)]])


def test_tick_kernel_occupancy(dev):
  for kernel in ('group', 'tick'):
    blocks, smem = step_cuda.occupancy(ct.EnvConfig(), kernel)
    assert blocks >= 5 and smem <= 46 * 1024, (kernel, blocks, smem)


SWEEP_GEOMETRIES = [(128, 5), (256, 5), (256, 4), (512, 4)]


@pytest.mark.parametrize('geometry', SWEEP_GEOMETRIES, ids=str)
def test_group_tick_geometry_variants_match(dev, geometry):
  """Each geometry of tools/sweep_group_block_cuda.py's default sweep (a
  build of its own but for the shipped 256:5): the group tick with and
  without snapshots equals the shipped build's and the plain twin's on
  dense states, and the launches are counted."""
  cfg = ct.EnvConfig()
  states = convert.state_from_numpy(
      dense_states.dense_states(128, 7, cfg.area, cfg.update_distance), dev)
  gen = torch.Generator().manual_seed(9)
  acts = torch.randint(0, 17, (10, 128), generator=gen).to(dev)
  for snaps in (False, True):
    before = step_cuda.group_tick.launches
    got = step_cuda.group_tick(states, acts, cfg, snapshots=snaps,
                               geometry=geometry)
    assert step_cuda.group_tick.launches == before + 1
    shipped = step_cuda.group_tick(states, acts, cfg, snapshots=snaps)
    ref = step_lib.step_group_plain(states, acts, cfg, snapshots=snaps)
    for a, b, c in zip(got[:3], shipped[:3], ref[:3]):
      _assert_equal(a, b)
      _assert_equal(a, c)
    if snaps:
      assert torch.equal(got[3].packed[:-1], ref[3].packed[:-1])
      assert torch.equal(got[3].packed[:-1], shipped[3].packed[:-1])
      for name in ('px', 'py', 'facing', 'sleeping', 'inv'):
        assert torch.equal(getattr(got[3], name), getattr(ref[3], name))


@pytest.mark.parametrize('geometry', SWEEP_GEOMETRIES, ids=str)
def test_group_tick_geometry_occupancy(dev, geometry):
  """The variant library's occupancy: at least the minimum blocks its
  launch bounds ask for (the shared memory allows 5 at 64 x 64), no more
  threads than an SM holds; the shipped geometry reports the default's."""
  threads, min_blocks = geometry
  cfg = ct.EnvConfig()
  for kernel in ('group', 'tick'):
    blocks, smem = step_cuda.occupancy(cfg, kernel, geometry=geometry)
    default = step_cuda.occupancy(cfg, kernel)
    assert min_blocks <= blocks and blocks * threads <= 2048, (kernel, blocks)
    assert smem == default[1]
    if geometry == (256, 5):
      assert blocks == default[0]


def test_render_formats_agree_at_4096(dev):
  """The render kernel's three output formats on 4096 frames of real
  windows (tools/bench_unpack_cuda.py's check): frames == the bytes of the
  packed lanes == the words."""
  cfg = ct.EnvConfig()
  atlas = ct.bake_atlas(cfg.size, cfg.view, cfg.item_rows, dev)
  args = _frames(dev, 4096, None, 11)
  frames, lanes, words = (
      ct.render_win79(*args, atlas, cfg.size, fmt)
      for fmt in ('frames', 'packed', 'words'))
  assert torch.equal(frames, ct.render.frame_image(lanes, cfg.size))
  assert torch.equal(words.view(torch.uint8).reshape(frames.shape), frames)


def test_noise3_kernel_matches_plain_twin(dev):
  gen = torch.Generator(device=dev)
  gen.manual_seed(6)
  pts = (torch.rand(100003, 3, generator=gen, device=dev) - 0.5) * 100
  seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (100003,), generator=gen,
                        device=dev, dtype=torch.int32)
  before = noise_cuda.noise3.launches
  for seed in (77, -5, seeds):
    assert torch.equal(noise_cuda.noise3(pts, seed),
                       noise.noise3_fast(pts, seed))
  grid = pts[:99999].reshape(3, 33333, 3)
  assert torch.equal(noise_cuda.noise3(grid, seeds[:3, None]),
                     noise.noise3_fast(grid, seeds[:3, None]))
  assert noise_cuda.noise3.launches == before + 4


@pytest.mark.parametrize('n', [1, 13, 4099])
def test_noise3_kernel_sizes_and_seeds_match_twin(dev, n):
  """Point counts that do not fill a thread's four, one seed and a seed a
  point, and points read from an unaligned view (the scalar loads)."""
  gen = torch.Generator(device=dev)
  gen.manual_seed(60 + n)
  pts = (torch.rand(n + 1, 3, generator=gen, device=dev) - 0.5) * 200
  seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (n + 1,), generator=gen,
                        device=dev, dtype=torch.int32)
  for p, sd in ((pts[:n], seeds[:n]), (pts[1:], seeds[1:]),
                (pts[:n], -123456789), (pts[1:], 2 ** 31 - 1)):
    assert torch.equal(noise_cuda.noise3(p, sd), noise.noise3_fast(p, sd))


@pytest.mark.parametrize('scale', [2.0 ** 22, 2.0 ** 24])
def test_noise3_far_points_match_twin(dev, scale):
  """Points around and beyond 2^22 of the origin, where the kernel leaves
  its round-down additions for the conversions: still the twin's bits."""
  gen = torch.Generator(device=dev)
  gen.manual_seed(61)
  n = 40003
  sign = torch.randint(0, 2, (n, 3), generator=gen, device=dev) * 2 - 1
  pts = sign * (scale + (torch.rand(n, 3, generator=gen, device=dev) - 0.5)
                * scale / 4)
  pts[: n // 2] = sign[: n // 2] * (2.0 ** 22 + torch.randint(
      -64, 64, (n // 2, 3), generator=gen, device=dev).float())
  seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                        device=dev, dtype=torch.int32)
  for sd in (seeds, 99):
    assert torch.equal(noise_cuda.noise3(pts, sd), noise.noise3_fast(pts, sd))


# (area, chunk size): the default; the largest chunk the configuration
# check accepts (16 x 16 is 256 cells, beyond the 8-bit counts); a ragged
# odd one; heights that are no multiple of 16 (the kernel's generic loads).
BALANCE_CASES = [((64, 64), (12, 12)), ((64, 64), (16, 15)),
                 ((64, 64), (5, 7)), ((48, 40), (12, 12)),
                 ((37, 29), (5, 7))]


@pytest.mark.parametrize('n', [1, 13, 4096])
@pytest.mark.parametrize('area,chunk', BALANCE_CASES, ids=str)
def test_balance_kernel_matches_twin(dev, n, area, chunk):
  """The balance kernel on dense states at day length 200 with steps past
  10000, a third of the worlds all grass, with and without an occupancy
  plane: every leaf the twin's, and the input state untouched."""
  cfg = ct.EnvConfig(area=area, chunk_size=chunk, day_length=200)
  states = convert.state_from_numpy(
      dense_states.balance_states(n, 70 + n, area, chunk), dev)
  keep = [t.clone() for _, t in leaves(states)]
  seeds = step_lib.tick_seeds(states.key, states.step)[2]
  gen = torch.Generator(device=dev)
  gen.manual_seed(n)
  occ = (torch.rand(states.ent.etype.shape, generator=gen, device=dev)
         < 0.05).to(torch.uint8)
  before = step_cuda.balance.launches
  for o in (None, occ):
    got = step_cuda.balance(states, seeds, o, cfg)
    _assert_equal(got, step_lib.balance_plain(states, seeds, o, cfg))
    if n > 1:
      assert bool((got.ent.etype != states.ent.etype).any())
  assert step_cuda.balance.launches == before + 2
  for (name, t), k in zip(leaves(states), keep):
    assert torch.equal(t, k), name


def test_balance_wrapper_reads_strided_inputs_and_checks(dev):
  """The player's position, the steps and the seeds are read with their
  strides; a wrong dtype or a strided plane raises."""
  cfg = ct.EnvConfig()
  states = convert.state_from_numpy(dense_states.balance_states(64, 5), dev)
  seeds = step_lib.tick_seeds(states.key, states.step)[2]
  want = step_lib.balance_plain(states, seeds, None, cfg)
  wide = torch.zeros((64, 5), dtype=torch.int32, device=dev)
  wide[:, 1:3] = states.player.pos
  spread = torch.zeros((64, 2), dtype=torch.int32, device=dev)
  spread[:, 0], spread[:, 1] = seeds, states.step
  odd = dataclasses.replace(
      states, step=spread[:, 1],
      player=dataclasses.replace(states.player, pos=wide[:, 1:3]))
  got = step_cuda.balance(odd, spread[:, 0], None, cfg)
  _assert_equal(got.ent, want.ent)
  assert torch.equal(got.chunk_touched, want.chunk_touched)
  with pytest.raises(TypeError, match='seeds'):
    step_cuda.balance(states, seeds.long(), None, cfg)
  strided = dataclasses.replace(states, mat_map=torch.cat(
      [states.mat_map, states.mat_map], 1)[:, ::2])
  with pytest.raises(TypeError, match='contiguous'):
    step_cuda.balance(strided, seeds, None, cfg)
  blocks, smem = step_cuda.balance_occupancy(cfg)
  assert blocks >= 4 and smem < 8 * 1024, (blocks, smem)


@pytest.mark.parametrize('day_length', [200, 300])
def test_daylight_on_card_equals_cpu(dev, day_length):
  """The daylight kernel and the plain form on the card, both equal to the
  CPU's, on steps 0..20000, negative and extreme ones, and a strided view."""
  steps = torch.cat([torch.arange(0, 20001, dtype=torch.int32),
                     torch.arange(-300, 0, dtype=torch.int32),
                     torch.tensor([2 ** 31 - 1, -2 ** 31], dtype=torch.int32)])
  want = ct.daylight(steps, day_length)
  before = ct.daylight.launches
  assert torch.equal(ct.daylight(steps.to(dev), day_length).cpu(), want)
  assert ct.daylight.launches == before + 1
  assert torch.equal(
      state_lib.daylight_plain(steps.to(dev), day_length).cpu(), want)
  grid = steps[:20000].to(dev).reshape(100, 200)
  assert torch.equal(ct.daylight(grid[:, ::3], day_length).cpu(),
                     want[:20000].reshape(100, 200)[:, ::3])
  with pytest.raises(TypeError, match='int32'):
    ct.daylight(steps.to(dev).long(), day_length)


@pytest.mark.parametrize('kind', roll_cuda.KINDS)
def test_roll_kernel_matches_plain_twin(dev, kind):
  """Bitwise against the twin at stage counts that reach every branch (none,
  one, a whole and a wrapped cycle of the 12 bits, 40) on row counts below,
  off a multiple of and far above the persistent grid; the input stays as
  it was and every call counts one launch."""
  gen = torch.Generator(device=dev)
  gen.manual_seed(7)
  for rows in (1, 13, 4099, 40960):
    x = torch.randint(0, 1 << 24, (rows, 4096), generator=gen, device=dev,
                      dtype=torch.int32)
    x0 = x.clone()
    for stages in (0, 1, 10, 12, 13, 40):
      before = roll_cuda.roll_stages.launches
      got = roll_cuda.roll_stages(x, kind, stages)
      assert roll_cuda.roll_stages.launches == before + 1
      assert torch.equal(got, roll_cuda.roll_stages_plain(x, kind, stages)), \
          (rows, stages)
    assert torch.equal(x, x0), rows


def test_roll_kernel_copies_an_unaligned_view(dev):
  """A view whose rows are not 16-byte aligned (the bulk copy's rule) is
  copied into an aligned tensor, not handed to the twin: one launch a
  call, the result the twin's, the view untouched."""
  gen = torch.Generator(device=dev)
  gen.manual_seed(8)
  base = torch.randint(0, 1 << 24, (13 * 4096 + 1,), generator=gen,
                       device=dev, dtype=torch.int32)
  x = base[1:].view(13, 4096)
  assert x.data_ptr() % 16 != 0
  x0 = x.clone()
  for kind in roll_cuda.KINDS:
    before = roll_cuda.roll_stages.launches
    got = roll_cuda.roll_stages(x, kind, 13)
    assert roll_cuda.roll_stages.launches == before + 1
    assert torch.equal(got, roll_cuda.roll_stages_plain(x0, kind, 13)), kind
  assert torch.equal(x, x0)
  empty = torch.empty((0, 4096), dtype=torch.int32, device=dev)
  before = roll_cuda.roll_stages.launches
  assert roll_cuda.roll_stages(empty, 'roll', 10).shape == (0, 4096)
  assert roll_cuda.roll_stages.launches == before
  for kind in roll_cuda.KINDS:
    blocks, smem, depth = roll_cuda.occupancy(kind)
    assert blocks >= 3 and depth >= 2 and smem > depth * 4096 * 4, kind


def test_env_on_card_equals_cpu(dev):
  """``Env`` on the card and on the CPU over two short episodes: frames,
  rewards, flags and info equal, and the render at 512x512 (the render
  kernel's global instantiation) too."""
  card = ct.Env(seed=5, length=30, device=dev)
  cpu = ct.Env(seed=5, length=30, device='cpu')
  rs = torch.Generator()
  rs.manual_seed(5)
  assert (card.reset() == cpu.reset()).all()
  launches = (step_cuda.tick.launches, ct.render_win79.launches)
  episodes = 0
  while episodes < 2:
    action = int(torch.randint(0, 17, (), generator=rs))
    a, b = card.step(action), cpu.step(action)
    assert (a[0] == b[0]).all() and a[1:3] == b[1:3]
    for name, value in b[3].items():
      assert (a[3][name] == value) if not hasattr(value, 'shape') else \
          (a[3][name] == value).all() and a[3][name].dtype == value.dtype, \
          name
    if a[2]:
      episodes += 1
      assert (card.reset() == cpu.reset()).all()
  assert (card.render((512, 512)) == cpu.render((512, 512))).all()
  now = (step_cuda.tick.launches, ct.render_win79.launches)
  assert all(b > a for a, b in zip(launches, now)), (launches, now)


def test_reset_pass_spans_on_card(dev):
  """The program's spans and counters on the card: ``worlds_made`` is
  ``min(reset_batch, n)`` on every pass whatever finished, ``envs_reset``
  adds up to the episodes started, and a traced group with a sink set runs
  as many device operations as without one (the profiler's device copies
  of the ``crafter.`` ranges are annotations, not operations)."""
  from crafter_tpu_torch.utils import profiling
  cfg = ct.EnvConfig(length=25)      # no env finishes in the first groups
  n, batch = 64, 16
  vs = ct.vec_reset(ct.home_keys(5, n, dev), cfg)
  gen = torch.Generator(device=dev)
  gen.manual_seed(3)
  acts = [torch.randint(0, 17, (10, n), generator=gen, device=dev)
          for _ in range(4)]
  ct.vec_step_group(vs, acts[0], cfg, batch)        # builds the kernels

  def traced(sink):
    profiling.set_sink(sink)
    try:
      with torch.profiler.profile(activities=[
          torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = ct.vec_step_group(vs, acts[0], cfg, batch)
        torch.cuda.synchronize()
    finally:
      profiling.set_sink(None)
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    ops = sum(1 for e in events if e.device_type == cuda
              and not getattr(e, 'is_user_annotation', False))
    return out, ops, {e.name for e in events}

  plain, ops, names = traced(None)
  spanned, ops_spanned, names_spanned = traced(profiling.Collector(dev))
  for a, b in zip(plain, spanned):
    _assert_equal(a, b)
  assert ops_spanned == ops > 0
  assert not any(name.startswith('crafter.') for name in names)
  assert {'crafter.reset_pass', 'crafter.generate_world'} <= names_spanned

  counts = []

  class Counts(profiling.Collector):
    def count(self, name, value, limit=None):
      counts.append((name, value, limit))

  profiling.set_sink(Counts(dev))
  try:
    start = int(vs.episode.sum())
    for a in acts:
      vs, _ = ct.vec_step_group(vs, a, cfg, batch)
  finally:
    profiling.set_sink(None)
  made = [v for name, v, _ in counts if name == 'worlds_made']
  assert made == [min(batch, n)] * len(acts)
  reset = [(v, lim) for name, v, lim in counts if name == 'envs_reset']
  assert profiling.counted(reset) == int(vs.episode.sum()) - start > 0
  assert min(int(v) for v, _ in reset) < batch


def test_train_step_on_card(dev):
  cfg = ct.PPOConfig(num_envs=16, rollout_len=10, epochs=2, minibatches=2,
                     reset_batch=4)
  ppo = ct.PPO(ct.EnvConfig(length=12), cfg, device=dev)
  ts = ppo.init(ct.prng.key(0, dev))
  before = {name: p.detach().clone()
            for name, p in ts.params.named_parameters()}
  launches = (step_cuda.tick.launches, ct.render_win79.launches,
              step_cuda.balance.launches, noise_cuda.noise2.launches)
  for _ in range(2):
    ts, metrics, stats = ppo.train_step_with_stats(ts)
  assert ts.update == 2 and ts.env_steps == 2 * 16 * 10
  for name, v in metrics.items():
    assert math.isfinite(float(v)), name
  assert 0 < float(metrics['entropy']) <= math.log(17) + 1e-6
  assert all(not torch.equal(before[name], p.detach())
             for name, p in ts.params.named_parameters())
  # An episode cap of 12 ticks ends every env inside the second rollout.
  assert int(stats['count']) + int(stats['dropped']) == int(
      metrics['episodes_done']) >= 16
  now = (step_cuda.tick.launches, ct.render_win79.launches,
         step_cuda.balance.launches, noise_cuda.noise2.launches)
  assert all(b > a for a, b in zip(launches, now)), (launches, now)


def test_one_rank_nccl_sharded_group_step_equals_vec_step_group(dev):
  """The multi-device group step on a real NCCL group of one rank: bitwise
  the one-process group step, across episode ends and a reset budget that
  overflows; ``psum_stats`` through NCCL is the identity on one rank."""
  import socket
  import torch.distributed as dist
  from crafter_tpu_torch.parallel import mesh as mesh_lib
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
  mesh_lib.distributed_init(f'127.0.0.1:{port}', 1, 0, backend='nccl')
  try:
    assert dist.get_backend() == 'nccl'
    mesh = mesh_lib.dp_mesh()
    cfg = ct.EnvConfig(length=25)
    n = 96
    step = mesh_lib.make_sharded_group_step(mesh, cfg, 8)
    va = ct.vec_reset(ct.home_keys(9, n, dev), cfg)
    vb = mesh_lib.shard_batch(va, mesh, n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for _ in range(3):
      acts = torch.randint(0, 17, (10, n), generator=gen, device=dev)
      va, oa = ct.vec_step_group(va, acts, cfg, 8)
      vb, ob = step(vb, acts)
      _assert_equal(va, vb)
      _assert_equal(oa, ob)
    assert int(va.episode.sum()) > n and int(va.pending.sum()) > 0
    hp = vb.env.player.inventory[:, 0]
    assert torch.equal(mesh_lib.psum_stats(hp, mesh), hp)
  finally:
    dist.destroy_process_group()
