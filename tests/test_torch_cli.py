"""The port's CLIs on the CPU against the JAX package's.

* ``run_random --device cpu``: the single-env path with ``--record`` and
  ``--health 5`` prints the same resource counts as the JAX CLI for the same
  seed (both paths are seed-equal), writes the recorder's files and its
  health override reaches the env; ``--envs 8`` and ``--profile`` print the
  JAX CLI's lines and write the trace.
* ``run_terrain --device cpu --amount 2 --area 16 16 --size 128``: the PNG,
  decoded by imageio, equals the JAX CLI's image byte for byte; the PNG
  writer round-trips random images.
* ``run_gui``'s ``GuiSession`` under ``SDL_VIDEODRIVER=dummy``, mirroring
  ``tests/test_gui.py``, the drawn window equal to PIL's NEAREST resize of
  the frame.
* Every CLI refuses ``--device cuda`` without a card.

Tolerance: none.
"""

import argparse
import json
import os
import re
import sys
import zlib

import imageio.v3 as iio
import numpy as np
import pytest

from crafter_tpu import rules as jrules
from crafter_tpu_torch import rules
from crafter_tpu_torch import run_gui, run_random, run_terrain
from one_thread import one_torch_thread  # noqa: F401

os.environ.setdefault('SDL_VIDEODRIVER', 'dummy')


def _jax_main(module, argv, monkeypatch):
  monkeypatch.setattr(sys, 'argv', ['prog'] + argv)
  module.main()


@pytest.fixture()
def restore_rules():
  yield
  rules.override_rules(lambda r: None)
  jrules.override_rules(lambda r: None)


def _counts(text):
  return {m.group(1): int(m.group(2))
          for m in re.finditer(r'^(\w+) count: (\d+)$', text, re.M)}


def test_run_random_single_env_record_and_health(tmp_path, capsys,
                                                 monkeypatch, restore_rules):
  from crafter_tpu import run_random as jrun_random
  argv = ['--seed', '3', '--steps', '45', '--length', '30', '--health', '5']
  run_random.main(argv + ['--device', 'cpu', '--record',
                          str(tmp_path / 'rec')])
  ours = capsys.readouterr().out
  assert int(rules.TABLES.item_initial[rules.ITEM_HEALTH]) == 5
  _jax_main(jrun_random, argv, monkeypatch)
  theirs = capsys.readouterr().out
  assert re.search(r'^Reset time: [\d.]+ms$', ours, re.M)
  assert re.search(r'^Step time: [\d.]+ms \(\d+ fps\)$', ours, re.M)
  assert set(_counts(ours)) == {'Coal', 'Iron', 'Diamond'}
  assert _counts(ours) == _counts(theirs)
  rows = [json.loads(line) for line in
          (tmp_path / 'rec' / 'stats.jsonl').read_text().splitlines()]
  assert rows and rows[0]['length'] == 30
  assert list((tmp_path / 'rec').glob('*.npz'))
  assert list((tmp_path / 'rec').glob('*.gif'))


def test_run_random_envs_and_profile(tmp_path, capsys):
  run_random.main(['--device', 'cpu', '--envs', '8', '--steps', '24',
                   '--seed', '1', '--profile', str(tmp_path / 'trace')])
  out = capsys.readouterr().out
  assert re.search(r'^Batched reset time: [\d.]+ms \(8 envs\)$', out, re.M)
  assert re.search(r'^Step time: [\d.]+ms \(\d+ env-steps/s\)$', out, re.M)
  assert (tmp_path / 'trace' / 'trace.json').stat().st_size > 0


def test_run_terrain_png_equals_jax_cli(tmp_path, capsys, monkeypatch):
  from crafter_tpu import run_terrain as jrun_terrain
  argv = ['--amount', '2', '--area', '16', '16', '--size', '128']
  grid = run_terrain.main(argv + ['--device', 'cpu', '--filename',
                                  str(tmp_path / 'ours.png')])
  _jax_main(jrun_terrain, argv + ['--filename', str(tmp_path / 'theirs.png')],
            monkeypatch)
  assert 'Saved' in capsys.readouterr().out
  ours = iio.imread(tmp_path / 'ours.png')
  theirs = iio.imread(tmp_path / 'theirs.png')
  assert ours.shape == (128, 256, 3) and ours.dtype == np.uint8
  np.testing.assert_array_equal(ours, theirs)
  np.testing.assert_array_equal(ours, grid)


@pytest.mark.parametrize('shape', [(1, 1, 3), (7, 13, 3), (64, 33, 3)])
def test_png_bytes_round_trip(tmp_path, shape):
  image = np.random.default_rng(sum(shape)).integers(
      0, 256, shape).astype(np.uint8)
  data = run_terrain.png_bytes(image)
  (tmp_path / 'x.png').write_bytes(data)
  np.testing.assert_array_equal(iio.imread(tmp_path / 'x.png'), image)
  # One IDAT chunk holding every row behind its filter byte 0.
  start = data.index(b'IDAT') + 4
  length = int.from_bytes(data[start - 8:start - 4], 'big')
  rows = np.frombuffer(zlib.decompress(data[start:start + length]), np.uint8)
  rows = rows.reshape(shape[0], shape[1] * 3 + 1)
  assert (rows[:, 0] == 0).all()
  np.testing.assert_array_equal(rows[:, 1:].reshape(shape), image)


@pytest.mark.parametrize('module', [run_random, run_terrain, run_gui])
def test_cli_refuses_cuda_without_a_card(module):
  import torch
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  with pytest.raises(SystemExit, match='no CUDA device'):
    module.main([])


# --- run_gui: the session loop, headless (tests/test_gui.py) ---------------


@pytest.fixture()
def pygame():
  return pytest.importorskip('pygame')


def _args(**kw):
  ns = dict(seed=1, area=(64, 64), view=(9, 9), length=12, health=9,
            window=(96, 80), size=(64, 64), record=None, fps=1000,
            wait=False, death='reset', device='cpu')
  ns.update(kw)
  return argparse.Namespace(**ns)


def _session(pygame, **kw):
  import crafter_tpu_torch as ct
  args = _args(**kw)
  env = ct.Env(area=args.area, view=args.view, length=args.length,
               seed=args.seed, device='cpu')
  if args.record:
    env = ct.Recorder(env, args.record, save_video=False, save_episode=False)
  env.reset()
  pygame.init()
  return run_gui.GuiSession(env, args, pygame), env


def _drive(session, ticks):
  for _ in range(ticks):
    if not session.running:
      break
    session.draw()
    action = session.read_action()   # None headless -> noop
    session.advance(action or 'do')


class TestGuiSession:
  def test_draw_scales_like_pil_nearest(self, pygame):
    from PIL import Image
    session, env = _session(pygame)
    session.draw()
    frame = env.render(session.render_size)
    want = np.array(Image.fromarray(frame).resize(
        session.args.window, resample=Image.NEAREST))
    shown = pygame.surfarray.array3d(session.screen).transpose(1, 0, 2)
    np.testing.assert_array_equal(shown, want)
    pygame.quit()

  def test_death_reset_starts_new_episode(self, pygame, capsys):
    session, _ = _session(pygame, death='reset', length=6)
    _drive(session, 15)
    out = capsys.readouterr().out
    assert 'Episode done!' in out
    assert 'Starting a new episode.' in out
    assert session.running
    assert session.steps < 15
    pygame.quit()

  def test_death_quit_stops_the_loop(self, pygame, capsys):
    session, _ = _session(pygame, death='quit', length=4)
    _drive(session, 10)
    assert not session.running
    assert 'Episode done!' in capsys.readouterr().out
    pygame.quit()

  def test_record_writes_stats(self, pygame, tmp_path):
    rec_dir = tmp_path / 'rec'
    session, _ = _session(pygame, record=str(rec_dir), length=5, death='reset')
    _drive(session, 12)
    rows = [json.loads(line) for line in
            (rec_dir / 'stats.jsonl').read_text().splitlines()]
    assert rows and all(r['length'] == 5 for r in rows)
    pygame.quit()

  def test_run_loop_quits_on_escape_event(self, pygame):
    session, _ = _session(pygame, death='continue', length=50)
    pygame.event.post(pygame.event.Event(
        pygame.KEYDOWN, key=pygame.K_ESCAPE))
    session.run()
    assert not session.running

  def test_keymap_matches_jax_package(self):
    from crafter_tpu import run_gui as jrun_gui
    assert run_gui.KEYMAP_NAMES == jrun_gui.KEYMAP_NAMES
