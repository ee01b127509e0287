"""The FLOP count and the byte bounds, against hand-worked shapes."""

import types

import pytest
import torch

from benchmark import flops, harness


def test_naturecnn_forward_flops():
  layers = dict(flops.layer_flops())
  assert layers == {'conv1': 15 * 15 * 32 * 192 * 2,
                    'conv2': 6 * 6 * 64 * 512 * 2,
                    'conv3': 4 * 4 * 64 * 576 * 2,
                    'dense': 1024 * 512 * 2, 'heads': 512 * 18 * 2}
  assert flops.forward_flops() == 7_370_752
  assert flops.train_flops() == 3 * 7_370_752 - 2_764_800
  update = flops.ppo_update_flops(4096, 64, 3)
  assert update == 65 * 4096 * 7_370_752 + 3 * 262144 * 19_347_456
  assert update == pytest.approx(17.18e12, rel=1e-3)


def _group_tick_bytes(n, k, cfg):
  """One group call's tensors, read once and written once, worked by hand:
  the env state in; the state out, less the key and the touched chunks,
  which the call passes through; the (K, N) int32 actions; the (K, N)
  results (float32 reward, bool done and dead; ``ended`` is ``done`` there)
  and the (N, C) uint8 occupancy."""
  import crafter_tpu_torch.rules as rules
  c = cfg.area[0] * cfg.area[1]
  ncx, ncy = cfg.n_chunks
  planes = c * (1 + 1 + 1 + 2 + 1)       # mat, etype, health, aux, facing
  player = (4 * (2 + 1 + rules.N_ITEMS + rules.N_ACHIEVEMENTS + 5)
            + 1)                         # ... and the bool sleeping
  scalars = 4 + rules.N_ACHIEVEMENTS + 4   # step, unlocked, last health
  key, touched = 2 * 8, ncx * ncy
  state_in = n * (planes + player + scalars + key + touched)
  state_out = n * (planes + player + scalars)
  results = k * n * (4 + 1 + 1)
  return state_in + state_out + k * n * 4 + results + n * c


def test_group_tick_bytes_match_hand_count():
  import crafter_tpu_torch as ct
  cfg = ct.EnvConfig()
  n, k = 4, cfg.balance_every
  vs = ct.vec_reset(ct.home_keys(0, n, 'cpu'), cfg)
  actions = torch.zeros((k, n), dtype=torch.int32)
  out = ct.group_tick(vs.env, actions, cfg)
  seen = set()
  got = harness.tensor_bytes((vs.env, actions, cfg), {}, seen=seen)
  got += harness.tensor_bytes(out, seen=seen)
  assert got == _group_tick_bytes(n, k, cfg)


def test_render_bytes_match_hand_count():
  import crafter_tpu_torch as ct
  cfg = ct.EnvConfig()
  atlas = ct.bake_atlas(cfg.size, cfg.view, cfg.item_rows, 'cpu')
  t = atlas.compact
  frames, c = 5, cfg.size[0] * cfg.size[1]
  win79 = torch.zeros((frames, 79), dtype=torch.int32)
  light = torch.ones((frames,), dtype=torch.float32)
  sleeping = torch.zeros((frames,), dtype=torch.int32)
  seeds = torch.zeros((frames,), dtype=torch.int32)
  out = torch.zeros((frames, cfg.size[1], cfg.size[0], 3), dtype=torch.uint8)
  tables = (t.mat_tex.numel() + t.spr_tex.numel() + t.item_tex.numel()
            + t.code.numel() + t.vignette.numel()) * 4
  want = frames * (79 * 4 + 4 + 4 + 4) + tables + frames * c * 3
  assert harness.tensor_bytes(win79, light, sleeping, seeds, t, out) == want


def test_device_ns_per_step_is_the_busy_union_over_the_steps():
  """The traced calls' busy seconds over their env-steps; a trace with no
  device operation (the CPU's) reads nothing."""
  reader = harness.load_module('metrics', 'device_ns_per_step')
  trace = {'device_ops': 1280, 'busy_s': 0.075, 'ticks': 200}
  ctx = types.SimpleNamespace(trace=trace, driver=types.SimpleNamespace(
      work_per_call=10 * 4096, ticks_per_call=10))
  assert reader.read(ctx) == pytest.approx(0.075e9 / (20 * 10 * 4096))
  ctx.trace = dict(trace, device_ops=0)
  assert reader.read(ctx) is None
