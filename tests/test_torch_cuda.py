"""The CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc and skip without them.
Run on a GPU machine with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: none (bitwise), for every kernel.
"""

import dataclasses

import pytest
import torch

import crafter_tpu_torch as ct
from crafter_tpu_torch import step as step_lib
from crafter_tpu_torch import step_cuda, worldgen
from crafter_tpu_torch.ops import noise, noise_cuda
from crafter_tpu_torch.state import leaves

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
  _assert_equal(worldgen.generate_world(keys, cfg),
                worldgen.generate_world(keys.cpu(), cfg))
