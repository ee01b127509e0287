"""Procedural world generation for a batch of keys.

The port's counterpart of ``crafter_tpu/worldgen.py:generate_world``: the
same 13 noise channels, material cascade, mob seeding and
``chunk_touched``, from the same threefry draws, so every leaf equals the
JAX package's world for the same key.  In the 2-D modes the noise runs
through the CUDA kernel wrapper in its shared form (``noise_mode`` 'auto':
the 13 channels' points once and a seed a world and channel, as the JAX
package vmaps its kernel) or the plain twin on the expanded per-point
inputs ('fast').  In 'compat' it is the permutation-table OpenSimplex
(``ops/noise.py:noise3``, a table a world drawn by ``perm_from_key``) at
the 3-D points ``(x / dx, y / dy, z)``: plain PyTorch on every device, as
its JAX counterpart is plain jnp.

Float details that keep it bit-exact: divisions by constants are multiplies
by float32 reciprocals and single-use products feeding a sum are fused
(``ops/fma.py``), as XLA compiles the JAX function; the sigmoid is XLA's
own (``ops/fma.py:sigmoid32``), so worlds are the same on the CPU and on
the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import prng, rules
from . import state as state_lib
from .config import EnvConfig
from .ops import noise, noise_cuda
from .ops.fma import fma32, sigmoid32
from .utils import profiling

# (x scale numerator, x divisor, y numerator, y divisor, z) per channel
# (crafter_tpu/worldgen.py:44-58): point = (num_x * x / div_x, num_y * y /
# div_y), z folded into the seed.
CHANNELS = (
    (1, 3, 1, 3, 8),      # start
    (1, 15, 1, 15, 3),    # water octave 15
    (1, 5, 1, 5, 3),      # water octave 5
    (1, 15, 1, 15, 0),    # mountain octave 15
    (1, 5, 1, 5, 0),      # mountain octave 5
    (1, 7, 1, 7, 6),      # caves
    (2, 3, 1, 15, 7),     # horizontal tunnels
    (1, 15, 2, 3, 7),     # vertical tunnels
    (1, 8, 1, 8, 1),      # coal
    (1, 6, 1, 6, 2),      # iron
    (1, 5, 1, 5, 6),      # lava
    (1, 9, 1, 9, 4),      # sand
    (1, 7, 1, 7, 5),      # trees
)
_GOLDEN = int(np.uint32(0x9E3779B9).view(np.int32))


def _recip(d: float) -> float:
  """float32 reciprocal, as XLA folds a division by a constant."""
  return float(np.float32(1.0) / np.float32(d))


def channel_points(cfg: EnvConfig, device) -> torch.Tensor:
  """(13, W, H, 2) float32 noise sample points, shared by every world
  (made once per area and device; do not write into it)."""
  return _channel_points(tuple(cfg.area), str(torch.device(device)))


@functools.lru_cache(maxsize=8)
def _channel_points(area, device: str) -> torch.Tensor:
  w, h = area
  x = torch.arange(w, dtype=torch.float32, device=device)[:, None].expand(w, h)
  y = torch.arange(h, dtype=torch.float32, device=device)[None, :].expand(w, h)
  pts = []
  for nx, dx, ny, dy, _ in CHANNELS:
    px = (x * nx if nx != 1 else x) * _recip(dx)
    py = (y * ny if ny != 1 else y) * _recip(dy)
    pts.append(torch.stack([px, py], -1))
  return torch.stack(pts)


def _mat_in(m: torch.Tensor, member_table) -> torch.Tensor:
  out = torch.zeros(m.shape, dtype=torch.bool, device=m.device)
  for i in np.flatnonzero(np.asarray(member_table)):
    out = out | (m == int(i))
  return out


def channel_points3(cfg: EnvConfig, device) -> torch.Tensor:
  """(13 * W * H, 3) float32 points of the 'compat' noise: the 2-D channel
  points with each channel's z (made once per area and device)."""
  return _channel_points3(tuple(cfg.area), str(torch.device(device)))


@functools.lru_cache(maxsize=8)
def _channel_points3(area, device: str) -> torch.Tensor:
  xy = _channel_points(area, device)
  z = torch.tensor([ch[4] for ch in CHANNELS], dtype=torch.float32,
                   device=device)
  z = z[:, None, None, None].expand(xy.shape[:-1] + (1,))
  return torch.cat([xy, z], -1).reshape(-1, 3)


def _compat_channels(keys: torch.Tensor, cfg: EnvConfig):
  """The 13 channels in 'compat' mode and the two composed ones, as XLA
  fuses them in the JAX package: the normalising multiply by 1/103 sits
  in each consumer, so ``water`` and ``mountain`` fuse the first channel's
  un-normalised sum, ``fma(t1, 1/103, n2 * 0.15)``.  Returns ``(n,
  water_n, mountain_n)`` with ``mountain_n`` still to be multiplied by
  1/1.3 (fused with the start term by the caller)."""
  w, h = cfg.area
  r = keys.shape[0]
  perm = noise.perm_from_key(prng.split(keys, 3)[:, 0])      # (R, 256)
  t = noise.noise3_total(channel_points3(cfg, keys.device)[None], perm)
  t = t.reshape(r, len(CHANNELS), w, h)
  c = noise.F32_INV_NORM_3D
  n = t * c
  water_n = fma32(t[:, 1], c, n[:, 2] * 0.15)
  mountain_n = fma32(t[:, 3], c, n[:, 4] * 0.3)
  return n, water_n, mountain_n


def noise_seeds(keys: torch.Tensor) -> torch.Tensor:
  """(R, 13) int32 noise seeds of a batch of worlds: one a world and
  channel."""
  k_perm = prng.split(keys, 3)[:, 0]
  perm = prng.randint(k_perm, 0, 2 ** 31 - 1)                 # (R,) int32
  zs = torch.tensor([ch[4] for ch in CHANNELS], dtype=torch.int32,
                    device=keys.device)
  return perm[:, None] + zs[None, :] * _GOLDEN


def noise_inputs(keys: torch.Tensor, cfg: EnvConfig):
  """The noise call of a batch of worlds in the per-point form: points
  (P, 2) float32 and per-point int32 seeds (P,), P = R * 13 * W * H,
  world-major."""
  w, h = cfg.area
  r = keys.shape[0]
  seeds = noise_seeds(keys)                                    # (R, 13)
  pts = channel_points(cfg, keys.device)                       # (13,W,H,2)
  return (pts[None].expand(r, -1, -1, -1, -1).reshape(-1, 2),
          seeds[:, :, None].expand(-1, -1, w * h).reshape(-1))


def generate_world(keys: torch.Tensor, cfg: EnvConfig) -> state_lib.State:
  """Fresh worlds for keys (R, 2): terrain, seeded mobs, player at center."""
  with profiling.span('generate_world'):
    w, h = cfg.area
    cx, cy = cfg.center
    r = keys.shape[0]
    dev = keys.device
    tables = rules.TABLES

    sub = prng.split(keys, 3)
    k_mat, k_obj = sub[:, 1], sub[:, 2]
    compat = cfg.noise_mode == 'compat'
    if compat:
      n, water_n, mountain_n = _compat_channels(keys, cfg)
    else:
      if cfg.noise_mode == 'fast':
        n = noise.noise2_fast(*noise_inputs(keys, cfg))
      else:
        # The shared form: the channels' points once, a seed a world and
        # channel.
        n = noise_cuda.noise2(
            channel_points(cfg, dev).reshape(len(CHANNELS), w * h, 2),
            noise_seeds(keys))
      n = n.reshape(r, len(CHANNELS), w, h)
      water_n = fma32(0.15, n[:, 2], n[:, 1])
      mountain_n = fma32(0.3, n[:, 4], n[:, 3]) * _recip(1.3)

    # --- material pass (worldgen.py:21-61) -------------------------------
    xs = torch.arange(w, device=dev)[:, None]
    ys = torch.arange(h, device=dev)[None, :]
    # float64 sqrt of an integer, rounded: the correctly rounded float32 on
    # any device.
    dist = torch.sqrt(((xs - cx) ** 2 + (ys - cy) ** 2).to(torch.float64)).to(
        torch.float32)
    start = sigmoid32(fma32(2.0, n[:, 0], 4.0 - dist))
    water = fma32(-2.0, start, water_n + 0.1)
    if compat:  # XLA fuses the 1/1.3 into the start term there
      mountain = fma32(mountain_n, _recip(1.3), -4.0 * start)
    else:
      mountain = mountain_n - 4.0 * start
    mountain = fma32(-0.3, water, mountain)

    u = prng.uniform(k_mat, (4, w, h))
    is_start = start > 0.5
    in_mtn = ~is_start & (mountain > 0.15)
    cave = in_mtn & (n[:, 5] > 0.15) & (mountain > 0.3)
    htun = in_mtn & ~cave & (n[:, 6] > 0.4)
    vtun = in_mtn & ~cave & ~htun & (n[:, 7] > 0.4)
    taken = cave | htun | vtun
    coal = in_mtn & ~taken & (n[:, 8] > 0) & (u[:, 0] > 0.85)
    taken = taken | coal
    iron = in_mtn & ~taken & (n[:, 9] > 0.4) & (u[:, 1] > 0.75)
    taken = taken | iron
    diamond = in_mtn & ~taken & (mountain > 0.18) & (u[:, 2] > 0.994)
    taken = taken | diamond
    lava = in_mtn & ~taken & (mountain > 0.3) & (n[:, 10] > 0.35)
    stone = in_mtn & ~taken & ~lava
    lowland = ~is_start & ~in_mtn
    sand = lowland & (0.25 < water) & (water <= 0.35) & (n[:, 11] > -0.2)
    watr = lowland & ~sand & (water > 0.3)
    grassland = lowland & ~sand & ~watr
    tree = grassland & (n[:, 12] > 0) & (u[:, 3] > 0.8)

    mat = torch.full((r, w, h), rules.MAT_GRASS, dtype=torch.uint8,
                     device=dev)
    for mask, mid in [
        (cave | htun | vtun, rules.MAT_PATH), (coal, rules.MAT_COAL),
        (iron, rules.MAT_IRON), (diamond, rules.MAT_DIAMOND),
        (lava, rules.MAT_LAVA), (stone, rules.MAT_STONE),
        (sand, rules.MAT_SAND), (watr, rules.MAT_WATER),
        (tree, rules.MAT_TREE)]:
      mat = torch.where(mask, mid, mat)
    tunnels = htun | vtun

    # --- object pass (worldgen.py:64-76) ---------------------------------
    uo = prng.uniform(k_obj, (3, w, h))
    walkable = _mat_in(mat, tables.walkable_mob)
    cow = (walkable & (dist > 3) & (mat == rules.MAT_GRASS)
           & (uo[:, 0] > 0.985))
    zombie = walkable & ~cow & (dist > 10) & (uo[:, 1] > 0.993)
    skeleton = (walkable & ~cow & ~zombie & (mat == rules.MAT_PATH)
                & tunnels & (uo[:, 2] > 0.95))
    etype = torch.where(
        cow, rules.E_COW,
        torch.where(zombie, rules.E_ZOMBIE,
                    torch.where(skeleton, rules.E_SKELETON, rules.E_NONE)))
    etype[:, cx, cy] = rules.E_PLAYER
    health = torch.where(
        etype == rules.E_COW, 3,
        torch.where(etype == rules.E_ZOMBIE, 5,
                    torch.where(etype == rules.E_SKELETON, 3, 0)))
    c = w * h
    ent = state_lib.EntMaps(
        etype=etype.to(torch.uint8).reshape(r, c),
        health=health.to(torch.uint8).reshape(r, c),
        aux=torch.zeros((r, c), dtype=torch.int16, device=dev),
        facing=torch.zeros((r, c), dtype=torch.uint8, device=dev))

    # Chunks that start with an object in them (engine.py:57).
    (csx, csy), (ncx, ncy) = cfg.chunk_size, cfg.n_chunks
    padded = torch.zeros((r, ncx * csx, ncy * csy), dtype=torch.bool,
                         device=dev)
    padded[:, :w, :h] = etype > 0
    chunk_touched = padded.reshape(r, ncx, csx, ncy, csy).any(4).any(2)

    i32 = dict(dtype=torch.int32, device=dev)
    return state_lib.State(
        mat_map=mat.reshape(r, c), ent=ent,
        player=state_lib.init_player(cfg, r, dev),
        step=torch.zeros((r,), **i32),
        key=prng.fold_in(keys, 0x5eed),
        unlocked=torch.zeros((r, rules.N_ACHIEVEMENTS), dtype=torch.bool,
                             device=dev),
        env_last_health=torch.full(
            (r,), int(tables.item_initial[rules.ITEM_HEALTH]), **i32),
        chunk_touched=chunk_touched)
