"""The batched world state: dataclasses of tensors over a leading env axis.

The port's counterpart of ``crafter_tpu/state.py``.  Entities live in the
grid as per-cell channel planes, every plane is flat ``(N, W*H)`` in x-major
cell order (cell ``c = x * H + y``), and the storage dtypes are the JAX
package's: uint8 material / type / health / facing, int16 aux, bool flags.
The PRNG key is the two uint32 words of a threefry key, carried as int64
values in ``[0, 2**32)`` (``crafter_tpu_torch.prng``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import rules
from .config import EnvConfig
from .ops.fma import cos32, fma32


@dataclasses.dataclass
class EntMaps:
  """Per-cell entity channels; a cell is occupied iff ``etype != 0``."""

  etype: torch.Tensor   # (N, C) uint8 entity type id (rules.E_*)
  health: torch.Tensor  # (N, C) uint8
  aux: torch.Tensor     # (N, C) int16 per-type counter
  facing: torch.Tensor  # (N, C) uint8 direction index (arrows)


@dataclasses.dataclass
class Player:
  """Player record (objects.py:70-82); life counters in half units."""

  pos: torch.Tensor           # (N, 2) int32
  facing: torch.Tensor        # (N,) int32
  inventory: torch.Tensor     # (N, 16) int32, index 0 is health
  achievements: torch.Tensor  # (N, 22) int32 counts
  sleeping: torch.Tensor      # (N,) bool
  hunger: torch.Tensor        # (N,) int32
  thirst: torch.Tensor        # (N,) int32
  fatigue: torch.Tensor       # (N,) int32
  recover: torch.Tensor       # (N,) int32
  last_health: torch.Tensor   # (N,) int32


@dataclasses.dataclass
class State:
  """Complete state of a batch of envs."""

  mat_map: torch.Tensor          # (N, C) uint8 material ids
  ent: EntMaps
  player: Player
  step: torch.Tensor             # (N,) int32
  key: torch.Tensor              # (N, 2) int64 threefry key words
  unlocked: torch.Tensor         # (N, 22) bool
  env_last_health: torch.Tensor  # (N,) int32
  chunk_touched: torch.Tensor    # (N, ncx, ncy) bool


def daylight_plain(step: torch.Tensor, day_length: int) -> torch.Tensor:
  """Day/night curve 1 - |cos(pi*((t/300)%1 + 0.3))|^3 (env.py:135-139) in
  PyTorch operations, the twin of ``render_cuda.daylight``'s kernel.  The
  renderer multiplies pixels by the light and floors, so every step is
  XLA's float32 arithmetic: the division as a multiply by the float32
  reciprocal, the cosine glibc's ``cosf`` (``ops/fma.py:cos32``), and
  ``1 - |c| * (|c| * |c|)`` with the outer product fused into the
  subtract.  Equal to the JAX function for every int32 step and day
  length tested (``tests/test_torch_render.py``)."""
  progress = torch.remainder(step.to(torch.float32) * inv_day(day_length),
                             1.0) + 0.3
  c = cos32(float(np.float32(np.pi)) * progress).abs()
  return fma32(-c, c * c, 1.0)


@functools.lru_cache(maxsize=None)
def inv_day(day_length: int) -> float:
  """float32(1) / float32(day_length), the reciprocal XLA multiplies by."""
  return float(np.float32(1.0) / np.float32(day_length))


def semantic_view(state: State, cfg: EnvConfig) -> torch.Tensor:
  """Material + entity-type id map (N, W, H) int32 (engine.py:251-264):
  entity type t shows as N_MATERIALS + t - 1, else the cell's material."""
  et = state.ent.etype.to(torch.int32)
  flat = torch.where(et > 0, rules.N_MATERIALS + et - 1,
                     state.mat_map.to(torch.int32))
  return flat.reshape(flat.shape[:-1] + tuple(cfg.area))


def init_player(cfg: EnvConfig, n: int, device) -> Player:
  tables = rules.TABLES
  i32 = dict(dtype=torch.int32, device=device)
  zeros = lambda: torch.zeros((n,), **i32)
  return Player(
      pos=torch.tensor(cfg.center, **i32).repeat(n, 1),
      facing=torch.full((n,), rules.DIR_DOWN, **i32),
      inventory=torch.tensor(tables.item_initial, **i32).repeat(n, 1),
      achievements=torch.zeros((n, rules.N_ACHIEVEMENTS), **i32),
      sleeping=torch.zeros((n,), dtype=torch.bool, device=device),
      hunger=zeros(), thirst=zeros(), fatigue=zeros(), recover=zeros(),
      last_health=torch.full(
          (n,), int(tables.item_initial[rules.ITEM_HEALTH]), **i32))


def empty_ent_maps(cfg: EnvConfig, n: int, device) -> EntMaps:
  c = cfg.area[0] * cfg.area[1]
  u8 = lambda: torch.zeros((n, c), dtype=torch.uint8, device=device)
  return EntMaps(etype=u8(), health=u8(),
                 aux=torch.zeros((n, c), dtype=torch.int16, device=device),
                 facing=u8())


def leaves(obj, prefix=''):
  """``[(path, tensor)]`` of a (nested) state dataclass, in field order."""
  if dataclasses.is_dataclass(obj):
    out = []
    for f in dataclasses.fields(obj):
      out += leaves(getattr(obj, f.name), f'{prefix}.{f.name}')
    return out
  return [(prefix, obj)]
