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
import pathlib

import numpy as np
import torch

from . import rules
from .config import EnvConfig

ASSETS = pathlib.Path(__file__).parent / 'assets'


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


@functools.lru_cache(maxsize=None)
def _daylight_table(device: str):
  """The committed light table (``assets/daylight.npz``) as
  ``(day_length, (T,) float32 tensor)``."""
  with np.load(ASSETS / 'daylight.npz') as f:
    return int(f['day_length']), torch.as_tensor(f['table'], device=device)


def _daylight_computed(step: torch.Tensor, day_length: int) -> torch.Tensor:
  inv = np.float32(1.0) / np.float32(day_length)
  progress = torch.remainder(step.to(torch.float32) * float(inv), 1.0) + 0.3
  c = torch.cos(float(np.float32(np.pi)) * progress).abs()
  return 1.0 - c * (c * c)


def daylight(step: torch.Tensor, day_length: int) -> torch.Tensor:
  """Day/night curve 1 - |cos(pi*((t/300)%1 + 0.3))|^3 (env.py:135-139).

  The renderer multiplies pixels by the light and floors, so the light has
  to be the JAX package's bit for bit, and the same on the CPU and the
  card.  No float32 cosine at hand gives that (torch's differs from XLA's
  in the last bits at 39% of the steps), so for the default day length the
  value is looked up by step in a committed table of the JAX function
  under ``jax.jit`` (``tools/pack_torch_textures.py``; steps 0..10000, the
  episode cap).  Another day length, or a step beyond the table, takes the
  computed form: float32 throughout, the division as a multiply by the
  float32 reciprocal as XLA rewrites it.  That form agrees with the JAX
  package wherever the balance reads it (through integer truncations,
  tests/test_torch_step.py) but not in every bit.
  """
  tab_len, table = _daylight_table(str(step.device))
  if day_length != tab_len:
    return _daylight_computed(step, day_length)
  last = table.shape[0] - 1
  # Both forms and a select: no host read of the steps, so no device sync.
  return torch.where((step >= 0) & (step <= last),
                     table[step.clamp(0, last).long()],
                     _daylight_computed(step, day_length))


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
