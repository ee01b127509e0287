"""Static environment configuration of the benchmark's plain reference: a
frozen copy of the port's ``EnvConfig``, the same fields and checks, so one
configuration file builds both.

``engine`` and ``noise_mode`` keep the port's names and values; the
reference runs plain PyTorch whatever ``engine`` says, and draws the 2-D
noise of 'auto' and 'fast' with the plain ``noise.noise2_shared``.
``noise_precision`` is the reference's own: 'bfloat16' rounds every noise
value to bfloat16, the lower-precision control that the benchmark's
comparison has to reject.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from . import rules

ENGINES = ('auto', 'plain')
NOISE_MODES = ('auto', 'fast', 'compat')
NOISE_PRECISIONS = ('float32', 'bfloat16')


@dataclasses.dataclass(frozen=True)
class EnvConfig:
  """Frozen, hashable env configuration."""

  area: Tuple[int, int] = (64, 64)     # world size in cells (env.py:28)
  view: Tuple[int, int] = (9, 9)       # view grid incl. item rows (env.py:28)
  size: Tuple[int, int] = (64, 64)     # observation pixels (env.py:28)
  reward: bool = True                  # reward vs NoReward variant (env.py:29)
  length: int = 10000                  # episode cap (env.py:28-29)
  chunk_size: Tuple[int, int] = (12, 12)  # env.py:40
  day_length: int = 300                # daylight period (env.py:135-139)
  balance_every: int = 10              # chunk-balance cadence (env.py:90)
  noise_mode: str = 'auto'
  engine: str = 'auto'
  noise_precision: str = 'float32'

  def __post_init__(self):
    # The balance kernel counts chunk members in 8-bit fields (the JAX
    # package packs four of them into an int32 lane); keep its limits so
    # both packages accept the same configurations.
    csx, csy = self.chunk_size
    if csx > 16 or csy > 16 or csx * csy > 255:
      raise ValueError(
          f'chunk_size={self.chunk_size} exceeds the (16, 16)-dim / '
          '255-cell limit of the balance kernel\'s 8-bit member counts')
    if self.engine not in ENGINES:
      raise ValueError(f'engine={self.engine!r} is not one of {ENGINES}')
    if self.noise_precision not in NOISE_PRECISIONS:
      raise ValueError(f'noise_precision={self.noise_precision!r} is not one '
                       f'of {NOISE_PRECISIONS}')
    if self.noise_mode not in NOISE_MODES:
      raise ValueError(
          f'noise_mode={self.noise_mode!r} is not one of {NOISE_MODES}')

  @property
  def item_rows(self) -> int:
    return math.ceil(rules.N_ITEMS / self.view[0])

  @property
  def local_grid(self) -> Tuple[int, int]:
    return (self.view[0], self.view[1] - self.item_rows)

  @property
  def update_distance(self) -> int:
    # env.py:88: entities update within L1 distance < 2 * max(view).
    return 2 * max(self.view)

  @property
  def n_chunks(self) -> Tuple[int, int]:
    return (math.ceil(self.area[0] / self.chunk_size[0]),
            math.ceil(self.area[1] / self.chunk_size[1]))

  @property
  def center(self) -> Tuple[int, int]:
    return (self.area[0] // 2, self.area[1] // 2)


DEFAULT_CONFIG = EnvConfig()
