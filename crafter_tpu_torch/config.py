"""Static environment configuration (the port's copy of ``crafter_tpu.config``).

Same fields and the same chunk-size check as the JAX package's
``EnvConfig``.  The two backend knobs keep their names; their values name
this package's backends:

* ``engine`` — one value, ``'auto'``: the tick, group tick, balance and
  render go through the kernel wrappers (``step_cuda``, ``render_cuda``),
  which launch the hand-written CUDA kernels for CUDA tensors and run the
  plain PyTorch twins for CPU tensors, so the tensors' device is the one
  choice.  The field stays because the benchmark's configuration files
  and the JAX package's ``EnvConfig`` name it; any other value raises.
* ``noise_mode`` — the worldgen noise: ``'auto'`` calls the noise kernel
  wrapper, ``'fast'`` always runs the plain ``noise2_fast``; ``'compat'``
  is the original OpenSimplex with its 256-entry permutation table (a
  table a world, ``ops/noise.py:noise3``), the JAX package's 'compat'
  mode: its candidate sum is one launch of ``csrc/noise3_perm.cu`` on the
  card (``ops/noise_cuda.py:noise3_perm``) and the plain twin on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from . import rules

ENGINES = ('auto',)
NOISE_MODES = ('auto', 'fast', 'compat')


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
