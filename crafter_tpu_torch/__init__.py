"""crafter_tpu_torch — the batched Crafter engine in PyTorch, with CUDA
kernels written by hand for Hopper (sm_90a).

A port of ``crafter_tpu`` (JAX on a TPU), which stays in the repository as
the reference.  This package imports neither JAX nor ``crafter_tpu``.  It
covers the state-only main path: ``vec_reset_chunked`` then
``vec_step_group`` over a balance-cadence group, with the group tick, the
group-end balance and the worldgen noise as CUDA kernels
(``step_cuda.py``, ``ops/noise_cuda.py``, sources in ``csrc/``) and plain
PyTorch twins beside them.  Entry points run on ``cuda`` unless given
``device='cpu'``.
"""

from . import prng, rules
from .config import DEFAULT_CONFIG, EnvConfig
from .convert import state_from_numpy, to_numpy
from .env import (VecState, home_keys, vec_reset, vec_reset_chunked,
                  vec_step_group)
from .state import EntMaps, Player, State, daylight
from .step import StepOut, balance_plain, step_group_plain
from .step_cuda import balance, group_tick
from .worldgen import generate_world

__all__ = [
    'DEFAULT_CONFIG', 'EntMaps', 'EnvConfig', 'Player', 'State', 'StepOut',
    'VecState', 'balance', 'balance_plain', 'daylight', 'generate_world',
    'group_tick', 'home_keys', 'prng', 'rules', 'state_from_numpy',
    'step_group_plain', 'to_numpy', 'vec_reset', 'vec_reset_chunked',
    'vec_step_group',
]
