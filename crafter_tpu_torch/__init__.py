"""crafter_tpu_torch — the batched Crafter engine in PyTorch, with CUDA
kernels written by hand for Hopper (sm_90a).

A port of ``crafter_tpu`` (JAX on a TPU), which stays in the repository as
the reference.  This package imports neither JAX nor ``crafter_tpu``.  It
covers the batched engine: ``vec_reset_chunked``, then either whole
balance-cadence groups (``vec_step_group`` state only,
``vec_step_group_obs`` with one frame a tick) or single ticks (``vec_step``,
``VecEnv``), with the group tick, the tick, the balance, the render and the
worldgen noise as CUDA kernels (``step_cuda.py``, ``render_cuda.py``,
``ops/noise_cuda.py``, sources in ``csrc/``) and plain PyTorch twins beside
them (``step.py``, ``render.py``, ``ops/noise.py``), where each kernel's
wrapper alone picks the kernel for CUDA tensors or the twin for others,
and the twins import no wrapper; and training on top of the per-tick
path: ``PPO`` / ``PPOConfig`` (``ppo.py``) with the ``CnnPolicy``
(``models/cnn.py``), ``checkpoint.py``, ``recorder.py`` /
``analysis.py`` and the CLI ``python -m crafter_tpu_torch.run_train``;
and the reference's single-env surfaces: ``Env`` (Gym API),
``GymnasiumEnv``, ``register_gym_envs`` and the recorders; the seed-exact
oracle ``ParityEnv`` (numpy on the host, ``parity.py``); the 'compat'
worldgen mode (``EnvConfig(noise_mode='compat')``: the permutation-table
OpenSimplex of ``ops/noise.py``); and
the CLIs ``run_random``, ``run_terrain``, ``run_gui`` and ``plots``; and
data parallelism over processes (``parallel``: ``distributed_init``,
``dp_mesh``, ``make_sharded_group_step``, ``psum_stats``; the sharded
``VecEnv(sharding=...)`` and ``make_sharded_train``).
Entry points run on ``cuda`` unless given ``device='cpu'``.
"""

from . import parallel, prng, render, rules
from .config import DEFAULT_CONFIG, EnvConfig
from .convert import state_from_numpy, to_numpy
from .env import (CrafterEnv, Env, GymnasiumEnv, VecEnv, VecState,
                  finish_tick, home_keys, register_gym_envs, step_batch,
                  vec_reset, vec_reset_chunked, vec_step, vec_step_group,
                  vec_step_group_obs, vec_step_k)
from .models import CnnPolicy, ImpalaLstmPolicy, PolicyOutput
from .parity import ParityEnv
from .ppo import PPO, PPOConfig, PPOState, Transition, make_sharded_train
from .recorder import (EpisodeRecorder, Recorder, StatsRecorder,
                       VecStatsRecorder, VideoRecorder)
from .render import (Atlas, bake_atlas, frame_image, noise_seed,
                     render_win79_plain, window_prep)
from .render_cuda import (daylight, render_fields, render_frames,
                          render_px_fields, render_win79)
from .state import EntMaps, Player, State, semantic_view
from .step import (GroupSnaps, StepOut, balance_plain, pack_cells,
                   step_group_plain, tick_plain)
from .step_cuda import balance, group_tick, tick
from .worldgen import generate_world

__all__ = [
    'Atlas', 'CnnPolicy', 'CrafterEnv', 'DEFAULT_CONFIG', 'EntMaps', 'Env',
    'EnvConfig', 'EpisodeRecorder', 'GroupSnaps', 'GymnasiumEnv',
    'ImpalaLstmPolicy', 'PPO',
    'PPOConfig', 'PPOState', 'ParityEnv', 'Player', 'PolicyOutput',
    'Recorder', 'State',
    'StatsRecorder', 'StepOut', 'Transition', 'VecEnv', 'VecState',
    'VecStatsRecorder', 'VideoRecorder', 'bake_atlas', 'balance',
    'balance_plain', 'daylight', 'finish_tick', 'frame_image',
    'generate_world', 'group_tick', 'home_keys', 'make_sharded_train',
    'noise_seed', 'pack_cells', 'parallel', 'prng', 'register_gym_envs',
    'render', 'render_fields', 'render_frames',
    'render_px_fields', 'render_win79', 'render_win79_plain', 'rules',
    'semantic_view', 'state_from_numpy', 'step_batch', 'step_group_plain',
    'tick', 'tick_plain', 'to_numpy', 'vec_reset', 'vec_reset_chunked',
    'vec_step', 'vec_step_group', 'vec_step_group_obs', 'vec_step_k',
    'window_prep',
]
