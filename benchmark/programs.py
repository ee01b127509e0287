"""What the drivers share: the program's and the reference's env
configuration from one configuration file, and the check of the first
worlds of a seed-drawn sample of envs against the reference."""

from __future__ import annotations

import torch

from benchmark import compare
from benchmark.reference import config as ref_config
from benchmark.reference import env as ref_env


def env_fields(config: dict) -> dict:
  """The ``env`` block of a configuration file, lists as tuples."""
  return {k: tuple(v) if isinstance(v, list) else v
          for k, v in config['env'].items()}


def program_env_config(config: dict):
  from crafter_tpu_torch.config import EnvConfig
  return EnvConfig(**env_fields(config))


def reference_env_config(config: dict, variant: str):
  """The reference's configuration; the control ``variant`` draws the
  worldgen noise in bfloat16."""
  return ref_config.EnvConfig(
      **env_fields(config),
      noise_precision='bfloat16' if variant == 'control' else 'float32')


def first_world_mismatch(got_rows, config: dict, seed: int, num_envs: int,
                         index: list, variant: str, device) -> int:
  """Elements of the envs ``index``'s first worlds that differ from the
  reference's (``got_rows`` the program's rows; for the control the
  control's worlds are compared instead)."""
  home = ref_env.home_keys(seed, num_envs, device)[torch.tensor(index,
                                                               device=device)]
  want = ref_env.first_worlds(home, reference_env_config(config, 'program'))
  if variant == 'control':
    got_rows = ref_env.first_worlds(home,
                                    reference_env_config(config, 'control'))
  return compare.mismatch(got_rows, want)
