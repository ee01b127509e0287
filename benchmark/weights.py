"""The policy's first weights, made by the benchmark on the device from the
seed and handed alike to the program and to the reference."""

from __future__ import annotations

import math

import torch

TRUNC_STD = 0.87962566103423978   # std of N(0, 1) truncated to (-2, 2)


def init_params(shape_of: dict, seed: int, device) -> dict:
  """``{name: float32 tensor}`` for ``{name: shape}``: every weight from one
  draw of a truncated normal, scaled to variance 1/fan_in (flax's
  lecun_normal, the port's own initialiser); biases zero."""
  gen = torch.Generator(device=device)
  gen.manual_seed(int(seed))
  weights = [n for n in shape_of if n.endswith('.weight')]
  sizes = [math.prod(shape_of[n]) for n in weights]
  flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
  torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
  params = {}
  for name, part in zip(weights, flat.split(sizes)):
    fan_in = math.prod(shape_of[name][1:])
    params[name] = (part * (math.sqrt(1.0 / fan_in) / TRUNC_STD)).reshape(
        shape_of[name])
  for name, shape in shape_of.items():
    if name.endswith('.bias'):
      params[name] = torch.zeros(shape, dtype=torch.float32, device=device)
  return {name: params[name] for name in shape_of}
