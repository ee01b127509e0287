"""The general generator of a cell's traffic: the actions of every call,
drawn on the device from the seed, as a traffic file's ``actions`` block
describes them.

    "actions": {"n": 17}                          uniform over 17 actions
    "actions": {"n": 17, "weights": [w0, ...]}    in those proportions
"""

from __future__ import annotations

import torch


class ActionStream:
  """``next()`` gives the next ``shape`` int32 tensor of actions."""

  def __init__(self, spec: dict, seed: int, shape, device):
    self.n = int(spec['n'])
    self.shape = tuple(shape)
    self.gen = torch.Generator(device=device)
    self.gen.manual_seed(int(seed))
    self.device = device
    weights = spec.get('weights')
    self.weights = None
    if weights is not None:
      if len(weights) != self.n:
        raise ValueError(f'{len(weights)} weights for {self.n} actions')
      self.weights = torch.tensor(weights, dtype=torch.float32,
                                  device=device)

  def next(self) -> torch.Tensor:
    if self.weights is None:
      return torch.randint(0, self.n, self.shape, generator=self.gen,
                           device=self.device, dtype=torch.int32)
    count = 1
    for s in self.shape:
      count *= s
    return torch.multinomial(self.weights, count, replacement=True,
                             generator=self.gen).to(torch.int32).reshape(
                                 self.shape)
