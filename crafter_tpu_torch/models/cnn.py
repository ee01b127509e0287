"""CNN actor-critic policy for pixel observations.

The port's counterpart of ``crafter_tpu/models/cnn.py``: the NatureCNN trunk
(8x8/4, 4x4/2, 3x3/1 valid convolutions and a dense layer) computed in
bfloat16 from float32 parameters, and two float32 heads.  The JAX package
leaves these products to XLA, outside any kernel of its own; here they are
``torch.nn.functional.conv2d`` and ``linear``.

Layouts.  Observations keep the JAX package's layout, ``(N, H, W, 3)``.  A
PyTorch convolution takes ``(N, C, H, W)``, so the frames are permuted to
that shape as a view (which is ``channels_last`` memory, no copy) and the
activations stay ``channels_last`` through the trunk.  Before the dense
layer they are permuted back to ``(N, H, W, C)`` and flattened, which is
flax's flatten order: the dense kernel's rows mean the same in both
packages, and :func:`crafter_tpu_torch.convert.policy_from_flax` only
transposes kernels (HWIO -> OIHW, ``(in, out)`` -> ``(out, in)``).

The bfloat16 trunk casts weights and biases on every call, as flax's
``dtype=bfloat16, param_dtype=float32`` does; gradients reach the float32
parameters through the casts.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Standard deviation of a standard normal truncated to (-2, 2): flax's
# default kernel initialiser (lecun_normal) divides by it.
_TRUNC_STD = 0.87962566103423978


class PolicyOutput(NamedTuple):
  logits: torch.Tensor  # (..., n_actions) float32
  value: torch.Tensor   # (...,) float32


def _conv_out(size: int, kernel: int, stride: int) -> int:
  return (size - kernel) // stride + 1


class CnnPolicy(nn.Module):
  """NatureCNN trunk (8x8/4, 4x4/2, 3x3/1 convs + ``width`` dense) and two
  heads.

  Accepts uint8 frames ``(..., H, W, 3)`` or the packed transport format:
  int32 lanes ``(..., H*W)`` holding ``r | g<<8 | b<<16`` per pixel
  (``CrafterEnv.observe_px``).  Parameters are float32, initialised as flax
  initialises them (truncated normal of variance 1/fan_in, zero biases) from
  ``generator``, or from the global generator when none is given.
  """

  def __init__(self, n_actions: int = 17, width: int = 512,
               input_hw: Tuple[int, int] = (64, 64),
               compute_dtype: torch.dtype = torch.bfloat16,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.n_actions = n_actions
    self.width = width
    self.input_hw = tuple(input_hw)
    self.compute_dtype = compute_dtype
    kw = dict(device=device, dtype=torch.float32)
    self.conv1 = nn.Conv2d(3, 32, 8, stride=4, **kw)
    self.conv2 = nn.Conv2d(32, 64, 4, stride=2, **kw)
    self.conv3 = nn.Conv2d(64, 64, 3, stride=1, **kw)
    h, w = self.input_hw
    for k, s in ((8, 4), (4, 2), (3, 1)):
      h, w = _conv_out(h, k, s), _conv_out(w, k, s)
    self.dense = nn.Linear(h * w * 64, width, **kw)
    self.logits = nn.Linear(width, n_actions, **kw)
    self.value = nn.Linear(width, 1, **kw)
    with torch.no_grad():
      for layer in self.layers():
        fan_in = layer.weight[0].numel()
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        # Drawn on the CPU, so that one seed gives one policy on any device.
        draw = torch.empty(layer.weight.shape, dtype=torch.float32)
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        layer.weight.copy_(draw * std)
        layer.bias.zero_()

  def layers(self):
    return (self.conv1, self.conv2, self.conv3, self.dense, self.logits,
            self.value)

  def forward(self, obs: torch.Tensor) -> PolicyOutput:
    if obs.dtype == torch.int32:  # packed pixel lanes
      h, w = self.input_hw
      obs = torch.stack([obs & 255, (obs >> 8) & 255, (obs >> 16) & 255],
                        -1).reshape(obs.shape[:-1] + (h, w, 3))
    lead = obs.shape[:-3]
    dt = self.compute_dtype
    x = obs.reshape((-1,) + obs.shape[-3:]).to(dt) / 255.0
    x = x.permute(0, 3, 1, 2)             # (N, 3, H, W), channels_last memory
    for conv in (self.conv1, self.conv2, self.conv3):
      x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                          stride=conv.stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's (H, W, C)
    x = F.relu(F.linear(x, self.dense.weight.to(dt), self.dense.bias.to(dt)))
    x = x.to(torch.float32)
    logits = self.logits(x)
    value = self.value(x)[..., 0]
    return PolicyOutput(logits=logits.reshape(lead + (self.n_actions,)),
                        value=value.reshape(lead))
