"""NatureCNN actor-critic in plain PyTorch, float32: the reference of the
port's ``CnnPolicy``.

Mnih et al. 2015 (Nature 518:529): 32 filters 8x8 stride 4, 64 4x4 stride
2, 64 3x3 stride 1, all valid, then a dense layer of 512; two linear heads
(logits, value).  Frames ``(N, H, W, 3)`` uint8 scaled by 1/255.  The conv
output is flattened in (H, W, C) order, so the dense rows mean what the
port's mean.  Parameters are a dict of float32 tensors named as the port's
``named_parameters()``; conv weights OIHW, linear weights (out, in).

``trunk='float8'`` is the lower-precision control: every input and weight
of the four trunk layers rounded to float8 e4m3 with a per-tensor scale
(amax / 448), gradients passed straight through the rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CONVS = (('conv1', 32, 8, 4), ('conv2', 64, 4, 2), ('conv3', 64, 3, 1))
E4M3_MAX = 448.0


def shapes(input_hw=(64, 64), channels=3, width=512, n_actions=17):
  """``{name: shape}`` of every parameter, in the port's order."""
  out, c = {}, channels
  h, w = input_hw
  for name, filters, k, s in CONVS:
    out[f'{name}.weight'] = (filters, c, k, k)
    out[f'{name}.bias'] = (filters,)
    c, h, w = filters, (h - k) // s + 1, (w - k) // s + 1
  out['dense.weight'] = (width, h * w * c)
  out['dense.bias'] = (width,)
  out['logits.weight'] = (n_actions, width)
  out['logits.bias'] = (n_actions,)
  out['value.weight'] = (1, width)
  out['value.bias'] = (1,)
  return out


def _float8(t: torch.Tensor) -> torch.Tensor:
  scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
  q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
  return t + (q - t.detach())


def forward(params: dict, obs: torch.Tensor, trunk: str = 'float32'):
  """``(logits (N, A), value (N,))`` of uint8 frames ``(N, H, W, 3)``."""
  q = _float8 if trunk == 'float8' else (lambda t: t)
  x = obs.to(torch.float32) / 255.0
  x = x.permute(0, 3, 1, 2)
  for name, _, _, stride in CONVS:
    x = F.relu(F.conv2d(q(x), q(params[f'{name}.weight']),
                        params[f'{name}.bias'], stride=stride))
  x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
  x = F.relu(F.linear(q(x), q(params['dense.weight']), params['dense.bias']))
  logits = F.linear(x, params['logits.weight'], params['logits.bias'])
  value = F.linear(x, params['value.weight'], params['value.bias'])[:, 0]
  return logits, value
