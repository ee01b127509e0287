"""Model FLOPs of NatureCNN and of a PPO update, counted from the layers'
published shapes (a multiply-add is two operations), not from any
implementation.

For a 64x64x3 frame with valid padding: conv1 15*15*32*192*2 = 2,764,800,
conv2 6*6*64*512*2 = 2,359,296, conv3 4*4*64*576*2 = 1,179,648, dense
1024*512*2 = 1,048,576, heads 512*18*2 = 18,432: 7,370,752 a forward pass.
The backward pass is twice the forward, less conv1's input gradient, which
nothing needs.
"""

from __future__ import annotations


def layer_flops(input_hw=(64, 64), channels=3,
                convs=((32, 8, 4), (64, 4, 2), (64, 3, 1)), dense=512,
                heads=18) -> list:
  """``[(name, forward FLOPs a frame)]`` of each layer."""
  h, w = input_hw
  c = channels
  out = []
  for i, (filters, k, s) in enumerate(convs):
    h, w = (h - k) // s + 1, (w - k) // s + 1
    out.append((f'conv{i + 1}', h * w * filters * (k * k * c) * 2))
    c = filters
  out.append(('dense', h * w * c * dense * 2))
  out.append(('heads', dense * heads * 2))
  return out


def forward_flops(**kw) -> int:
  return sum(f for _, f in layer_flops(**kw))


def train_flops(**kw) -> int:
  """Forward and backward of a frame: the backward twice the forward,
  except that the first layer computes no gradient of its input."""
  layers = layer_flops(**kw)
  return 3 * sum(f for _, f in layers) - layers[0][1]


def ppo_update_flops(num_envs: int, rollout_len: int, epochs: int,
                     **kw) -> int:
  """One update: the rollout's forward passes (one a tick and one for the
  last value) and ``epochs`` passes of forward and backward over the
  rollout's frames."""
  frames = num_envs * rollout_len
  return ((rollout_len + 1) * num_envs * forward_flops(**kw)
          + epochs * frames * train_flops(**kw))


def policy_kwargs(policy: dict, size, n_actions: int) -> dict:
  """:func:`layer_flops`'s arguments from a configuration's ``policy``
  block and frame size ``(W, H)``."""
  return dict(input_hw=(size[1], size[0]), channels=3,
              convs=tuple(tuple(c) for c in policy['convs']),
              dense=policy['dense'], heads=n_actions + 1)
