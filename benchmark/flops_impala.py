"""Model FLOPs of the IMPALA ResNet-LSTM policy and of a recurrent PPO
update, counted from the layers' published shapes (a multiply-add is two
operations), not from any implementation.

For a 64x64x3 frame (same padding; each stack's 3x3 max-pool of stride 2
halves the side): the stacks' convolutions 3,538,944 + 18,874,368 (16
channels: one conv at 64x64, four at 32x32), 9,437,184 + 18,874,368 (32:
one at 32x32, four at 16x16), 4,718,592 + 4,718,592 (32: one at 16x16,
four at 8x8), 60,162,048 in all; the dense layer 2,048 * 256 * 2 =
1,048,576; the LSTM's gates (256 + 17 + 1 + 256) * 1,024 * 2 = 1,085,440;
the heads 256 * 18 * 2 = 9,216: 62,305,280 a forward pass.  The backward
pass is twice the forward, less the first convolution's input gradient,
which nothing needs.  Pooling, ReLU and the gates' elementwise arithmetic
are not multiply-adds and are not counted.
"""

from __future__ import annotations


def layer_flops(input_hw=(64, 64), channels=3, stacks=(16, 32, 32),
                blocks=2, width=256, hidden=256, n_actions=17) -> list:
  """``[(name, forward FLOPs a frame)]`` of each layer."""
  h, w = input_hw
  c = channels
  out = []
  for i, c_out in enumerate(stacks):
    out.append((f'stack{i}.conv', h * w * c_out * 9 * c * 2))
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out.append((f'stack{i}.res', 2 * blocks * h * w * c_out * 9 * c_out * 2))
    c = c_out
  out.append(('fc', h * w * c * width * 2))
  out.append(('lstm', (width + n_actions + 1 + hidden) * 4 * hidden * 2))
  out.append(('heads', hidden * (n_actions + 1) * 2))
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
