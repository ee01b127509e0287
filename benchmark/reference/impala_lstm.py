"""The IMPALA ResNet-LSTM actor-critic in plain PyTorch, float32: the
reference of the port's ``ImpalaLstmPolicy``, a frozen copy of the
repository's ``tests/impala_lstm_ref.py`` (its model half; the update is
``ppo_recurrent.py``).

Espeholt et al. 2018 (arXiv:1802.01561, Fig. 3 right): three stacks of 16,
32, 32 channels, each a 3x3 convolution (stride 1, same padding), a 3x3
max-pool of stride 2 and two residual blocks ``x + conv(relu(conv(relu(x))))``;
ReLU, flatten in (H, W, C) order, a dense layer of 256, ReLU; an LSTM of
256 (gates i, f, g, o) fed the dense output, the one-hot previous action
and the previous reward clipped to [-1, 1], stepped one tick at a time;
linear heads for the logits and the value.  Departures: the max-pool pads
one pixel on each side (PyTorch's ``padding=1``, CleanRL's
``ppo_procgen.py``), where TensorFlow's SAME pads 0 before and 1 after;
before each tick the state and the previous action and reward are
multiplied by ``1 - done`` of the tick before (CleanRL's
``ppo_atari_lstm.py``); frames are the env's 64x64x3, not DMLab's 96x72.

Every function runs with TF32 off for matrix products and convolutions,
the flags restored after.  Two lower-precision controls: the trunk's
``'float8'`` rounds every input and weight of the convolutions and the
dense layer to float8 e4m3 with a per-tensor scale (``policy._float8``);
the core's ``'bfloat16'`` computes the LSTM and the heads in bfloat16 and
keeps the state in bfloat16 from tick to tick.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from .policy import _float8

STACKS = (16, 32, 32)
BLOCKS = 2
WIDTH = 256
HIDDEN = 256


def shapes(input_hw=(64, 64), n_actions=17, stacks=STACKS, blocks=BLOCKS,
           width=WIDTH, hidden=HIDDEN) -> dict:
  """``{name: shape}`` of every parameter, in the port's order."""
  out, c = {}, 3
  h, w = input_hw
  for i, c_out in enumerate(stacks):
    convs = [f'stacks.{i}.conv'] + [f'stacks.{i}.res.{j}.conv{k}'
                                     for j in range(blocks) for k in (0, 1)]
    for name in convs:
      out[f'{name}.weight'] = (c_out, c if name == convs[0] else c_out, 3, 3)
      out[f'{name}.bias'] = (c_out,)
    c, h, w = c_out, (h - 1) // 2 + 1, (w - 1) // 2 + 1
  out['fc.weight'] = (width, h * w * c)
  out['fc.bias'] = (width,)
  out['lstm_ih.weight'] = (4 * hidden, width + n_actions + 1)
  out['lstm_ih.bias'] = (4 * hidden,)
  out['lstm_hh.weight'] = (4 * hidden, hidden)
  out['logits.weight'] = (n_actions, hidden)
  out['logits.bias'] = (n_actions,)
  out['value.weight'] = (1, hidden)
  out['value.bias'] = (1,)
  return out


def float32_only(fn):
  """``fn`` with TF32 off for matrix products and convolutions."""
  @functools.wraps(fn)
  def wrapped(*args, **kwargs):
    with no_tf32():
      return fn(*args, **kwargs)
  return wrapped


@contextlib.contextmanager
def no_tf32():
  flags = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


@float32_only
def trunk(params: dict, obs: torch.Tensor,
          precision: str = 'float32') -> torch.Tensor:
  """``(N, WIDTH)`` features of uint8 frames ``(N, H, W, 3)``."""
  q = _float8 if precision == 'float8' else (lambda t: t)
  conv = lambda name, x: F.conv2d(q(x), q(params[f'{name}.weight']),
                                  params[f'{name}.bias'], padding=1)
  x = obs.to(torch.float32).permute(0, 3, 1, 2) / 255.0
  i = 0
  while f'stacks.{i}.conv.weight' in params:
    x = F.max_pool2d(conv(f'stacks.{i}.conv', x), 3, stride=2, padding=1)
    j = 0
    while f'stacks.{i}.res.{j}.conv0.weight' in params:
      block = f'stacks.{i}.res.{j}'
      x = x + conv(f'{block}.conv1',
                   F.relu(conv(f'{block}.conv0', F.relu(x))))
      j += 1
    i += 1
  x = F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
  return F.relu(F.linear(q(x), q(params['fc.weight']), params['fc.bias']))


@float32_only
def step(params: dict, feat, h, c, prev_action, prev_reward, reset,
         precision: str = 'float32'):
  """One LSTM tick of ``B`` envs and the heads: ``(logits, value, h, c)``,
  logits and value float32.  The state and the previous action and reward
  are zeroed where ``reset`` (the tick before ended an episode)."""
  dt = torch.bfloat16 if precision == 'bfloat16' else torch.float32
  p = lambda name: params[name].to(dt)
  keep = 1.0 - reset.to(dt)[:, None]
  n_actions = params['logits.weight'].shape[0]
  x = torch.cat([feat.to(dt), F.one_hot(prev_action, n_actions).to(dt) * keep,
                 prev_reward.clamp(-1.0, 1.0).to(dt)[:, None] * keep], -1)
  gates = (F.linear(x, p('lstm_ih.weight'), p('lstm_ih.bias'))
           + F.linear(h.to(dt) * keep, p('lstm_hh.weight')))
  i, f, g, o = gates.chunk(4, -1)
  c = torch.sigmoid(f) * (c.to(dt) * keep) + torch.sigmoid(i) * torch.tanh(g)
  h = torch.sigmoid(o) * torch.tanh(c)
  logits = F.linear(h, p('logits.weight'), p('logits.bias'))
  value = F.linear(h, p('value.weight'), p('value.bias'))[:, 0]
  return logits.float(), value.float(), h, c


@float32_only
def forward(params: dict, obs, h, c, prev_action, prev_reward, reset,
            trunk_precision: str = 'float32',
            core_precision: str = 'float32'):
  """``T`` ticks of ``B`` envs from the state ``(h, c)``: logits
  ``(T, B, A)``, values ``(T, B)`` and the state after the last tick.
  ``obs`` ``(T, B, H, W, 3)`` uint8; the other inputs ``(T, B)``.  The
  trunk takes every frame at once (it has no state); the LSTM steps."""
  feat = trunk(params, obs.reshape((-1,) + obs.shape[2:]),
               trunk_precision).reshape(obs.shape[:2] + (-1,))
  logits, values = [], []
  for t in range(obs.shape[0]):
    out = step(params, feat[t], h, c, prev_action[t], prev_reward[t],
               reset[t], core_precision)
    logits.append(out[0])
    values.append(out[1])
    h, c = out[2], out[3]
  return torch.stack(logits), torch.stack(values), (h, c)
