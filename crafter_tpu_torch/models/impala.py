"""IMPALA ResNet-LSTM actor-critic for pixel observations.

The "large" network of Espeholt et al. 2018 (IMPALA, arXiv:1802.01561,
Fig. 3 right) over the env's 64x64x3 frames:

* three stacks of 16, 32 and 32 channels, each a 3x3 convolution (stride
  1, same padding), a 3x3 max-pool of stride 2 and two residual blocks
  ``y = x + conv(relu(conv(relu(x))))``;
* ReLU, flatten (8 x 8 x 32 = 2,048 at 64x64), a dense layer of 256, ReLU;
* an LSTM of 256 (gates i, f, g, o; ``c' = f c + i g``, ``h' = o tanh(c')``)
  fed the dense output, the one-hot previous action and the previous
  reward clipped to [-1, 1];
* linear heads on ``h'``: the action logits and the value.

Departures from the paper: the max-pool pads one pixel on each side
(PyTorch's ``padding=1``, as CleanRL's ``ppo_procgen.py``), where
TensorFlow's SAME pads 0 before and 1 after; and the recurrent-PPO rule of
CleanRL's ``ppo_atari_lstm.py``: before each tick the core's state and its
previous action and reward are multiplied by ``1 - done`` of the tick
before, so an episode starts from zeros.

Precision as :class:`CnnPolicy`: the trunk and the dense layer compute in
bfloat16 from float32 parameters (``channels_last`` activations, cuDNN
convolutions on the card); the LSTM and the heads in float32.

Two entry points share the cell: :meth:`ImpalaLstmPolicy.step`, one tick of
``N`` envs (the rollout), and :meth:`ImpalaLstmPolicy.sequence`, ``T`` ticks
of ``B`` envs from a stored state (learn): the trunk over all ``T * B``
frames at once, then a masked scan of ``T`` cell steps that autograd
differentiates through.  The rollout's ``step`` runs inside a ``lstm``
span, the learn scan inside a ``lstm_scan`` span, and both count the cell
steps they issue (``lstm_steps``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling
from .cnn import _TRUNC_STD, PolicyOutput

# The published widths: channels of the three stacks, residual blocks a
# stack, the dense layer and the LSTM.
STACKS = (16, 32, 32)
BLOCKS = 2
WIDTH = 256
HIDDEN = 256


@dataclasses.dataclass
class LstmCarry:
  """What the core carries from one tick to the next, per env: its state
  after the tick, and the tick's action, training reward and done flag
  (the next tick's inputs and reset mask)."""

  h: torch.Tensor        # (N, HIDDEN) float32
  c: torch.Tensor        # (N, HIDDEN) float32
  action: torch.Tensor   # (N,) int64
  reward: torch.Tensor   # (N,) float32, unclipped
  done: torch.Tensor     # (N,) bool


@dataclasses.dataclass
class CoreInputs:
  """The core's inputs over ``T`` ticks of ``B`` envs besides the frames:
  the state before the first tick, and per tick the previous action and
  reward and whether the tick before ended an episode (``reset``)."""

  h: torch.Tensor            # (B, HIDDEN) float32
  c: torch.Tensor            # (B, HIDDEN) float32
  prev_action: torch.Tensor  # (T, B) int64
  prev_reward: torch.Tensor  # (T, B) float32, unclipped
  reset: torch.Tensor        # (T, B) bool

  def envs(self, index) -> 'CoreInputs':
    """The inputs of envs ``index``."""
    return CoreInputs(self.h[index], self.c[index],
                      self.prev_action[:, index], self.prev_reward[:, index],
                      self.reset[:, index])


class _Stack(nn.Module):
  """Conv 3x3, max-pool 3/2, two residual blocks."""

  def __init__(self, c_in: int, c_out: int, blocks: int, **kw):
    super().__init__()
    self.conv = nn.Conv2d(c_in, c_out, 3, padding=1, **kw)
    self.res = nn.ModuleList(_Residual(c_out, **kw) for _ in range(blocks))


class _Residual(nn.Module):

  def __init__(self, channels: int, **kw):
    super().__init__()
    self.conv0 = nn.Conv2d(channels, channels, 3, padding=1, **kw)
    self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, **kw)


class ImpalaLstmPolicy(nn.Module):
  """The IMPALA ResNet trunk, an LSTM core and two heads.

  Takes uint8 frames: ``(N, H, W, 3)`` a tick, ``(T, B, H, W, 3)`` a
  sequence.  The widths are the published ones.  Parameters are float32,
  initialised as :class:`CnnPolicy`'s (truncated normal of variance
  1/fan_in, zero biases) from ``generator``, or from the global generator
  when none is given.
  """

  def __init__(self, n_actions: int = 17,
               input_hw: Tuple[int, int] = (64, 64),
               compute_dtype: torch.dtype = torch.bfloat16,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.n_actions = n_actions
    self.input_hw = tuple(input_hw)
    self.compute_dtype = compute_dtype
    kw = dict(device=device, dtype=torch.float32)
    self.stacks = nn.ModuleList()
    c, (h, w) = 3, self.input_hw
    for c_out in STACKS:
      self.stacks.append(_Stack(c, c_out, BLOCKS, **kw))
      c, h, w = c_out, (h - 1) // 2 + 1, (w - 1) // 2 + 1
    self.fc = nn.Linear(h * w * c, WIDTH, **kw)
    # The gates' input projection of [dense output, one-hot previous
    # action, previous reward] with the bias, and the state's, unbiased.
    self.lstm_ih = nn.Linear(WIDTH + n_actions + 1, 4 * HIDDEN, **kw)
    self.lstm_hh = nn.Linear(HIDDEN, 4 * HIDDEN, bias=False, **kw)
    self.logits = nn.Linear(HIDDEN, n_actions, **kw)
    self.value = nn.Linear(HIDDEN, 1, **kw)
    with torch.no_grad():
      for name, p in self.named_parameters():
        if name.endswith('.bias'):
          p.zero_()
          continue
        std = math.sqrt(1.0 / p[0].numel()) / _TRUNC_STD
        # Drawn on the CPU, so that one seed gives one policy on any device.
        draw = torch.empty(p.shape, dtype=torch.float32)
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        p.copy_(draw * std)

  # -- the parts --------------------------------------------------------------

  def trunk(self, obs: torch.Tensor) -> torch.Tensor:
    """``(N, WIDTH)`` float32 features of uint8 frames ``(N, H, W, 3)``."""
    dt = self.compute_dtype
    conv = lambda x, m: F.conv2d(x, m.weight.to(dt), m.bias.to(dt),
                                 padding=1)
    x = (obs.to(dt) / 255.0).permute(0, 3, 1, 2)  # channels_last memory
    for stack in self.stacks:
      x = F.max_pool2d(conv(x, stack.conv), 3, stride=2, padding=1)
      for block in stack.res:
        x = x + conv(F.relu(conv(F.relu(x), block.conv0)), block.conv1)
    x = F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (H, W, C)
    x = F.relu(F.linear(x, self.fc.weight.to(dt), self.fc.bias.to(dt)))
    return x.to(torch.float32)

  def _gate_inputs(self, feat, prev_action, prev_reward, keep):
    """The gates' input projection of the features and the previous action
    and reward, the latter two zeroed where ``keep`` is 0."""
    x = torch.cat([feat,
                   F.one_hot(prev_action, self.n_actions).to(feat.dtype)
                   * keep,
                   prev_reward.clamp(-1.0, 1.0)[..., None] * keep], -1)
    return self.lstm_ih(x)

  def _cell(self, gates_x, h, c):
    i, f, g, o = (gates_x + self.lstm_hh(h)).chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c

  def _heads(self, h) -> PolicyOutput:
    return PolicyOutput(logits=self.logits(h), value=self.value(h)[..., 0])

  # -- entry points -----------------------------------------------------------

  def step(self, obs: torch.Tensor, carry: LstmCarry):
    """One tick: ``(PolicyOutput (N,), (h, c))`` of frames ``(N, H, W, 3)``
    from the carry of the tick before."""
    feat = self.trunk(obs)
    with profiling.span('lstm'):
      keep = (~carry.done).to(torch.float32)[:, None]
      h, c = self._cell(
          self._gate_inputs(feat, carry.action, carry.reward, keep),
          carry.h * keep, carry.c * keep)
      profiling.count('lstm_steps', 1)
    return self._heads(h), (h, c)

  def sequence(self, obs: torch.Tensor, core: CoreInputs) -> PolicyOutput:
    """``T`` ticks: logits ``(T, B, A)`` and values ``(T, B)`` of frames
    ``(T, B, H, W, 3)``, the scan differentiable through every step."""
    t_len, b = obs.shape[:2]
    feat = self.trunk(obs.reshape((-1,) + obs.shape[2:])).reshape(
        t_len, b, -1)
    keep = (~core.reset).to(torch.float32)[..., None]
    gates_x = self._gate_inputs(feat, core.prev_action, core.prev_reward,
                                keep)
    h, c, hs = core.h, core.c, []
    with profiling.span('lstm_scan'):
      for t in range(t_len):
        h, c = self._cell(gates_x[t], h * keep[t], c * keep[t])
        hs.append(h)
      profiling.count('lstm_steps', t_len)
    return self._heads(torch.stack(hs))

  def zero_carry(self, n: int, device) -> LstmCarry:
    """The carry before an env's first tick: zeros, and ``done`` set so
    that the first tick starts from them."""
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(
        shape, dtype=dtype, device=device)
    return LstmCarry(
        h=zeros(n, HIDDEN), c=zeros(n, HIDDEN),
        action=zeros(n, dtype=torch.int64), reward=zeros(n),
        done=torch.ones((n,), dtype=torch.bool, device=device))
