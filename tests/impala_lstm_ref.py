"""The IMPALA ResNet-LSTM policy and one recurrent PPO update in plain
float32 PyTorch: the reference that the tests hold the port's
``models/impala.py`` and its recurrent learner (``ppo.py``) to.

Imports neither JAX, nor ``crafter_tpu``, nor any module of the port.
Parameters are a dict of float32 tensors named as the port's
``named_parameters()``: conv weights OIHW, linear weights (out, in).  Every
public function runs with TF32 off (``torch.backends.cuda.matmul`` and
``torch.backends.cudnn``), the flags restored after.

The network is Espeholt et al. 2018 (IMPALA, arXiv:1802.01561, Fig. 3
right): three stacks of 16, 32, 32 channels, each a 3x3 convolution
(stride 1, same padding), a 3x3 max-pool of stride 2 and two residual
blocks ``x + conv(relu(conv(relu(x))))``; ReLU, flatten in (H, W, C) order,
a dense layer of 256 and ReLU; an LSTM of 256 (gates i, f, g, o) fed the
dense output, the one-hot previous action and the previous reward clipped
to [-1, 1]; linear heads for the logits and the value.  The LSTM steps one
tick at a time in a Python loop.  Departures:

* the max-pool pads one pixel on each side (PyTorch's ``padding=1``, as
  CleanRL's ``ppo_procgen.py``), where TensorFlow's SAME pads 0 before and
  1 after;
* CleanRL's recurrent-PPO rule (``ppo_atari_lstm.py``): before each tick
  the state, the previous action and the previous reward are multiplied by
  ``1 - done`` of the tick before, and the sequence is cut at the rollout's
  start (the learner starts each sequence from the stored state);
* PPO (arXiv:1707.06347) learns in place of IMPALA's V-trace, with the
  port's settings: advantages normalised per minibatch, the gradients
  clipped to a global norm as optax clips them, Adam with eps 1e-5;
  minibatches are whole env sequences, ``num_envs / minibatches`` envs each,
  from one env permutation per epoch;
* frames are the env's 64x64x3, where IMPALA used DMLab's 96x72.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

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
    with _no_tf32():
      return fn(*args, **kwargs)
  return wrapped


@contextlib.contextmanager
def _no_tf32():
  flags = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _conv(params, name, x):
  return F.conv2d(x, params[f'{name}.weight'], params[f'{name}.bias'],
                  padding=1)


@float32_only
def trunk(params: dict, obs: torch.Tensor) -> torch.Tensor:
  """``(N, WIDTH)`` features of uint8 frames ``(N, H, W, 3)``."""
  x = obs.to(torch.float32).permute(0, 3, 1, 2) / 255.0
  i = 0
  while f'stacks.{i}.conv.weight' in params:
    x = F.max_pool2d(_conv(params, f'stacks.{i}.conv', x), 3, stride=2,
                     padding=1)
    j = 0
    while f'stacks.{i}.res.{j}.conv0.weight' in params:
      block = f'stacks.{i}.res.{j}'
      x = x + _conv(params, f'{block}.conv1',
                    F.relu(_conv(params, f'{block}.conv0', F.relu(x))))
      j += 1
    i += 1
  x = F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
  return F.relu(F.linear(x, params['fc.weight'], params['fc.bias']))


@float32_only
def step(params: dict, feat, h, c, prev_action, prev_reward, reset):
  """One LSTM tick of ``B`` envs and the heads: ``(logits, value, h, c)``.
  The state and the previous action and reward are zeroed where ``reset``
  (the tick before ended an episode)."""
  keep = 1.0 - reset.to(torch.float32)[:, None]
  n_actions = params['logits.weight'].shape[0]
  x = torch.cat([feat, F.one_hot(prev_action, n_actions).float() * keep,
                 prev_reward.clamp(-1.0, 1.0)[:, None] * keep], -1)
  gates = (F.linear(x, params['lstm_ih.weight'], params['lstm_ih.bias'])
           + F.linear(h * keep, params['lstm_hh.weight']))
  i, f, g, o = gates.chunk(4, -1)
  c = torch.sigmoid(f) * (c * keep) + torch.sigmoid(i) * torch.tanh(g)
  h = torch.sigmoid(o) * torch.tanh(c)
  logits = F.linear(h, params['logits.weight'], params['logits.bias'])
  value = F.linear(h, params['value.weight'], params['value.bias'])[:, 0]
  return logits, value, h, c


@float32_only
def forward(params: dict, obs, h, c, prev_action, prev_reward, reset):
  """``T`` ticks of ``B`` envs from the state ``(h, c)``: logits
  ``(T, B, A)``, values ``(T, B)`` and the state after the last tick.
  ``obs`` ``(T, B, H, W, 3)`` uint8; the other inputs ``(T, B)``.  The
  trunk takes every frame at once (it has no state); the LSTM steps."""
  feat = trunk(params, obs.reshape((-1,) + obs.shape[2:])).reshape(
      obs.shape[:2] + (-1,))
  logits, values = [], []
  for t in range(obs.shape[0]):
    out = step(params, feat[t], h, c, prev_action[t], prev_reward[t],
               reset[t])
    logits.append(out[0])
    values.append(out[1])
    h, c = out[2], out[3]
  return torch.stack(logits), torch.stack(values), (h, c)


def gae(value, reward, done, last_value, gamma=0.99, lam=0.95):
  """Advantages and returns of ``(T, B)`` rollouts."""
  adv = torch.empty_like(value)
  running = torch.zeros_like(last_value)
  next_value = last_value
  for t in range(value.shape[0] - 1, -1, -1):
    nonterm = 1.0 - done[t].to(torch.float32)
    delta = reward[t] + gamma * next_value * nonterm - value[t]
    running = delta + gamma * lam * nonterm * running
    adv[t] = running
    next_value = value[t]
  return adv, adv + value


def loss(params: dict, mb: dict, adv, ret, clip=0.2, vf_coef=0.5,
         ent_coef=0.01):
  """PPO's loss over a minibatch of whole sequences, advantages normalised
  over it: ``(loss, pg, v_loss, entropy)``."""
  logits, value, _ = forward(params, mb['obs'], mb['h'], mb['c'],
                             mb['prev_action'], mb['prev_reward'],
                             mb['reset'])
  logp_all = torch.log_softmax(logits, -1)
  logp = logp_all.gather(-1, mb['action'][..., None])[..., 0]
  adv = (adv - adv.mean()) / (torch.sqrt(torch.square(
      adv - adv.mean()).mean()) + 1e-8)
  ratio = torch.exp(logp - mb['logp'])
  pg = -torch.minimum(ratio * adv,
                      torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
  v_loss = 0.5 * torch.square(value - ret).mean()
  entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
  return pg + vf_coef * v_loss - ent_coef * entropy, pg, v_loss, entropy


@float32_only
def learn(params: dict, opt: torch.optim.Optimizer, batch: dict,
          last_value, env_perms, minibatches: int, max_grad_norm=0.5,
          **hyper):
  """One update's learning on a rollout ``batch`` (``(T, N)`` leaves
  ``obs``, ``action``, ``logp``, ``value``, ``reward``, ``done``,
  ``prev_action``, ``prev_reward``, ``reset``; ``(N, HIDDEN)`` ``h`` and
  ``c``): GAE, then for each epoch's env permutation its ``minibatches``
  groups of envs, each a loss, its gradient, the clip and an Adam step of
  ``opt`` over ``params`` (leaves that require grad).  Returns each
  minibatch's loss and the first minibatch's clipped gradient."""
  gamma, lam = hyper.pop('gamma', 0.99), hyper.pop('gae_lambda', 0.95)
  adv, ret = gae(batch['value'], batch['reward'], batch['done'], last_value,
                 gamma, lam)
  losses, first_grad = [], None
  for perm in env_perms:
    for idx in perm.reshape(minibatches, -1):
      mb = {name: (x[idx] if name in ('h', 'c') else x[:, idx])
            for name, x in batch.items()}
      opt.zero_grad(set_to_none=True)
      total = loss(params, mb, adv[:, idx], ret[:, idx], **hyper)[0]
      total.backward()
      grads = [p.grad for p in params.values()]
      norm = torch.linalg.vector_norm(
          torch.stack([torch.linalg.vector_norm(g) for g in grads]))
      with torch.no_grad():
        for g in grads:
          g.copy_(torch.where(norm < max_grad_norm, g,
                              g / norm * max_grad_norm))
      if first_grad is None:
        first_grad = {n: p.grad.detach().clone() for n, p in params.items()}
      losses.append(total.detach())
      opt.step()
  return losses, first_grad
