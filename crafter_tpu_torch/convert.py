"""Carry a batched state across from the JAX package, and back out as numpy.

``state_from_numpy`` takes the JAX package's ``VecState`` (or ``State``)
after its leaves were turned into numpy arrays, with every PRNG key as its
``(N, 2)`` uint32 key data.  It reads fields by name, from attributes or
mapping keys, so it needs none of the JAX package's types.
``policy_from_flax`` turns the flax parameter tree of the JAX package's
``CnnPolicy``, as numpy arrays, into the port's ``state_dict``.  The port
never sees a JAX array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .env import VecState
from .state import EntMaps, Player, State


def _get(tree, name):
  return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _tensor(a, device, key=False) -> torch.Tensor:
  a = np.asarray(a)
  if key:
    if a.dtype != np.uint32 or a.shape[-1] != 2:
      raise ValueError(f'key data must be (..., 2) uint32, got {a.dtype} '
                       f'{a.shape}')
    a = a.astype(np.int64)
  return torch.from_numpy(np.array(a)).to(device)


def _build(cls, tree, device):
  kw = {}
  for f in dataclasses.fields(cls):
    v = _get(tree, f.name)
    sub = {'ent': EntMaps, 'player': Player, 'env': State}.get(f.name)
    if sub is not None:
      kw[f.name] = _build(sub, v, device)
    else:
      # The global tick counter lives on the host (env.VecState).
      kw[f.name] = _tensor(v, 'cpu' if f.name == 'tick' else device,
                           key=f.name in ('key', 'home_key'))
  return cls(**kw)


def state_from_numpy(tree, device='cuda'):
  """A :class:`VecState` (if ``tree`` has an ``env`` field) or a
  :class:`State` from the JAX package's state as numpy arrays."""
  has_env = ('env' in tree) if isinstance(tree, dict) else hasattr(tree, 'env')
  return _build(VecState if has_env else State, tree, device)


def to_numpy(obj):
  """Nested dict of numpy arrays from a dataclass of tensors (a state, a
  ``StepOut``, a ``GroupSnaps``), a dict of tensors (an ``info``) or a
  tensor (frames); PRNG keys come out as uint32 key data."""
  if isinstance(obj, dict):
    return {name: to_numpy(v) for name, v in obj.items()}
  if dataclasses.is_dataclass(obj):
    out = {}
    for f in dataclasses.fields(obj):
      v = to_numpy(getattr(obj, f.name))
      if f.name in ('key', 'home_key'):
        v = v.astype(np.uint32)
      out[f.name] = v
    return out
  return obj.detach().cpu().numpy()


def policy_from_flax(params) -> dict:
  """The ``state_dict`` of :class:`crafter_tpu_torch.models.CnnPolicy` from
  the flax parameters of the JAX package's ``CnnPolicy`` as (nested dicts
  of) numpy arrays, with or without the outer ``'params'`` level.

  Convolution kernels go from HWIO to OIHW and dense kernels from
  ``(in, out)`` to ``(out, in)``.  The dense layer's input rows stay in
  flax's (H, W, C) order: the port's policy flattens its activations in
  that order too.
  """
  tree = params['params'] if 'params' in params else params
  names = {'conv1': 'Conv_0', 'conv2': 'Conv_1', 'conv3': 'Conv_2',
           'dense': 'Dense_0', 'logits': 'Dense_1', 'value': 'Dense_2'}
  out = {}
  for ours, theirs in names.items():
    kernel = np.asarray(tree[theirs]['kernel'], np.float32)
    axes = (3, 2, 0, 1) if kernel.ndim == 4 else (1, 0)
    out[f'{ours}.weight'] = torch.from_numpy(
        np.array(kernel.transpose(axes), order='C'))
    out[f'{ours}.bias'] = torch.from_numpy(
        np.array(tree[theirs]['bias'], np.float32))
  return out
