"""Carry a batched state across from the JAX package, and back out as numpy.

``state_from_numpy`` takes the JAX package's ``VecState`` (or ``State``)
after its leaves were turned into numpy arrays, with every PRNG key as its
``(N, 2)`` uint32 key data.  It reads fields by name, from attributes or
mapping keys, so it needs none of the JAX package's types.  The port never
sees a JAX array.
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
