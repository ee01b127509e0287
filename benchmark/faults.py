"""What the drivers' planted faults share (each driver's ``fault(name)``
plants them under its entry; ``calibrate.py`` reads them): an attribute
replaced for a block, and half of a batch of env rows."""

from __future__ import annotations

import dataclasses


def patch(owner, name, make):
  """Replace ``owner.name`` by ``make(original)``; returns the undo."""
  original = getattr(owner, name)
  setattr(owner, name, make(original))
  return lambda: setattr(owner, name, original)


def half(tree, n):
  """Leaves with a leading env axis of ``n``: the first half's rows."""
  if dataclasses.is_dataclass(tree):
    return type(tree)(**{f.name: half(getattr(tree, f.name), n)
                         for f in dataclasses.fields(tree)})
  return tree[:n // 2] if tree.ndim and tree.shape[0] == n else tree


def join_half(new, old, n):
  """``new``'s rows for the first half, ``old``'s for the rest."""
  import torch
  if dataclasses.is_dataclass(new):
    return type(new)(**{f.name: join_half(getattr(new, f.name),
                                          getattr(old, f.name), n)
                        for f in dataclasses.fields(new)})
  if old.ndim and old.shape[0] == n:
    return torch.cat([new, old[n // 2:]])
  return new
