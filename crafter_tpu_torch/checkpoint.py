"""Checkpoint and resume over ``torch.save``.

The port's counterpart of ``crafter_tpu/checkpoint.py``.  The entire
training state checkpoints and restores bit for bit: policy parameters,
optimizer state, PRNG key, counters and the batched env state (the
host-side tick too), so a run resumes mid-episode with identical results.

A state is a tree of dataclasses, dicts, lists and tuples whose leaves are
tensors, Python numbers, ``nn.Module``s and optimizers (saved as their
``state_dict``).  ``restore_latest`` rebuilds it along a template of the
same structure: tensors move to the template's devices, and a module or an
optimizer of the template is loaded in place and returned.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
from typing import Any, Optional

import torch

_NAME = re.compile(r'ckpt_(\d+)\.pt$')


def _pack(obj):
  if isinstance(obj, (torch.nn.Module, torch.optim.Optimizer)):
    return obj.state_dict()
  if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
    return {f.name: _pack(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}
  if isinstance(obj, dict):
    return {name: _pack(v) for name, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return [_pack(v) for v in obj]
  return obj


def _unpack(template, saved):
  if isinstance(template, (torch.nn.Module, torch.optim.Optimizer)):
    template.load_state_dict(saved)
    return template
  if dataclasses.is_dataclass(template) and not isinstance(template, type):
    return type(template)(**{
        f.name: _unpack(getattr(template, f.name), saved[f.name])
        for f in dataclasses.fields(template)})
  if isinstance(template, dict):
    return {name: _unpack(v, saved[name]) for name, v in template.items()}
  if isinstance(template, (list, tuple)):
    return type(template)(_unpack(t, s) for t, s in zip(template, saved))
  if isinstance(template, torch.Tensor):
    return saved.to(template.device)
  return saved


class Checkpointer:
  """Numbered checkpoints ``ckpt_<step>.pt`` in a directory, the newest
  ``keep`` of them kept."""

  def __init__(self, directory, keep: int = 3):
    self._dir = pathlib.Path(directory).absolute()
    self._dir.mkdir(parents=True, exist_ok=True)
    self._keep = keep

  def _steps(self):
    return sorted(int(m.group(1)) for m in
                  (_NAME.match(p.name) for p in self._dir.iterdir()) if m)

  def _path(self, step: int) -> pathlib.Path:
    return self._dir / f'ckpt_{step:010d}.pt'

  def save(self, step: int, state: Any) -> None:
    tmp = self._path(step).with_suffix('.tmp')
    torch.save(_pack(state), tmp)
    os.replace(tmp, self._path(step))    # atomic: never a half-written file
    for old in self._steps()[:-self._keep]:
      self._path(old).unlink()

  def restore_latest(self, template: Any) -> Optional[Any]:
    step = self.latest_step
    if step is None:
      return None
    # weights_only: the file holds tensors, numbers and containers only.
    saved = torch.load(self._path(step), map_location='cpu',
                       weights_only=True)
    return _unpack(template, saved)

  @property
  def latest_step(self) -> Optional[int]:
    steps = self._steps()
    return steps[-1] if steps else None
