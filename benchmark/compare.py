"""The comparisons that decide ``correct``: exact counts for the env's
integer state, rewards, flags and frames, and norm gaps for training."""

from __future__ import annotations

import dataclasses
import statistics

import torch

from benchmark.reference import env as ref_env
from benchmark.reference import state as ref_state
from benchmark.reference import step as ref_step

_REF_CLASSES = {cls.__name__: cls for cls in (
    ref_env.VecState, ref_state.State, ref_state.EntMaps, ref_state.Player,
    ref_step.StepOut)}


def to_reference(tree):
  """A state or result of the program as the reference's dataclass of the
  same name and fields (the tensors are shared, not copied)."""
  if dataclasses.is_dataclass(tree):
    cls = _REF_CLASSES[type(tree).__name__]
    return cls(**{f.name: to_reference(getattr(tree, f.name))
                  for f in dataclasses.fields(cls)})
  return tree


def leaves(tree, prefix=''):
  if dataclasses.is_dataclass(tree):
    for f in dataclasses.fields(tree):
      yield from leaves(getattr(tree, f.name), f'{prefix}{f.name}.')
  else:
    yield prefix.rstrip('.'), tree


def mismatch(got, want) -> int:
  """Elements that differ between two trees of the same fields (a leaf of
  another shape counts whole); 0 when equal bit for bit."""
  bad = 0
  want_leaves = dict(leaves(want))
  for name, g in leaves(got):
    w = want_leaves[name]
    g, w = torch.as_tensor(g), torch.as_tensor(w)
    if g.shape != w.shape:
      bad += max(g.numel(), w.numel())
      continue
    g = g.to(w.device)
    if g.dtype.is_floating_point or w.dtype.is_floating_point:
      # Bit patterns: -0.0 and 0.0 differ, a NaN equals itself.
      g = g.to(w.dtype).contiguous().view(torch.int32 if w.element_size() == 4
                                          else torch.uint8)
      w = w.contiguous().view(g.dtype)
    bad += int((g != w).sum())
  return bad


def rows(tree, index):
  """Rows ``index`` of every leaf with a leading env axis."""
  if dataclasses.is_dataclass(tree):
    return type(tree)(**{f.name: rows(getattr(tree, f.name), index)
                         for f in dataclasses.fields(tree)})
  return tree[index] if tree.ndim else tree


def _kept(want: dict, gate: dict):
  """The leaves whose ``gate`` norm (the reference's first gradient) is at
  least a thousandth of the median leaf's (Adam moves the others by
  round-off alone), with the reference's norm of each and of the median
  kept leaf."""
  gate_norm = {n: float(torch.linalg.vector_norm(v)) for n, v in gate.items()}
  floor = 1e-3 * statistics.median(gate_norm.values())
  names = [n for n in want if gate_norm[n] >= floor]
  ref_norm = {n: float(torch.linalg.vector_norm(want[n])) for n in names}
  return ref_norm, statistics.median(ref_norm.values())


def norm_gap(got: dict, want: dict, gate: dict) -> float:
  """The worst leaf's gap between the program's norm and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf.  A leaf missing on the program's side counts as a gap of 1."""
  ref_norm, median = _kept(want, gate)
  worst = 0.0
  for n, r in ref_norm.items():
    if n not in got:
      return 1.0
    g = float(torch.linalg.vector_norm(got[n].to(want[n].device).float()))
    worst = max(worst, abs(g - r) / max(r, median))
  return worst


def norm_diff(got: dict, want: dict, gate: dict) -> float:
  """The worst leaf's norm of the difference, over the larger of the
  reference's norm of that leaf and of the median leaf: for a quantity
  both sides compute from the same weights and data, such as the first
  gradient.  A leaf missing on the program's side counts as 1."""
  ref_norm, median = _kept(want, gate)
  worst = 0.0
  for n, r in ref_norm.items():
    if n not in got:
      return 1.0
    d = float(torch.linalg.vector_norm(got[n].to(want[n].device).float()
                                       - want[n]))
    worst = max(worst, d / max(r, median))
  return worst
