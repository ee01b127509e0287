"""Roll-and-select stages over int32 rows: the micro-bench kernel's wrapper
(``csrc/roll.cu``) and its plain twin.

Replaces the TPU kernel of ``tools/bench_roll.py:make``.  On ``(n, 4096)``
int32 rows, stage ``k`` of ``stages`` (``b = k % 12``) replaces the elements
whose column index has bit ``b`` set by ``f_k(x)``: the row rotated left by
``1 << b`` (``'roll'``), by 1 (``'roll1'``), or ``x * 3 + k`` wrapping
(``'ctl'``, the arithmetic control).  ``tools/bench_roll_cuda.py`` times the
three kinds against each other.  For CUDA tensors :func:`roll_stages`
launches the kernel; for CPU tensors it runs the twin.
``roll_stages.launches`` counts kernel launches.  The kernel streams rows
with the bulk copy, which needs 16-byte aligned rows: input whose storage
offset breaks that (a view) is copied into a fresh tensor first.
:func:`occupancy` gives the kernel's resident blocks an SM, shared memory a
block and ring depth for a kind.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

COLS = 4096
KINDS = ('ctl', 'roll', 'roll1')


def roll_stages_plain(x: torch.Tensor, kind: str, stages: int) -> torch.Tensor:
  """The stages with ``torch.roll`` and ``torch.where``."""
  _check(x, kind)
  j = torch.arange(x.shape[1], device=x.device)
  for k in range(stages):
    b = k % 12
    if kind == 'roll':
      f = torch.roll(x, -(1 << b), dims=1)
    elif kind == 'roll1':
      f = torch.roll(x, -1, dims=1)
    else:
      f = x * 3 + k
    x = torch.where((j >> b) & 1 != 0, f, x)
  return x


def roll_stages(x: torch.Tensor, kind: str, stages: int) -> torch.Tensor:
  """``stages`` roll-and-select (or control) stages on ``x`` (n, 4096)
  int32; returns a new tensor."""
  _check(x, kind)
  if not x.is_cuda:
    return roll_stages_plain(x, kind, stages)
  if x.shape[0] == 0:
    return x.clone()
  x = x.contiguous()
  if x.data_ptr() % 16:
    x = x.clone()          # a fresh allocation is aligned
  out = torch.empty_like(x)
  lib = _build.library()
  _build.check(lib.crafter_roll(
      x.data_ptr(), out.data_ptr(), x.shape[0], KINDS.index(kind),
      int(stages), torch.cuda.current_stream(x.device).cuda_stream), 'roll')
  roll_stages.launches += 1
  return out


roll_stages.launches = 0


def occupancy(kind: str) -> tuple[int, int, int]:
  """``(blocks of 256 threads an SM, shared-memory bytes a block, ring
  depth in rows)`` of the kernel for ``kind``."""
  if kind not in KINDS:
    raise ValueError(f'kind={kind!r} is not one of {KINDS}')
  out = [ctypes.c_int() for _ in range(3)]
  _build.check(_build.library().crafter_roll_occupancy(
      KINDS.index(kind), *(ctypes.byref(o) for o in out)), 'roll occupancy')
  return tuple(o.value for o in out)


def _check(x: torch.Tensor, kind: str) -> None:
  if kind not in KINDS:
    raise ValueError(f'kind={kind!r} is not one of {KINDS}')
  if x.ndim != 2 or x.shape[1] != COLS or x.dtype != torch.int32:
    raise ValueError(f'x {tuple(x.shape)} {x.dtype}: want (n, {COLS}) int32')
