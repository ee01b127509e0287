"""The wrapper of the threefry kernel (``csrc/threefry.cu``).

``prng.split``, ``fold_in``, ``random_bits`` and ``uniform`` call it for
CUDA keys, one launch a draw; their int64 PyTorch code (``prng.py:
threefry2x32``) is the plain twin, which CPU keys take.  ``draw.launches``
counts the kernel's launches and ``draw.launches_by_mode`` splits them by
``MODES``.

Keys are the API's int64 words ``(..., 2)``, read with their strides (no
copy where the leading dims flatten to one stride).  A draw's counters are
computed in the kernel from :func:`geometry`, the flat indices of
``prng._counters``; the card tests hold the two to each other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

MODES = ('split', 'fold_in', 'bits', 'uniform')
# The kernel's output modes and counter sources (csrc/threefry.cu).
_PAIRS, _BITS, _UNIFORM = 0, 1, 2
_GEOMETRY, _ONE, _INT32, _INT64 = 0, 1, 2, 3


def geometry(shape, rows=None, axis: int = 0) -> tuple[int, ...]:
  """``(outer, axis_len, inner, start, total)`` of a draw of ``shape``:
  the draw is ``outer`` blocks of ``axis_len`` rows of ``inner`` elements,
  the rows ``[start, start + axis_len)`` of a draw whose ``axis`` is
  ``total`` long.  ``rows=None`` draws the whole shape: ``(1, size, 1, 0,
  size)``."""
  shape = tuple(int(s) for s in shape)
  if rows is None:
    size = math.prod(shape)
    return 1, size, 1, 0, size
  start, total = (int(v) for v in rows)
  if not 0 <= start <= total - shape[axis]:
    raise ValueError(f'rows {rows} do not hold {shape[axis]} rows')
  return (math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:]),
          start, total)


def _stream(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def draw(keys: torch.Tensor, mode: str, geom, data=None) -> torch.Tensor:
  """One launch: the draws of :func:`geometry` ``geom`` (``n`` a key) for
  each key of ``keys`` (..., 2) int64 on the card, flat and contiguous:
  ``(K * n, 2)`` int64 for 'split' and 'fold_in', ``(K * n,)`` int64 for
  'bits' and float32 for 'uniform'.  'fold_in' (``geometry(())``) takes
  its counters from ``data``, a Python int or an int32 / int64 tensor of
  ``keys.shape[:-1]``; the others from ``geom``."""
  if mode not in MODES:
    raise ValueError(f'mode={mode!r} is not one of {MODES}')
  if not keys.is_cuda:
    raise ValueError('the threefry kernel takes CUDA keys')
  if keys.dtype != torch.int64 or keys.ndim < 1 or keys.shape[-1] != 2:
    raise TypeError(f'keys {keys.dtype} {tuple(keys.shape)}: want int64 '
                    '(..., 2)')
  outer, axis_len, inner, start, total = geom
  n = outer * axis_len * inner
  k = keys.reshape(-1, 2)       # a view where the strides allow
  pairs = mode in ('split', 'fold_in')
  out = torch.empty((k.shape[0] * n,) + ((2,) if pairs else ()),
                    dtype=torch.float32 if mode == 'uniform' else torch.int64,
                    device=keys.device)
  if out.numel() == 0:
    return out
  counter, ptr, stride, one = _GEOMETRY, None, 0, 0
  if mode == 'fold_in':
    if n != 1:
      raise ValueError(f'fold_in makes one draw a key, not {n}')
    if isinstance(data, torch.Tensor):
      if data.dtype not in (torch.int32, torch.int64):
        raise TypeError(f'fold_in data {data.dtype}: want int32 or int64')
      if data.device != keys.device or data.shape != keys.shape[:-1]:
        raise ValueError(f'fold_in data {tuple(data.shape)} on '
                         f'{data.device}: want {tuple(keys.shape[:-1])} on '
                         f'{keys.device}')
      data = data.reshape(-1)
      counter = _INT32 if data.dtype == torch.int32 else _INT64
      ptr, stride = data.data_ptr(), data.stride(0)
    else:
      counter, one = _ONE, int(data) & 0xFFFFFFFF
  _build.check(_build.library().crafter_threefry(
      k.data_ptr(), k.stride(0), k.stride(1), counter, ptr, stride, one,
      k.shape[0], n, axis_len, inner, start, total,
      _PAIRS if pairs else _BITS if mode == 'bits' else _UNIFORM,
      out.data_ptr(), _stream(keys)), 'threefry')
  draw.launches += 1
  draw.launches_by_mode[mode] += 1
  return out


draw.launches = 0
draw.launches_by_mode = dict.fromkeys(MODES, 0)


def occupancy(mode: str) -> int:
  """Resident blocks of 256 threads an SM of the kernel for ``mode``."""
  blocks = ctypes.c_int()
  kernel_mode = (_PAIRS if mode in ('split', 'fold_in') else
                 _BITS if mode == 'bits' else _UNIFORM)
  _build.check(_build.library().crafter_threefry_occupancy(
      kernel_mode, ctypes.byref(blocks)), 'threefry occupancy')
  return blocks.value
