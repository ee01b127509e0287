"""Wrapper of the render kernel (``csrc/render.cu``).

:func:`render_win79` replaces ``crafter_tpu/render.py:render_win79``; its
plain twin is ``render.render_win79_plain``.  For CUDA tensors it launches
the kernel on the atlas's compact tables (``render.CompactTables``): the
shared-memory instantiation where they fit in a block's shared memory (64
x 64), else the instantiation that reads them from global memory; for CPU
tensors it runs the twin.  A window is 79 values for the 9 x 9 view, or
any other count (a view of the whole area: one a world cell and 16),
which the atlas's view fixes.  ``render_win79.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from . import render as render_lib

OUT_FORMATS = ('frames', 'packed', 'words')
INSTANTIATIONS = ('auto', 'shared', 'global')


def render_win79(win79: torch.Tensor, daylight: torch.Tensor,
                 sleeping: torch.Tensor, seeds: torch.Tensor,
                 atlas: render_lib.Atlas, size: Tuple[int, int] = (64, 64),
                 out_format: str = 'frames',
                 instantiation: str = 'auto') -> torch.Tensor:
  """Frame synthesis on prepared (B, N) window rows (N = 79 for the 9 x 9
  view, ``render.window_prep``'s width in general), (B,) ``daylight``
  float32, ``sleeping`` and ``seeds``.  Returns (B, size[1], size[0], 3)
  uint8 (``'frames'``), (B, C) int32 ``r | g<<8 | b<<16`` (``'packed'``) or
  the frames' byte stream as (B, 3C/4) int32 (``'words'``).
  ``instantiation`` picks the kernel's (``'auto'``: shared memory where the
  tables fit); the CPU ignores it."""
  if out_format not in OUT_FORMATS:
    raise ValueError(f'out_format={out_format!r} is not one of {OUT_FORMATS}')
  if instantiation not in INSTANTIATIONS:
    raise ValueError(f'instantiation={instantiation!r} is not one of '
                     f'{INSTANTIATIONS}')
  c = atlas.src.shape[0]
  if out_format != 'packed' and size[0] * size[1] != c:
    raise ValueError(f'size {size} does not match the atlas ({c} pixels)')
  if out_format == 'words' and c % 4:
    raise ValueError('words output needs a pixel count divisible by 4')
  if not win79.is_cuda:
    px = render_lib.render_win79_plain(win79, daylight, sleeping, seeds, atlas)
    return render_lib.format_pixels(px, size, out_format)
  out = _launch_render(win79, daylight, sleeping, seeds, atlas, size,
                       out_format, instantiation)
  render_win79.launches += 1
  return out


render_win79.launches = 0


@functools.lru_cache(maxsize=None)
def _occupancy(shared: bool, n_win: int, items_words: int, texels: int,
               c: int, device: int) -> tuple[int, int]:
  blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
  with torch.cuda.device(device):
    _build.check(_build.library().crafter_render_occupancy(
        int(shared), n_win, items_words, texels, c, ctypes.byref(blocks),
        ctypes.byref(smem)), 'render occupancy')
  return blocks.value, smem.value


def occupancy(atlas: render_lib.Atlas,
              shared: bool = True) -> tuple[int, int]:
  """``(blocks per SM, shared bytes per block)`` of the render kernel's
  shared (or global) instantiation on ``atlas``'s tables and windows, from
  the CUDA occupancy calculator; 0 blocks where the tables do not fit."""
  t = atlas.compact
  return _occupancy(shared, t.n_win, t.item_tex.numel(), t.mat_tex.shape[1],
                    t.code.shape[0], t.code.device.index or 0)


def _launch_render(win79, daylight, sleeping, seeds, atlas, size, out_format,
                   instantiation):
  b, n_win = win79.shape
  t = atlas.compact
  if t is None:
    raise ValueError('the atlas has no compact tables: make it with '
                     'render.bake_atlas')
  if n_win != t.n_win:
    raise ValueError(f'windows of {n_win} values do not match the atlas '
                     f'(made for {t.n_win})')
  c = t.code.shape[0]
  dev = win79.device
  for name, dt in (('mat_tex', torch.int32), ('spr_tex', torch.int32),
                   ('item_tex', torch.int32), ('code', torch.int32),
                   ('vignette', torch.float32)):
    x = getattr(t, name)
    if (x.device != dev or x.dtype != dt or not x.is_contiguous()
        or x.data_ptr() % 16):
      raise TypeError(f'compact table {name} {x.dtype} on {x.device}: want '
                      f'contiguous, 16-byte aligned {dt} on {dev}')
  cols = [daylight.to(torch.float32), sleeping.to(torch.int32),
          seeds.to(torch.int32)]
  for col in cols:
    if col.numel() != b or col.device != dev:
      raise ValueError(f'per-frame column {tuple(col.shape)} on {col.device}: '
                       f'want {b} values on {dev}')
  cols = [col.reshape(b).contiguous() for col in cols]
  win = win79.to(torch.int32).contiguous()
  fits = occupancy(atlas, True)[0] > 0
  if instantiation == 'shared' and not fits:
    raise ValueError('the compact tables do not fit in shared memory')
  shared = fits if instantiation == 'auto' else instantiation == 'shared'
  packed = out_format == 'packed'
  if packed:
    out = torch.empty((b, c), dtype=torch.int32, device=dev)
  else:
    out = torch.empty((b, size[1], size[0], 3), dtype=torch.uint8, device=dev)
  items, n_amt, texels = t.item_tex.shape
  lib = _build.library()
  _build.check(lib.crafter_render(
      win.data_ptr(), *[col.data_ptr() for col in cols],
      t.mat_tex.data_ptr(), t.mat_tex.shape[0], t.spr_tex.data_ptr(),
      t.spr_tex.shape[0], t.item_tex.data_ptr(), items, n_amt, texels,
      t.code.data_ptr(), t.vignette.data_ptr(), out.data_ptr(),
      0 if packed else 1, int(shared), b, n_win, c, t.src_bits,
      torch.cuda.current_stream(dev).cuda_stream), 'render_win79')
  if out_format == 'words':
    return out.reshape(b, -1).view(torch.int32)
  return out
