"""Wrapper of the render kernel (``csrc/render.cu``).

:func:`render_win79` replaces ``crafter_tpu/render.py:render_win79``; its
plain twin is ``render.render_win79_plain``.  For CUDA tensors it launches
the kernel; for CPU tensors it runs the twin.  ``render_win79.launches``
counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from . import render as render_lib

OUT_FORMATS = ('frames', 'packed', 'words')


def render_win79(win79: torch.Tensor, daylight: torch.Tensor,
                 sleeping: torch.Tensor, seeds: torch.Tensor,
                 atlas: render_lib.Atlas, size: Tuple[int, int] = (64, 64),
                 out_format: str = 'frames') -> torch.Tensor:
  """Frame synthesis on prepared (B, 79) window rows, (B,) ``daylight``
  float32, ``sleeping`` and ``seeds``.  Returns (B, size[1], size[0], 3)
  uint8 (``'frames'``), (B, C) int32 ``r | g<<8 | b<<16`` (``'packed'``) or
  the frames' byte stream as (B, 3C/4) int32 (``'words'``)."""
  if out_format not in OUT_FORMATS:
    raise ValueError(f'out_format={out_format!r} is not one of {OUT_FORMATS}')
  c = atlas.src.shape[0]
  if out_format != 'packed' and size[0] * size[1] != c:
    raise ValueError(f'size {size} does not match the atlas ({c} pixels)')
  if out_format == 'words' and c % 4:
    raise ValueError('words output needs a pixel count divisible by 4')
  if not win79.is_cuda:
    px = render_lib.render_win79_plain(win79, daylight, sleeping, seeds, atlas)
    return render_lib.format_pixels(px, size, out_format)
  out = _launch_render(win79, daylight, sleeping, seeds, atlas, size,
                       out_format)
  render_win79.launches += 1
  return out


render_win79.launches = 0


def _launch_render(win79, daylight, sleeping, seeds, atlas, size, out_format):
  b, n_win = win79.shape
  c = atlas.src.shape[0]
  dev = win79.device
  tables = (atlas.mat_planes, atlas.spr_planes, atlas.src, atlas.vignette,
            atlas.view_mask)
  for t, dt in zip(tables, (torch.int32, torch.int32, torch.int32,
                            torch.float32, torch.int32)):
    if t.device != dev or t.dtype != dt or not t.is_contiguous():
      raise TypeError(f'atlas table {t.dtype} on {t.device}: want contiguous '
                      f'{dt} on {dev}')
  cols = [daylight.to(torch.float32), sleeping.to(torch.int32),
          seeds.to(torch.int32)]
  for col in cols:
    if col.numel() != b or col.device != dev:
      raise ValueError(f'per-frame column {tuple(col.shape)} on {col.device}: '
                       f'want {b} values on {dev}')
  cols = [col.reshape(b).contiguous() for col in cols]
  win = win79.to(torch.int32).contiguous()
  packed = out_format == 'packed'
  if packed:
    out = torch.empty((b, c), dtype=torch.int32, device=dev)
  else:
    out = torch.empty((b, size[1], size[0], 3), dtype=torch.uint8, device=dev)
  lib = _build.library()
  _build.check(lib.crafter_render(
      win.data_ptr(), *[col.data_ptr() for col in cols],
      atlas.mat_planes.data_ptr(), atlas.mat_planes.shape[0],
      atlas.spr_planes.data_ptr(), atlas.spr_planes.shape[0],
      atlas.src.data_ptr(), atlas.vignette.data_ptr(),
      atlas.view_mask.data_ptr(), out.data_ptr(), 0 if packed else 1, b,
      n_win, c, torch.cuda.current_stream(dev).cuda_stream), 'render_win79')
  if out_format == 'words':
    return out.reshape(b, -1).view(torch.int32)
  return out
