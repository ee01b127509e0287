"""Wrappers of the render and daylight kernels (``csrc/render.cu``,
``csrc/daylight.cu``), and the frame functions built on them.

:func:`render_win79` replaces ``crafter_tpu/render.py:render_win79``; its
plain twin is ``render.render_win79_plain``.  For CUDA tensors it launches
the kernel on the atlas's compact tables (``render.CompactTables``): the
shared-memory instantiation where they fit in a block's shared memory (64
x 64), else the instantiation that reads them from global memory; for CPU
tensors it runs the twin.  A window is 79 values for the 9 x 9 view, or
any other count (a view of the whole area: one a world cell and 16),
which the atlas's view fixes.  :func:`daylight` is the frames' light: one
launch of its kernel for int32 steps on the card, the twin
``state.daylight_plain`` for CPU steps.  ``render_win79.launches`` and
``daylight.launches`` count kernel launches.

:func:`render_frames` gathers each frame's window (``render.window_prep``)
and renders it with the light of its step; :func:`render_fields`,
:func:`render_px_fields` and :func:`render` make the frames of bare field
tensors or of a state.  They call :func:`render_win79` and
:func:`daylight` through this module's globals, so a replacement of
either attribute sees every frame.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from . import render as render_lib
from . import state as state_lib
from .config import EnvConfig
from .state import State
from .step import pack_cells

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


def daylight(step: torch.Tensor, day_length: int) -> torch.Tensor:
  """Day/night curve 1 - |cos(pi*((t/300)%1 + 0.3))|^3 (env.py:135-139).

  The renderer multiplies pixels by the light and floors, so the light has
  to be the JAX package's under ``jax.jit`` bit for bit, and the same on
  the CPU and the card.  CPU steps take ``state.daylight_plain``; int32
  steps on the card one launch of ``csrc/daylight.cu``, the same
  arithmetic.
  """
  if not step.is_cuda:
    return state_lib.daylight_plain(step, day_length)
  if step.dtype != torch.int32:
    raise TypeError(f'daylight takes int32 steps on the card, not '
                    f'{step.dtype}')
  flat = step.reshape(-1)
  out = torch.empty(flat.shape, dtype=torch.float32, device=step.device)
  _build.check(_build.library().crafter_daylight(
      flat.data_ptr(), flat.stride(0), flat.numel(),
      state_lib.inv_day(day_length), out.data_ptr(),
      torch.cuda.current_stream(step.device).cuda_stream), 'daylight')
  daylight.launches += 1
  return out.reshape(step.shape)


daylight.launches = 0


def render_frames(packed: torch.Tensor, ppos: torch.Tensor,
                  pfacing: torch.Tensor, sleeping: torch.Tensor,
                  inventory: torch.Tensor, steps: torch.Tensor,
                  seeds: torch.Tensor, cfg: EnvConfig,
                  atlas: render_lib.Atlas, size: Tuple[int, int] = (64, 64),
                  out_format: str = 'frames') -> torch.Tensor:
  """A batch of frames: window gather, then :func:`render_win79`.

  ``packed`` (B, C_cells) packed cell planes (``step.pack_cells`` or the
  group kernel's snapshots), ``seeds`` (B,) from ``render.noise_seed``.
  ``out_format``: ``'frames'`` (B, size[1], size[0], 3) uint8; ``'packed'``
  (B, C) int32 ``r | g<<8 | b<<16`` pixel lanes; ``'words'`` the frames'
  byte stream viewed as (B, 3C/4) int32.
  """
  win79 = render_lib.window_prep(packed, ppos, pfacing, sleeping, inventory,
                                 cfg)
  light = daylight(steps, cfg.day_length)
  return render_win79(win79, light, sleeping, seeds, atlas, size, out_format)


def _render_any(mat_map, ent_etype, ent_aux, ent_facing, ppos, pfacing,
                sleeping, inventory, step, key, cfg, atlas, size, out_format):
  single = mat_map.ndim == 1
  fields = [mat_map, ent_etype, ent_aux, ent_facing, ppos, pfacing,
            torch.as_tensor(sleeping, device=mat_map.device), inventory,
            torch.as_tensor(step, device=mat_map.device), key]
  if single:
    fields = [f[None] for f in fields]
  (mat_map, ent_etype, ent_aux, ent_facing, ppos, pfacing, sleeping,
   inventory, step, key) = fields
  out = render_frames(
      pack_cells(mat_map, ent_etype, ent_aux, ent_facing), ppos, pfacing,
      sleeping, inventory, step, render_lib.noise_seed(key, step), cfg,
      atlas, size, out_format)
  return out[0] if single else out


def render_px_fields(mat_map, ent_etype, ent_aux, ent_facing, ppos, pfacing,
                     sleeping, inventory, step, key, cfg: EnvConfig,
                     atlas: render_lib.Atlas) -> torch.Tensor:
  """Frames from bare field tensors as raw (.., C) int32 ``r | g<<8 |
  b<<16`` pixel lanes.  Every field has a leading env axis, or none has
  (one env)."""
  return _render_any(mat_map, ent_etype, ent_aux, ent_facing, ppos, pfacing,
                     sleeping, inventory, step, key, cfg, atlas, cfg.size,
                     'packed')


def render_fields(mat_map, ent_etype, ent_aux, ent_facing, ppos, pfacing,
                  sleeping, inventory, step, key, cfg: EnvConfig,
                  atlas: render_lib.Atlas,
                  size: Tuple[int, int] = (64, 64)) -> torch.Tensor:
  """:func:`render` on bare field tensors: (.., size[1], size[0], 3)
  uint8."""
  return _render_any(mat_map, ent_etype, ent_aux, ent_facing, ppos, pfacing,
                     sleeping, inventory, step, key, cfg, atlas, size,
                     'frames')


def render(state: State, cfg: EnvConfig, atlas: render_lib.Atlas,
           size: Tuple[int, int] = (64, 64)) -> torch.Tensor:
  """Frames of a state, one env or a batch: (.., size[1], size[0], 3)
  uint8 (env.py:120-130)."""
  return render_fields(
      state.mat_map, state.ent.etype, state.ent.aux, state.ent.facing,
      state.player.pos, state.player.facing, state.player.sleeping,
      state.player.inventory, state.step, state.key, cfg, atlas, size)
