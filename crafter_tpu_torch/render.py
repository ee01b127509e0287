"""Observation rendering: the atlas, the per-frame window and the plain
frame synthesis.

The port's counterpart of ``crafter_tpu/render.py``.  A frame depends on 79
dynamic values (63 view tiles ``mid | texid << 4`` and 16 inventory
amounts) and four scalars (daylight, sleeping, noise seed; facing is folded
into the player tile).  Everything that depends only on the pixel position
is baked once per render size into the :class:`Atlas`.

* :func:`bake_atlas` bakes the tables with numpy from the decoded textures
  of ``assets/textures.npz`` (no PIL, no imageio: the nearest-neighbour
  resize is PIL's, reproduced), equal to the JAX package's tables, and
  their compact form (:class:`CompactTables`: each texture once and a code
  word a pixel), which the render kernel reads; :func:`expand_compact`
  rebuilds the planes from it and :func:`render_win79_compact` renders
  through it as the kernel does.
* :func:`window_prep` gathers the 79 values of each frame.
* :func:`render_win79_plain` is the plain twin of the render kernel
  (``render_cuda.render_win79`` / ``csrc/render.cu``): the trace of the JAX
  package's ``_render_core`` on tensors, bit for bit.  Where the TPU kernel
  expands the 79 values onto pixels with a one-hot matmul and picks texels
  with select chains over the candidate planes, this indexes: a per-pixel
  source index and one gather each from the material and sprite planes.
* ``render_cuda.render_frames`` and ``render_cuda.render`` tie them to
  the render kernel's wrapper.

Pixel lanes are row-major over the output frame: lane ``l = row * size[0]
+ col`` of the ``(size[1], size[0], 3)`` image.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib
from typing import Tuple

import numpy as np
import torch

from . import rules
from .config import EnvConfig
from .ops.fma import fma32
from .step import (TEX_PLAYER, TEX_PLAYER_SLEEP, fmix, i32c, key_words_i32,
                   srl)

ASSETS = pathlib.Path(__file__).parent / 'assets'

# The sprite textures by ``step.TEX_*`` id.
ENT_TEX_NAMES = (
    None, 'player-left', 'player-right', 'player-up', 'player-down',
    'player-sleep', 'cow', 'zombie', 'skeleton', 'arrow-left', 'arrow-right',
    'arrow-up', 'arrow-down', 'plant', 'plant-ripe')

GRAY_ID = rules.N_MATERIALS  # out-of-bounds tile: the 127-gray canvas
NOISE_SCALE = float(np.float32(95.0 / (1 << 24)))
# The desaturation's 0.4, as the float32 constant XLA multiplies by.
DESAT = float(np.float32(0.4))
# Inventory amounts with a tile of their own (0..9; larger are clipped).
N_AMOUNTS = 10
# A pixel's code word in the compact tables: source index + 1 in the low
# CODE_SRC_BITS bits (0: none; more bits for windows of 256 values or more,
# :func:`code_src_bits`), the view bit, and the texel offset above it.
CODE_SRC_BITS = 8


def code_src_bits(n_values: int) -> int:
  """Width of the code words' source field for a window of ``n_values``
  values (it holds 0..n_values)."""
  return max(CODE_SRC_BITS, int(n_values).bit_length())


@dataclasses.dataclass
class Atlas:
  """Baked per-pixel tables for one (size, view) configuration.

  ``C`` = size[0] * size[1] output pixels.  View borders (env.py:123-125)
  are baked into the layout.
  """

  mat_planes: torch.Tensor  # (N_MATERIALS+1, C) int32 r|g<<8|b<<16: texel of
  #                           material k in the view, of item amount k (k<10)
  #                           in the strip
  spr_planes: torch.Tensor  # (15, C) int32 r|g<<8|b<<16|a<<24 sprite texels
  src: torch.Tensor         # (C,) int32 index into the frame's 79 values that
  #                           this pixel shows, -1 where none (reads id 0)
  vignette: torch.Tensor    # (1, C) float32 night vignette (0 off the view)
  view_mask: torch.Tensor   # (1, C) int32 0/1: pixels the lighting applies to
  compact: 'CompactTables | None' = None  # the render kernel's form of the
  #                                        same tables


@dataclasses.dataclass
class CompactTables:
  """The atlas as the render kernel reads it: every texture once, ``T`` =
  ux * uy texels a tile, and a word a pixel.

  Inside the view, material plane ``k`` of the atlas is one tile texture
  repeated over the view tiles; in the item strip it is the tile of (slot,
  amount ``k``).  :func:`expand_compact` rebuilds the atlas's planes from
  these tables.
  """

  mat_tex: torch.Tensor   # (N_MATERIALS+1, T) int32 r|g<<8|b<<16
  spr_tex: torch.Tensor   # (15, T) int32 r|g<<8|b<<16|a<<24 (row 0 empty)
  item_tex: torch.Tensor  # (N_ITEMS, N_AMOUNTS, T) int32 r|g<<8|b<<16
  code: torch.Tensor      # (C,) int32 (src + 1) | view << S | off << S + 1:
  #                         off is the texel in the tile (view) or the
  #                         offset of the texel at amount 0 in item_tex
  #                         (strip)
  vignette: torch.Tensor  # (C,) float32, 0 off the view
  n_win: int = 79         # window values a frame has (the atlas's view)

  @property
  def src_bits(self) -> int:
    """S, the width of the code words' source field."""
    return code_src_bits(self.n_win)


@functools.lru_cache(maxsize=None)
def _textures() -> dict:
  with np.load(ASSETS / 'textures.npz') as f:
    return {name: f[name] for name in f.files}


def _load(name: str) -> np.ndarray:
  """A texture as uint8 (x, y, channels), like the reference
  (engine.py:127)."""
  return _textures()[name]


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
  """Source index of each output pixel under PIL's ``Image.NEAREST``: the
  centre ``(i + 0.5) * n_in / n_out`` truncated, with the centre reached by
  repeated addition in float64 as PIL's affine scaler does."""
  step = n_in / n_out
  pos = np.empty((n_out,), np.float64)
  acc = step * 0.5
  for i in range(n_out):
    pos[i] = acc
    acc += step
  return np.clip(pos.astype(np.int64), 0, n_in - 1)


def _resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
  """Nearest-neighbour resize to ``size`` along the two leading axes,
  equal to PIL's (engine.py:136-141)."""
  ix = _nearest_index(img.shape[0], int(size[0]))
  iy = _nearest_index(img.shape[1], int(size[1]))
  return img[ix][:, iy]


def _rgb(img: np.ndarray) -> np.ndarray:
  return img[..., :3] if img.shape[-1] == 4 else img


def _draw_alpha(canvas: np.ndarray, pos, texture: np.ndarray) -> None:
  """The reference's alpha-over blit, float64 + truncation
  (engine.py:276-284)."""
  (x, y), (w, h) = pos, texture.shape[:2]
  if texture.shape[-1] == 4:
    alpha = texture[..., 3:].astype(np.float64) / 255
    rgb = texture[..., :3].astype(np.float64) / 255
    cur = canvas[x: x + w, y: y + h].astype(np.float64) / 255
    texture = (255 * (alpha * rgb + (1 - alpha) * cur)).astype(np.uint8)
  canvas[x: x + w, y: y + h] = texture


def _vignette(shape: Tuple[int, int], stddev: float) -> np.ndarray:
  """engine.py:213-218."""
  xs, ys = np.meshgrid(np.linspace(-1, 1, shape[0]),
                       np.linspace(-1, 1, shape[1]))
  return (1 - np.exp(-0.5 * (xs ** 2 + ys ** 2) / (stddev ** 2))).T


@functools.lru_cache(maxsize=8)
def _bake_parts(size: Tuple[int, int], view: Tuple[int, int],
                item_rows: int) -> dict:
  """The textures resized to one tile and each pixel's place in the layout
  (``crafter_tpu/render.py:139-239``): what both the atlas's per-pixel
  planes and the render kernel's compact tables are made of."""
  ux, uy = size[0] // view[0], size[1] // view[1]
  gw, gh = view[0], view[1] - item_rows
  wpix, hpix = size
  c = wpix * hpix
  # View border (env.py:123-125): bx along the minor (col) axis, by rows.
  bx = (wpix - ux * view[0]) // 2
  by = (hpix - uy * view[1]) // 2
  n_mat = rules.N_MATERIALS + 1  # + the 127-gray out-of-bounds candidate

  mat_tex = np.full((n_mat, ux, uy, 3), 127, np.uint8)
  mat_tex[0] = _rgb(_resize(_load('unknown'), (ux, uy)))
  for name, mid in rules.MAT_ID.items():
    mat_tex[mid] = _rgb(_resize(_load(name), (ux, uy)))

  spr_tex = np.zeros((len(ENT_TEX_NAMES), ux, uy, 4), np.uint8)
  for i, name in enumerate(ENT_TEX_NAMES):
    if name is None:
      continue
    img = _resize(_load(name), (ux, uy))
    if img.shape[-1] == 3:
      img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255,
                                         np.uint8)], -1)
    spr_tex[i] = img

  # Inventory tiles: icon at 0.8*unit offset 0.1*unit, count digit at
  # 0.6*unit offset 0.4*unit, zero amounts blank (engine.py:227-248).
  unit = np.array([ux, uy])
  item_tiles = np.zeros((rules.N_ITEMS, N_AMOUNTS, ux, uy, 3), np.uint8)
  for i, name in enumerate(rules.ITEMS):
    icon = _resize(_load(name), tuple((0.8 * unit).astype(int)))
    for amount in range(1, N_AMOUNTS):
      tile = np.zeros((ux, uy, 3), np.uint8)
      _draw_alpha(tile, (0.1 * unit).astype(int), icon)
      digit = _resize(_load(str(amount)), tuple((0.6 * unit).astype(int)))
      _draw_alpha(tile, (0.4 * unit).astype(int), digit)
      item_tiles[i, amount] = tile

  # Per-pixel places, row-major (y, x) like the output frame: the
  # reference's final transpose (env.py:130) is baked into the layout.
  ys, xs = np.divmod(np.arange(c), wpix)     # ys = row, xs = col
  r_view = ys - by
  c_view = xs - bx
  in_view = ((r_view >= 0) & (r_view < gh * uy)
             & (c_view >= 0) & (c_view < gw * ux))
  r_strip = r_view - gh * uy
  in_strip = ((r_strip >= 0) & (r_strip < item_rows * uy)
              & (c_view >= 0) & (c_view < gw * ux))
  tx = np.clip(c_view // ux, 0, gw - 1)
  ty = np.clip(r_view // uy, 0, gh - 1)
  px = np.clip(c_view % ux, 0, ux - 1)
  py_v = np.clip(r_view % uy, 0, uy - 1)
  py_s = np.clip(r_strip % uy, 0, uy - 1)
  item = np.clip(r_strip // uy, 0, item_rows - 1) * gw + tx  # engine.py:238
  item_ok = in_strip & (item < rules.N_ITEMS)
  # Pixel <- its view tile (x-major, the window's flatten order) or its
  # strip item slot; -1 where the pixel shows neither.
  src = np.where(in_view, tx * gh + ty,
                 np.where(item_ok, gw * gh + item, -1))

  vig = np.zeros((c,), np.float32)
  vig_view = _vignette((gw * ux, gh * uy), 0.5).astype(np.float32).T
  vig[in_view] = vig_view[r_view[in_view], c_view[in_view]]
  return dict(mat_tex=mat_tex, spr_tex=spr_tex, item_tiles=item_tiles,
              in_view=in_view, item_ok=item_ok,
              item=np.clip(item, 0, rules.N_ITEMS - 1), px=px, py_v=py_v,
              py_s=py_s, src=src, vig=vig)


def _pk3(t: np.ndarray) -> np.ndarray:
  """(..., 3) uint8 -> (...) int64 r | g<<8 | b<<16."""
  return (t[..., 0].astype(np.int64) | (t[..., 1].astype(np.int64) << 8)
          | (t[..., 2].astype(np.int64) << 16))


def _pk4(t: np.ndarray) -> np.ndarray:
  """(..., 4) uint8 -> (...) int64 r | g<<8 | b<<16 | a<<24."""
  return _pk3(t) | (t[..., 3].astype(np.int64) << 24)


def _i32(a: np.ndarray) -> np.ndarray:
  return (a & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=8)
def _bake_tables(size: Tuple[int, int], view: Tuple[int, int],
                 item_rows: int) -> dict:
  """The atlas tables as numpy arrays (``crafter_tpu/render.py:139-239``)."""
  parts = _bake_parts(size, view, item_rows)
  mat_tex, spr_tex, item_tiles = (parts['mat_tex'], parts['spr_tex'],
                                  parts['item_tiles'])
  in_view, item_ok, item = parts['in_view'], parts['item_ok'], parts['item']
  px, py_v, py_s = parts['px'], parts['py_v'], parts['py_s']
  c = in_view.shape[0]
  n_mat = mat_tex.shape[0]
  mat_planes = np.zeros((n_mat, c), np.int64)
  for k in range(n_mat):
    mat_planes[k][in_view] = _pk3(mat_tex[k][px, py_v])[in_view]
    if k < N_AMOUNTS:
      mat_planes[k][item_ok] = _pk3(item_tiles[item, k, px, py_s])[item_ok]
  spr_planes = np.zeros((len(ENT_TEX_NAMES), c), np.int64)
  for k in range(1, len(ENT_TEX_NAMES)):
    spr_planes[k][in_view] = _pk4(spr_tex[k][px, py_v])[in_view]
  return dict(mat_planes=_i32(mat_planes), spr_planes=_i32(spr_planes),
              src=parts['src'].astype(np.int32),
              vignette=parts['vig'].reshape(1, c),
              view_mask=in_view.astype(np.int32).reshape(1, c))


@functools.lru_cache(maxsize=8)
def _bake_compact(size: Tuple[int, int], view: Tuple[int, int],
                  item_rows: int) -> dict:
  """The render kernel's tables (:class:`CompactTables`) as numpy arrays:
  each texture once, and one code word and the vignette a pixel."""
  parts = _bake_parts(size, view, item_rows)
  mat_tex, spr_tex, item_tiles = (parts['mat_tex'], parts['spr_tex'],
                                  parts['item_tiles'])
  in_view, item_ok, item = parts['in_view'], parts['item_ok'], parts['item']
  px, py_v, py_s = parts['px'], parts['py_v'], parts['py_s']
  uy = mat_tex.shape[2]
  texels = mat_tex.shape[1] * uy
  # A view pixel's texel in its tile; a strip pixel's offset into the item
  # table at amount 0 (its slot's row, then its texel).
  off = np.where(in_view, px * uy + py_v,
                 np.where(item_ok, item * N_AMOUNTS * texels + px * uy + py_s,
                          0))
  n_win = view[0] * (view[1] - item_rows) + rules.N_ITEMS
  bits = code_src_bits(n_win)
  code = (parts['src'] + 1) | (in_view.astype(np.int64) << bits) \
      | (off << (bits + 1))
  if code.max() >= 2 ** 31:
    raise ValueError(f'the render code words of size {size} and view {view} '
                     'do not fit in 31 bits')
  return dict(
      n_win=n_win,
      mat_tex=_i32(_pk3(mat_tex).reshape(mat_tex.shape[0], texels)),
      spr_tex=_i32(_pk4(spr_tex).reshape(spr_tex.shape[0], texels)),
      item_tex=_i32(_pk3(item_tiles).reshape(rules.N_ITEMS, N_AMOUNTS,
                                             texels)),
      code=code.astype(np.int32), vignette=parts['vig'])


@functools.lru_cache(maxsize=8)
def _bake_atlas(size, view, item_rows, device: str) -> Atlas:
  as_t = lambda tables: {name: torch.as_tensor(a, device=device)
                         if isinstance(a, np.ndarray) else a
                         for name, a in tables.items()}
  return Atlas(**as_t(_bake_tables(size, view, item_rows)),
               compact=CompactTables(**as_t(_bake_compact(size, view,
                                                          item_rows))))


def bake_atlas(size: Tuple[int, int] = (64, 64),
               view: Tuple[int, int] = (9, 9), item_rows: int = 2,
               device='cuda') -> Atlas:
  """Bake the per-pixel tables for a render size, with their compact form
  (cached per device)."""
  return _bake_atlas(tuple(size), tuple(view), int(item_rows), str(device))


def _code_fields(code: torch.Tensor, src_bits: int = CODE_SRC_BITS):
  """A compact pixel code -> (source index + 1, view flag, texel offset)."""
  return (code & ((1 << src_bits) - 1), ((code >> src_bits) & 1) == 1,
          code >> (src_bits + 1))


def expand_compact(t: CompactTables) -> dict:
  """The atlas's per-pixel tables rebuilt from the compact ones:
  ``mat_planes``, ``spr_planes``, ``src``, ``vignette`` and ``view_mask``
  as :class:`Atlas` holds them."""
  src1, view, off = _code_fields(t.code, t.src_bits)
  strip = ~view & (src1 > 0)
  texels = t.mat_tex.shape[1]
  off_v = torch.where(view, off, 0).long()
  off_s = torch.where(strip, off, 0).long()
  items = t.item_tex.reshape(-1)
  mat = [torch.where(view, t.mat_tex[k, off_v],
                     torch.where(strip, items[off_s + k * texels], 0)
                     if k < t.item_tex.shape[1] else 0)
         for k in range(t.mat_tex.shape[0])]
  spr = [torch.where(view, t.spr_tex[k, off_v], 0)
         for k in range(t.spr_tex.shape[0])]
  return dict(mat_planes=torch.stack(mat), spr_planes=torch.stack(spr),
              src=src1 - 1, vignette=t.vignette.reshape(1, -1),
              view_mask=view.to(torch.int32).reshape(1, -1))


def _luma_i(r, g, b):
  """PIL's fixed-point ITU-R 601-2 luma (Convert.c L24 table), int32 in."""
  return (19595 * r + 38470 * g + 7471 * b + 32768) >> 16


def noise_seed(key: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
  """Per-(episode, step) int32 seed of the night-noise hash: ``key``
  (..., 2) int64 key words, ``step`` (...) int."""
  k0, k1 = key_words_i32(key)
  return fmix(k0 ^ (fmix(k1 + step.to(torch.int32) * i32c(0x9E3779B9))
                    + i32c(0x51ED2701)))


def window_prep(packed: torch.Tensor, ppos: torch.Tensor,
                pfacing: torch.Tensor, sleeping: torch.Tensor,
                inventory: torch.Tensor, cfg: EnvConfig) -> torch.Tensor:
  """Each frame's 79 dynamic values, (B, 79) int32: 63 window tiles
  ``mid | texid << 4`` (x-major) and 16 inventory amounts clipped to 0..9
  (engine.py:165-181, :227-235).

  ``packed`` (B, C) packed cell planes, ``ppos`` (B, 2), ``pfacing`` (B,),
  ``sleeping`` (B,) bool or int, ``inventory`` (B, 16).  Out-of-world tiles
  read the 127-gray candidate.
  """
  gw, gh = cfg.local_grid
  w, h = cfg.area
  dev = packed.device
  b = packed.shape[0]
  ppos = ppos.to(torch.int32)
  xs = ppos[:, :1] + torch.arange(gw, dtype=torch.int32, device=dev) - gw // 2
  ys = ppos[:, 1:] + torch.arange(gh, dtype=torch.int32, device=dev) - gh // 2
  inside = (((xs >= 0) & (xs < w))[:, :, None]
            & ((ys >= 0) & (ys < h))[:, None, :])            # (B, gw, gh)
  cell = (xs.clamp(0, w - 1)[:, :, None] * h
          + ys.clamp(0, h - 1)[:, None, :]).reshape(b, gw * gh)
  win = packed.gather(1, cell.long()).to(torch.int32).reshape(b, gw, gh)
  mid = torch.where(inside, win & 15, GRAY_ID)
  ctex = torch.where(inside, (win >> 4) & 15, 0)
  # The player tile carries the TEX_PLAYER marker; resolve it against
  # facing / sleeping (objects.py:85-93).  Every other sprite id is final.
  ptex = torch.where(sleeping != 0, TEX_PLAYER_SLEEP,
                     TEX_PLAYER + pfacing.to(torch.int32))
  texid = torch.where(ctex == TEX_PLAYER, ptex[:, None, None], ctex)
  return torch.cat([(mid | (texid << 4)).reshape(b, gw * gh),
                    inventory.to(torch.int32).clamp(0, 9)], 1)


def render_win79_plain(win79: torch.Tensor, daylight: torch.Tensor,
                       sleeping: torch.Tensor, seeds: torch.Tensor,
                       atlas: Atlas) -> torch.Tensor:
  """Frame synthesis on flat pixel lanes: (B, 79) window rows, (B,)
  daylight / sleeping / seeds -> (B, C) int32 packed ``r | g<<8 | b<<16``.

  The plain twin of the render kernel.  Every arithmetic step keeps the
  order and the truncation points of the JAX package's ``_render_core``
  (engine.py:182-218, :276-284, env.py:120-130).  Every float expression
  ends in a floor, and the JAX package's frames are those of XLA's CPU
  backend, which rounds a single-use product together with the add that
  consumes it; those are the :func:`fma32` calls: the noise scale-and-shift,
  the canvas term of the noise blend (the ``mask * noise`` term is shared by
  the channels and rounds alone), the desaturation, the canvas term of the
  daylight blend.  The half-and-half tint blends are exact either way.
  """
  c = atlas.src.shape[0]
  # Each pixel copies its source value (id 0 where it has none).
  has = atlas.src >= 0
  ids = torch.where(has[None],
                    win79.to(torch.int32)[:, atlas.src.clamp_min(0).long()],
                    0)
  mid = ids & 15
  tex = srl(ids, 4) & 15
  lane = torch.arange(c, device=win79.device)
  # An id past its table shows nothing, as no candidate matches it.
  n_mat = atlas.mat_planes.shape[0]
  base = torch.where(mid < n_mat,
                     atlas.mat_planes[mid.clamp_max(n_mat - 1).long(), lane],
                     0)
  n_spr = atlas.spr_planes.shape[0]
  spr = torch.where((tex >= 1) & (tex < n_spr),
                    atlas.spr_planes[tex.clamp_max(n_spr - 1).long(), lane],
                    0)
  return _shade(base, spr, daylight, sleeping, seeds, atlas.vignette,
                atlas.view_mask != 0, skip_day_noise=False)


def render_win79_compact(win79: torch.Tensor, daylight: torch.Tensor,
                         sleeping: torch.Tensor, seeds: torch.Tensor,
                         tables: CompactTables) -> torch.Tensor:
  """:func:`render_win79_plain` through the compact tables, step for step
  as the render kernel reads them: a pixel's code word gives its source
  value and its texel offset; a view pixel picks its material and sprite
  texels from the tile textures, a strip pixel its item tile's texel at
  the amount it shows; frames by day skip the keyed noise, which cannot
  reach them.  Equal to :func:`render_win79_plain` bit for bit."""
  src1, view, off = _code_fields(tables.code, tables.src_bits)
  strip = ~view & (src1 > 0)
  ids = torch.where(src1 > 0,
                    win79.to(torch.int32)[:, (src1 - 1).clamp_min(0).long()],
                    0)
  mid = ids & 15
  tex = srl(ids, 4) & 15
  texels = tables.mat_tex.shape[1]
  n_mat, n_spr = tables.mat_tex.shape[0], tables.spr_tex.shape[0]
  n_amt = tables.item_tex.shape[1]
  off_v = torch.where(view, off, 0)
  off_s = torch.where(strip, off, 0)
  mats, sprs = tables.mat_tex.reshape(-1), tables.spr_tex.reshape(-1)
  items = tables.item_tex.reshape(-1)
  in_view = torch.where(
      mid < n_mat, mats[(mid.clamp_max(n_mat - 1) * texels + off_v).long()],
      0)
  in_strip = torch.where(
      mid < n_amt, items[(off_s + mid.clamp_max(n_amt - 1) * texels).long()],
      0)
  base = torch.where(view, in_view, torch.where(strip, in_strip, 0))
  spr = torch.where(
      view & (tex >= 1) & (tex < n_spr),
      sprs[(tex.clamp_max(n_spr - 1) * texels + off_v).long()], 0)
  return _shade(base, spr, daylight, sleeping, seeds, tables.vignette,
                view, skip_day_noise=True)


def _shade(base, spr, daylight, sleeping, seeds, vignette, view,
           skip_day_noise: bool) -> torch.Tensor:
  """Blit, night lighting, sleep overlay and view mask of (B, C) material
  and sprite texels -> (B, C) int32 packed pixels.  ``skip_day_noise``:
  frames whose darkness is exactly 0 take the canvas for the noised canvas
  (``fma(1 - 0, ch, 0 * noise)`` is the canvas itself)."""
  f32 = torch.float32
  c = base.shape[1]
  daylight = daylight.to(f32).reshape(-1, 1)
  slp = sleeping.reshape(-1, 1) != 0
  seed = seeds.to(torch.int32).reshape(-1, 1)
  lane = torch.arange(c, device=base.device)
  un3 = lambda v: (v & 255, srl(v, 8) & 255, srl(v, 16) & 255)
  alpha = srl(spr, 24) & 255

  # Alpha-over blit with the reference's truncation, in exact integers:
  # floor((a*s + (255-a)*b) / 255) as a multiply-shift division.
  canv = [(((alpha * s + (255 - alpha) * b) * 32897) >> 23).to(f32)
          for s, b in zip(un3(spr), un3(base))]

  # Night lighting (engine.py:189-196).  mask == 0 at daylight >= 0.5, so
  # the noised canvas equals the canvas exactly.
  nbits = fmix(seed + lane.to(torch.int32) * i32c(0x9E3779B9))
  noise = fma32(srl(nbits, 8).to(f32), NOISE_SCALE, 32.0)
  dark = (2.0 * (0.5 - daylight)).clamp_min(0.0)
  mask = dark * vignette.reshape(1, c)
  mn = mask * noise
  noised = [fma32(1.0 - mask, ch, mn) for ch in canv]
  if skip_day_noise:
    noised = [torch.where(dark == 0.0, ch, nz)
              for ch, nz in zip(canv, noised)]
  nf = [torch.floor(ch).to(torch.int32) for ch in noised]
  lum = _luma_i(*nf).to(f32)
  desat = [torch.floor(fma32(ch.to(f32) - lum, DESAT, lum)) for ch in nf]
  tint = (0.0, 16.0, 64.0)                                # engine.py:195
  night = [0.5 * d + 0.5 * t for d, t in zip(desat, tint)]
  lit = [fma32(daylight, ch, (1.0 - daylight) * ng)
         for ch, ng in zip(canv, night)]

  # Sleep overlay (engine.py:198-202).
  lf = [torch.floor(ch).to(torch.int32) for ch in lit]
  lum2 = _luma_i(*lf).to(f32)
  stint = (0.0, 0.0, 16.0)
  out = [torch.where(slp, 0.5 * lum2 + 0.5 * t, ch)
         for ch, t in zip(lit, stint)]
  # Lighting covers the local view only; the item strip and the border keep
  # their raw texels (env.py:126-129).
  vmask = view.reshape(1, c)
  out = [torch.floor(torch.where(vmask, o, ch)).to(torch.int32)
         for o, ch in zip(out, canv)]
  return out[0] | (out[1] << 8) | (out[2] << 16)


def frame_image(packed_px: torch.Tensor,
                size: Tuple[int, int]) -> torch.Tensor:
  """(.., C) int32 packed RGB -> (.., size[1], size[0], 3) uint8: byte 0 of
  the little-endian int32 is R, so a byte view and a 4 -> 3 slice."""
  lead = packed_px.shape[:-1]
  b = packed_px.contiguous().view(torch.uint8).reshape(lead + (-1, 4))
  return b[..., :3].reshape(lead + (size[1], size[0], 3))


def format_pixels(px: torch.Tensor, size: Tuple[int, int],
                  out_format: str) -> torch.Tensor:
  """(B, C) packed pixel lanes in one of the output formats of
  ``render_cuda.render_frames``."""
  if out_format == 'packed':
    return px
  frames = frame_image(px, size)
  if out_format == 'words':
    return frames.reshape(px.shape[0], -1).view(torch.int32)
  return frames
