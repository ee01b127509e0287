"""Whole-map terrain dumps (reference: crafter/run_terrain.py:1-43).

Renders ``--amount`` full worlds with an area-sized view into one PNG grid
for visual worldgen inspection:

    python -m crafter_tpu_torch.run_terrain --amount 4 --size 1024

Runs on the first CUDA device; ``--device cpu`` runs the plain PyTorch
versions of the kernels on the CPU.  The PNG is written by
:func:`png_bytes` (``zlib`` + ``struct``; no image library).
"""

import argparse
import pathlib
import struct
import zlib

import numpy as np


def png_bytes(image: np.ndarray) -> bytes:
  """An (H, W, 3) uint8 image as a PNG file: 8-bit RGB, no interlace,
  every row with filter type 0 (none), one zlib stream."""
  image = np.ascontiguousarray(image, np.uint8)
  h, w, c = image.shape
  if c != 3:
    raise ValueError(f'png_bytes takes (H, W, 3) uint8, got {image.shape}')
  rows = np.concatenate([np.zeros((h, 1), np.uint8),
                         image.reshape(h, w * 3)], 1)

  def chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))

  header = struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0)
  return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', header)
          + chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
          + chunk(b'IEND', b''))


def terrain_grid(amount, cols, area, size, seed, device) -> np.ndarray:
  """The first frame of ``amount`` worlds (seeds ``seed + i``), each viewed
  whole (view = area, run_terrain.py:21-24) at ``size`` x ``size``, laid
  out ``cols`` to a row: (rows * size, cols * size, 3) uint8."""
  import crafter_tpu_torch
  images = []
  for i in range(amount):
    env = crafter_tpu_torch.Env(
        area=area, view=area, size=(size, size), seed=seed + i,
        device=device)
    images.append(env.reset())
  cols = min(cols, len(images))
  rows = int(np.ceil(len(images) / cols))
  grid = np.zeros((rows * size, cols * size, 3), np.uint8)
  for i, image in enumerate(images):
    r, c = divmod(i, cols)
    grid[r * size:(r + 1) * size, c * size:(c + 1) * size] = image
  return grid


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--amount', type=int, default=4)
  parser.add_argument('--cols', type=int, default=4)
  parser.add_argument('--area', nargs=2, type=int, default=(64, 64))
  parser.add_argument('--size', type=int, default=1024)
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--filename', type=str, default='terrain.png')
  parser.add_argument('--device', type=str, default='cuda')
  args = parser.parse_args(argv)

  import torch
  if args.device.startswith('cuda') and not torch.cuda.is_available():
    raise SystemExit(
        'run_terrain: no CUDA device found.  The engine runs on an NVIDIA '
        'GPU; pass --device cpu to run the plain PyTorch path on the CPU.')

  grid = terrain_grid(args.amount, args.cols, tuple(args.area), args.size,
                      args.seed, args.device)
  pathlib.Path(args.filename).write_bytes(png_bytes(grid))
  print('Saved', args.filename)
  return grid


if __name__ == '__main__':
  main()
