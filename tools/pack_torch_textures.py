"""Pack the data file of ``crafter_tpu_torch/assets`` from the JAX package.

    python tools/pack_torch_textures.py

Writes ``textures.npz``, which the PyTorch port reads at run time so that
it needs neither ``imageio`` nor PIL: every ``crafter_tpu/assets/*.png``
decoded to its uint8 array, keyed by file stem, in the (x, y) axis order of
``crafter_tpu/render.py:_load``.  ``tests/test_torch_render.py`` holds it
equal to the PNGs.
"""

import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / 'crafter_tpu_torch' / 'assets'


def textures() -> dict:
  import imageio.v3 as iio
  out = {}
  for path in sorted((ROOT / 'crafter_tpu' / 'assets').glob('*.png')):
    img = iio.imread(path.read_bytes())
    out[path.stem] = np.ascontiguousarray(
        img.transpose((1, 0) + tuple(range(2, img.ndim))))
  return out


def main():
  OUT.mkdir(parents=True, exist_ok=True)
  tex = textures()
  np.savez_compressed(OUT / 'textures.npz', **tex)
  print(f'{len(tex)} textures, {sum(t.nbytes for t in tex.values())} bytes '
        f'decoded -> {OUT}')


if __name__ == '__main__':
  main()
