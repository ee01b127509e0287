"""Pack the data files of ``crafter_tpu_torch/assets`` from the JAX package.

    JAX_PLATFORMS=cpu python tools/pack_torch_textures.py

Writes two files that the PyTorch port reads at run time, so that it needs
neither ``imageio`` nor PIL nor JAX:

* ``textures.npz`` — every ``crafter_tpu/assets/*.png`` decoded to its uint8
  array, keyed by file stem, in the (x, y) axis order of
  ``crafter_tpu/render.py:_load``.
* ``daylight.npz`` — ``crafter_tpu.state.daylight`` under ``jax.jit`` on the
  CPU for steps 0..TABLE_STEPS at ``day_length = DAY_LENGTH`` as float32
  (``table``), with ``day_length`` beside it.  The port looks the light up
  by step, so frames are bit-identical to the JAX package's whatever the
  float32 cosine of the device at hand rounds to.

Both are held equal to their sources by ``tests/test_torch_render.py``.
"""

import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))   # the JAX package, when run as a script
OUT = ROOT / 'crafter_tpu_torch' / 'assets'
DAY_LENGTH = 300        # EnvConfig.day_length
TABLE_STEPS = 10000     # EnvConfig.length: the last step an episode reaches


def textures() -> dict:
  import imageio.v3 as iio
  out = {}
  for path in sorted((ROOT / 'crafter_tpu' / 'assets').glob('*.png')):
    img = iio.imread(path.read_bytes())
    out[path.stem] = np.ascontiguousarray(
        img.transpose((1, 0) + tuple(range(2, img.ndim))))
  return out


def daylight_table() -> np.ndarray:
  import jax
  import jax.numpy as jnp
  from crafter_tpu import state as jstate
  steps = jnp.arange(TABLE_STEPS + 1, dtype=jnp.int32)
  table = jax.jit(lambda s: jstate.daylight(s, DAY_LENGTH))(steps)
  return np.asarray(table, np.float32)


def main():
  OUT.mkdir(parents=True, exist_ok=True)
  tex = textures()
  np.savez_compressed(OUT / 'textures.npz', **tex)
  table = daylight_table()
  np.savez_compressed(OUT / 'daylight.npz', table=table,
                      day_length=np.int32(DAY_LENGTH))
  print(f'{len(tex)} textures, {sum(t.nbytes for t in tex.values())} bytes '
        f'decoded; daylight table of {table.size} steps -> {OUT}')


if __name__ == '__main__':
  main()
