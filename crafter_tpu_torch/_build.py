"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process for ``sm_90a``, all
started together, and linked into one shared library with a plain C
interface that ``ctypes`` loads (no PyTorch headers, so a build takes
seconds).  The build runs at first use, into ``build/kernels-<hash>/`` at
the repository root, keyed on a hash of the sources and flags; a later
call in the same checkout reuses it.  ``ptxas.log`` beside the library
holds each kernel's register and shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parent.parent / 'build'
SOURCES = ('noise2.cu', 'noise3.cu', 'roll.cu', 'group_tick.cu', 'balance.cu',
           'render.cu', 'daylight.cu')
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         # No implicit multiply-add contraction: the kernels place every
         # fused multiply-add explicitly, to match their plain twins.
         '-fmad=false', '-Xptxas', '-v', '-Xcompiler', '-fPIC')
LIB_NAME = 'libcrafter_kernels.so'

_lib = None


def _nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  path = Path(cuda_home) / 'bin' / 'nvcc'
  if path.exists():
    return str(path)
  raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit')


def _digest() -> str:
  h = hashlib.sha256(' '.join(FLAGS).encode())
  for name in sorted(p.name for p in CSRC.iterdir()):
    h.update(name.encode())
    h.update((CSRC / name).read_bytes())
  return h.hexdigest()[:16]


def build() -> Path:
  """Compile the kernels if this source tree has not been built; return
  the library's path."""
  out_dir = BUILD_ROOT / f'kernels-{_digest()}'
  lib = out_dir / LIB_NAME
  if lib.exists():
    return lib
  BUILD_ROOT.mkdir(parents=True, exist_ok=True)
  nvcc = _nvcc()
  with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
    procs = []
    for src in SOURCES:
      obj = Path(tmp) / (src + '.o')
      cmd = [nvcc, *FLAGS, '-I', str(CSRC), '-c', str(CSRC / src),
             '-o', str(obj)]
      procs.append((src, obj, subprocess.Popen(
          cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
      out, _ = p.communicate()
      logs.append(f'== {src}\n{out}')
      if p.returncode != 0:
        failed.append(src)
    if failed:
      raise RuntimeError(f'nvcc failed on {failed}:\n' + '\n'.join(logs))
    tmp_lib = Path(tmp) / LIB_NAME
    link = subprocess.run(
        [nvcc, '-shared', '-o', str(tmp_lib)]
        + [str(obj) for _, obj, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
      raise RuntimeError(f'linking the kernels failed:\n{link.stdout}')
    (Path(tmp) / 'ptxas.log').write_text('\n'.join(logs))
    staged = Path(tmp) / 'out'
    staged.mkdir()
    shutil.move(str(tmp_lib), staged / LIB_NAME)
    shutil.move(str(Path(tmp) / 'ptxas.log'), staged / 'ptxas.log')
    try:
      os.replace(staged, out_dir)   # atomic: a concurrent build may win
    except OSError:
      if not lib.exists():
        raise
  return lib


def library() -> ctypes.CDLL:
  """The loaded kernel library (built at first use)."""
  global _lib
  if _lib is None:
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.crafter_noise2.argtypes = [vp, vp, vp, i64, f32, f32, f32, vp]
    lib.crafter_noise2_shared.argtypes = ([vp] * 3 + [i32] * 3 + [f32] * 3
                                          + [vp])
    lib.crafter_noise3.argtypes = [vp, vp, i32, vp, i64, i32, f32, f32, f32,
                                   vp]
    lib.crafter_roll.argtypes = [vp, vp, i64, i32, i32, vp]
    lib.crafter_roll_occupancy.argtypes = [i32] + [ctypes.POINTER(i32)] * 3
    lib.crafter_group_tick.argtypes = [vp] * 24 + [i32] * 6 + [vp]
    lib.crafter_tick.argtypes = [vp] * 16 + [i32] * 4 + [vp]
    lib.crafter_tick_occupancy.argtypes = [i32] * 4 + [ctypes.POINTER(i32)] * 2
    lib.crafter_render.argtypes = ([vp] * 5 + [i32, vp, i32, vp] + [i32] * 3
                                   + [vp] * 3 + [i32] * 6 + [vp])
    lib.crafter_render_occupancy.argtypes = ([i32] * 5
                                             + [ctypes.POINTER(i32)] * 2)
    lib.crafter_balance.argtypes = ([vp] * 7 + [i64, vp, i64, i64, vp, i64]
                                    + [vp] * 4 + [i32] * 8 + [f32, vp])
    lib.crafter_balance_occupancy.argtypes = ([i32] * 3
                                              + [ctypes.POINTER(i32)] * 2)
    lib.crafter_daylight.argtypes = [vp, i64, i32, f32, vp, vp]
    lib.crafter_error_string.argtypes = [i32]
    lib.crafter_error_string.restype = ctypes.c_char_p
    for fn in ('crafter_noise2', 'crafter_noise2_shared', 'crafter_noise3',
               'crafter_roll', 'crafter_roll_occupancy', 'crafter_group_tick',
               'crafter_tick',
               'crafter_tick_occupancy', 'crafter_balance',
               'crafter_balance_occupancy', 'crafter_render',
               'crafter_render_occupancy', 'crafter_daylight'):
      getattr(lib, fn).restype = i32
    _lib = lib
  return _lib


def check(code: int, what: str) -> None:
  """Raise if a launch function returned a CUDA error."""
  if code != 0:
    msg = library().crafter_error_string(code).decode()
    raise RuntimeError(f'{what}: CUDA error {code} ({msg})')
