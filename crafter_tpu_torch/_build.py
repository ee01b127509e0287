"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process for ``sm_90a``, all
started together, and linked into one shared library with a plain C
interface that ``ctypes`` loads (no PyTorch headers, so a build takes
seconds).  The build runs at first use, into ``build/kernels-<hash>/`` at
the repository root, keyed on a hash of the sources and flags; a later
call in the same checkout reuses it.  ``ptxas.log`` beside the library
holds each kernel's register and shared-memory report.

A *geometry variant* of the group and tick kernels, ``library(geometry=
(threads, min_blocks))``, compiles ``group_tick.cu`` alone with
``-DCRAFTER_GROUP_THREADS`` / ``-DCRAFTER_GROUP_MIN_BLOCKS`` beside the same
flags, into ``build/kernels-<hash>-t<threads>b<min_blocks>/`` with its own
``ptxas.log``, and loads as a library of its own.  The shipped geometry,
``DEFAULT_GEOMETRY``, is the default build.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parent.parent / 'build'
SOURCES = ('noise2.cu', 'noise3.cu', 'roll.cu', 'group_tick.cu', 'balance.cu',
           'render.cu', 'daylight.cu', 'threefry.cu', 'noise3_perm.cu')
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         # No implicit multiply-add contraction: the kernels place every
         # fused multiply-add explicitly, to match their plain twins.
         '-fmad=false', '-Xptxas', '-v', '-Xcompiler', '-fPIC')
LIB_NAME = 'libcrafter_kernels.so'

DEFAULT_GEOMETRY = (256, 5)   # csrc/group_tick.cu: the shipped build's
VARIANT_SOURCES = ('group_tick.cu',)
VARIANT_FUNCTIONS = ('crafter_group_tick', 'crafter_tick',
                     'crafter_tick_occupancy')

_libs = {}


def check_geometry(geometry) -> tuple[int, int] | None:
  """``(threads, min_blocks)`` checked, or None for the default build (no
  geometry, or the shipped one).  Threads must be a multiple of 32 in [64,
  1024] (the kernels stride by the block and need warp 0), min blocks at
  least 1; anything else raises before ``nvcc`` runs."""
  if geometry is None:
    return None
  threads, min_blocks = (int(v) for v in geometry)
  if threads % 32 or not 64 <= threads <= 1024:
    raise ValueError(f'{threads} threads a block: want a multiple of 32 in '
                     '[64, 1024]')
  if min_blocks < 1:
    raise ValueError(f'{min_blocks} minimum blocks an SM: want at least 1')
  geometry = (threads, min_blocks)
  return None if geometry == DEFAULT_GEOMETRY else geometry


def _nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  path = Path(cuda_home) / 'bin' / 'nvcc'
  if path.exists():
    return str(path)
  raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit')


def _flags(geometry) -> tuple[str, ...]:
  if geometry is None:
    return FLAGS
  threads, min_blocks = geometry
  return FLAGS + (f'-DCRAFTER_GROUP_THREADS={threads}',
                  f'-DCRAFTER_GROUP_MIN_BLOCKS={min_blocks}')


def _digest(geometry=None) -> str:
  h = hashlib.sha256(' '.join(_flags(geometry)).encode())
  for name in sorted(p.name for p in CSRC.iterdir()):
    h.update(name.encode())
    h.update((CSRC / name).read_bytes())
  return h.hexdigest()[:16]


def out_dir(geometry=None) -> Path:
  """Where the library of ``geometry`` (None: the default build) is
  built."""
  geometry = check_geometry(geometry)
  name = f'kernels-{_digest(geometry)}'
  if geometry is not None:
    name += f'-t{geometry[0]}b{geometry[1]}'
  return BUILD_ROOT / name


def compile_command(nvcc: str, src: str, obj: Path,
                    geometry=None) -> list[str]:
  """The ``nvcc`` command that compiles ``csrc/<src>`` into ``obj``."""
  return [nvcc, *_flags(check_geometry(geometry)), '-I', str(CSRC), '-c',
          str(CSRC / src), '-o', str(obj)]


def build(geometry=None) -> Path:
  """Compile the kernels if this source tree has not been built; return
  the library's path.  ``geometry``: a variant of the group and tick
  kernels (see the module's docstring)."""
  return build_many([geometry])[0]


def build_many(geometries) -> list[Path]:
  """:func:`build` for several geometries, every ``nvcc`` started
  together; the libraries' paths in order."""
  geometries = [check_geometry(g) for g in geometries]
  libs = [out_dir(g) / LIB_NAME for g in geometries]
  todo = {g: lib for g, lib in zip(geometries, libs) if not lib.exists()}
  if not todo:
    return libs
  BUILD_ROOT.mkdir(parents=True, exist_ok=True)
  nvcc = _nvcc()
  with contextlib.ExitStack() as stack:
    jobs = []
    for g in todo:
      tmp = Path(stack.enter_context(
          tempfile.TemporaryDirectory(dir=BUILD_ROOT)))
      procs = []
      for src in SOURCES if g is None else VARIANT_SOURCES:
        obj = tmp / (src + '.o')
        procs.append((src, obj, subprocess.Popen(
            compile_command(nvcc, src, obj, g), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
      jobs.append((g, tmp, procs))
    # Every nvcc ends before any library is linked or a failure raised.
    outs = [[p.communicate()[0] for _, _, p in procs] for _, _, procs in jobs]
    for (g, tmp, procs), out in zip(jobs, outs):
      _link(nvcc, tmp, procs, out, todo[g])
  return libs


def _link(nvcc: str, tmp: Path, procs, outs, lib: Path) -> None:
  """Link one library from its compiles (``outs``: each ``nvcc``'s
  output) and move it into place."""
  logs = [f'== {src}\n{out}' for (src, _, _), out in zip(procs, outs)]
  failed = [src for src, _, p in procs if p.returncode != 0]
  if failed:
    raise RuntimeError(f'nvcc failed on {failed}:\n' + '\n'.join(logs))
  tmp_lib = tmp / LIB_NAME
  link = subprocess.run(
      [nvcc, '-shared', '-o', str(tmp_lib)]
      + [str(obj) for _, obj, _ in procs],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  if link.returncode != 0:
    raise RuntimeError(f'linking the kernels failed:\n{link.stdout}')
  (tmp / 'ptxas.log').write_text('\n'.join(logs))
  staged = tmp / 'out'
  staged.mkdir()
  shutil.move(str(tmp_lib), staged / LIB_NAME)
  shutil.move(str(tmp / 'ptxas.log'), staged / 'ptxas.log')
  try:
    os.replace(staged, lib.parent)   # atomic: a concurrent build may win
  except OSError:
    if not lib.exists():
      raise


def library(geometry=None) -> ctypes.CDLL:
  """The loaded kernel library (built at first use); with ``geometry``,
  that variant's library, which holds only the group and tick kernels."""
  geometry = check_geometry(geometry)
  if geometry not in _libs:
    lib = ctypes.CDLL(str(build(geometry)))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    argtypes = {
        'crafter_noise2': [vp, vp, vp, i64, f32, f32, f32, vp],
        'crafter_noise2_shared': [vp] * 3 + [i32] * 3 + [f32] * 3 + [vp],
        'crafter_noise3': [vp, vp, i32, vp, i64, i32, f32, f32, f32, vp],
        'crafter_roll': [vp, vp, i64, i32, i32, vp],
        'crafter_roll_occupancy': [i32] + [ctypes.POINTER(i32)] * 3,
        'crafter_group_tick': [vp] * 24 + [i32] * 6 + [vp],
        'crafter_tick': [vp] * 16 + [i32] * 4 + [vp],
        'crafter_tick_occupancy': [i32] * 4 + [ctypes.POINTER(i32)] * 2,
        'crafter_render': ([vp] * 5 + [i32, vp, i32, vp] + [i32] * 3
                           + [vp] * 3 + [i32] * 6 + [vp]),
        'crafter_render_occupancy': [i32] * 5 + [ctypes.POINTER(i32)] * 2,
        'crafter_balance': ([vp] * 7 + [i64, vp, i64, i64, vp, i64]
                            + [vp] * 4 + [i32] * 8 + [f32, vp]),
        'crafter_balance_occupancy': [i32] * 3 + [ctypes.POINTER(i32)] * 2,
        'crafter_daylight': [vp, i64, i32, f32, vp, vp],
        'crafter_threefry': ([vp, i64, i64, i32, vp] + [i64] * 8
                             + [i32, vp, vp]),
        'crafter_threefry_occupancy': [i32, ctypes.POINTER(i32)],
        'crafter_noise3_perm': [vp, i64, vp, i32, vp, vp],
    }
    names = argtypes if geometry is None else VARIANT_FUNCTIONS
    for fn in names:
      getattr(lib, fn).argtypes = argtypes[fn]
      getattr(lib, fn).restype = i32
    if geometry is None:
      lib.crafter_error_string.argtypes = [i32]
      lib.crafter_error_string.restype = ctypes.c_char_p
    _libs[geometry] = lib
  return _libs[geometry]


def ptxas_usage(geometry=None) -> dict:
  """Each kernel's registers and spill bytes from the ``ptxas.log`` of the
  library of ``geometry``: ``{mangled name: {'registers': r,
  'spill_stores': s, 'spill_loads': l}}``."""
  usage, entry, props = {}, None, None
  for line in (out_dir(geometry) / 'ptxas.log').read_text().splitlines():
    if m := re.search(r"entry function '(\w+)'", line):
      entry = m.group(1)
      usage[entry] = {'registers': None, 'spill_stores': 0, 'spill_loads': 0}
    elif m := re.search(r'Function properties for (\w+)', line):
      props = m.group(1)
    elif m := re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                        line):
      if props in usage:
        usage[props].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
    elif (m := re.search(r'Used (\d+) registers', line)) and entry:
      usage[entry]['registers'] = int(m.group(1))
  return usage


def check(code: int, what: str) -> None:
  """Raise if a launch function returned a CUDA error."""
  if code != 0:
    msg = library().crafter_error_string(code).decode()
    raise RuntimeError(f'{what}: CUDA error {code} ({msg})')
