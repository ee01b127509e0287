"""Wrappers of the noise kernels (``csrc/noise2.cu``, ``csrc/noise3.cu``,
``csrc/noise3_perm.cu``).

The first two replace ``crafter_tpu/ops/noise_pallas.py:noise2_pallas`` and
``noise3_pallas``; the third, the 'compat' worldgen's permutation-table
noise, replaces no TPU kernel.  For CUDA tensors a wrapper launches its
kernel; for CPU tensors it runs the plain twin (``ops/noise.py:
noise2_fast`` / ``noise3_fast`` / ``noise3_total``).  ``noise2.launches``,
``noise3.launches`` and ``noise3_perm.launches`` count kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from . import noise


def noise2(points: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
  """Noise at ``points`` (P, 2) float32 with per-point int32 ``seeds`` (P,),
  returning (P,) float32; or, in the shared form, at ``points`` (K, P, 2)
  shared by every row with ``seeds`` (R, K), returning (R, K, P)."""
  shared = points.ndim == 3
  if shared:
    if (points.shape[2] != 2 or seeds.ndim != 2
        or seeds.shape[1] != points.shape[0]):
      raise ValueError(f'points {tuple(points.shape)} / seeds '
                       f'{tuple(seeds.shape)}: want (K, P, 2) and (R, K)')
  elif (points.ndim != 2 or points.shape[1] != 2
        or seeds.shape != points.shape[:1]):
    raise ValueError(f'points {tuple(points.shape)} / seeds '
                     f'{tuple(seeds.shape)}: want (P, 2) and (P,)')
  if not points.is_cuda:
    return (noise.noise2_shared if shared else noise.noise2_fast)(points,
                                                                  seeds)
  out = _launch_noise2(points, seeds, shared)
  noise2.launches += 1
  if shared:
    worlds = seeds.shape[0]
    noise2.launches_by_rows[worlds] = noise2.launches_by_rows.get(worlds,
                                                                  0) + 1
  return out


noise2.launches = 0
# Shared-form launches by the number of rows (worlds) of the call.
noise2.launches_by_rows = {}


def _stream(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def _launch_noise2(points: torch.Tensor, seeds: torch.Tensor,
                   shared: bool) -> torch.Tensor:
  if points.dtype != torch.float32 or seeds.dtype != torch.int32:
    raise TypeError('noise2 takes float32 points and int32 seeds')
  if seeds.device != points.device:
    raise ValueError('points and seeds must be on one device')
  pts = points.contiguous()
  sd = seeds.contiguous()
  lib = _build.library()
  consts = (noise.F32_STRETCH, noise.F32_SQUISH, noise.F32_INV_NORM)
  if shared:
    if pts.data_ptr() % 16:
      raise ValueError('noise2: the shared points must be 16-byte aligned')
    k, p, _ = pts.shape
    out = torch.empty((sd.shape[0], k, p), dtype=torch.float32,
                      device=pts.device)
    _build.check(lib.crafter_noise2_shared(
        pts.data_ptr(), sd.data_ptr(), out.data_ptr(), sd.numel(), k, p,
        *consts, _stream(pts)), 'noise2')
    return out
  out = torch.empty(pts.shape[0], dtype=torch.float32, device=pts.device)
  _build.check(lib.crafter_noise2(
      pts.data_ptr(), sd.data_ptr(), out.data_ptr(), pts.shape[0], *consts,
      _stream(pts)), 'noise2')
  return out


def noise3(points: torch.Tensor, seed) -> torch.Tensor:
  """The drop-in for ``noise3_fast`` on the card: noise at ``points``
  (..., 3) float32 with an int32 ``seed``, a Python int or a tensor
  broadcastable against the leading point dims.  Returns (...) float32."""
  if points.ndim < 1 or points.shape[-1] != 3:
    raise ValueError(f'points {tuple(points.shape)}: want (..., 3)')
  if not points.is_cuda:
    return noise.noise3_fast(points, seed)
  if points.dtype != torch.float32:
    raise TypeError('noise3 takes float32 points')
  shape = points.shape[:-1]
  pts = points.reshape(-1, 3).contiguous()
  if isinstance(seed, torch.Tensor) and seed.numel() > 1:
    if seed.dtype != torch.int32 or seed.device != points.device:
      raise TypeError('noise3 takes int32 seeds on the points\' device')
    seeds = seed.broadcast_to(shape).reshape(-1).contiguous()
    seeds_ptr, seed_all = seeds.data_ptr(), 0
  else:
    # One seed for every point: passed by value, as the TPU wrapper
    # broadcasts it.  Reduced to its int32 two's-complement value.
    seed_all = ((int(seed) + 2 ** 31) % 2 ** 32) - 2 ** 31
    seeds_ptr = None
  out = torch.empty(pts.shape[0], dtype=torch.float32, device=pts.device)
  # 16-byte loads where every pointer allows them.
  vec = int(all(p % 16 == 0 for p in (pts.data_ptr(), out.data_ptr(),
                                      seeds_ptr or 0)))
  lib = _build.library()
  _build.check(lib.crafter_noise3(
      pts.data_ptr(), seeds_ptr, seed_all, out.data_ptr(), pts.shape[0], vec,
      noise.F32_STRETCH_3D, noise.F32_SQUISH_3D, noise.F32_INV_NORM_3D,
      _stream(pts)), 'noise3')
  noise3.launches += 1
  return out.reshape(shape)


noise3.launches = 0


def noise3_perm(points: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
  """The candidate sum of the permutation-table noise, un-normalised, at
  ``points`` (P, 3) float32 shared by every row, with ``perm`` (R, 256)
  int32, a permutation of 0..255 a row: (R, P) float32, what
  ``noise.noise3_total(points[None], perm)`` returns."""
  if points.dtype != torch.float32 or perm.dtype != torch.int32:
    raise TypeError('noise3_perm takes float32 points and int32 tables')
  if (points.ndim != 2 or points.shape[1] != 3 or perm.ndim != 2
      or perm.shape[1] != 256):
    raise ValueError(f'points {tuple(points.shape)} / perm '
                     f'{tuple(perm.shape)}: want (P, 3) and (R, 256)')
  if perm.device != points.device:
    raise ValueError('points and perm must be on one device')
  if not (points.is_contiguous() and perm.is_contiguous()):
    raise ValueError('noise3_perm takes contiguous points and tables')
  if not points.is_cuda:
    return noise.noise3_total(points[None], perm)
  out = torch.empty((perm.shape[0], points.shape[0]), dtype=torch.float32,
                    device=points.device)
  _build.check(_build.library().crafter_noise3_perm(
      points.data_ptr(), points.shape[0], perm.data_ptr(), perm.shape[0],
      out.data_ptr(), _stream(points)), 'noise3_perm')
  noise3_perm.launches += 1
  return out


noise3_perm.launches = 0
