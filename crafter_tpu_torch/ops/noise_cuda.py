"""Wrapper of the 2-D noise kernel (``csrc/noise2.cu``).

Replaces ``crafter_tpu/ops/noise_pallas.py:noise2_pallas``.  For CUDA
tensors it launches the kernel; for CPU tensors it runs the plain twin
``ops/noise.py:noise2_fast``.  ``noise2.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from . import noise


def noise2(points: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
  """Noise at ``points`` (P, 2) float32 with per-point int32 ``seeds`` (P,).
  Returns (P,) float32."""
  if points.ndim != 2 or points.shape[1] != 2 or seeds.shape != points.shape[:1]:
    raise ValueError(f'points {tuple(points.shape)} / seeds '
                     f'{tuple(seeds.shape)}: want (P, 2) and (P,)')
  if not points.is_cuda:
    return noise.noise2_fast(points, seeds)
  out = _launch_noise2(points, seeds)
  noise2.launches += 1
  return out


noise2.launches = 0


def _stream(t: torch.Tensor) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def _launch_noise2(points: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
  if points.dtype != torch.float32 or seeds.dtype != torch.int32:
    raise TypeError('noise2 takes float32 points and int32 seeds')
  if seeds.device != points.device:
    raise ValueError('points and seeds must be on one device')
  pts = points.contiguous()
  sd = seeds.contiguous()
  out = torch.empty(pts.shape[0], dtype=torch.float32, device=pts.device)
  lib = _build.library()
  _build.check(lib.crafter_noise2(
      pts.data_ptr(), sd.data_ptr(), out.data_ptr(), pts.shape[0],
      noise.F32_STRETCH, noise.F32_SQUISH, noise.F32_INV_NORM,
      _stream(pts)), 'noise2')
  return out
