"""2-D OpenSimplex-structured gradient noise — the plain PyTorch version.

The port's counterpart of ``crafter_tpu/ops/noise.py:noise2_fast``, and the
plain twin of the CUDA kernel in ``ops/noise_cuda.py``.  Same lattice,
candidate set, attenuation, arithmetic gradient hash and normalisation, op
for op in float32, so it reproduces the JAX function bit for bit:

* the fused multiply-adds sit where XLA's CPU backend contracts them
  (``ops/fma.py``), every other float op rounds on its own;
* the division by the normaliser is a multiply by its float32 reciprocal,
  which is what XLA makes of a division by a constant.
"""

from __future__ import annotations

import numpy as np
import torch

from .fma import fma32

STRETCH_2D = float((1.0 / np.sqrt(3.0) - 1.0) / 2.0)
SQUISH_2D = float((np.sqrt(3.0) - 1.0) / 2.0)
# The original 2-D normaliser is 47; 55 rescales the field to the 3-D
# field's spread (crafter_tpu/ops/noise.py:211-215).
NORM_2D = 55.0
# Lattice offsets that can have positive attenuation (exhaustive sweep in
# tests/test_noise.py).
CANDIDATES_2D = np.array([
    (-1, 1), (0, 0), (0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0),
], np.int32)

# float32 constants exactly as XLA sees them.
F32_STRETCH = float(np.float32(STRETCH_2D))
F32_SQUISH = float(np.float32(SQUISH_2D))
F32_INV_NORM = float(np.float32(1.0) / np.float32(NORM_2D))
NUDGE = 2.0 ** -13
# Hash multipliers as int32 (two's-complement wrap).
H_X, H_Y, H_MIX = -1918454973, -668077119, 0x27D4EB2F


def noise2_fast(points: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
  """Noise at ``points`` (..., 2) float32 with int32 ``seed`` broadcastable
  against the leading point dims.  Returns (...) float32."""
  pts = points.to(torch.float32)
  shape = pts.shape[:-1]
  seed = torch.as_tensor(seed, dtype=torch.int32,
                         device=pts.device).broadcast_to(shape).reshape(-1)
  pts = pts.reshape(-1, 2)
  px, py = pts[:, 0], pts[:, 1]
  stretch = (px + py) * F32_STRETCH
  xb = torch.floor(px + stretch + NUDGE).to(torch.int32)
  yb = torch.floor(py + stretch + NUDGE).to(torch.int32)

  total = torch.zeros_like(px)
  for cx, cy in CANDIDATES_2D.tolist():
    vx, vy = xb + cx, yb + cy
    squish = (vx + vy).to(torch.float32) * F32_SQUISH
    dx = px - (vx.to(torch.float32) + squish)
    dy = py - (vy.to(torch.float32) + squish)
    attn = torch.clamp_min(fma32(-dy, dy, fma32(-dx, dx, 2.0)), 0.0)
    attn2 = attn * attn
    h = (vx * H_X) ^ (vy * H_Y) ^ seed
    h = h * H_MIX
    h = h ^ (h >> 15)                       # arithmetic shift, as in JAX
    s0 = 1 - 2 * (h & 1)
    s1 = 1 - 2 * ((h >> 1) & 1)
    long_x = ((h >> 2) & 1) == 1
    gx = torch.where(long_x, 5, 2) * s0
    gy = torch.where(long_x, 2, 5) * s1
    grad = fma32(gx.to(torch.float32), dx, gy * dy)
    total = fma32(attn2 * attn2, grad, total)
  return (total * F32_INV_NORM).reshape(shape)
