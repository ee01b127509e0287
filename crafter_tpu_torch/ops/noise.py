"""OpenSimplex-structured gradient noise, 2-D and 3-D — the plain PyTorch
versions.

The port's counterparts of ``crafter_tpu/ops/noise.py``: ``noise2_fast`` and
``noise3_fast`` (the plain twins of the CUDA kernels in
``ops/noise_cuda.py``), and the permutation-table OpenSimplex of the
'compat' worldgen mode: ``perm_from_key``, ``perm_from_java_seed``,
``noise3`` and ``octaved_noise3``.  Same lattice, candidate sets,
attenuation, gradient hashes and normalisation, op for op in float32, so
they reproduce the jitted JAX functions bit for bit:

* the fused multiply-adds sit where XLA's CPU backend contracts them
  (``ops/fma.py``), every other float op rounds on its own;
* the division by the normaliser is a multiply by its float32 reciprocal,
  which is what XLA makes of a division by a constant.

:func:`noise2_shared` is the twin of the 2-D kernel's shared form (points
once a channel, a seed a row and channel), which worldgen calls.

Where the fusions of the 3-D sums sit was read off XLA's optimised code for
``jax.jit(noise3_fast)`` (see :func:`noise3_fast`) and for the loop body of
``noise3`` inside ``jax.jit(jax.vmap(generate_world))`` (see
:func:`noise3_total`).  The permutation-table noise has no TPU kernel
behind it (the JAX package runs it as a ``lax.scan`` of jnp ops); on the
card worldgen calls its CUDA kernel (``ops/noise_cuda.py:noise3_perm``,
``csrc/noise3_perm.cu``), whose plain twin is :func:`noise3_total`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import prng
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


def noise2_shared(points: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
  """:func:`noise2_fast` on points shared by every row: ``points`` (K, P, 2)
  float32 (one point set a channel), ``seeds`` (R, K) int32 (one seed a row
  and channel).  Returns (R, K, P) float32: the points and seeds expanded
  to every (row, channel, point), then :func:`noise2_fast`."""
  r, k = seeds.shape
  pts = points[None].expand(r, -1, -1, -1)
  return noise2_fast(pts, seeds[:, :, None].expand(-1, -1, points.shape[1]))


STRETCH_3D = -1.0 / 6.0
SQUISH_3D = 1.0 / 3.0
NORM_3D = 103.0
# All lattice offsets relative to floor(stretched point) that can have
# positive attenuation (exhaustive sweep in tests/test_noise.py).
CANDIDATES = np.array([
    (-1, 0, 1), (-1, 1, 0), (-1, 1, 1),
    (0, -1, 1), (0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, -1), (0, 1, 0),
    (0, 1, 1), (0, 1, 2), (0, 2, 0), (0, 2, 1),
    (1, -1, 0), (1, -1, 1), (1, 0, -1), (1, 0, 0), (1, 0, 1), (1, 0, 2),
    (1, 1, -1), (1, 1, 0), (1, 1, 1), (1, 2, 0),
    (2, 0, 0), (2, 0, 1), (2, 1, 0),
], np.int32)  # (26, 3)

F32_STRETCH_3D = float(np.float32(STRETCH_3D))
F32_SQUISH_3D = float(np.float32(SQUISH_3D))
F32_INV_NORM_3D = float(np.float32(1.0) / np.float32(NORM_3D))
H_Z = -888626401
# Candidates whose ``dz * dz`` XLA computes once for several of them: those
# whose x and y offsets cancel share their dz with every other such
# candidate of the same z offset.  A product with several uses is not
# fused into the subtraction that consumes it.
_cancel = [(c[0] + c[1] == 0, c[2]) for c in CANDIDATES.tolist()]
DZ2_SHARED = tuple(cancels and _cancel.count((True, cz)) > 1
                   for cancels, cz in _cancel)


def noise3_fast(points: torch.Tensor, seed) -> torch.Tensor:
  """Noise at ``points`` (..., 3) float32 with an int32 ``seed``, a scalar or
  broadcastable against the leading point dims.  Returns (...) float32.

  The fused multiply-adds are those of XLA's compiled code for the jitted
  JAX function: every square of the attenuation is fused into its
  subtraction, except ``dz * dz`` of the six candidates of ``DZ2_SHARED``
  (XLA shares that product between them, and a product with several uses
  rounds alone); the gradient dot product is
  ``fma(gz, dz, fma(gx, dx, gy * dy))``; the sum over the candidates starts
  as ``fma(t0, g0, t1 * g1)`` and takes every later term as
  ``fma(tk, gk, sum)``.
  """
  pts = points.to(torch.float32)
  shape = pts.shape[:-1]
  seed = torch.as_tensor(seed, dtype=torch.int32,
                         device=pts.device).broadcast_to(shape).reshape(-1)
  pts = pts.reshape(-1, 3)
  px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
  stretch = ((px + py) + pz) * F32_STRETCH_3D
  xb = torch.floor(px + stretch + NUDGE).to(torch.int32)
  yb = torch.floor(py + stretch + NUDGE).to(torch.int32)
  zb = torch.floor(pz + stretch + NUDGE).to(torch.int32)

  total = first = None
  for (cx, cy, cz), shared in zip(CANDIDATES.tolist(), DZ2_SHARED):
    vx, vy, vz = xb + cx, yb + cy, zb + cz
    squish = (vx + vy + vz).to(torch.float32) * F32_SQUISH_3D
    dx = px - (vx.to(torch.float32) + squish)
    dy = py - (vy.to(torch.float32) + squish)
    dz = pz - (vz.to(torch.float32) + squish)
    attn = fma32(-dy, dy, fma32(-dx, dx, 2.0))
    attn = attn - dz * dz if shared else fma32(-dz, dz, attn)
    attn = torch.clamp_min(attn, 0.0)
    attn2 = attn * attn
    h = (vx * H_X) ^ (vy * H_Y) ^ (vz * H_Z) ^ seed
    h = h * H_MIX
    h = h ^ (h >> 15)                       # arithmetic shift, as in JAX
    h = (h & 0x7FFFFFFF) % 24
    # The 24 gradients are (+-11, +-4, +-4) with the 11 on `axis`.
    axis = h // 8
    s0 = 1 - 2 * (h & 1)
    s1 = 1 - 2 * ((h >> 1) & 1)
    s2 = 1 - 2 * ((h >> 2) & 1)
    gx = (torch.where(axis == 0, 11, 4) * s0).to(torch.float32)
    gy = (torch.where(axis == 1, 11, 4) * s1).to(torch.float32)
    gz = (torch.where(axis == 2, 11, 4) * s2).to(torch.float32)
    grad = fma32(gz, dz, fma32(gx, dx, gy * dy))
    weight = attn2 * attn2
    if first is None:
      first = (weight, grad)
    elif total is None:
      total = fma32(first[0], first[1], weight * grad)
    else:
      total = fma32(weight, grad, total)
  return (total * F32_INV_NORM_3D).reshape(shape)


# ---------------------------------------------------------------------------
# The permutation-table OpenSimplex noise of the 'compat' worldgen mode
# (crafter_tpu/ops/noise.py:61-143, :274-290).

# The 24 gradient directions of OpenSimplex 3D (rhombicuboctahedron
# vertices), as a (24, 3) table.
GRAD3 = np.array([
    (-11, 4, 4), (-4, 11, 4), (-4, 4, 11),
    (11, 4, 4), (4, 11, 4), (4, 4, 11),
    (-11, -4, 4), (-4, -11, 4), (-4, -4, 11),
    (11, -4, 4), (4, -11, 4), (4, -4, 11),
    (-11, 4, -4), (-4, 11, -4), (-4, 4, -11),
    (11, 4, -4), (4, 11, -4), (4, 4, -11),
    (-11, -4, -4), (-4, -11, -4), (-4, -4, -11),
    (11, -4, -4), (4, -11, -4), (4, -4, -11),
], np.float32)


def perm_from_key(keys: torch.Tensor) -> torch.Tensor:
  """Random permutation tables of 0..255 from PRNG keys: (R, 2) key words
  -> (R, 256) int32, each row ``jax.random.permutation(key, 256)``.

  JAX shuffles 256 elements in one round of its sort shuffle: it splits the
  key, draws 32 bits an element from the second half and sorts stably by
  them (``prng.permutation`` for one key); the sorted order of the
  identity is the table."""
  sub = prng.split(keys, 2)[..., 1, :]
  bits = prng.random_bits(sub, (256,))            # uint32 values in int64
  return torch.sort(bits, dim=-1, stable=True).indices.to(torch.int32)


def perm_from_java_seed(seed: int) -> np.ndarray:
  """Exact permutation table of ``opensimplex.OpenSimplex(seed)`` (numpy).

  Reproduces the original 64-bit LCG Fisher-Yates: three warm-up LCG steps,
  then for i = 255..0 draw ``r = (seed + 31) % (i + 1)`` (signed, corrected
  to non-negative) and swap.  Host-side helper for the parity engine.
  """
  mask = (1 << 64) - 1
  mul, add = 6364136223846793005, 1442695040888963407
  s = seed & mask
  for _ in range(3):
    s = (s * mul + add) & mask
  source = list(range(256))
  perm = np.zeros(256, np.int32)
  for i in range(255, -1, -1):
    s = (s * mul + add) & mask
    t = (s + 31) & mask
    t_signed = t - (1 << 64) if t >= (1 << 63) else t
    r = t_signed % (i + 1)  # Python's % is the mathematical mod, as the
    #                         original's sign correction makes it.
    perm[i] = source[r]
    source[r] = source[i]
  return perm


def noise3_total(points: torch.Tensor, perm) -> torch.Tensor:
  """The candidate sum of :func:`noise3` before its normalisation.

  ``points`` (..., 3); ``perm`` (256,) -> (...), or (R, 256) with points
  (R, ...) or (1, ...) (one point set shared by every row) -> (R, ...).

  The float operations are those XLA compiles the JAX loop body to (one
  fusion, read off its optimised LLVM IR): the stretch is fused,
  ``floor(fma(x + y + z, -1/6, p) + 2**-13)``; the squish ``(vx + vy +
  vz) * 1/3`` has three uses and rounds alone; the attenuation is
  ``fma(-dz, dz, fma(-dy, dy, fma(-dx, dx, 2)))``; the gradient dot is
  ``fma(gz, dz, fma(gx, dx, gy * dy))``; and the sum, carried from zero
  through the 26 iterations, takes each term as ``fma(attn**4, grad,
  sum)``.  Every temporary is a (R, P) or (P,) tensor: a (P, 26) form would
  take tens of GB at a 4096-env reset.
  """
  pts = points.to(torch.float32)
  perm = torch.as_tensor(perm, device=pts.device)
  table = perm.reshape(-1, 256).to(torch.int64)               # (R, 256)
  rows = table.shape[0]
  if perm.ndim == 1:
    pts = pts[None]
  shape = pts.shape[:-1]
  pts = pts.reshape(shape[0], -1, 3)                          # (Rp, P, 3)
  px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
  coord_sum = (px + py) + pz
  xb, yb, zb = (torch.floor(fma32(coord_sum, F32_STRETCH_3D, p) + NUDGE)
                .to(torch.int32) for p in (px, py, pz))
  # The gradient of each table entry: GRAD3[perm % 24], a row each.
  grads = torch.from_numpy(GRAD3).to(pts.device)[table % 24]  # (R, 256, 3)
  gxt, gyt, gzt = (grads[..., i].contiguous() for i in range(3))
  full = (rows, pts.shape[1])

  total = None
  for cx, cy, cz in CANDIDATES.tolist():
    vx, vy, vz = xb + cx, yb + cy, zb + cz
    squish = ((vx + vy) + vz).to(torch.float32) * F32_SQUISH_3D
    dx = px - (vx.to(torch.float32) + squish)
    dy = py - (vy.to(torch.float32) + squish)
    dz = pz - (vz.to(torch.float32) + squish)
    attn = fma32(-dz, dz, fma32(-dy, dy, fma32(-dx, dx, 2.0)))
    attn2 = torch.clamp_min(attn, 0.0)
    attn2 = attn2 * attn2
    weight = attn2 * attn2
    # perm[(perm[(perm[x & 255] + y) & 255] + z) & 255] % 24, a row each.
    h = torch.gather(table, 1, (vx & 0xFF).to(torch.int64).expand(full))
    h = torch.gather(table, 1, (h + vy) & 0xFF)
    h = (h + vz) & 0xFF
    gx = torch.gather(gxt, 1, h)
    gy = torch.gather(gyt, 1, h)
    gz = torch.gather(gzt, 1, h)
    grad = fma32(gz, dz, fma32(gx, dx, gy * dy))
    total = fma32(weight, grad, 0.0 if total is None else total)
  out_shape = (rows,) + tuple(shape[1:])
  total = total.reshape(out_shape)
  return total[0] if perm.ndim == 1 else total


def noise3(points: torch.Tensor, perm) -> torch.Tensor:
  """OpenSimplex 3-D noise at ``points`` (..., 3) float32 with a
  permutation table ``perm`` (256,), or one a row (R, 256) with points
  (R, ...) or (1, ...); values in about [-0.87, 0.87], float32.  Equal to
  the JAX package's jitted ``noise3``."""
  return noise3_total(points, perm) * F32_INV_NORM_3D


def octaved_noise3(xy: torch.Tensor, z: float, sizes: dict,
                   perm, normalize: bool = True) -> torch.Tensor:
  """The reference's ``_simplex`` octave helper (worldgen.py:79-91):
  ``xy`` (..., 2); each (size, weight) adds ``weight * noise3(xy / size,
  z)``; ``normalize`` divides by the weight sum.  Each step rounds alone,
  as the JAX function's eager operations do."""
  total = None
  xy = xy.to(torch.float32)
  for size, weight in sizes.items():
    pts = torch.cat([xy / float(np.float32(size)),
                     torch.full(xy.shape[:-1] + (1,), float(z),
                                dtype=torch.float32, device=xy.device)], -1)
    val = float(np.float32(weight)) * noise3(pts, perm)
    total = val if total is None else total + val
  if normalize:
    total = total / float(np.float32(sum(sizes.values())))
  return total
