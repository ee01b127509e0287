"""Host-side float64 OpenSimplex 3D noise for the seed-exact parity engine
(the port's copy of ``crafter_tpu/ops/noise_host.py``; numpy only).

The reference's worldgen calls ``opensimplex.OpenSimplex(seed).noise3``
per cell (reference: crafter/worldgen.py:11, :79-91).  Parity mode needs the
same float64 values; this is the vectorized candidate-sum formulation of
Kurt Spencer's 2014 algorithm (sum over every lattice vertex with positive
attenuation — a superset of the original's contribution walk, identical
because excluded vertices have non-positive attenuation; validated against
a [-3,3]^3 brute-force sweep in tests/test_noise.py and gated against the
real PyPI package where installable).

The permutation table of a seed, reproducing the package's 64-bit LCG
seeding exactly, is ``ops/noise.py:perm_from_java_seed``.
"""

from __future__ import annotations

import numpy as np

STRETCH = -1.0 / 6.0
SQUISH = 1.0 / 3.0
NORM = 103.0

GRAD3 = np.array([
    (-11, 4, 4), (-4, 11, 4), (-4, 4, 11),
    (11, 4, 4), (4, 11, 4), (4, 4, 11),
    (-11, -4, 4), (-4, -11, 4), (-4, -4, 11),
    (11, -4, 4), (4, -11, 4), (4, -4, 11),
    (-11, 4, -4), (-4, 11, -4), (-4, 4, -11),
    (11, 4, -4), (4, 11, -4), (4, 4, -11),
    (-11, -4, -4), (-4, -11, -4), (-4, -4, -11),
    (11, -4, -4), (4, -11, -4), (4, -4, -11),
], np.float64)

CANDIDATES = np.array([
    (-1, 0, 1), (-1, 1, 0), (-1, 1, 1),
    (0, -1, 1), (0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, -1), (0, 1, 0),
    (0, 1, 1), (0, 1, 2), (0, 2, 0), (0, 2, 1),
    (1, -1, 0), (1, -1, 1), (1, 0, -1), (1, 0, 0), (1, 0, 1), (1, 0, 2),
    (1, 1, -1), (1, 1, 0), (1, 1, 1), (1, 2, 0),
    (2, 0, 0), (2, 0, 1), (2, 1, 0),
], np.int64)  # 26 offsets covering every vertex with possible attn > 0


def noise3_host(points: np.ndarray, perm: np.ndarray) -> np.ndarray:
  """OpenSimplex noise3 at float64 ``points`` (..., 3); vectorized.

  NOTE: this is the *candidate-sum reformulation* — it sums
  EVERY lattice vertex with positive attenuation.  The original walk
  (and therefore the PyPI package the reference imports) contributes at
  most 6 region vertices + 2 cascade-selected extras, and near region
  boundaries it OMITS up to ~3 more tiny positive-attenuation vertices
  this sum includes: ~4% of points differ, by up to ~3e-5 (measured in
  tests/test_noise.py).  Parity surfaces must use
  :func:`noise3_walk_host`; this formulation remains the mathematical
  model of the branch-free noise of ``ops/noise.py``.
  """
  p = np.asarray(points, np.float64)
  s = p + STRETCH * p.sum(-1, keepdims=True)
  base = np.floor(s).astype(np.int64)
  verts = base[..., None, :] + CANDIDATES            # (..., 26, 3)
  vin = verts + SQUISH * verts.sum(-1, keepdims=True)
  d = p[..., None, :] - vin
  attn = np.maximum(0.0, 2.0 - (d * d).sum(-1))
  h = perm[verts[..., 0] & 0xFF]
  h = perm[(h + verts[..., 1]) & 0xFF]
  h = perm[(h + verts[..., 2]) & 0xFF] % 24
  grad = GRAD3[h]
  return (attn ** 4 * (grad * d).sum(-1)).sum(-1) / NORM


def noise3_walk_host(points: np.ndarray, perm: np.ndarray) -> np.ndarray:
  """Vectorized float64 OpenSimplex noise3 with the ORIGINAL walk's
  vertex selection and accumulation order — bit-identical to Kurt
  Spencer's 2014 decision-tree eval (and so to the PyPI ``opensimplex``
  package the reference imports, crafter/worldgen.py:84-87).

  Bit-exactness strategy: every branch of the scalar cascade
  (tests/oracles/opensimplex_walk.py) is evaluated as flat ``np.where``
  selections with the walk's exact per-contribution arithmetic order
  (e.g. ``dx0 + 1 - SQUISH`` stays left-associative), and contributions
  accumulate in the walk's order: the region's vertices first, then the
  two cascade-selected extra vertices.  Asserted bit-identical to the
  scalar oracle and the committed goldens in tests/test_noise.py.
  """
  p = np.asarray(points, np.float64)
  shape = p.shape[:-1]
  x, y, z = (p[..., i] for i in range(3))
  so = (x + y + z) * STRETCH
  xs, ys, zs = x + so, y + so, z + so
  xsb = np.floor(xs).astype(np.int64)
  ysb = np.floor(ys).astype(np.int64)
  zsb = np.floor(zs).astype(np.int64)
  sq = (xsb + ysb + zsb) * SQUISH
  dx0 = x - (xsb + sq)
  dy0 = y - (ysb + sq)
  dz0 = z - (zsb + sq)
  xins, yins, zins = xs - xsb, ys - ysb, zs - zsb
  in_sum = xins + yins + zins

  def extrap(vx, vy, vz, dx, dy, dz):
    h = perm[(perm[(perm[vx & 0xFF] + vy) & 0xFF] + vz) & 0xFF] % 24
    g = GRAD3[h]
    return g[..., 0] * dx + g[..., 1] * dy + g[..., 2] * dz

  def contrib(vx, vy, vz, dx, dy, dz):
    attn = 2 - dx * dx - dy * dy - dz * dz
    a2 = attn * attn
    return np.where(attn > 0, a2 * a2 * extrap(vx, vy, vz, dx, dy, dz), 0.0)

  W = np.where
  zero = np.zeros(shape, np.int64)

  # ---- region A (in_sum <= 1): tetrahedron at (0,0,0) -------------------
  aP = np.full(shape, 0x01, np.int64)
  aS = xins
  bP = np.full(shape, 0x02, np.int64)
  bS = yins
  c1 = (aS >= bS) & (zins > bS)
  c2 = (aS < bS) & (zins > aS)
  bP, bS = W(c1, 0x04, bP), W(c1, zins, bS)
  aP, aS = W(c2, 0x04, aP), W(c2, zins, aS)
  wins = 1 - in_sum
  near0 = (wins > aS) | (wins > bS)   # (0,0,0) among the two closest
  cN = W(bS > aS, bP, aP)
  cF = aP | bP
  # near0 exts (vertex sums 0: no squish terms)
  xe0_n = W(cN & 1 == 0, xsb - 1, xsb + 1)
  xe1_n = W(cN & 1 == 0, xsb, xsb + 1)
  dxe0_n = W(cN & 1 == 0, dx0 + 1, dx0 - 1)
  dxe1_n = W(cN & 1 == 0, dx0, dx0 - 1)
  y_open = cN & 2 == 0
  ye0_n = W(y_open, W(cN & 1 != 0, ysb - 1, ysb), ysb + 1)
  ye1_n = W(y_open, W(cN & 1 == 0, ysb - 1, ysb), ysb + 1)
  dye0_n = W(y_open, W(cN & 1 != 0, dy0 + 1, dy0), dy0 - 1)
  dye1_n = W(y_open, W(cN & 1 == 0, dy0 + 1, dy0), dy0 - 1)
  ze0_n = W(cN & 4 == 0, zsb, zsb + 1)
  ze1_n = W(cN & 4 == 0, zsb - 1, zsb + 1)
  dze0_n = W(cN & 4 == 0, dz0, dz0 - 1)
  dze1_n = W(cN & 4 == 0, dz0 + 1, dz0 - 1)
  # far0 exts (c = aP | bP; ext0 sums 2, ext1 sums 1)
  xe0_f = W(cF & 1 == 0, xsb, xsb + 1)
  xe1_f = W(cF & 1 == 0, xsb - 1, xsb + 1)
  dxe0_f = W(cF & 1 == 0, dx0 - 2 * SQUISH, dx0 - 1 - 2 * SQUISH)
  dxe1_f = W(cF & 1 == 0, dx0 + 1 - SQUISH, dx0 - 1 - SQUISH)
  ye0_f = W(cF & 2 == 0, ysb, ysb + 1)
  ye1_f = W(cF & 2 == 0, ysb - 1, ysb + 1)
  dye0_f = W(cF & 2 == 0, dy0 - 2 * SQUISH, dy0 - 1 - 2 * SQUISH)
  dye1_f = W(cF & 2 == 0, dy0 + 1 - SQUISH, dy0 - 1 - SQUISH)
  ze0_f = W(cF & 4 == 0, zsb, zsb + 1)
  ze1_f = W(cF & 4 == 0, zsb - 1, zsb + 1)
  dze0_f = W(cF & 4 == 0, dz0 - 2 * SQUISH, dz0 - 1 - 2 * SQUISH)
  dze1_f = W(cF & 4 == 0, dz0 + 1 - SQUISH, dz0 - 1 - SQUISH)
  xeA0, xeA1 = W(near0, xe0_n, xe0_f), W(near0, xe1_n, xe1_f)
  yeA0, yeA1 = W(near0, ye0_n, ye0_f), W(near0, ye1_n, ye1_f)
  zeA0, zeA1 = W(near0, ze0_n, ze0_f), W(near0, ze1_n, ze1_f)
  dxeA0, dxeA1 = W(near0, dxe0_n, dxe0_f), W(near0, dxe1_n, dxe1_f)
  dyeA0, dyeA1 = W(near0, dye0_n, dye0_f), W(near0, dye1_n, dye1_f)
  dzeA0, dzeA1 = W(near0, dze0_n, dze0_f), W(near0, dze1_n, dze1_f)
  dx1 = dx0 - 1 - SQUISH
  dy1 = dy0 - 0 - SQUISH
  dz1 = dz0 - 0 - SQUISH
  dx2 = dx0 - 0 - SQUISH
  dy2 = dy0 - 1 - SQUISH
  dz3 = dz0 - 1 - SQUISH
  valueA = contrib(xsb, ysb, zsb, dx0, dy0, dz0)
  valueA = valueA + contrib(xsb + 1, ysb, zsb, dx1, dy1, dz1)
  valueA = valueA + contrib(xsb, ysb + 1, zsb, dx2, dy2, dz1)
  valueA = valueA + contrib(xsb, ysb, zsb + 1, dx2, dy1, dz3)

  # ---- region C (in_sum >= 2): tetrahedron at (1,1,1) -------------------
  aP = np.full(shape, 0x06, np.int64)
  aS = xins
  bP = np.full(shape, 0x05, np.int64)
  bS = yins
  c1 = (aS <= bS) & (zins < bS)
  c2 = (aS > bS) & (zins < aS)
  bP, bS = W(c1, 0x03, bP), W(c1, zins, bS)
  aP, aS = W(c2, 0x03, aP), W(c2, zins, aS)
  wins = 3 - in_sum
  near1 = (wins < aS) | (wins < bS)   # (1,1,1) among the two closest
  cN = W(bS < aS, bP, aP)
  cF = aP & bP
  xe0_n = W(cN & 1 != 0, xsb + 2, xsb)
  xe1_n = W(cN & 1 != 0, xsb + 1, xsb)
  dxe0_n = W(cN & 1 != 0, dx0 - 2 - 3 * SQUISH, dx0 - 3 * SQUISH)
  dxe1_n = W(cN & 1 != 0, dx0 - 1 - 3 * SQUISH, dx0 - 3 * SQUISH)
  y_set = cN & 2 != 0
  ye0_n = W(y_set, W(cN & 1 == 0, ysb + 2, ysb + 1), ysb)
  ye1_n = W(y_set, W(cN & 1 != 0, ysb + 2, ysb + 1), ysb)
  dye0_n = W(y_set, W(cN & 1 == 0, dy0 - 1 - 3 * SQUISH - 1,
                      dy0 - 1 - 3 * SQUISH), dy0 - 3 * SQUISH)
  dye1_n = W(y_set, W(cN & 1 != 0, dy0 - 1 - 3 * SQUISH - 1,
                      dy0 - 1 - 3 * SQUISH), dy0 - 3 * SQUISH)
  ze0_n = W(cN & 4 != 0, zsb + 1, zsb)
  ze1_n = W(cN & 4 != 0, zsb + 2, zsb)
  dze0_n = W(cN & 4 != 0, dz0 - 1 - 3 * SQUISH, dz0 - 3 * SQUISH)
  dze1_n = W(cN & 4 != 0, dz0 - 2 - 3 * SQUISH, dz0 - 3 * SQUISH)
  xe0_f = W(cF & 1 != 0, xsb + 1, xsb)
  xe1_f = W(cF & 1 != 0, xsb + 2, xsb)
  dxe0_f = W(cF & 1 != 0, dx0 - 1 - SQUISH, dx0 - SQUISH)
  dxe1_f = W(cF & 1 != 0, dx0 - 2 - 2 * SQUISH, dx0 - 2 * SQUISH)
  ye0_f = W(cF & 2 != 0, ysb + 1, ysb)
  ye1_f = W(cF & 2 != 0, ysb + 2, ysb)
  dye0_f = W(cF & 2 != 0, dy0 - 1 - SQUISH, dy0 - SQUISH)
  dye1_f = W(cF & 2 != 0, dy0 - 2 - 2 * SQUISH, dy0 - 2 * SQUISH)
  ze0_f = W(cF & 4 != 0, zsb + 1, zsb)
  ze1_f = W(cF & 4 != 0, zsb + 2, zsb)
  dze0_f = W(cF & 4 != 0, dz0 - 1 - SQUISH, dz0 - SQUISH)
  dze1_f = W(cF & 4 != 0, dz0 - 2 - 2 * SQUISH, dz0 - 2 * SQUISH)
  xeC0, xeC1 = W(near1, xe0_n, xe0_f), W(near1, xe1_n, xe1_f)
  yeC0, yeC1 = W(near1, ye0_n, ye0_f), W(near1, ye1_n, ye1_f)
  zeC0, zeC1 = W(near1, ze0_n, ze0_f), W(near1, ze1_n, ze1_f)
  dxeC0, dxeC1 = W(near1, dxe0_n, dxe0_f), W(near1, dxe1_n, dxe1_f)
  dyeC0, dyeC1 = W(near1, dye0_n, dye0_f), W(near1, dye1_n, dye1_f)
  dzeC0, dzeC1 = W(near1, dze0_n, dze0_f), W(near1, dze1_n, dze1_f)
  dx3 = dx0 - 1 - 2 * SQUISH
  dy3 = dy0 - 1 - 2 * SQUISH
  dz3c = dz0 - 0 - 2 * SQUISH
  dy2c = dy0 - 0 - 2 * SQUISH
  dz2c = dz0 - 1 - 2 * SQUISH
  dx1c = dx0 - 0 - 2 * SQUISH
  dxl = dx0 - 1 - 3 * SQUISH
  dyl = dy0 - 1 - 3 * SQUISH
  dzl = dz0 - 1 - 3 * SQUISH
  valueC = contrib(xsb + 1, ysb + 1, zsb, dx3, dy3, dz3c)
  valueC = valueC + contrib(xsb + 1, ysb, zsb + 1, dx3, dy2c, dz2c)
  valueC = valueC + contrib(xsb, ysb + 1, zsb + 1, dx1c, dy3, dz2c)
  valueC = valueC + contrib(xsb + 1, ysb + 1, zsb + 1, dxl, dyl, dzl)

  # ---- region B (1 < in_sum < 2): the octahedron ------------------------
  p1 = xins + yins
  aF = p1 > 1
  aS = W(aF, p1 - 1, 1 - p1)
  aP = W(aF, 0x03, 0x04) + zero
  p2 = xins + zins
  bF = p2 > 1
  bS = W(bF, p2 - 1, 1 - p2)
  bP = W(bF, 0x05, 0x02) + zero
  p3 = yins + zins
  sc_hi = p3 > 1
  score = W(sc_hi, p3 - 1, 1 - p3)
  newP = W(sc_hi, 0x06, 0x01)
  repl_a = (aS <= bS) & (aS < score)
  repl_b = (aS > bS) & (bS < score)
  aP, aS, aF = (W(repl_a, newP, aP), W(repl_a, score, aS),
                W(repl_a, sc_hi, aF))
  bP, bS, bF = (W(repl_b, newP, bP), W(repl_b, score, bS),
                W(repl_b, sc_hi, bF))
  same = aF == bF
  both_far = same & aF
  both_near = same & ~aF
  cAnd = aP & bP
  cOr = aP | bP
  c1m = W(aF, aP, bP)   # mixed case: the (1,1,1)-side point
  c2m = W(aF, bP, aP)   # mixed case: the (0,0,0)-side point
  # ext0
  xB0 = W(both_far, xsb + 1,
          W(both_near, xsb,
            W(c1m & 1 == 0, xsb - 1, xsb + 1)))
  yB0 = W(both_far, ysb + 1,
          W(both_near, ysb,
            W((c1m & 1 != 0) & (c1m & 2 == 0), ysb - 1, ysb + 1)))
  zB0 = W(both_far, zsb + 1,
          W(both_near, zsb,
            W((c1m & 1 == 0) | (c1m & 2 == 0), zsb + 1, zsb - 1)))
  dxB0 = W(both_far, dx0 - 1 - 3 * SQUISH,
           W(both_near, dx0,
             W(c1m & 1 == 0, dx0 + 1 - SQUISH, dx0 - 1 - SQUISH)))
  dyB0 = W(both_far, dy0 - 1 - 3 * SQUISH,
           W(both_near, dy0,
             W((c1m & 1 != 0) & (c1m & 2 == 0), dy0 + 1 - SQUISH,
               dy0 - 1 - SQUISH)))
  dzB0 = W(both_far, dz0 - 1 - 3 * SQUISH,
           W(both_near, dz0,
             W((c1m & 1 == 0) | (c1m & 2 == 0), dz0 - 1 - SQUISH,
               dz0 + 1 - SQUISH)))
  # ext1
  xB1 = W(both_far, W(cAnd & 1 != 0, xsb + 2, xsb),
          W(both_near, W(cOr & 1 == 0, xsb - 1, xsb + 1),
            W(c2m & 1 != 0, xsb + 2, xsb)))
  yB1 = W(both_far, W(cAnd & 2 != 0, ysb + 2, ysb),
          W(both_near, W(cOr & 2 == 0, ysb - 1, ysb + 1),
            W((c2m & 1 == 0) & (c2m & 2 != 0), ysb + 2, ysb)))
  zB1 = W(both_far, W(cAnd & 4 != 0, zsb + 2, zsb),
          W(both_near, W(cOr & 4 == 0, zsb - 1, zsb + 1),
            W((c2m & 1 == 0) & (c2m & 2 == 0), zsb + 2, zsb)))
  dxB1 = W(both_far,
           W(cAnd & 1 != 0, dx0 - 2 - 2 * SQUISH, dx0 - 2 * SQUISH),
           W(both_near,
             W(cOr & 1 == 0, dx0 + 1 - SQUISH, dx0 - 1 - SQUISH),
             W(c2m & 1 != 0, dx0 - 2 * SQUISH - 2, dx0 - 2 * SQUISH)))
  dyB1 = W(both_far,
           W(cAnd & 2 != 0, dy0 - 2 - 2 * SQUISH, dy0 - 2 * SQUISH),
           W(both_near,
             W(cOr & 2 == 0, dy0 + 1 - SQUISH, dy0 - 1 - SQUISH),
             W((c2m & 1 == 0) & (c2m & 2 != 0), dy0 - 2 * SQUISH - 2,
               dy0 - 2 * SQUISH)))
  dzB1 = W(both_far,
           W(cAnd & 4 != 0, dz0 - 2 - 2 * SQUISH, dz0 - 2 * SQUISH),
           W(both_near,
             W(cOr & 4 == 0, dz0 + 1 - SQUISH, dz0 - 1 - SQUISH),
             W((c2m & 1 == 0) & (c2m & 2 == 0), dz0 - 2 * SQUISH - 2,
               dz0 - 2 * SQUISH)))
  dx4 = dx0 - 1 - 2 * SQUISH
  dy4 = dy0 - 1 - 2 * SQUISH
  dz4 = dz0 - 0 - 2 * SQUISH
  dy5 = dy0 - 0 - 2 * SQUISH
  dz5 = dz0 - 1 - 2 * SQUISH
  dx6 = dx0 - 0 - 2 * SQUISH
  valueB = contrib(xsb + 1, ysb, zsb, dx1, dy1, dz1)
  valueB = valueB + contrib(xsb, ysb + 1, zsb, dx2, dy2, dz1)
  valueB = valueB + contrib(xsb, ysb, zsb + 1, dx2, dy1, dz3)
  valueB = valueB + contrib(xsb + 1, ysb + 1, zsb, dx4, dy4, dz4)
  valueB = valueB + contrib(xsb + 1, ysb, zsb + 1, dx4, dy5, dz5)
  valueB = valueB + contrib(xsb, ysb + 1, zsb + 1, dx6, dy4, dz5)

  mA = in_sum <= 1
  mC = in_sum >= 2
  value = W(mA, valueA, W(mC, valueC, valueB))
  xe0 = W(mA, xeA0, W(mC, xeC0, xB0))
  ye0 = W(mA, yeA0, W(mC, yeC0, yB0))
  ze0 = W(mA, zeA0, W(mC, zeC0, zB0))
  xe1 = W(mA, xeA1, W(mC, xeC1, xB1))
  ye1 = W(mA, yeA1, W(mC, yeC1, yB1))
  ze1 = W(mA, zeA1, W(mC, zeC1, zB1))
  dxe0 = W(mA, dxeA0, W(mC, dxeC0, dxB0))
  dye0 = W(mA, dyeA0, W(mC, dyeC0, dyB0))
  dze0 = W(mA, dzeA0, W(mC, dzeC0, dzB0))
  dxe1 = W(mA, dxeA1, W(mC, dxeC1, dxB1))
  dye1 = W(mA, dyeA1, W(mC, dyeC1, dyB1))
  dze1 = W(mA, dzeA1, W(mC, dzeC1, dzB1))
  value = value + contrib(xe0, ye0, ze0, dxe0, dye0, dze0)
  value = value + contrib(xe1, ye1, ze1, dxe1, dye1, dze1)
  return value / NORM
