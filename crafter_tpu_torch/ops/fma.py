"""A float32 fused multiply-add for plain PyTorch code.

The JAX package's reference numbers come from XLA on the CPU, whose LLVM
backend contracts a single-use float multiply feeding an add into one fused
multiply-add (one rounding instead of two).  Where the reference does that,
the port's plain versions call :func:`fma32` and its CUDA kernels call
``fmaf``, so all three agree bit for bit.

PyTorch has no fused multiply-add op, so this one is exact by construction:
the float32 product is exact in float64, the float64 sum is made
round-to-odd from its exact error term, and rounding a round-to-odd float64
to float32 is then the correctly rounded fused result.

:func:`sigmoid32` is the reference's logistic in the same terms: XLA
computes ``1 / (1 + exp(-x))`` with the Cephes float32 exponential, its
multiply-adds fused.  Built from float32 IEEE operations and :func:`fma32`
only, it gives the same bits on the CPU and on the card, where
``torch.sigmoid`` gives neither the reference's bits nor one device's.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(v: float) -> float:
  return float(np.float32(v))


# Cephes expf: exp(x) = 2^n * p(r), r = x - n ln 2 with ln 2 split in two.
_EXP_HI = _f32(88.3762626647950)
_LOG2E = _f32(1.44269504088896341)
_LN2_HI, _LN2_LO = _f32(-0.693359375), _f32(2.12194440e-4)
_EXP_POLY = tuple(_f32(p) for p in (1.9875691500e-4, 1.3981999507e-3,
                                    8.3334519073e-3, 4.1665795894e-2,
                                    1.6666665459e-1, 5.0000001201e-1))


def fma32(a, b, c) -> torch.Tensor:
  """``a * b + c`` with one float32 rounding (tensors or Python floats)."""
  ref = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))
  d = lambda v: (v.to(torch.float64) if isinstance(v, torch.Tensor)
                 else torch.tensor(float(v), dtype=torch.float64,
                                   device=ref.device))
  p = d(a) * d(b)                       # exact: 24 + 24 bits
  cc = d(c)
  s = p + cc
  bp = s - p                            # TwoSum: s + e == p + cc exactly
  e = (p - (s - bp)) + (cc - bp)
  even = (s.view(torch.int64) & 1) == 0
  toward = torch.where(e > 0, torch.full_like(s, float('inf')),
                       torch.full_like(s, float('-inf')))
  s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
  return s.to(torch.float32)


def exp32(x: torch.Tensor) -> torch.Tensor:
  """float32 ``exp`` as XLA computes it on the CPU (Cephes, fused)."""
  x = x.clamp(-_EXP_HI, _EXP_HI)
  fx = torch.floor(fma32(x, _LOG2E, 0.5))
  r = fma32(fx, _LN2_LO, fma32(fx, _LN2_HI, x))
  z = r * r
  y = torch.full_like(r, _EXP_POLY[0])
  for p in _EXP_POLY[1:]:
    y = fma32(y, r, p)
  y = fma32(y, z, r) + 1.0
  scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
  return y * scale


def sigmoid32(x: torch.Tensor) -> torch.Tensor:
  """float32 ``1 / (1 + exp(-x))``, the reference's ``jax.nn.sigmoid``."""
  return 1.0 / (1.0 + exp32(-x))
