"""Frozen copy of the port's ``crafter_tpu_torch/ops/fma.py`` for the
benchmark's reference: every call of a CUDA kernel replaced by its
plain twin, nothing imported from the port.  The port's own text
follows.

A float32 fused multiply-add for plain PyTorch code.

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

:func:`cos32` is the reference's float32 cosine.  XLA on the CPU calls the
C library's ``cosf``; glibc's (since 2.28) is the ``sincosf`` of ARM's
optimized-routines: the argument widened to float64, reduced by the
nearest multiple of pi/2, a float64 polynomial, one rounding to float32.
Done in float64 IEEE operations it gives glibc's bits on the CPU and on
the card (``crafter::cos32`` in ``csrc/common.cuh``), where ``torch.cos``
does not.
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


# glibc cosf (sysdeps/ieee754/flt-32/s_cosf.c with sincosf.h and
# sincosf_data.c), read off libm.so.6's .rodata: the reduction constants
# 2/pi * 2^24 and pi/2, the cosine polynomial c0..c4 and the sine's s1..s3.
_COS_HPI_INV = float.fromhex('0x1.45f306dc9c883p+23')
_COS_HPI = float.fromhex('0x1.921fb54442d18p+0')
_COS_C = tuple(float.fromhex(v) for v in (
    '0x1p0', '-0x1.ffffffd0c621cp-2', '0x1.55553e1068f19p-5',
    '-0x1.6c087e89a359dp-10', '0x1.99343027bf8c3p-16'))
_COS_S = tuple(float.fromhex(v) for v in (
    '-0x1.555545995a603p-3', '0x1.1107605230bc4p-7',
    '-0x1.994eb3774cf24p-13'))


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


def cos32(x: torch.Tensor) -> torch.Tensor:
  """float32 ``cos`` as XLA computes it on the CPU: glibc's ``cosf``, bit
  for bit, for ``|x| < 120`` (its fast reduction; beyond it glibc reduces
  by a table of 2/pi bits, which no caller needs).

  Every step is one float64 operation, as the plain (SSE2) build of glibc
  does it.  On a CPU with FMA, glibc runs its FMA build, which fuses the
  reduction and the polynomial's multiply-adds; this form still equals
  ``jax.jit(jnp.cos)`` there on every float32 in [0.3 pi, 1.3 pi], the
  daylight's arguments (``tests/test_torch_render.py``).
  """
  top = (x.view(torch.int32) >> 20) & 0x7FF
  y = x.to(torch.float64)
  # n = nearest multiple of pi/2 (glibc's reduce_fast without intrinsics);
  # arguments below 0.75 (top < 0x3f4) are not reduced.
  n = ((y * _COS_HPI_INV).to(torch.int32) + 0x800000) >> 24
  n = torch.where(top < 0x3F4, torch.zeros_like(n), n)
  r = y - n.to(torch.float64) * _COS_HPI
  r2 = r * r
  # cos(x) is sin(r) for odd n and cos(r) for even n, negated for n & 3 in
  # {1, 2} (glibc's sign table and its second, negated cosine table).
  c0, c1, c2, c3, c4 = _COS_C
  r4 = r2 * r2
  c = (c0 + r2 * c1) + r4 * c2
  c = c + (r4 * r2) * (c3 + r2 * c4)
  s1, s2, s3 = _COS_S
  r3 = r2 * r
  s = (r + r3 * s1) + (r3 * r2) * (s2 + r2 * s3)
  v = torch.where((n & 1) == 1, s, c)
  v = torch.where(((n & 3) == 1) | ((n & 3) == 2), -v, v)
  # Below 2^-12 (top < 0x398) glibc returns 1 without the polynomial.
  return torch.where(top < 0x398, torch.ones_like(x), v.to(torch.float32))
