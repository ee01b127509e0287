// Shared device helpers of the port's kernels: the counter hashes of
// crafter_tpu/step.py (_fmix, _cell_bits_plane, _seed_uniform) on uint32
// words, whose wrapping multiplies and logical shifts are the int32 lane
// arithmetic of the JAX package bit for bit; and the reference's float32
// cosine and daylight curve (ops/fma.py:cos32, state.py:daylight).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace crafter {

// murmur3-style 32-bit finalizer (step.py:_fmix).
__device__ __forceinline__ uint32_t fmix(uint32_t v) {
  v ^= v >> 16;
  v *= 0x7FEB352Du;
  v ^= v >> 15;
  v *= 0x846CA68Bu;
  v ^= v >> 16;
  return v;
}

// Per-cell random bits from (seed, channel, x, y) (step.py:_cell_bits_plane).
__device__ __forceinline__ uint32_t cell_bits(uint32_t seed, uint32_t chan,
                                              uint32_t x, uint32_t y) {
  uint32_t v = seed + 0x9E3779B9u * chan + x * 0x85EBCA6Bu + y * 0xC2B2AE35u;
  return fmix(fmix(v));
}

// float32 uniform in [0, 1) from the top 24 bits of a word (exact).
__device__ __forceinline__ float u24(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// float32 cos as XLA computes it on the CPU: glibc's cosf (the sincosf of
// ARM's optimized-routines), for |x| < 120.  Float64 throughout, every
// step one IEEE operation (the kernels build with -fmad=false), one
// rounding to float32 at the end; the constants are libm's.  The same
// steps as ops/fma.py:cos32, which the CPU tests hold to jax.jit(jnp.cos).
__device__ __forceinline__ float cos32(float x) {
  const uint32_t top = (__float_as_uint(x) >> 20) & 0x7FFu;
  if (top < 0x398u) return 1.0f;   // |x| < 2^-12
  double r = (double)x;
  int n = 0;
  if (top >= 0x3F4u) {             // |x| >= 0.75: reduce by n * pi/2
    n = ((int)(r * 0x1.45f306dc9c883p+23) + 0x800000) >> 24;
    r = r - (double)n * 0x1.921fb54442d18p+0;
  }
  const double r2 = r * r;
  double v;
  if (n & 1) {                     // sin(r)
    const double r3 = r2 * r;
    const double s = r + r3 * -0x1.555545995a603p-3;
    v = s + (r3 * r2) * (0x1.1107605230bc4p-7 + r2 * -0x1.994eb3774cf24p-13);
  } else {                         // cos(r)
    const double r4 = r2 * r2;
    const double c = (1.0 + r2 * -0x1.ffffffd0c621cp-2) +
                     r4 * 0x1.55553e1068f19p-5;
    v = c + (r4 * r2) *
                (-0x1.6c087e89a359dp-10 + r2 * 0x1.99343027bf8c3p-16);
  }
  if (((n & 3) == 1) || ((n & 3) == 2)) v = -v;
  return (float)v;
}

// Day/night curve 1 - |cos(pi * ((t / L) % 1 + 0.3))|^3 under jax.jit
// (state.py:daylight): t * float32(1 / L), a floor-mod by 1, the outer
// product of |c|^3 fused into the subtract.
__device__ __forceinline__ float daylight32(int32_t step, float inv_day) {
  float m = fmodf((float)step * inv_day, 1.0f);
  if (m < 0.0f) m += 1.0f;
  const float c = fabsf(cos32(0x1.921fb6p+1f * (m + 0.3f)));
  return fmaf(-c, c * c, 1.0f);
}

}  // namespace crafter
