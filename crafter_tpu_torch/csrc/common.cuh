// Shared device helpers of the port's kernels: the counter hashes of
// crafter_tpu/step.py (_fmix, _cell_bits_plane, _seed_uniform) on uint32
// words, whose wrapping multiplies and logical shifts are the int32 lane
// arithmetic of the JAX package bit for bit.
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

}  // namespace crafter
