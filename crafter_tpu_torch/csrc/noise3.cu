// 3-D candidate-sum gradient noise.
//
// Replaces the TPU kernel crafter_tpu/ops/noise_pallas.py:noise3_pallas
// (_noise_kernel).  Computes the plain twin crafter_tpu_torch/ops/noise.py:
// noise3_fast bit for bit: the float ops are in the same order, and the
// file is built with -fmad=false, so the only fused multiply-adds are the
// explicit fmaf calls, placed where XLA's CPU backend fuses the reference
// (see the twin's docstring: the shared dz*dz of six candidates rounds
// alone, and the candidate sum starts from the second term).
//
// Bound on the H100: operations.  Each point reads 12 bytes (16 with a
// per-point seed) and writes 4; the work is the 26 candidates (their
// offsets, attenuation, hash and gradient) and the base cell, ~1010
// operations a point counted from this source (chip_smoke.py:
// OPS_NOISE3_POINT), ~60 a byte against the card's ~20.
//
// Design.  A block of 256 threads makes 1024 consecutive points, 4 a
// thread, read as three 16-byte words (and the seeds as one) and stored as
// one.  Per point the candidates share what they can without changing a
// bit, as csrc/noise2.cu does:
//   * the floors are round-down additions to 1.5 * 2^23, which give the
//     base cell as an integer and as an exact float with no conversion
//     instruction (16 lanes a clock on an SM against 128 for an add);
//   * a candidate's lattice coordinate as a float is the base's plus its
//     offset, and the sum of its three coordinates the base's sum plus one
//     of 0..3 (the candidates' offsets sum to 0..3): four squish products
//     a point instead of 26, and no conversions;
//   * a hash product of a candidate is the base's product plus the
//     offset's, wrapping as the JAX hash does: four a coordinate, the seed
//     folded into x's;
//   * with the offsets compile-time constants, the compiler shares the
//     coordinate differences between candidates with equal offsets;
//   * a gradient is three loads from tables of 24 floats in shared memory,
//     one a component (each table in distinct banks: no conflicts),
//     instead of a dozen selects and sign operations.
// All of that is exact within 2^22 of the origin; a point beyond it (or
// not finite) takes the conversions of the twin, as the fallback branch.
#include "common.cuh"

namespace {

constexpr int kPerThread = 4;
constexpr int kThreads = 256;
// floor(v) for |v| < 2^22: 1.5 * 2^23 + v rounded down has ulp 1.
constexpr float kBias = 12582912.0f;
constexpr int kBiasBits = 0x4B400000;
constexpr float kFastRange = 4194304.0f;   // 2^22
constexpr uint32_t kHx = 0x8DA6B343u, kHy = 0xD82DF3C1u, kHz = 0xCB08A31Fu;

// The gradients of h = hash % 24: (+-11, +-4, +-4) with the 11 on axis
// h >> 3 and the signs of x, y, z in bits 0, 1, 2.  Rows of 32 floats, so
// that each table starts at bank 0.
struct Grads {
  float x[32], y[32], z[32];
};

__device__ __forceinline__ void init_grads(Grads& g) {
  const int k = threadIdx.x;
  if (k < 24) {
    const int axis = k >> 3;
    g.x[k] = (k & 1) ? -(axis == 0 ? 11.0f : 4.0f) : (axis == 0 ? 11.0f : 4.0f);
    g.y[k] = (k & 2) ? -(axis == 1 ? 11.0f : 4.0f) : (axis == 1 ? 11.0f : 4.0f);
    g.z[k] = (k & 4) ? -(axis == 2 ? 11.0f : 4.0f) : (axis == 2 ? 11.0f : 4.0f);
  }
  __syncthreads();
}

// The gradient dot product of a candidate from its hash word (products
// xor'ed with the seed, before the mix).
__device__ __forceinline__ float grad_dot(uint32_t hu, float dx, float dy,
                                          float dz, const Grads& g) {
  hu *= 0x27D4EB2Fu;
  int32_t hs = (int32_t)hu;
  hs ^= hs >> 15;   // arithmetic shift, as the JAX hash
  const uint32_t h = ((uint32_t)hs & 0x7FFFFFFFu) % 24u;
  return fmaf(g.z[h], dz, fmaf(g.x[h], dx, g.y[h] * dy));
}

// The candidates (cx, cy, cz) of ops/noise.py:CANDIDATES, in its order,
// and which of them take the shared dz * dz (DZ2_SHARED).
#define CRAFTER_NOISE3_CANDIDATES                                            \
  constexpr int cxs[26] = {-1, -1, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,        \
                           1,  1,  1,  1, 1, 1, 1, 1, 1, 1, 2, 2, 2};       \
  constexpr int cys[26] = {0, 1, 1, -1, 0, 0, 0, 1, 1, 1, 1, 2, 2,          \
                           -1, -1, 0, 0, 0, 0, 1, 1, 1, 2, 0, 0, 1};        \
  constexpr int czs[26] = {1, 0, 1, 1, 0, 1, 2, -1, 0, 1, 2, 0, 1,          \
                           0, 1, -1, 0, 1, 2, -1, 0, 1, 0, 0, 1, 0};        \
  constexpr bool dz2_shared[26] = {0, 1, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0,   \
                                   1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// One candidate's weight and gradient folded into the sum: the first term
// is held, the second starts the sum as fma(w0, g0, w1 * g1).
__device__ __forceinline__ void accumulate(int k, float attn, float grad,
                                           float& w0, float& g0,
                                           float& total) {
  const float a2 = attn * attn;
  const float w = a2 * a2;
  if (k == 0) {
    w0 = w;
    g0 = grad;
  } else if (k == 1) {
    total = fmaf(w0, g0, w * grad);
  } else {
    total = fmaf(w, grad, total);
  }
}

// The candidate sum at (px, py, pz) from the base cell, given as integers
// and as exact floats.
__device__ __forceinline__ float candidates(float px, float py, float pz,
                                            int xb, int yb, int zb, float xf,
                                            float yf, float zf, uint32_t seed,
                                            float squish, float inv_norm,
                                            const Grads& g) {
  CRAFTER_NOISE3_CANDIDATES
  // (float)(xb + yb + zb + s) for s = 0..3: sums of integers below 2^24.
  const float sf = (xf + yf) + zf;
  const float sq[4] = {sf * squish, (sf + 1.0f) * squish,
                       (sf + 2.0f) * squish, (sf + 3.0f) * squish};
  const float fx[4] = {xf - 1.0f, xf, xf + 1.0f, xf + 2.0f};
  const float fy[4] = {yf - 1.0f, yf, yf + 1.0f, yf + 2.0f};
  const float fz[4] = {zf - 1.0f, zf, zf + 1.0f, zf + 2.0f};
  const uint32_t bx = (uint32_t)xb * kHx, by = (uint32_t)yb * kHy,
                 bz = (uint32_t)zb * kHz;
  const uint32_t hx[4] = {(bx - kHx) ^ seed, bx ^ seed, (bx + kHx) ^ seed,
                          (bx + 2u * kHx) ^ seed};
  const uint32_t hy[4] = {by - kHy, by, by + kHy, by + 2u * kHy};
  const uint32_t hz[4] = {bz - kHz, bz, bz + kHz, bz + 2u * kHz};
  float total = 0.0f, w0 = 0.0f, g0 = 0.0f;
#pragma unroll
  for (int k = 0; k < 26; ++k) {
    const int cx = cxs[k] + 1, cy = cys[k] + 1, cz = czs[k] + 1;
    const float s = sq[cxs[k] + cys[k] + czs[k]];
    const float dx = px - (fx[cx] + s);
    const float dy = py - (fy[cy] + s);
    const float dz = pz - (fz[cz] + s);
    float attn = fmaf(-dy, dy, fmaf(-dx, dx, 2.0f));
    attn = dz2_shared[k] ? attn - dz * dz : fmaf(-dz, dz, attn);
    attn = fmaxf(attn, 0.0f);
    accumulate(k, attn, grad_dot(hx[cx] ^ hy[cy] ^ hz[cz], dx, dy, dz, g),
               w0, g0, total);
  }
  return total * inv_norm;
}

__device__ __forceinline__ float noise_at(float px, float py, float pz,
                                          uint32_t seed, float stretch,
                                          float squish, float inv_norm,
                                          const Grads& g) {
  const float nudge = 1.0f / 8192.0f;
  const float st = ((px + py) + pz) * stretch;
  const float vx = (px + st) + nudge, vy = (py + st) + nudge,
              vz = (pz + st) + nudge;
  if (fabsf(vx) < kFastRange && fabsf(vy) < kFastRange &&
      fabsf(vz) < kFastRange) {
    const float bx = __fadd_rd(vx, kBias), by = __fadd_rd(vy, kBias),
                bz = __fadd_rd(vz, kBias);
    return candidates(px, py, pz, __float_as_int(bx) - kBiasBits,
                      __float_as_int(by) - kBiasBits,
                      __float_as_int(bz) - kBiasBits, bx - kBias, by - kBias,
                      bz - kBias, seed, squish, inv_norm, g);
  }
  // Far from the origin (or not finite): the conversions, as the twin.
  CRAFTER_NOISE3_CANDIDATES
  const int xb = (int)floorf(vx), yb = (int)floorf(vy), zb = (int)floorf(vz);
  float total = 0.0f, w0 = 0.0f, g0 = 0.0f;
#pragma unroll
  for (int k = 0; k < 26; ++k) {
    const int x = xb + cxs[k], y = yb + cys[k], z = zb + czs[k];
    const float sq = (float)(x + y + z) * squish;
    const float dx = px - ((float)x + sq);
    const float dy = py - ((float)y + sq);
    const float dz = pz - ((float)z + sq);
    float attn = fmaf(-dy, dy, fmaf(-dx, dx, 2.0f));
    attn = dz2_shared[k] ? attn - dz * dz : fmaf(-dz, dz, attn);
    attn = fmaxf(attn, 0.0f);
    const uint32_t hu =
        ((uint32_t)x * kHx) ^ ((uint32_t)y * kHy) ^ ((uint32_t)z * kHz) ^ seed;
    accumulate(k, attn, grad_dot(hu, dx, dy, dz, g), w0, g0, total);
  }
  return total * inv_norm;
}

// `vec`: pts, seeds and out are 16-byte aligned, so a thread's 4 points
// are three 16-byte loads.
__global__ void __launch_bounds__(kThreads) noise3_kernel(
    const float* __restrict__ pts, const int32_t* __restrict__ seeds,
    int32_t seed_all, float* __restrict__ out, long long n, int vec,
    float stretch, float squish, float inv_norm) {
  __shared__ Grads g;
  init_grads(g);
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kPerThread;
  if (i0 >= n) return;
  if (vec && i0 + kPerThread <= n) {
    const float4* p = reinterpret_cast<const float4*>(pts + 3 * i0);
    const float4 a = p[0], b = p[1], c = p[2];
    int4 sd = make_int4(seed_all, seed_all, seed_all, seed_all);
    if (seeds != nullptr) sd = *reinterpret_cast<const int4*>(seeds + i0);
    float4 v;
    v.x = noise_at(a.x, a.y, a.z, (uint32_t)sd.x, stretch, squish, inv_norm, g);
    v.y = noise_at(a.w, b.x, b.y, (uint32_t)sd.y, stretch, squish, inv_norm, g);
    v.z = noise_at(b.z, b.w, c.x, (uint32_t)sd.z, stretch, squish, inv_norm, g);
    v.w = noise_at(c.y, c.z, c.w, (uint32_t)sd.w, stretch, squish, inv_norm, g);
    *reinterpret_cast<float4*>(out + i0) = v;
  } else {
    for (long long i = i0; i < i0 + kPerThread && i < n; ++i)
      out[i] = noise_at(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2],
                        (uint32_t)(seeds != nullptr ? seeds[i] : seed_all),
                        stretch, squish, inv_norm, g);
  }
}

}  // namespace

// `seeds` may be null: every point then takes `seed_all`.
extern "C" int crafter_noise3(const float* pts, const int32_t* seeds,
                              int seed_all, float* out, long long n, int vec,
                              float stretch, float squish, float inv_norm,
                              void* stream) {
  if (n <= 0) return 0;
  const long long per_block = (long long)kThreads * kPerThread;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  noise3_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pts, seeds, (int32_t)seed_all, out, n, vec, stretch, squish, inv_norm);
  return (int)cudaGetLastError();
}
