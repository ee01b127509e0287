// 2-D candidate-sum gradient noise.
//
// Replaces the TPU kernel crafter_tpu/ops/noise_pallas.py:noise2_pallas
// (_noise2_kernel).  Computes the plain twin crafter_tpu_torch/ops/noise.py:
// noise2_fast bit for bit: the float ops are in the same order, and the
// file is built with -fmad=false, so the only fused multiply-adds are the
// explicit fmaf calls, placed where XLA's CPU backend fuses the reference.
//
// Two forms.  The per-point form takes (P, 2) points and (P,) seeds, one
// thread a point.  The shared form, which worldgen calls, takes the 13
// channels' points once, (13, W*H, 2), and a seed a (world, channel) row,
// (R, 13), as the JAX package vmaps the kernel over shared points and
// per-row seeds (crafter_tpu/worldgen.py:59-74): worldgen no longer writes
// R * 13 copies of the points and seeds for the kernel to read back.
//
// Bound on the H100: operations.  noise_at needs ~170 a point: per
// candidate 12 float operations (offsets, attenuation, its fourth power,
// gradient dot, sum), 6 integer ones (hash, gradient index) and the
// gradient's load, and ~26 for the base corner; against 4 bytes of output
// a point in the shared form (the per-point form reads 12 bytes more).  No conversion
// instruction runs for points within 2^22 of the origin: the floors and
// integer-valued floats go through round-down additions to 1.5 * 2^23.
// Design of the shared form: a block owns 1024 consecutive points of one
// (world, channel) row, so its seed is one uniform load and its points one
// contiguous stretch of the channel's table (426 KB in all, which stays in
// L2); each thread makes 4 consecutive points, reads them as two 16-byte
// words and stores one.  Per point the candidates share what they can
// without changing a bit: the hash products of the base corner
// ((xb + cx) * H == xb * H + cx * H in wrapping uint32), the squish
// products (vx + vy takes only the three values xb + yb + {0, 1, 2}) and
// the lattice coordinates as floats; a candidate's gradient is one load
// from a table of eight in shared memory.
#include "common.cuh"

namespace {

constexpr int kPerThread = 4;
constexpr int kSharedThreads = 256;

// floor(v) for |v| < 2^22 without the conversion unit (16 lanes a clock on
// an SM, against 128 for a float add): 1.5 * 2^23 + v rounded down has
// ulp 1, so it is 1.5 * 2^23 + floor(v), exactly.
constexpr float kBias = 12582912.0f;
constexpr int kBiasBits = 0x4B400000;
constexpr float kFastRange = 4194304.0f;   // 2^22

// The gradient of hash bits h & 7, (gx, gy): bit 2 picks the long axis
// (5 on it, 2 on the other), bits 0 and 1 the signs of gx and gy.  Each
// block keeps the eight in shared memory: one load a candidate instead of
// a dozen bit operations and selects.
__device__ __forceinline__ void init_grads(float2* grads) {
  const int k = threadIdx.x;
  if (k < 8) {
    const float g5 = (k & 4) ? 5.0f : 2.0f, g2 = (k & 4) ? 2.0f : 5.0f;
    grads[k] = make_float2((k & 1) ? -g5 : g5, (k & 2) ? -g2 : g2);
  }
  __syncthreads();
}

// The candidate sum at (px, py) from the base corner (xb, yb), given also
// as exact floats.
__device__ __forceinline__ float candidates(float px, float py, int xb,
                                            int yb, float xf, float yf,
                                            uint32_t seed, float squish,
                                            float inv_norm,
                                            const float2* grads) {
  const uint32_t hx = (uint32_t)xb * 0x8DA6B343u;
  const uint32_t hy = (uint32_t)yb * 0xD82DF3C1u;
  // (float)(xb + yb + k) and (float)(xb + k): sums of small integers,
  // exact in float.
  const float sq[3] = {(xf + yf) * squish, ((xf + yf) + 1.0f) * squish,
                       ((xf + yf) + 2.0f) * squish};
  const float fx[4] = {xf - 1.0f, xf, xf + 1.0f, xf + 2.0f};
  const float fy[4] = {yf - 1.0f, yf, yf + 1.0f, yf + 2.0f};
  // The candidates (cx, cy) of ops/noise.py:CANDIDATES_2D, in its order.
  constexpr int cxs[8] = {-1, 0, 0, 0, 1, 1, 1, 2};
  constexpr int cys[8] = {1, 0, 1, 2, -1, 0, 1, 0};
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int cx = cxs[k], cy = cys[k];
    const float s = sq[cx + cy];
    const float dx = px - (fx[cx + 1] + s);
    const float dy = py - (fy[cy + 1] + s);
    const float attn = fmaxf(fmaf(-dy, dy, fmaf(-dx, dx, 2.0f)), 0.0f);
    const float a2 = attn * attn;
    uint32_t hu = (hx + (uint32_t)cx * 0x8DA6B343u)
                  ^ (hy + (uint32_t)cy * 0xD82DF3C1u) ^ seed;
    hu *= 0x27D4EB2Fu;
    // Bits 0..2 of h ^ (h >> 15) (the JAX hash's shift is arithmetic; its
    // bits 15..17 are the same either way).
    const float2 g = grads[(hu ^ (hu >> 15)) & 7];
    const float grad = fmaf(g.x, dx, g.y * dy);
    total = fmaf(a2 * a2, grad, total);
  }
  return total * inv_norm;
}

__device__ __forceinline__ float noise_at(float px, float py, uint32_t seed,
                                          float stretch, float squish,
                                          float inv_norm,
                                          const float2* grads) {
  const float nudge = 1.0f / 8192.0f;
  const float st = (px + py) * stretch;
  const float vx = (px + st) + nudge, vy = (py + st) + nudge;
  if (fabsf(vx) < kFastRange && fabsf(vy) < kFastRange) {
    const float bx = __fadd_rd(vx, kBias), by = __fadd_rd(vy, kBias);
    return candidates(px, py, __float_as_int(bx) - kBiasBits,
                      __float_as_int(by) - kBiasBits, bx - kBias, by - kBias,
                      seed, squish, inv_norm, grads);
  }
  // Far from the origin (or not finite): the conversions, as the twin.
  const int xb = (int)floorf(vx), yb = (int)floorf(vy);
  float total = 0.0f;
  constexpr int cxs[8] = {-1, 0, 0, 0, 1, 1, 1, 2};
  constexpr int cys[8] = {1, 0, 1, 2, -1, 0, 1, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int x = xb + cxs[k], y = yb + cys[k];
    const float sq = (float)(x + y) * squish;
    const float dx = px - ((float)x + sq), dy = py - ((float)y + sq);
    const float attn = fmaxf(fmaf(-dy, dy, fmaf(-dx, dx, 2.0f)), 0.0f);
    const float a2 = attn * attn;
    uint32_t hu = ((uint32_t)x * 0x8DA6B343u) ^ ((uint32_t)y * 0xD82DF3C1u)
                  ^ seed;
    hu *= 0x27D4EB2Fu;
    int32_t h = (int32_t)hu;
    h ^= h >> 15;
    const bool long_x = ((h >> 2) & 1) != 0;
    const float gx = (float)((long_x ? 5 : 2) * (1 - 2 * (h & 1)));
    const float gy = (float)((long_x ? 2 : 5) * (1 - 2 * ((h >> 1) & 1)));
    total = fmaf(a2 * a2, fmaf(gx, dx, gy * dy), total);
  }
  return total * inv_norm;
}

__global__ void noise2_kernel(const float* __restrict__ pts,
                              const int32_t* __restrict__ seeds,
                              float* __restrict__ out, long long n,
                              float stretch, float squish, float inv_norm) {
  __shared__ float2 grads[8];
  init_grads(grads);
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = noise_at(pts[2 * i], pts[2 * i + 1], (uint32_t)seeds[i], stretch,
                    squish, inv_norm, grads);
}

__global__ void __launch_bounds__(kSharedThreads) noise2_shared_kernel(
    const float* __restrict__ pts, const int32_t* __restrict__ seeds,
    float* __restrict__ out, int n_ch, int p, float stretch, float squish,
    float inv_norm) {
  __shared__ float2 grads[8];
  init_grads(grads);
  const int row = blockIdx.x;                  // world * n_ch + channel
  const uint32_t seed = (uint32_t)seeds[row];
  const float* cp = pts + (size_t)(row % n_ch) * p * 2;
  float* o = out + (size_t)row * p;
  const int i0 = (blockIdx.y * kSharedThreads + threadIdx.x) * kPerThread;
  if (i0 >= p) return;
  float v[kPerThread];
  if ((p & 3) == 0) {
    const float4 a = *reinterpret_cast<const float4*>(cp + 2 * i0);
    const float4 b = *reinterpret_cast<const float4*>(cp + 2 * i0 + 4);
    v[0] = noise_at(a.x, a.y, seed, stretch, squish, inv_norm, grads);
    v[1] = noise_at(a.z, a.w, seed, stretch, squish, inv_norm, grads);
    v[2] = noise_at(b.x, b.y, seed, stretch, squish, inv_norm, grads);
    v[3] = noise_at(b.z, b.w, seed, stretch, squish, inv_norm, grads);
    *reinterpret_cast<float4*>(o + i0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < kPerThread && i0 + j < p; ++j)
      o[i0 + j] = noise_at(cp[2 * (i0 + j)], cp[2 * (i0 + j) + 1], seed,
                           stretch, squish, inv_norm, grads);
  }
}

}  // namespace

extern "C" int crafter_noise2(const float* pts, const int32_t* seeds,
                              float* out, long long n, float stretch,
                              float squish, float inv_norm, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  noise2_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      pts, seeds, out, n, stretch, squish, inv_norm);
  return (int)cudaGetLastError();
}

extern "C" int crafter_noise2_shared(const float* pts, const int32_t* seeds,
                                     float* out, int rows, int n_ch, int p,
                                     float stretch, float squish,
                                     float inv_norm, void* stream) {
  if (rows <= 0 || p <= 0) return 0;
  const int per_block = kSharedThreads * kPerThread;
  if (n_ch <= 0 || (p + per_block - 1) / per_block > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(rows, (p + per_block - 1) / per_block);
  noise2_shared_kernel<<<grid, kSharedThreads, 0, (cudaStream_t)stream>>>(
      pts, seeds, out, n_ch, p, stretch, squish, inv_norm);
  return (int)cudaGetLastError();
}

extern "C" const char* crafter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
