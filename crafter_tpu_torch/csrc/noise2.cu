// 2-D candidate-sum gradient noise, one thread per point.
//
// Replaces the TPU kernel crafter_tpu/ops/noise_pallas.py:noise2_pallas
// (_noise2_kernel).  Computes the plain twin crafter_tpu_torch/ops/noise.py:
// noise2_fast bit for bit: the float ops are in the same order, and the
// file is built with -fmad=false, so the only fused multiply-adds are the
// explicit fmaf calls, placed where XLA's CPU backend fuses the reference.
//
// Bound on the H100: bytes, narrowly.  Each point reads 12 bytes and
// writes 4 and does ~134 float32 operations (8 candidates of ~16), about
// 8 operations a byte against the card's ~20 (67 TFLOP/s over 3.35 TB/s);
// the ~100 integer hash operations a point come close to that line too.
// Design: one coalesced pass, no shared memory, no divergence beyond the
// bounds check, the candidate loop unrolled over constant offsets.
#include "common.cuh"

namespace {

__constant__ int kCandX[8] = {-1, 0, 0, 0, 1, 1, 1, 2};
__constant__ int kCandY[8] = {1, 0, 1, 2, -1, 0, 1, 0};

__global__ void noise2_kernel(const float* __restrict__ pts,
                              const int32_t* __restrict__ seeds,
                              float* __restrict__ out, long long n,
                              float stretch, float squish, float inv_norm) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = pts[2 * i], py = pts[2 * i + 1];
  const uint32_t seed = (uint32_t)seeds[i];
  const float nudge = 1.0f / 8192.0f;
  const float st = (px + py) * stretch;
  const int xb = (int)floorf((px + st) + nudge);
  const int yb = (int)floorf((py + st) + nudge);
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int vx = xb + kCandX[k], vy = yb + kCandY[k];
    const float sq = (float)(vx + vy) * squish;
    const float dx = px - ((float)vx + sq);
    const float dy = py - ((float)vy + sq);
    const float attn = fmaxf(fmaf(-dy, dy, fmaf(-dx, dx, 2.0f)), 0.0f);
    const float a2 = attn * attn;
    uint32_t hu = ((uint32_t)vx * 0x8DA6B343u) ^ ((uint32_t)vy * 0xD82DF3C1u)
                  ^ seed;
    hu *= 0x27D4EB2Fu;
    int32_t h = (int32_t)hu;
    h ^= h >> 15;  // arithmetic shift, as the JAX hash
    const int s0 = 1 - 2 * (h & 1);
    const int s1 = 1 - 2 * ((h >> 1) & 1);
    const bool long_x = ((h >> 2) & 1) != 0;
    const float gx = (float)((long_x ? 5 : 2) * s0);
    const float gy = (float)((long_x ? 2 : 5) * s1);
    const float grad = fmaf(gx, dx, gy * dy);
    total = fmaf(a2 * a2, grad, total);
  }
  out[i] = total * inv_norm;
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

extern "C" const char* crafter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
