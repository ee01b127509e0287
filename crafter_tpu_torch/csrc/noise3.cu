// 3-D candidate-sum gradient noise, one thread per point.
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
// per-point seed) and writes 4, and does 26 candidates of ~22 float and ~30
// integer operations: ~80 operations a byte against the card's ~20 (67
// T op/s over 3.35 TB/s).  Design: one coalesced pass with no shared
// memory and no divergence beyond the bounds check; the candidate loop is
// fully unrolled over a table in constant memory (uniform loads, the
// per-candidate choice a select); the TPU kernel's (256, 128) padding is
// that machine's layout and has no counterpart here.
#include "common.cuh"

namespace {

struct Cand { int x, y, z, dz2_shared; };

// crafter_tpu_torch/ops/noise.py: CANDIDATES and DZ2_SHARED.
__constant__ Cand kCand[26] = {
    {-1, 0, 1, 0}, {-1, 1, 0, 1}, {-1, 1, 1, 1}, {0, -1, 1, 0},
    {0, 0, 0, 1},  {0, 0, 1, 1},  {0, 0, 2, 0},  {0, 1, -1, 0},
    {0, 1, 0, 0},  {0, 1, 1, 0},  {0, 1, 2, 0},  {0, 2, 0, 0},
    {0, 2, 1, 0},  {1, -1, 0, 1}, {1, -1, 1, 1}, {1, 0, -1, 0},
    {1, 0, 0, 0},  {1, 0, 1, 0},  {1, 0, 2, 0},  {1, 1, -1, 0},
    {1, 1, 0, 0},  {1, 1, 1, 0},  {1, 2, 0, 0},  {2, 0, 0, 0},
    {2, 0, 1, 0},  {2, 1, 0, 0}};

__global__ void noise3_kernel(const float* __restrict__ pts,
                              const int32_t* __restrict__ seeds,
                              int32_t seed_all, float* __restrict__ out,
                              long long n, float stretch, float squish,
                              float inv_norm) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
  const uint32_t seed = (uint32_t)(seeds != nullptr ? seeds[i] : seed_all);
  const float nudge = 1.0f / 8192.0f;
  const float st = ((px + py) + pz) * stretch;
  const int xb = (int)floorf((px + st) + nudge);
  const int yb = (int)floorf((py + st) + nudge);
  const int zb = (int)floorf((pz + st) + nudge);
  float total = 0.0f, w0 = 0.0f, g0 = 0.0f;
#pragma unroll
  for (int k = 0; k < 26; ++k) {
    const int vx = xb + kCand[k].x, vy = yb + kCand[k].y, vz = zb + kCand[k].z;
    const float sq = (float)(vx + vy + vz) * squish;
    const float dx = px - ((float)vx + sq);
    const float dy = py - ((float)vy + sq);
    const float dz = pz - ((float)vz + sq);
    float attn = fmaf(-dy, dy, fmaf(-dx, dx, 2.0f));
    attn = kCand[k].dz2_shared ? attn - dz * dz : fmaf(-dz, dz, attn);
    attn = fmaxf(attn, 0.0f);
    const float a2 = attn * attn;
    uint32_t hu = ((uint32_t)vx * 0x8DA6B343u) ^ ((uint32_t)vy * 0xD82DF3C1u)
                  ^ ((uint32_t)vz * 0xCB08A31Fu) ^ seed;
    hu *= 0x27D4EB2Fu;
    int32_t hs = (int32_t)hu;
    hs ^= hs >> 15;  // arithmetic shift, as the JAX hash
    const uint32_t h = ((uint32_t)hs & 0x7FFFFFFFu) % 24u;
    const uint32_t axis = h >> 3;
    const int s0 = 1 - 2 * (int)(h & 1u);
    const int s1 = 1 - 2 * (int)((h >> 1) & 1u);
    const int s2 = 1 - 2 * (int)((h >> 2) & 1u);
    const float gx = (float)((axis == 0 ? 11 : 4) * s0);
    const float gy = (float)((axis == 1 ? 11 : 4) * s1);
    const float gz = (float)((axis == 2 ? 11 : 4) * s2);
    const float grad = fmaf(gz, dz, fmaf(gx, dx, gy * dy));
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
  out[i] = total * inv_norm;
}

}  // namespace

// `seeds` may be null: every point then takes `seed_all`.
extern "C" int crafter_noise3(const float* pts, const int32_t* seeds,
                              int seed_all, float* out, long long n,
                              float stretch, float squish, float inv_norm,
                              void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  noise3_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      pts, seeds, (int32_t)seed_all, out, n, stretch, squish, inv_norm);
  return (int)cudaGetLastError();
}
