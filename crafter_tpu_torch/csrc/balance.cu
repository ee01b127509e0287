// Group-end chunk balancing (env.py:141-179): despawn then spawn picks for
// zombie / skeleton / cow over the chunks of each env, one block per env.
//
// Replaces the TPU kernel crafter_tpu/step.py:_balance_pallas (kernel
// :1146 over _balance_core :935).  Its plain twin is
// crafter_tpu_torch/step.py:balance_plain; the two agree bit for bit.
//
// Bound on the H100: bytes.  Each cell is read once (material, type,
// health, aux, occupancy: 6 bytes) and written once (type, health, aux:
// 4 bytes); the chunk logic is a few hundred operations an env.
// Design: per-chunk member counts by shared-memory atomics in one pass over
// the env's cells (which also copies the planes through), the per-chunk
// gate and draw arithmetic on one thread per chunk, and each pick as a
// scan of its chunk in x-major cell order counting members until the r-th
// — the order in which the JAX kernel's segmented prefix counts number
// them.  Member counts are plain ints: the 8-bit limit of the JAX packing
// (config.py) is kept by the configuration check, not by packing here.
#include "common.cuh"

namespace {

using crafter::fmix;
using crafter::u24;

constexpr int kThreads = 256;
constexpr int kMembers = 5;   // zombie, skeleton, cow (type), grass, path
constexpr int kPicks = 6;     // 3 despawn, 3 spawn
constexpr int E_PLAYER = 1, E_COW = 2, E_ZOMBIE = 3, E_SKELETON = 4;
constexpr int MAT_GRASS = 2, MAT_PATH = 4;
__device__ __constant__ int kClass[3] = {E_ZOMBIE, E_SKELETON, E_COW};
__device__ __constant__ int kSpan[3] = {6, 7, 5};
__device__ __constant__ int kDespan[3] = {0, 7, 5};
__device__ __constant__ float kSpawnP[3] = {0.3f, 0.1f, 0.01f};
__device__ __constant__ float kDespawnP[3] = {0.4f, 0.1f, 0.1f};
__device__ __constant__ int kPickMem[kPicks] = {0, 1, 2, 3, 4, 3};
__device__ __constant__ int kTypeHealth[7] = {0, 0, 3, 5, 3, 0, 1};

__device__ __forceinline__ bool is_member(int m, int mat, int et) {
  return m < 3 ? et == kClass[m] : mat == (m == 4 ? MAT_PATH : MAT_GRASS);
}

__device__ __forceinline__ float gate(uint32_t seed, int j) {
  return u24(fmix(fmix(seed + 0x27D4EB2Fu * (uint32_t)j)));
}

__global__ void __launch_bounds__(kThreads) balance_kernel(
    const uint8_t* __restrict__ mat, const uint8_t* __restrict__ et,
    const uint8_t* __restrict__ hp, const int16_t* __restrict__ aux,
    const uint8_t* __restrict__ occ, const uint8_t* __restrict__ touched_in,
    const float* __restrict__ light, const int32_t* __restrict__ pxs,
    const int32_t* __restrict__ pys, const int32_t* __restrict__ seeds,
    uint8_t* __restrict__ et_out, uint8_t* __restrict__ hp_out,
    int16_t* __restrict__ aux_out, uint8_t* __restrict__ touched_out, int w,
    int h, int csx, int csy, int ncx, int ncy) {
  extern __shared__ __align__(16) unsigned char crafter_smem[];
  const int env = blockIdx.x;
  const int C = w * h, nch = ncx * ncy;
  const int tid = threadIdx.x, nt = blockDim.x;
  int* cnt = reinterpret_cast<int*>(crafter_smem);   // [kMembers][nch]
  int* touched = cnt + kMembers * nch;                // [nch]
  int* want = touched + nch;                          // [nch] pick bits
  int* rdraw = want + nch;                            // [kPicks][nch]
  int* pick = rdraw + kPicks * nch;                   // [kPicks][nch]
  uint8_t* M = reinterpret_cast<uint8_t*>(pick + kPicks * nch);
  uint8_t* T = M + C;
  const size_t off = (size_t)env * C;

  for (int i = tid; i < kMembers * nch; i += nt) cnt[i] = 0;
  for (int i = tid; i < nch; i += nt) touched[i] = touched_in[(size_t)env * nch + i];
  __syncthreads();

  // Copy through, count chunk members, fold the group's occupancy into
  // touched.
  for (int c = tid; c < C; c += nt) {
    const int m = mat[off + c], e = et[off + c];
    M[c] = (uint8_t)m;
    T[c] = (uint8_t)e;
    et_out[off + c] = (uint8_t)e;
    hp_out[off + c] = hp[off + c];
    aux_out[off + c] = aux[off + c];
    const int x = c / h, y = c - x * h;
    const int ch = (x / csx) * ncy + y / csy;
    if (occ[off + c]) touched[ch] = 1;
    for (int j = 0; j < kMembers; ++j)
      if (is_member(j, m, e)) atomicAdd(&cnt[j * nch + ch], 1);
  }
  __syncthreads();

  // Per chunk: spawn / despawn wants and the member index of each pick.
  const uint32_t seed = (uint32_t)seeds[env];
  for (int k = tid; k < nch; k += nt) {
    const float L = light[env];
    const float dark = fmaf(-3.0f, L, 3.5f);  // 3.5 - 3 * light, fused
    const int grass = cnt[3 * nch + k], path = cnt[4 * nch + k];
    const int tmin[3] = {grass < 50 ? 0 : (int)dark, path < 6 ? 0 : 1,
                         grass < 30 ? 0 : 1};
    const int tmax[3] = {(int)dark, 2, (int)(1.5f + L)};
    int bits = 0;
    for (int i = 0; i < 3; ++i) {
      const int n_i = cnt[i * nch + k];
      const bool ws = touched[k] && n_i < tmin[i] &&
                      gate(seed, k * 6 + i * 2 + 1) < kSpawnP[i];
      const bool wd = touched[k] && !ws && n_i > tmax[i] &&
                      gate(seed, k * 6 + i * 2 + 2) < kDespawnP[i];
      bits |= (wd ? 1 << i : 0) | (ws ? 1 << (3 + i) : 0);
    }
    want[k] = bits;
    for (int j = 0; j < kPicks; ++j) {
      const int n_m = cnt[kPickMem[j] * nch + k];
      const float u = gate(seed, 6 * nch + 1 + k * 6 + j);
      rdraw[j * nch + k] =
          (int)fminf(floorf(u * (float)n_m), (float)(n_m - 1));
    }
  }
  __syncthreads();

  // Each wanted pick: the r-th member of its chunk in x-major order.
  for (int p = tid; p < kPicks * nch; p += nt) {
    const int j = p / nch, k = p - j * nch;
    const int r = rdraw[p];
    int found = -1;
    if (((want[k] >> j) & 1) && r >= 0) {
      const int m = kPickMem[j];
      const int x0 = (k / ncy) * csx, y0 = (k % ncy) * csy;
      const int x1 = min(x0 + csx, w), y1 = min(y0 + csy, h);
      int seen = 0;
      for (int x = x0; x < x1 && found < 0; ++x)
        for (int y = y0; y < y1; ++y) {
          const int c = x * h + y;
          if (is_member(m, M[c], T[c]) && seen++ == r) {
            found = c;
            break;
          }
        }
    }
    pick[p] = found;
  }
  __syncthreads();

  // Apply per chunk (picks of a chunk lie in it): despawns, then spawns in
  // class order onto cells still empty.
  const int px = pxs[env], py = pys[env];
  for (int k = tid; k < nch; k += nt) {
    for (int i = 0; i < 3; ++i) {
      const int c = pick[i * nch + k];
      if (c < 0) continue;
      const int x = c / h, y = c - x * h;
      if (abs(x - px) + abs(y - py) >= kDespan[i] && T[c] > E_PLAYER) {
        T[c] = 0;
        et_out[off + c] = 0;
      }
    }
    for (int i = 0; i < 3; ++i) {
      const int c = pick[(3 + i) * nch + k];
      if (c < 0) continue;
      const int x = c / h, y = c - x * h;
      if (abs(x - px) + abs(y - py) >= kSpan[i] && T[c] == 0) {
        T[c] = (uint8_t)kClass[i];
        et_out[off + c] = (uint8_t)kClass[i];
        hp_out[off + c] = (uint8_t)kTypeHealth[kClass[i]];
        aux_out[off + c] = 0;
      }
    }
  }
  __syncthreads();

  for (int c = tid; c < C; c += nt) {
    if (T[c] > 0) {
      const int x = c / h, y = c - x * h;
      touched[(x / csx) * ncy + y / csy] = 1;
    }
  }
  __syncthreads();
  for (int k = tid; k < nch; k += nt)
    touched_out[(size_t)env * nch + k] = touched[k] ? 1 : 0;
}

}  // namespace

extern "C" int crafter_balance(
    const uint8_t* mat, const uint8_t* et, const uint8_t* hp,
    const int16_t* aux, const uint8_t* occ, const uint8_t* touched_in,
    const float* light, const int32_t* px, const int32_t* py,
    const int32_t* seeds, uint8_t* et_out, uint8_t* hp_out,
    int16_t* aux_out, uint8_t* touched_out, int n, int w, int h, int csx,
    int csy, int ncx, int ncy, void* stream) {
  if (n <= 0) return 0;
  const int nch = ncx * ncy;
  const size_t smem = (size_t)(kMembers + 2 + 2 * kPicks) * nch * sizeof(int) +
                      2 * (size_t)w * h;
  cudaError_t err = cudaFuncSetAttribute(
      balance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  balance_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      mat, et, hp, aux, occ, touched_in, light, px, py, seeds, et_out, hp_out,
      aux_out, touched_out, w, h, csx, csy, ncx, ncy);
  return (int)cudaGetLastError();
}
