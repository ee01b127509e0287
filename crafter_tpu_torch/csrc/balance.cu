// Group-end chunk balancing (env.py:141-179): despawn then spawn picks for
// zombie / skeleton / cow over the chunks of each env, one block per env.
//
// Replaces the TPU kernel crafter_tpu/step.py:_balance_pallas (kernel
// :1146 over _balance_core :935).  Its plain twin is
// crafter_tpu_torch/step.py:balance_plain; the two agree bit for bit.
//
// Bound on the H100: bytes.  Each cell is read once (material, type,
// health, aux, occupancy: 6 bytes) and written once (type, health, aux:
// 4 bytes): 4096 envs x 4096 cells x 10 B = 167.8 MB, 0.050 ms at
// 3.35 TB/s; the chunk logic is a few hundred operations an env.
//
// Design.  A thread takes a segment of 16 cells of one column (cells
// y = 16j .. 16j + 15 of column x, consecutive in the x-major layout
// c = x * h + y): at 64x64, 256 threads and one segment each.  Where
// h % 16 == 0 and the planes are 16-byte aligned, a segment is one 16-byte
// load of each byte plane (two of aux) and its copy-through one store of
// each output; otherwise (the generic path) it is byte by byte.  The
// thread turns its segment into 16-bit member masks, one bit a cell, for
// seven members (zombie, skeleton, cow by type; grass, path by material;
// any entity; occupancy) and keeps them in shared memory, one word per
// (member, segment): 3.5 KB at 64x64.
//   * Counts: one thread per (member, chunk) adds popc(mask & the chunk's
//     rows) over the chunk's columns; a chunk's rows (at most 16, as the
//     configuration check keeps them) lie in one or two segments of a
//     column, read as one 32-bit word.  No atomics, no division a cell.
//   * Picks: one thread per (pick, chunk) draws its gate and its rank r
//     and, if the pick is wanted, walks the chunk's columns subtracting
//     each column's popc until the r-th member lies in it, then finds the
//     bit: x-major order, the order in which _balance_core's segmented
//     prefix counts number the members.  At most csx column words instead
//     of a scan of up to csx * csy cells.
//   * Apply: one thread per chunk applies its despawns, then its spawns
//     onto cells still empty, as single-byte stores over the copy-through
//     (ordered after it by the block's barriers), and writes touched as
//     touched_in | occupancy | (entities - despawns + spawns > 0), from
//     the counts: no second pass over the cells.
// The light is computed from the env's step on the card with the exact
// float32 cosine (common.cuh: daylight32), so the wrapper launches no
// daylight ops.  Member counts are bytes: the 8-bit limit of the JAX
// packing (config.py) bounds a chunk at 255 cells, so they fit.
#include "common.cuh"

namespace {

using crafter::fmix;
using crafter::u24;

constexpr int kThreads = 256;
constexpr int kMembers = 7;   // zombie, skeleton, cow, grass, path, any, occ
constexpr int kAny = 5, kOcc = 6;
constexpr int kPicks = 6;     // 3 despawn, 3 spawn
constexpr int E_COW = 2, E_ZOMBIE = 3, E_SKELETON = 4;
constexpr int MAT_GRASS = 2, MAT_PATH = 4;
__device__ __constant__ int kClass[3] = {E_ZOMBIE, E_SKELETON, E_COW};
__device__ __constant__ int kSpan[3] = {6, 7, 5};
__device__ __constant__ int kDespan[3] = {0, 7, 5};
__device__ __constant__ float kSpawnP[3] = {0.3f, 0.1f, 0.01f};
__device__ __constant__ float kDespawnP[3] = {0.4f, 0.1f, 0.1f};
__device__ __constant__ int kPickMem[kPicks] = {0, 1, 2, 3, 4, 3};
__device__ __constant__ int kTypeHealth[7] = {0, 0, 3, 5, 3, 0, 1};

__device__ __forceinline__ float gate(uint32_t seed, int j) {
  return u24(fmix(fmix(seed + 0x27D4EB2Fu * (uint32_t)j)));
}

// Bits 0..3: which bytes of w equal v (v < 128).
__device__ __forceinline__ uint32_t eq4(uint32_t w, uint32_t v) {
  const uint32_t t = w ^ (v * 0x01010101u);
  // 0x80 in each zero byte of t, exactly (no borrow between bytes).
  const uint32_t z = ~(((t & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | t | 0x7F7F7F7Fu);
  return ((z >> 7) * 0x01020408u) >> 24;
}

// Bits 0..3: which bytes of w are nonzero.
__device__ __forceinline__ uint32_t nz4(uint32_t w) {
  const uint32_t z = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return ((z >> 7) * 0x01020408u) >> 24;
}

// A chunk's rows [y0, y1) as a 32-bit mask over the two segments j0, j0+1
// of a column (bit b is row 16 * j0 + b).
struct Rows {
  int j0;
  bool two;
  uint32_t mask;
};

__device__ __forceinline__ Rows chunk_rows(int cy, int csy, int h) {
  const int y0 = cy * csy, y1 = min(y0 + csy, h);
  const int sh = y0 & 15, len = y1 - y0;
  return {y0 >> 4, sh + len > 16, ((1u << len) - 1u) << sh};
}

__device__ __forceinline__ uint32_t col_word(const uint16_t* plane, int base,
                                             const Rows& r) {
  uint32_t v = plane[base + r.j0];
  if (r.two) v |= (uint32_t)plane[base + r.j0 + 1] << 16;
  return v & r.mask;
}

struct Args {
  const uint8_t *mat, *et, *hp;
  const int16_t* aux;
  const uint8_t *occ, *touched_in;   // occ may be null
  const int32_t *step, *pos, *seeds;
  long long step_stride, pos_stride0, pos_stride1, seed_stride;
  uint8_t *et_out, *hp_out;
  int16_t* aux_out;
  uint8_t* touched_out;
  int w, h, csx, csy, ncx, ncy, vec;
  float inv_day;
};

__global__ void __launch_bounds__(kThreads) balance_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char crafter_smem[];
  const int env = blockIdx.x;
  const int w = a.w, h = a.h, C = w * h;
  const int nseg = (h + 15) >> 4, S = w * nseg;
  const int ncy = a.ncy, nch = a.ncx * ncy;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* light = reinterpret_cast<float*>(crafter_smem);
  int* pick = reinterpret_cast<int*>(crafter_smem + 16);    // [kPicks][nch]
  uint16_t* planes = reinterpret_cast<uint16_t*>(pick + kPicks * nch);
  uint8_t* cnt = reinterpret_cast<uint8_t*>(planes + kMembers * S);
  const size_t off = (size_t)env * C;

  if (tid == 0)
    *light = crafter::daylight32(a.step[env * a.step_stride], a.inv_day);

  // Copy through and build the member masks, a segment a thread.
  for (int s = tid; s < S; s += nt) {
    uint32_t m[kMembers];
    if (a.vec) {
      const size_t c0 = off + (size_t)s * 16;
      const uint4 mv = *reinterpret_cast<const uint4*>(a.mat + c0);
      const uint4 ev = *reinterpret_cast<const uint4*>(a.et + c0);
      const uint4 hv = *reinterpret_cast<const uint4*>(a.hp + c0);
      const uint4 a0 = *reinterpret_cast<const uint4*>(a.aux + c0);
      const uint4 a1 = *reinterpret_cast<const uint4*>(a.aux + c0 + 8);
      const uint4 ov = a.occ ? *reinterpret_cast<const uint4*>(a.occ + c0)
                             : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(a.et_out + c0) = ev;
      *reinterpret_cast<uint4*>(a.hp_out + c0) = hv;
      *reinterpret_cast<uint4*>(a.aux_out + c0) = a0;
      *reinterpret_cast<uint4*>(a.aux_out + c0 + 8) = a1;
      const uint32_t mw[4] = {mv.x, mv.y, mv.z, mv.w};
      const uint32_t ew[4] = {ev.x, ev.y, ev.z, ev.w};
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int j = 0; j < kMembers; ++j) m[j] = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int sh = 4 * q;
        m[0] |= eq4(ew[q], E_ZOMBIE) << sh;
        m[1] |= eq4(ew[q], E_SKELETON) << sh;
        m[2] |= eq4(ew[q], E_COW) << sh;
        m[3] |= eq4(mw[q], MAT_GRASS) << sh;
        m[4] |= eq4(mw[q], MAT_PATH) << sh;
        m[kAny] |= nz4(ew[q]) << sh;
        m[kOcc] |= nz4(ow[q]) << sh;
      }
    } else {
      const int x = s / nseg, y0 = (s - x * nseg) * 16;
      const int len = min(16, h - y0);
      const size_t c0 = off + (size_t)x * h + y0;
#pragma unroll
      for (int j = 0; j < kMembers; ++j) m[j] = 0;
      for (int b = 0; b < len; ++b) {
        const int mt = a.mat[c0 + b], e = a.et[c0 + b];
        const bool o = a.occ && a.occ[c0 + b];
        a.et_out[c0 + b] = (uint8_t)e;
        a.hp_out[c0 + b] = a.hp[c0 + b];
        a.aux_out[c0 + b] = a.aux[c0 + b];
        m[0] |= (uint32_t)(e == E_ZOMBIE) << b;
        m[1] |= (uint32_t)(e == E_SKELETON) << b;
        m[2] |= (uint32_t)(e == E_COW) << b;
        m[3] |= (uint32_t)(mt == MAT_GRASS) << b;
        m[4] |= (uint32_t)(mt == MAT_PATH) << b;
        m[kAny] |= (uint32_t)(e != 0) << b;
        m[kOcc] |= (uint32_t)o << b;
      }
    }
#pragma unroll
    for (int j = 0; j < kMembers; ++j) planes[j * S + s] = (uint16_t)m[j];
  }
  __syncthreads();

  // Member counts per chunk: popc over the chunk's column words.
  for (int p = tid; p < kMembers * nch; p += nt) {
    const int j = p / nch, k = p - j * nch;
    const int cx = k / ncy, cy = k - cx * ncy;
    const Rows r = chunk_rows(cy, a.csy, h);
    const int x0 = cx * a.csx, x1 = min(x0 + a.csx, w);
    const uint16_t* plane = planes + j * S;
    int n = 0;
    for (int x = x0; x < x1; ++x) n += __popc(col_word(plane, x * nseg, r));
    cnt[p] = (uint8_t)n;
  }
  __syncthreads();

  // Picks: gate, rank, and the r-th member of the chunk in x-major order.
  const uint32_t seed = (uint32_t)a.seeds[env * a.seed_stride];
  for (int p = tid; p < kPicks * nch; p += nt) {
    const int j = p / nch, k = p - j * nch;
    const int i = j < 3 ? j : j - 3;
    const float L = *light;
    const float dark = fmaf(-3.0f, L, 3.5f);  // 3.5 - 3 * light, fused
    const int grass = cnt[3 * nch + k], path = cnt[4 * nch + k];
    const int tmin = i == 0 ? (grass < 50 ? 0 : (int)dark)
                   : i == 1 ? (path < 6 ? 0 : 1) : (grass < 30 ? 0 : 1);
    const int tmax = i == 0 ? (int)dark : i == 1 ? 2 : (int)(1.5f + L);
    const bool touched = a.touched_in[(size_t)env * nch + k] ||
                         cnt[kOcc * nch + k] > 0;
    const int n_i = cnt[i * nch + k];
    const bool ws = touched && n_i < tmin &&
                    gate(seed, k * 6 + i * 2 + 1) < kSpawnP[i];
    const bool want =
        j >= 3 ? ws
               : touched && !ws && n_i > tmax &&
                     gate(seed, k * 6 + i * 2 + 2) < kDespawnP[i];
    const int mem = kPickMem[j];
    const int n_m = cnt[mem * nch + k];
    const float u = gate(seed, 6 * nch + 1 + k * 6 + j);
    int r = (int)fminf(floorf(u * (float)n_m), (float)(n_m - 1));
    int found = -1;
    if (want && r >= 0) {
      const int cx = k / ncy, cy = k - cx * ncy;
      const Rows rows = chunk_rows(cy, a.csy, h);
      const uint16_t* plane = planes + mem * S;
      for (int x = cx * a.csx; found < 0; ++x) {
        uint32_t v = col_word(plane, x * nseg, rows);
        const int c = __popc(v);
        if (r < c) {
          for (; r > 0; --r) v &= v - 1u;
          found = (x << 16) | (rows.j0 * 16 + __ffs(v) - 1);
        } else {
          r -= c;
        }
      }
    }
    pick[p] = found;
  }
  __syncthreads();

  // Apply per chunk (picks of a chunk lie in it): despawns, then spawns in
  // class order onto cells still empty; then touched.
  const int px = a.pos[env * a.pos_stride0];
  const int py = a.pos[env * a.pos_stride0 + a.pos_stride1];
  const uint16_t* any = planes + kAny * S;
  for (int k = tid; k < nch; k += nt) {
    int gone[3], made[3], nd = 0, ns = 0;
    for (int i = 0; i < 3; ++i) {
      const int q = pick[i * nch + k];
      if (q < 0) continue;
      const int x = q >> 16, y = q & 0xFFFF;
      // A despawn pick is a zombie / skeleton / cow: its type > player.
      if (abs(x - px) + abs(y - py) >= kDespan[i]) {
        const int c = x * h + y;
        a.et_out[off + c] = 0;
        gone[nd++] = c;
      }
    }
    for (int i = 0; i < 3; ++i) {
      const int q = pick[(3 + i) * nch + k];
      if (q < 0) continue;
      const int x = q >> 16, y = q & 0xFFFF;
      if (abs(x - px) + abs(y - py) < kSpan[i]) continue;
      const int c = x * h + y;
      bool full = (any[x * nseg + (y >> 4)] >> (y & 15)) & 1u;
      for (int d = 0; d < nd; ++d) full = full && gone[d] != c;
      for (int d = 0; d < ns; ++d) full = full || made[d] == c;
      if (full) continue;
      a.et_out[off + c] = (uint8_t)kClass[i];
      a.hp_out[off + c] = (uint8_t)kTypeHealth[kClass[i]];
      a.aux_out[off + c] = 0;
      made[ns++] = c;
    }
    const size_t t = (size_t)env * nch + k;
    a.touched_out[t] = a.touched_in[t] || cnt[kOcc * nch + k] > 0 ||
                       (int)cnt[kAny * nch + k] - nd + ns > 0;
  }
}

size_t smem_bytes(int w, int h, int nch) {
  const size_t S = (size_t)w * ((h + 15) / 16);
  return 16 + (size_t)kPicks * nch * sizeof(int) + kMembers * S * 2 +
         (size_t)kMembers * nch;
}

// Shared memory above the default 48 KB needs the attribute before a
// launch (tiny chunks on large worlds); set once per size reached.
cudaError_t prepare(size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      balance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

}  // namespace

extern "C" int crafter_balance_occupancy(int w, int h, int nch, int* blocks,
                                         int* smem_out) {
  const size_t smem = smem_bytes(w, h, nch);
  *smem_out = (int)smem;
  cudaError_t err = prepare(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, balance_kernel,
                                                        kThreads, smem);
  return (int)err;
}

extern "C" int crafter_balance(
    const uint8_t* mat, const uint8_t* et, const uint8_t* hp,
    const int16_t* aux, const uint8_t* occ, const uint8_t* touched_in,
    const int32_t* step, long long step_stride, const int32_t* pos,
    long long pos_stride0, long long pos_stride1, const int32_t* seeds,
    long long seed_stride, uint8_t* et_out, uint8_t* hp_out,
    int16_t* aux_out, uint8_t* touched_out, int n, int w, int h, int csx,
    int csy, int ncx, int ncy, int vec, float inv_day, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = smem_bytes(w, h, ncx * ncy);
  const cudaError_t err = prepare(smem);
  if (err != cudaSuccess) return (int)err;
  const Args args{mat,         et,          hp,          aux,
                  occ,         touched_in,  step,        pos,
                  seeds,       step_stride, pos_stride0, pos_stride1,
                  seed_stride, et_out,      hp_out,      aux_out,
                  touched_out, w,           h,           csx,
                  csy,         ncx,         ncy,         vec,
                  inv_day};
  balance_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
