// The permutation-table OpenSimplex 3-D noise of the 'compat' worldgen: the
// candidate sum of crafter_tpu_torch/ops/noise.py:noise3_total at one point
// set shared by every world, with a permutation table a world, in one
// launch.
//
// Replaces no TPU kernel: the JAX package runs this noise as jnp ops
// (crafter_tpu/ops/noise.py:noise3 in a lax.scan), with no Pallas kernel
// behind it.  It was added because the eager twin is ~210 ms of a ~213 ms
// group of 4096 envs on the H100 in the compat mode: thousands of
// elementwise launches a reset pass, its fused multiply-adds emulated in
// float64, each streaming a (worlds, points) tensor.
//
// Computes the twin bit for bit: the float ops are in the twin's order,
// and the file is built with -fmad=false, so the only fused multiply-adds
// are the explicit fmaf calls, one where the twin calls fma32 (the stretch,
// the attenuation's three squares, the gradient dot's two terms and each
// term of the sum, which starts at 0.0f and takes the candidates in the
// order of ops/noise.py:CANDIDATES).  No candidate is skipped where its
// weight is 0, so zeros keep the twin's sign.
//
// Bound on the H100: operations, and in practice shared-memory lookups.
// Everything but the gradient is a function of the point alone (the
// lattice cell, the squish, the offsets and the weight, ~750 operations a
// point); what the table decides is, for each (point, world, candidate),
// three lookups (perm[perm[x] + y], then the gradient of entry +z) and
// four float operations (gy * dy and three fused multiply-adds).  At 320
// worlds of 53,248 points that is 443 M triples, ~4.5 G operations (0.067
// ms at 67 T op/s, chip_smoke.py's bound); but the three lookups are four
// shared-memory wavefronts of a warp (the gradient word is 8 bytes), and
// an SM serves one a clock: ~0.21 ms at 1.98 GHz.
//
// Design.  A block takes 256 consecutive points (one a thread, so a warp
// reads neighbouring lattice cells: its lookups mostly share addresses)
// and a tile of kTile worlds.  The tile's tables are staged once in shared
// memory: each world's 256 perm bytes and, per entry, its gradient
// GRAD3[perm % 24] as one 8-byte word (x and y as the high halves of their
// float bits, exact for +-4 and +-11, and z as float bits); both tables
// are doubled, entry k + 256 equal to entry k, so that a table value plus
// a coordinate's low byte indexes them with no mask.  A thread computes a
// candidate's geometry once and walks its worlds, with a float32 sum a
// world in registers; the stores are coalesced along the points.  A tile
// past the last world repeats the last table and stores nothing there.
#include "common.cuh"

namespace {

// Worlds a block, chosen by measurement on the H100 at 320 worlds: 8 took
// 0.297 ms, 12 0.298, 16 0.338 and 24 0.502 (74, 80, 102 and 147
// registers).  Its tables, 36,864 bytes, fit the default shared memory.
constexpr int kTile = 8;
constexpr int kThreads = 256;

// float32 constants of ops/noise.py: F32_STRETCH_3D, F32_SQUISH_3D, NUDGE.
constexpr float kStretch = -0x1.555556p-3f;
constexpr float kSquish = 0x1.555556p-2f;
constexpr float kNudge = 0x1p-13f;

// ops/noise.py:GRAD3.
__constant__ float kGrad3[24][3] = {
    {-11, 4, 4},  {-4, 11, 4},  {-4, 4, 11},   {11, 4, 4},   {4, 11, 4},
    {4, 4, 11},   {-11, -4, 4}, {-4, -11, 4},  {-4, -4, 11}, {11, -4, 4},
    {4, -11, 4},  {4, -4, 11},  {-11, 4, -4},  {-4, 11, -4}, {-4, 4, -11},
    {11, 4, -4},  {4, 11, -4},  {4, 4, -11},   {-11, -4, -4},
    {-4, -11, -4}, {-4, -4, -11}, {11, -4, -4}, {4, -11, -4}, {4, -4, -11}};

// One world's tables, each doubled.
struct World {
  uint2 grad[512];
  uint8_t perm[512];
};

__global__ void __launch_bounds__(kThreads) noise3_perm_kernel(
    const float* __restrict__ pts, long long n_pts,
    const int32_t* __restrict__ perm, int n_rows, float* __restrict__ out) {
  __shared__ World worlds[kTile];
  const int r0 = blockIdx.y * kTile;
  for (int i = threadIdx.x; i < kTile * 256; i += kThreads) {
    const int j = i >> 8, k = i & 255;
    const int v = perm[(long long)min(r0 + j, n_rows - 1) * 256 + k] & 255;
    const float* g = kGrad3[v % 24];
    const uint2 word = make_uint2(
        (__float_as_uint(g[0]) & 0xFFFF0000u) | (__float_as_uint(g[1]) >> 16),
        __float_as_uint(g[2]));
    worlds[j].perm[k] = worlds[j].perm[k + 256] = (uint8_t)v;
    worlds[j].grad[k] = worlds[j].grad[k + 256] = word;
  }
  __syncthreads();
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_pts) return;

  // ops/noise.py:CANDIDATES.
  constexpr int cxs[26] = {-1, -1, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                           1,  1,  1,  1, 1, 1, 1, 1, 1, 1, 2, 2, 2};
  constexpr int cys[26] = {0, 1, 1, -1, 0, 0, 0, 1, 1, 1, 1, 2, 2,
                           -1, -1, 0, 0, 0, 0, 1, 1, 1, 2, 0, 0, 1};
  constexpr int czs[26] = {1, 0, 1, 1, 0, 1, 2, -1, 0, 1, 2, 0, 1,
                           0, 1, -1, 0, 1, 2, -1, 0, 1, 0, 0, 1, 0};
  const float px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
  const float sum = (px + py) + pz;
  // Integer lattice arithmetic in uint32: the twin's int32 wraps.
  const uint32_t xb = (uint32_t)(int)floorf(fmaf(sum, kStretch, px) + kNudge);
  const uint32_t yb = (uint32_t)(int)floorf(fmaf(sum, kStretch, py) + kNudge);
  const uint32_t zb = (uint32_t)(int)floorf(fmaf(sum, kStretch, pz) + kNudge);
  float total[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) total[j] = 0.0f;
#pragma unroll
  for (int c = 0; c < 26; ++c) {
    const uint32_t vx = xb + cxs[c], vy = yb + cys[c], vz = zb + czs[c];
    const float s = (float)(int32_t)((vx + vy) + vz) * kSquish;
    const float dx = px - ((float)(int32_t)vx + s);
    const float dy = py - ((float)(int32_t)vy + s);
    const float dz = pz - ((float)(int32_t)vz + s);
    const float attn =
        fmaxf(fmaf(-dz, dz, fmaf(-dy, dy, fmaf(-dx, dx, 2.0f))), 0.0f);
    const float a2 = attn * attn;
    const float w = a2 * a2;
    const int ix = vx & 255, iy = vy & 255, iz = vz & 255;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const World& t = worlds[j];
      const uint2 g = t.grad[t.perm[t.perm[ix] + iy] + iz];
      const float gx = __uint_as_float(g.x & 0xFFFF0000u);
      const float gy = __uint_as_float(g.x << 16);
      const float gz = __uint_as_float(g.y);
      total[j] = fmaf(w, fmaf(gz, dz, fmaf(gx, dx, gy * dy)), total[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kTile; ++j)
    if (r0 + j < n_rows) out[(long long)(r0 + j) * n_pts + p] = total[j];
}

}  // namespace

// points (P, 3) float32, perm (R, 256) int32 holding 0..255, out (R, P)
// float32: the un-normalised candidate sum.
extern "C" int crafter_noise3_perm(const float* points, long long n_pts,
                                   const int32_t* perm, int n_rows,
                                   float* out, void* stream) {
  if (n_pts <= 0 || n_rows <= 0) return 0;
  const long long blocks = (n_pts + kThreads - 1) / kThreads;
  const int tiles = (n_rows + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFFLL || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  noise3_perm_kernel<<<dim3((unsigned)blocks, tiles), kThreads, 0,
                       (cudaStream_t)stream>>>(points, n_pts, perm, n_rows,
                                               out);
  return (int)cudaGetLastError();
}
