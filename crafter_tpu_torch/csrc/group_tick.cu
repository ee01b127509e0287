// The simulation tick on the card: K fused ticks of every env (the group
// kernel, with optional per-tick render snapshots) and the single tick (the
// tick kernel), one thread block per env, on shared device code.
//
// crafter_group_tick replaces the TPU kernel
// crafter_tpu/step.py:step_group_batch (kernel body :1431, pallas_call
// :1539), GroupSnaps included; its plain twin is
// crafter_tpu_torch/step.py:step_group_plain.  crafter_tick replaces
// crafter_tpu/step.py:_tick_pallas (kernel body :1268, pallas_call :1311);
// its plain twin is crafter_tpu_torch/step.py:tick_plain.  Kernels and
// twins agree bit for bit.
//
// Bound on the H100: bytes.  A group moves 6 bytes a cell in and 7 out
// (~220 MB at 4096 envs x 4096 cells, ~66 us at 3.35 TB/s), plus one byte
// a cell and tick when it writes snapshots; a single tick moves 6 in and 6
// out.  The work the function needs is small beside that: only an active
// entity (type above the player's within the update distance; 0.13% of
// cell-ticks measured at 4096 envs) needs the ~180 operations of the mob
// phase.
//
// Design.  The block keeps its env's planes in shared memory for all K
// ticks, so device memory sees one read and one write of them a group, 16
// bytes a thread per access (aux 8).  Each tick:
// * The player phase runs on warp 0: the scalar decisions on every lane
//   alike, lane j holding item j and achievement j, so the per-item loops
//   become one lane-parallel step with warp votes (req_ok, new unlocks) and
//   shuffles (single items).  The reward and unlock bookkeeping of the tick
//   follows on the same warp.
// * The mob phase runs in seven barrier-separated passes, each reading only
//   what earlier passes wrote, so the per-tick semantics of the JAX phase
//   (all mobs decide against the post-player state, movement claims
//   resolved by direction priority) hold without atomics except one sum for
//   the player's damage.  Passes visit only the update window, the cells at
//   L1 distance <= upd from the player (after its move), clipped to the
//   world: 685 cells of 4096 at upd = 18.
//
// Why nothing outside the window changes in the mob phase.  An entity is
// active only at distance < upd.  Impacts, movement claims, moves, arrow
// spawns and reloads all start from an active entity and land on it or a
// 4-neighbour of it, so at distance <= upd; zombie strikes and the pending
// plant sit at distance <= 1.  Every other cell keeps its planes, except
// that the hash bits, which only active entities use, are not computed
// there.  A window cell reads its neighbours' per-pass scratch (claims,
// hostility, shooters); a neighbour outside the window holds none of them.
// The scratch (FL, PK, B8) is therefore kept per slot of the window's
// bounding box, one row of padding on each side, zeroed once at load:
// slots outside the diamond are never written and read as "none", and a
// diamond slot is always written by a pass before the next pass reads it.
//
// The occupancy OR (occ_pre) covers the state after ticks 0..K-2.  After
// tick 0 every cell is swept once; after a later marked tick only the
// window is ORed: a cell outside it did not change in that tick, so its
// state equals the one ORed after the tick before.  The snapshot byte of
// every cell is written after each marked tick, 16 cells a thread.
//
// Shared memory at 64 x 64, upd = 18: four byte planes and the int32 aux
// plane (32 KB), the occupancy as bits, the window scratch on 39 x 37
// slots and the window's offsets: 45,104 bytes, so five blocks fit an SM.
// Aux stays int32 inside a group as in the JAX kernel: with no episode cap
// (length 0) a plant's counter may pass the int16 range inside a group,
// and the comparisons read the unwrapped value there.  The kernel is
// instantiated on the world's height: 64 (index arithmetic by shifts) and
// any height (the same code with the height at run time).
#include "common.cuh"

// Where the kernels read each field of the env records, in record order: a
// pointer, the stride between envs in elements and the element type (the
// words of one env's field are contiguous), so that the wrapper passes the
// state's own tensors (step_cuda._record_in).  A key word is the low half
// of an int64 in [0, 2**32), a flag a byte.  Outside the unnamed
// namespace: the exported launch functions take it.
enum : int { K_I32 = 0, K_U8 = 1, K_I64 = 2 };
struct RecField {
  const void* ptr;
  long long stride;
  long long kind;
};
constexpr int kFields = 14;
struct RecIn {
  RecField f[kFields];
};

namespace {

using crafter::cell_bits;
using crafter::fmix;
using crafter::u24;

// The block's geometry: threads a block (a multiple of 32 from 64 to 1024:
// the loops stride by blockDim.x and the player phase runs on warp 0) and
// the minimum resident blocks per SM that __launch_bounds__ asks for.  A
// build may set both with -D (_build.library(geometry=...)); these are the
// shipped values.
#ifndef CRAFTER_GROUP_THREADS
#define CRAFTER_GROUP_THREADS 256
#endif
#ifndef CRAFTER_GROUP_MIN_BLOCKS
#define CRAFTER_GROUP_MIN_BLOCKS 5   // resident blocks per SM at 64 x 64
#endif
constexpr int kThreads = CRAFTER_GROUP_THREADS;
constexpr int kMinBlocks = CRAFTER_GROUP_MIN_BLOCKS;
static_assert(kThreads % 32 == 0 && kThreads >= 64 && kThreads <= 1024,
              "CRAFTER_GROUP_THREADS: a multiple of 32 in [64, 1024]");
static_assert(kMinBlocks >= 1, "CRAFTER_GROUP_MIN_BLOCKS: at least 1");
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kItems = 16, kAch = 22;
constexpr int kRecScalars = 13;
constexpr int kInv = kRecScalars, kAchOff = kInv + kItems,
              kUnl = kAchOff + kAch;
constexpr int kRec = kRecScalars + kItems + 2 * kAch;  // step_cuda.REC
enum { R_FACING, R_PX, R_PY, R_SLEEP, R_HUNGER, R_THIRST, R_FATIGUE,
       R_RECOVER, R_LASTH, R_STEP, R_ELH, R_K0, R_K1 };

// Offsets of the rules blob (step_cuda._rules_blob).
constexpr int OFF_ITEM_MAX = 0, OFF_WALK_PLAYER = 16, OFF_WALK_MOB = 17,
              OFF_WALK_ARROW = 18, OFF_COLLECTIBLE = 19,
              OFF_COLLECT_REQ = 20, OFF_COLLECT_RECV = 228,
              OFF_COLLECT_LEAVES = 436, OFF_COLLECT_PROB = 449,
              OFF_COLLECT_ACH = 462, OFF_PLACE_USES = 475,
              OFF_PLACE_WHERE = 539, OFF_PLACE_ISMAT = 543,
              OFF_PLACE_MAT = 547, OFF_PLACE_ACH = 551,
              OFF_MAKE_USES = 555, OFF_MAKE_NEED = 651,
              OFF_MAKE_ITEM = 657, OFF_MAKE_COUNT = 663, OFF_MAKE_ACH = 669;

// Ids of crafter_tpu_torch/rules.py.
constexpr int E_PLAYER = 1, E_COW = 2, E_ZOMBIE = 3, E_SKELETON = 4,
              E_ARROW = 5, E_PLANT = 6;
constexpr int MAT_WATER = 1, MAT_PATH = 4, MAT_LAVA = 7, MAT_TABLE = 11,
              MAT_FURNACE = 12;
constexpr int I_HEALTH = 0, I_FOOD = 1, I_DRINK = 2, I_ENERGY = 3,
              I_WOOD_SWORD = 13, I_STONE_SWORD = 14, I_IRON_SWORD = 15;
constexpr int ACH_DEFEAT_SKELETON = 7, ACH_DEFEAT_ZOMBIE = 8,
              ACH_EAT_COW = 9, ACH_EAT_PLANT = 10, ACH_WAKE_UP = 21;
constexpr int A_DO = 5, A_SLEEP = 6;

// 10-bit thresholds round(p * 1024) of the mob gates (step.py:558).
constexpr int P10_05 = 512, P10_09 = 922, P10_08 = 819, P10_06 = 614,
              P10_03 = 307, P10_02 = 205;

// Per-slot flag word of the mob phase (window scratch FL).
enum : int {
  FL_ACTIVE = 1 << 0, FL_DYING = 1 << 1, FL_VALID = 1 << 2,   // pdir: 3-4
  FL_FEASIBLE = 1 << 5, FL_RETREAT = 1 << 6, FL_CSHOOT = 1 << 7,
  FL_AHIT = 1 << 8, FL_ABLOCK = 1 << 9,                      // type: 10-12
  FL_RELOAD0 = 1 << 13, FL_HOSTILE = 1 << 14                 // sdir+1: 15-17
};

// Word i of env's record.
__device__ int rec_word(const RecIn& in, int env, int i) {
  // facing, pos, sleeping, hunger, thirst, fatigue, recover, last_health,
  // step, env_last_health, key, inventory, achievements, unlocked.
  constexpr int kWords[kFields] = {1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 2, kItems,
                                   kAch, kAch};
  int j = 0;
  while (i >= kWords[j]) i -= kWords[j++];
  const RecField f = in.f[j];
  const long long at = env * f.stride + i;
  if (f.kind == K_U8) return static_cast<const uint8_t*>(f.ptr)[at];
  if (f.kind == K_I64)
    return (int)(uint32_t)static_cast<const long long*>(f.ptr)[at];
  return static_cast<const int*>(f.ptr)[at];
}

// The env's record (step_cuda.REC order) and the tick's shared scalars.
struct Scalars {
  int rec[kRec];
  int plant_idx;     // cell of the plant placed this tick, or -1
  uint32_t s_mob;    // the tick's mob seed
  int player_dmg, zdmg;
};

// The update window: radius u, rows of bw slots, nd diamond cells, nb
// slots of the padded bounding box.
struct Window {
  int u, bw, nd, nb;
};

__host__ __device__ inline Window window_of(int upd) {
  Window W;
  W.u = upd > 1 ? upd : 1;   // zombie strikes and the plant: distance <= 1
  W.bw = 2 * W.u + 1;
  W.nd = 2 * W.u * (W.u + 1) + 1;
  W.nb = (W.bw + 2) * W.bw;
  return W;
}

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~size_t(15);
}

// Byte offsets of the block's shared memory.
struct Layout {
  size_t s, m, t, hs, f, a, occ, fl, pk, b8, dt, total;
};

__host__ __device__ inline Layout layout_of(int C, const Window& W) {
  Layout L;
  size_t o = 0;
  L.s = o;   o = align16(o + sizeof(Scalars));
  L.m = o;   o = align16(o + C);
  L.t = o;   o = align16(o + C);
  L.hs = o;  o = align16(o + C);
  L.f = o;   o = align16(o + C);
  L.a = o;   o = align16(o + 4 * (size_t)C);
  L.occ = o; o = align16(o + 4 * (size_t)((C + 31) / 32));
  L.fl = o;  o = align16(o + 4 * (size_t)W.nb);
  L.pk = o;  o = align16(o + 2 * (size_t)W.nb);
  L.b8 = o;  o = align16(o + W.nb);
  L.dt = o;  o = align16(o + 2 * (size_t)W.nd);
  L.total = o;
  return L;
}

// The env's working set in shared memory.
struct Planes {
  uint8_t *M, *T, *Hs, *F;   // C cells each
  int* A;                    // aux counters, int32 as in the JAX kernel
  uint32_t* OCC;             // occupancy OR of the group's ticks, a bit a cell
  int* FL;                   // window scratch: per-slot flags
  uint16_t* PK;              // window scratch: the claim word a mover carries
  uint8_t* B8;               // window scratch: impacts, winners
  char2* DT;                 // (dx, dy) of each window cell
};

// rules.DIRS: left, right, up, down.
__device__ __forceinline__ int dir_dx(int d) {
  return d == 0 ? -1 : (d == 1 ? 1 : 0);
}
__device__ __forceinline__ int dir_dy(int d) {
  return d == 2 ? -1 : (d == 3 ? 1 : 0);
}

__device__ __forceinline__ void dirvec(int d, int& dx, int& dy) {
  dx = dir_dx(d);
  dy = dir_dy(d);
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// --- global <-> shared copies, 16 bytes a thread where aligned ----------

__device__ void load_bytes(uint8_t* dst, const uint8_t* __restrict__ src,
                           int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (aligned(src, 16) && (n & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < n >> 4; i += nt) d[i] = __ldg(s + i);
  } else {
    for (int i = tid; i < n; i += nt) dst[i] = src[i];
  }
}

__device__ void store_bytes(uint8_t* __restrict__ dst, const uint8_t* src,
                            int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (aligned(dst, 16) && (n & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < n >> 4; i += nt) d[i] = s[i];
  } else {
    for (int i = tid; i < n; i += nt) dst[i] = src[i];
  }
}

__device__ void load_aux(int* dst, const int16_t* __restrict__ src, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (aligned(src, 8) && (n & 3) == 0) {
    const uint2* s = reinterpret_cast<const uint2*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = tid; i < n >> 2; i += nt) {
      const uint2 v = __ldg(s + i);
      d[i] = make_int4((int16_t)(v.x & 0xFFFFu), (int16_t)(v.x >> 16),
                       (int16_t)(v.y & 0xFFFFu), (int16_t)(v.y >> 16));
    }
  } else {
    for (int i = tid; i < n; i += nt) dst[i] = src[i];
  }
}

__device__ void store_aux(int16_t* __restrict__ dst, const int* src, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (aligned(dst, 8) && (n & 3) == 0) {
    const int4* s = reinterpret_cast<const int4*>(src);
    uint2* d = reinterpret_cast<uint2*>(dst);
    for (int i = tid; i < n >> 2; i += nt) {
      const int4 v = s[i];
      d[i] = make_uint2((uint16_t)v.x | ((uint32_t)(uint16_t)v.y << 16),
                        (uint16_t)v.z | ((uint32_t)(uint16_t)v.w << 16));
    }
  } else {
    for (int i = tid; i < n; i += nt) dst[i] = (int16_t)src[i];
  }
}

// Four occupancy bits as four 0/1 bytes.
__device__ __forceinline__ uint32_t spread4(uint32_t b) {
  return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

__device__ void store_occ(uint8_t* __restrict__ dst, const uint32_t* occ,
                          int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (aligned(dst, 16) && (n & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < n >> 4; i += nt) {
      const uint32_t b = (occ[i >> 1] >> ((i & 1) << 4)) & 0xFFFFu;
      d[i] = make_uint4(spread4(b & 15u), spread4((b >> 4) & 15u),
                        spread4((b >> 8) & 15u), spread4(b >> 12));
    }
  } else {
    for (int c = tid; c < n; c += nt) dst[c] = (occ[c >> 5] >> (c & 31)) & 1u;
  }
}

// A nonzero bit for each nonzero byte of a word.
__device__ __forceinline__ uint32_t nonzero4(uint32_t v) {
  return ((v & 0xFFu) != 0) | (((v & 0xFF00u) != 0) << 1) |
         (((v & 0xFF0000u) != 0) << 2) | (((v & 0xFF000000u) != 0) << 3);
}

// OR the occupancy of every cell into OCC (after tick 0).
__device__ void occ_sweep(const Planes& P, int C) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int wd = tid; wd < (C + 31) >> 5; wd += nt) {
    uint32_t bits = 0;
    if ((C & 31) == 0) {
      const uint4* t = reinterpret_cast<const uint4*>(P.T) + 2 * wd;
      const uint4 a = t[0], b = t[1];
      bits = nonzero4(a.x) | nonzero4(a.y) << 4 | nonzero4(a.z) << 8 |
             nonzero4(a.w) << 12 | nonzero4(b.x) << 16 | nonzero4(b.y) << 20 |
             nonzero4(b.z) << 24 | nonzero4(b.w) << 28;
    } else {
      for (int j = 0; j < 32 && 32 * wd + j < C; ++j)
        if (P.T[32 * wd + j] != 0) bits |= 1u << j;
    }
    P.OCC[wd] |= bits;
  }
}

// The render.pack_cells encoding of one cell.
__device__ __forceinline__ uint32_t snap_code(const Planes& P, int c) {
  const int Tc = P.T[c];
  const int ctex = Tc == E_PLAYER     ? 1
                   : Tc == E_COW      ? 6
                   : Tc == E_ZOMBIE   ? 7
                   : Tc == E_SKELETON ? 8
                   : Tc == E_ARROW    ? 9 + P.F[c]
                   : Tc == E_PLANT    ? 13 + (P.A[c] > 300 ? 1 : 0)
                                      : 0;
  return (uint32_t)(P.M[c] | (ctex << 4)) & 0xFFu;
}

// The tick's packed render plane of this env, 16 cells a thread.
__device__ void write_snapshot(const Planes& P, uint8_t* __restrict__ snap,
                               int C) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (aligned(snap, 16) && (C & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(snap);
    for (int i = tid; i < C >> 4; i += nt) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) v |= snap_code(P, 16 * i + 4 * q + b) << (8 * b);
        w[q] = v;
      }
      d[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int c = tid; c < C; c += nt) snap[c] = (uint8_t)snap_code(P, c);
  }
}

// (dx, dy) of window cell i: rows dx = -u..u of 2 (u - |dx|) + 1 cells.
__device__ char2 diamond_offset(int i, int u) {
  int dx = -u;
  for (;; ++dx) {
    const int len = 2 * (u - abs(dx)) + 1;
    if (i < len) break;
    i -= len;
  }
  return make_char2((signed char)dx, (signed char)(i - (u - abs(dx))));
}

// Carve the block's shared memory, load the env's planes and record and
// the window's offsets; ends with a barrier.
__device__ Planes load_env(unsigned char* smem, Scalars*& S,
                           const uint8_t* mat_in, const uint8_t* et_in,
                           const uint8_t* hp_in, const int16_t* aux_in,
                           const uint8_t* fac_in, const RecIn& rin,
                           int env, int C, const Window& W) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = layout_of(C, W);
  S = reinterpret_cast<Scalars*>(smem + L.s);
  Planes P;
  P.M = smem + L.m;
  P.T = smem + L.t;
  P.Hs = smem + L.hs;
  P.F = smem + L.f;
  P.A = reinterpret_cast<int*>(smem + L.a);
  P.OCC = reinterpret_cast<uint32_t*>(smem + L.occ);
  P.FL = reinterpret_cast<int*>(smem + L.fl);
  P.PK = reinterpret_cast<uint16_t*>(smem + L.pk);
  P.B8 = smem + L.b8;
  P.DT = reinterpret_cast<char2*>(smem + L.dt);
  const size_t off = (size_t)env * C;
  load_bytes(P.M, mat_in + off, C);
  load_bytes(P.T, et_in + off, C);
  load_bytes(P.Hs, hp_in + off, C);
  load_bytes(P.F, fac_in + off, C);
  load_aux(P.A, aux_in + off, C);
  for (int i = tid; i < (C + 31) >> 5; i += nt) P.OCC[i] = 0;
  for (int i = tid; i < W.nb; i += nt) {
    P.FL[i] = 0;
    P.PK[i] = 0;
    P.B8[i] = 0;
  }
  for (int i = tid; i < W.nd; i += nt) P.DT[i] = diamond_offset(i, W.u);
  for (int i = tid; i < kRec; i += nt) S->rec[i] = rec_word(rin, env, i);
  __syncthreads();
  return P;
}

// Write the env's planes and record back; the caller has put a barrier
// after the last write to them.  occ_out may be null.
__device__ void store_env(const Planes& P, const Scalars& S,
                          uint8_t* mat_out, uint8_t* et_out, uint8_t* hp_out,
                          int16_t* aux_out, uint8_t* fac_out,
                          uint8_t* occ_out, int32_t* rec_out, int env, int C,
                          int step_out) {
  const size_t off = (size_t)env * C;
  store_bytes(mat_out + off, P.M, C);
  store_bytes(et_out + off, P.T, C);
  store_bytes(hp_out + off, P.Hs, C);
  store_bytes(fac_out + off, P.F, C);
  store_aux(aux_out + off, P.A, C);
  if (occ_out != nullptr) store_occ(occ_out + off, P.OCC, C);
  for (int i = threadIdx.x; i < kRec; i += blockDim.x)
    rec_out[(size_t)env * kRec + i] = i == R_STEP ? step_out : S.rec[i];
}

// --- the player phase, on warp 0 -----------------------------------------

// Whether the inventory (lane j holds item j) meets a requirement row.
__device__ __forceinline__ bool req_ok(const int* __restrict__ need, int inv,
                                       int lane) {
  const int nj = lane < kItems ? __ldg(need + lane) : 0;
  return __all_sync(kFull, nj == 0 || inv >= nj);
}

// Player.update (objects.py:99-131) for one env, on the 32 lanes of warp 0
// (step.py:_player_core).  Ends with the warp's writes to the planes and
// the record done.
template <int kH>
__device__ void player_phase(Scalars& S, const Planes& P,
                             const int* __restrict__ R, int action,
                             uint32_t seed, int w, int h_arg) {
  const int h = kH > 0 ? kH : h_arg;
  const int lane = threadIdx.x & 31;
  int* const rec = S.rec;
  uint8_t* const M = P.M;
  int inv = lane < kItems ? rec[kInv + lane] : 0;
  int ach = lane < kAch ? rec[kAchOff + lane] : 0;
  auto item = [&](int j) { return __shfl_sync(kFull, inv, j); };

  const int energy_max = __ldg(R + OFF_ITEM_MAX + I_ENERGY);
  bool sleeping = rec[R_SLEEP] != 0;
  const bool full = item(I_ENERGY) >= energy_max;
  const bool wake = sleeping && full;
  if (sleeping && !full) action = A_SLEEP;
  sleeping = sleeping && !wake;
  if (wake && lane == ACH_WAKE_UP) ach += 1;

  const int px0 = rec[R_PX], py0 = rec[R_PY];
  int px = px0, py = py0, facing = rec[R_FACING];
  int fdx, fdy;
  dirvec(facing, fdx, fdy);
  const int tx = px + fdx, ty = py + fdy;
  const bool tin = tx >= 0 && tx < w && ty >= 0 && ty < h;
  const int t_idx = tin ? tx * h + ty : -1;
  const int move_dir = min(max(action - 1, 0), 3);
  int mdx, mdy;
  dirvec(move_dir, mdx, mdy);
  const int mx = px + mdx, my = py + mdy;
  const bool m_in = mx >= 0 && mx < w && my >= 0 && my < h;
  const int m_idx = m_in ? mx * h + my : -1;
  const int p_idx = px * h + py;
  const int tmat = t_idx >= 0 ? M[t_idx] : 0;
  const int mtmat = m_idx >= 0 ? M[m_idx] : 0;
  const int heremat = M[p_idx];
  const int ttype = t_idx >= 0 ? P.T[t_idx] : 0;
  const int thp = t_idx >= 0 ? P.Hs[t_idx] : 0;
  const int taux = t_idx >= 0 ? P.A[t_idx] : 0;
  const bool t_occ = ttype > 0;
  const bool mt_occ = (m_idx >= 0 ? P.T[m_idx] : 0) > 0;
  const bool is_move = action >= 1 && action <= 4;
  const bool is_do = action == A_DO, is_sleep = action == A_SLEEP;
  const bool is_place = action >= 7 && action <= 10;
  const bool is_make = action >= 11 && action <= 16;

  // Move (objects.py:174-179): facing set even when blocked.
  if (is_move) facing = move_dir;
  const bool can_move = is_move && m_in &&
                        ((__ldg(R + OFF_WALK_PLAYER) >> mtmat) & 1) && !mt_occ;
  if (can_move) {
    px = mx;
    py = my;
  }
  if (is_move && (can_move ? mtmat : heremat) == MAT_LAVA && lane == I_HEALTH)
    inv = 0;

  // Do on an entity (objects.py:181-213).
  const bool do_obj = is_do && t_occ;
  int damage = 1;
  if (item(I_WOOD_SWORD) > 0) damage = max(damage, 2);
  if (item(I_STONE_SWORD) > 0) damage = max(damage, 3);
  if (item(I_IRON_SWORD) > 0) damage = max(damage, 5);
  const bool eat_plant = do_obj && ttype == E_PLANT && taux > 300;
  const bool hit_mob = do_obj && (ttype == E_ZOMBIE || ttype == E_SKELETON ||
                                  ttype == E_COW);
  const int hp_after = max(0, thp - damage);
  const bool killed = hit_mob && hp_after <= 0;
  const bool eat_cow = killed && ttype == E_COW;
  if (lane == I_FOOD) inv += (eat_plant ? 4 : 0) + (eat_cow ? 6 : 0);
  if (eat_plant && lane == ACH_EAT_PLANT) ach += 1;
  if (eat_cow && lane == ACH_EAT_COW) ach += 1;
  if (killed && ttype == E_ZOMBIE && lane == ACH_DEFEAT_ZOMBIE) ach += 1;
  if (killed && ttype == E_SKELETON && lane == ACH_DEFEAT_SKELETON) ach += 1;

  // Do on a material (objects.py:214-229).
  const bool do_mat = is_do && !t_occ;
  const bool drink_water = do_mat && tmat == MAT_WATER;
  const bool can_collect =
      do_mat && ((__ldg(R + OFF_COLLECTIBLE) >> tmat) & 1) &&
      req_ok(R + OFF_COLLECT_REQ + tmat * kItems, inv, lane);
  const float prob = __int_as_float(__ldg(R + OFF_COLLECT_PROB + tmat));
  if (can_collect && u24(fmix(seed)) <= prob) {
    if (lane < kItems) inv += __ldg(R + OFF_COLLECT_RECV + tmat * kItems + lane);
    const int cach = __ldg(R + OFF_COLLECT_ACH + tmat);
    if (cach >= 0 && lane == cach) ach += 1;
  }

  // Sleep (objects.py:117-119).
  if (is_sleep && item(I_ENERGY) < energy_max) sleeping = true;

  // Place (objects.py:231-249).
  const int pidx = min(max(action - 7, 0), 3);
  const bool place_ok = is_place && !t_occ &&
                        ((__ldg(R + OFF_PLACE_WHERE + pidx) >> tmat) & 1) &&
                        req_ok(R + OFF_PLACE_USES + pidx * kItems, inv, lane);
  const bool place_mat = place_ok && __ldg(R + OFF_PLACE_ISMAT + pidx);
  const bool plant_spawn = place_ok && !place_mat;
  if (place_ok) {
    if (lane < kItems) inv -= __ldg(R + OFF_PLACE_USES + pidx * kItems + lane);
    if (lane == __ldg(R + OFF_PLACE_ACH + pidx)) ach += 1;
  }

  // Make (objects.py:251-261): 3x3 nearby window, empty at the x==0 or
  // y==0 edge (engine.py:95-103); lanes 0..8 read one cell each.
  if (is_make) {
    const int midx = min(max(action - 11, 0), 5);
    unsigned bit = 0;
    if (px0 >= 1 && py0 >= 1 && lane < 9) {
      const int wx = px0 - 1 + lane / 3, wy = py0 - 1 + lane % 3;
      if (wx < w && wy < h) bit = 1u << M[wx * h + wy];
    }
    const int present = (int)__reduce_or_sync(kFull, bit);
    if ((__ldg(R + OFF_MAKE_NEED + midx) & ~present) == 0 &&
        req_ok(R + OFF_MAKE_USES + midx * kItems, inv, lane)) {
      if (lane < kItems) inv -= __ldg(R + OFF_MAKE_USES + midx * kItems + lane);
      if (lane == __ldg(R + OFF_MAKE_ITEM + midx))
        inv += __ldg(R + OFF_MAKE_COUNT + midx);
      if (lane == __ldg(R + OFF_MAKE_ACH + midx)) ach += 1;
    }
  }

  // Life stats in half units (objects.py:133-151).
  int hunger = eat_cow ? 0 : rec[R_HUNGER];
  int thirst = drink_water ? 0 : rec[R_THIRST];
  int fatigue = rec[R_FATIGUE], recover = rec[R_RECOVER];
  hunger += sleeping ? 1 : 2;
  const bool hungry = hunger > 50;
  if (hungry) hunger = 0;
  thirst += sleeping ? 1 : 2;
  const bool thirsty = thirst > 40;
  if (thirsty) thirst = 0;
  if (hungry && lane == I_FOOD) inv -= 1;
  if (thirsty && lane == I_DRINK) inv -= 1;
  fatigue = sleeping ? min(fatigue - 2, 0) : fatigue + 2;
  const bool gain_e = fatigue < -20, lose_e = fatigue > 60;
  if (gain_e || lose_e) fatigue = 0;
  if (lane == I_ENERGY) inv += (gain_e ? 1 : 0) - (lose_e ? 1 : 0);

  // Health regen / degen (objects.py:153-167).
  const int food = item(I_FOOD), drink = item(I_DRINK),
            energy = item(I_ENERGY);
  const bool nec = food > 0 && drink > 0 && (energy > 0 || sleeping);
  recover += nec ? (sleeping ? 4 : 2) : (sleeping ? -1 : -2);
  const bool regen = recover > 50, degen = recover < -30;
  if (regen || degen) recover = 0;
  if (lane == I_HEALTH) inv = max(0, inv + (regen ? 1 : 0) - (degen ? 1 : 0));

  // Clamp, then wake on hurt (objects.py:126-131, :169-172).
  if (lane < kItems) inv = min(max(inv, 0), __ldg(R + OFF_ITEM_MAX + lane));
  const int hp = item(I_HEALTH);
  if (hp < rec[R_LASTH]) sleeping = false;

  // Every lane has read what it needs: write the planes and the record.
  __syncwarp();
  if (lane == 0) {
    if (can_move) {
      P.T[p_idx] = 0;
      P.T[m_idx] = E_PLAYER;
    }
    if (eat_plant) P.A[t_idx] = 0;
    if (hit_mob) P.Hs[t_idx] = (uint8_t)hp_after;
    if (can_collect) M[t_idx] = (uint8_t)__ldg(R + OFF_COLLECT_LEAVES + tmat);
    if (place_mat) M[t_idx] = (uint8_t)__ldg(R + OFF_PLACE_MAT + pidx);
    rec[R_PX] = px;
    rec[R_PY] = py;
    rec[R_FACING] = facing;
    rec[R_SLEEP] = sleeping ? 1 : 0;
    rec[R_HUNGER] = hunger;
    rec[R_THIRST] = thirst;
    rec[R_FATIGUE] = fatigue;
    rec[R_RECOVER] = recover;
    rec[R_LASTH] = hp;
    S.plant_idx = plant_spawn ? t_idx : -1;
    S.player_dmg = 0;
    S.zdmg = 0;
  }
  if (lane < kItems) rec[kInv + lane] = inv;
  if (lane < kAch) rec[kAchOff + lane] = ach;
  __syncwarp();
}

// The mob phase's damage lands on the player's health (objects.py:302-312);
// on warp 0.  Returns the health (on every lane).
__device__ __forceinline__ int apply_mob_damage(Scalars& S) {
  const int hp = max(0, S.rec[kInv + I_HEALTH] - (S.player_dmg + S.zdmg));
  __syncwarp();
  if ((threadIdx.x & 31) == 0) S.rec[kInv + I_HEALTH] = hp;
  __syncwarp();
  return hp;
}

// --- the mob phase, on every thread --------------------------------------

// Window cell i: its coordinates, cell index and box slot; false outside
// the world.
struct WCell {
  int x, y, c, b, dx, dy;
};

template <int kH>
__device__ __forceinline__ bool window_cell(const Planes& P, const Window& W,
                                            int i, int px, int py, int w,
                                            int h_arg, WCell& k) {
  const int h = kH > 0 ? kH : h_arg;
  const char2 d = P.DT[i];
  k.dx = d.x;
  k.dy = d.y;
  k.x = px + d.x;
  k.y = py + d.y;
  if ((unsigned)k.x >= (unsigned)w || (unsigned)k.y >= (unsigned)h)
    return false;
  k.c = k.x * h + k.y;
  k.b = (d.x + W.u + 1) * W.bw + d.y + W.u;
  return true;
}

// All non-player entities for one tick (step.py:_mob_core), run by every
// thread of the block after the player phase and a barrier.  S.s_mob is the
// tick's mob seed; the player's damage is left in S.player_dmg + S.zdmg.
// occ_window / occ_all: OR the post-tick occupancy of the window / of every
// cell into OCC.  snap: where to write the tick's packed render plane of
// this env, or null.  Ends with a barrier.
template <int kH>
__device__ void mob_phase(Scalars& S, const Planes& P,
                          const int* __restrict__ R, int w, int h_arg,
                          int upd, const Window& W, bool occ_window,
                          bool occ_all, uint8_t* __restrict__ snap) {
  const int h = kH > 0 ? kH : h_arg;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int C = w * h, bw = W.bw, nd = W.nd;
  int* const A = P.A;
  int* const FL = P.FL;
  uint16_t* const PK = P.PK;
  uint8_t* const M = P.M;
  uint8_t* const T = P.T;
  uint8_t* const Hs = P.Hs;
  uint8_t* const F = P.F;
  uint8_t* const B8 = P.B8;
  const int walk_mob = __ldg(R + OFF_WALK_MOB);
  const int walk_arrow = __ldg(R + OFF_WALK_ARROW);
  const int px = S.rec[R_PX], py = S.rec[R_PY], plant = S.plant_idx;
  const bool slp = S.rec[R_SLEEP] != 0;
  const uint32_t sm = S.s_mob;
  // Whether the dir-d neighbour (x - DX[d], y - DY[d]) lies in the world.
  auto nbr_in = [&](const WCell& k, int d) {
    const int sx = k.x - dir_dx(d), sy = k.y - dir_dy(d);
    return sx >= 0 && sx < w && sy >= 0 && sy < h;
  };
  WCell k;

  // --- pass 1: every active entity decides against the post-player state.
  for (int i = tid; i < nd; i += nt) {
    if (!window_cell<kH>(P, W, i, px, py, w, h, k)) continue;
    const int x = k.x, y = k.y, c = k.c;
    const int Tc = T[c];
    const int offx = -k.dx, offy = -k.dy;
    const int ax = abs(offx), ay = abs(offy);
    const int pdist = ax + ay;
    if (!(Tc > E_PLAYER && pdist < upd)) {
      FL[k.b] = Tc << 10;
      B8[k.b] = 0;
      continue;
    }
    const bool is_cow = Tc == E_COW, is_zom = Tc == E_ZOMBIE;
    const bool is_skel = Tc == E_SKELETON, is_arrow = Tc == E_ARROW;
    const bool dying = Hs[c] <= 0 && (is_cow || is_zom || is_skel);
    const uint32_t hb0 = cell_bits(sm, 0u, (uint32_t)x, (uint32_t)y);
    const uint32_t hb1 = cell_bits(sm, 1u, (uint32_t)x, (uint32_t)y);
    const int g0 = hb0 & 0x3FF, g1 = (hb0 >> 10) & 0x3FF;
    const int g2 = (hb0 >> 20) & 0x3FF, dirbits = hb0 >> 30;
    const int g3 = hb1 & 0x3FF, g4 = (hb1 >> 10) & 0x3FF;
    const bool x_longer = ax > ay;
    const int sgnx = sgn(offx), sgny = sgn(offy);
    int rdx, rdy;
    dirvec(dirbits, rdx, rdy);
    const bool retreat = pdist <= 3;
    const bool c_shoot = pdist <= 5 && g1 < P10_05;
    bool wants_kind = false;
    int mvx, mvy;
    if (is_zom) {
      const bool chase = pdist <= 8 && g0 < P10_09;
      const bool use_x = (g1 < P10_08) == x_longer;
      mvx = chase ? (use_x ? sgnx : 0) : rdx;
      mvy = chase ? (use_x ? 0 : sgny) : rdy;
      wants_kind = true;
    } else if (is_skel) {
      const bool c_approach = pdist <= 8 && g2 < P10_03;
      const bool c_walk = g3 < P10_02;
      const bool appr = !c_shoot && c_approach;
      const bool ax_use = (g4 < P10_06) == x_longer;
      const int sox = appr ? (ax_use ? sgnx : 0) : rdx;
      const int soy = appr ? (ax_use ? 0 : sgny) : rdy;
      const bool rx_use = (g0 < P10_06) == x_longer;
      mvx = retreat ? -(rx_use ? sgnx : 0) : sox;
      mvy = retreat ? -(rx_use ? 0 : sgny) : soy;
      wants_kind = retreat || (!c_shoot && (c_approach || c_walk));
    } else if (is_arrow) {
      dirvec(F[c], mvx, mvy);
    } else {
      mvx = rdx;
      mvy = rdy;
      wants_kind = is_cow && g0 < P10_05;
    }
    const bool moving = mvx != 0 || mvy != 0;
    const int pdir = mvx == -1 ? 0 : (mvx == 1 ? 1 : (mvy == -1 ? 2 : 3));
    int tmat;
    bool tocc, inside;
    if (moving) {
      inside = pdir == 0 ? x >= 1
                         : (pdir == 1 ? x <= w - 2
                                      : (pdir == 2 ? y >= 1 : y <= h - 2));
      if (inside) {
        const int tc = c + dir_dx(pdir) * h + dir_dy(pdir);
        tmat = M[tc];
        tocc = T[tc] > 0 || tc == plant;
      } else {
        tmat = 0;
        tocc = false;
      }
    } else {
      inside = true;
      tmat = M[c];
      tocc = true;   // the entity itself
    }
    const bool walk_arrow_t = (walk_arrow >> tmat) & 1;
    const bool a_hit = is_arrow && tocc;
    const bool a_block = is_arrow && !a_hit && !walk_arrow_t;
    const bool smash_src =
        a_block && (tmat == MAT_TABLE || tmat == MAT_FURNACE);
    const bool a_fly = is_arrow && !a_hit && !a_block;
    const bool wants = !dying && (wants_kind || a_fly);
    const bool walk_ok =
        is_arrow ? walk_arrow_t : (((walk_mob >> tmat) & 1) != 0);
    const bool feasible = inside && walk_ok && !tocc;
    const bool valid = wants && feasible && moving;
    FL[k.b] = FL_ACTIVE | (dying ? FL_DYING : 0) | (valid ? FL_VALID : 0) |
              (pdir << 3) | (feasible ? FL_FEASIBLE : 0) |
              (retreat ? FL_RETREAT : 0) | (c_shoot ? FL_CSHOOT : 0) |
              (a_hit ? FL_AHIT : 0) | (a_block ? FL_ABLOCK : 0) | (Tc << 10);
    B8[k.b] = (a_hit ? 1 : 0) | (smash_src ? 2 : 0);
  }
  __syncthreads();

  // --- pass 2: arrow impacts land, plants grow, skeletons reload, and
  // each cell packs the claim word its move would carry: type - 2 (a mover
  // is a cow, zombie, skeleton or arrow), facing, health, aux & 15.
  for (int i = tid; i < nd; i += nt) {
    if (!window_cell<kH>(P, W, i, px, py, w, h, k)) continue;
    const int c = k.c;
    const int fl = FL[k.b];
    const int Tc0 = (fl >> 10) & 7;
    int dmg = 0;
    bool smash = false;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (!nbr_in(k, d)) continue;
      const int bits = B8[k.b - dir_dx(d) * bw - dir_dy(d)];
      if (bits != 0 && F[c - dir_dx(d) * h - dir_dy(d)] == d) {
        dmg += 2 * (bits & 1);
        smash = smash || (bits & 2);
      }
    }
    if (k.dx == 0 && k.dy == 0) S.player_dmg = dmg;
    int Hc = Hs[c];
    if (Tc0 > E_PLAYER) Hc = max(0, Hc - dmg);
    Hs[c] = (uint8_t)Hc;
    if (smash) M[c] = MAT_PATH;
    const bool active = fl & FL_ACTIVE;
    int Ac = A[c];
    const int reload = (active && Tc0 == E_SKELETON) ? max(0, Ac - 1) : Ac;
    if (active && Tc0 == E_PLANT) Ac += 1;
    if (Tc0 == E_SKELETON) Ac = reload;
    A[c] = Ac;
    PK[k.b] = (uint16_t)(((Tc0 - 2) & 3) | ((F[c] & 3) << 2) | (Hc << 4) |
                         ((Ac & 15) << 12));
    if (reload == 0) FL[k.b] = fl | FL_RELOAD0;
  }
  __syncthreads();

  // --- pass 3: each target takes the first valid claim in direction
  // order (B8 = winning direction + 1).
  for (int i = tid; i < nd; i += nt) {
    if (!window_cell<kH>(P, W, i, px, py, w, h, k)) continue;
    int win = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (win || !nbr_in(k, d)) continue;
      const int fs = FL[k.b - dir_dx(d) * bw - dir_dy(d)];
      if ((fs & FL_VALID) && ((fs >> 3) & 3) == d) win = d + 1;
    }
    B8[k.b] = (uint8_t)win;
  }
  __syncthreads();

  // --- pass 4: moves land, movers vacate, skeletons decide to shoot,
  // zombies strike.
  for (int i = tid; i < nd; i += nt) {
    if (!window_cell<kH>(P, W, i, px, py, w, h, k)) continue;
    const int c = k.c;
    const int fl = FL[k.b];
    const int Tc0 = (fl >> 10) & 7;
    int T1 = T[c], F1 = F[c], H1 = Hs[c], A1 = A[c];
    const int win = B8[k.b];
    if (win) {
      int ddx, ddy;
      dirvec(win - 1, ddx, ddy);
      const int pk = PK[k.b - ddx * bw - ddy];
      T1 = (pk & 3) + 2;
      F1 = (pk >> 2) & 3;
      H1 = (pk >> 4) & 255;
      A1 = (pk >> 12) & 15;
    }
    bool success = false;
    if (fl & FL_VALID) {
      const int pdir = (fl >> 3) & 3;
      int ddx, ddy;
      dirvec(pdir, ddx, ddy);
      success = B8[k.b + ddx * bw + ddy] == pdir + 1;
    }
    if (success) T1 = 0;
    const bool dying = fl & FL_DYING, retreat = fl & FL_RETREAT;
    const bool s_moved = (dying && retreat && (fl & FL_FEASIBLE)) ||
                         (!dying && retreat && success);
    const bool shoot = (fl & FL_ACTIVE) && Tc0 == E_SKELETON && !s_moved &&
                       (fl & FL_CSHOOT) && (fl & FL_RELOAD0);
    int sdir = -1;
    if (shoot) {
      const int offx = -k.dx, offy = -k.dy;
      const bool x_longer = abs(offx) > abs(offy);
      const int shvx = x_longer ? sgn(offx) : 0;
      const int shvy = x_longer ? 0 : sgn(offy);
      sdir = shvx == -1 ? 0
                        : (shvx == 1 ? 1
                                     : (shvy == -1 ? 2 : (shvy == 1 ? 3 : -1)));
    }
    const int pdist = abs(k.dx) + abs(k.dy);
    const bool z_adj = T1 == E_ZOMBIE && pdist <= 1;
    const bool z_att = z_adj && A1 == 0;
    if (z_adj) A1 = z_att ? 5 : A1 - 1;
    if (z_att) atomicAdd(&S.zdmg, slp ? 7 : 2);
    const bool hostile = T1 == E_COW || T1 == E_ZOMBIE || T1 == E_SKELETON;
    T[c] = (uint8_t)T1;
    F[c] = (uint8_t)F1;
    Hs[c] = (uint8_t)H1;
    A[c] = A1;
    FL[k.b] = fl | (hostile ? FL_HOSTILE : 0) | ((sdir + 1) << 15);
  }
  __syncthreads();

  // --- pass 5: plants take damage from hostile neighbours; removals;
  // the pending plant materializes.
  for (int i = tid; i < nd; i += nt) {
    if (!window_cell<kH>(P, W, i, px, py, w, h, k)) continue;
    const int c = k.c;
    const int fl = FL[k.b];
    const bool plant0 = (fl & FL_ACTIVE) && ((fl >> 10) & 7) == E_PLANT;
    int T1 = T[c], H1 = Hs[c], A1 = A[c];
    bool nbr_hostile = false;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (!nbr_in(k, d)) continue;
      nbr_hostile = nbr_hostile || (FL[k.b - dir_dx(d) * bw - dir_dy(d)] & FL_HOSTILE);
    }
    if (plant0 && nbr_hostile) H1 = max(0, H1 - 1);
    const bool plant_dead = plant0 && H1 <= 0;
    if ((fl & (FL_DYING | FL_AHIT | FL_ABLOCK)) || plant_dead) T1 = 0;
    if (c == plant) {
      T1 = E_PLANT;
      H1 = 1;
      A1 = 0;
    }
    T[c] = (uint8_t)T1;
    Hs[c] = (uint8_t)H1;
    A[c] = A1;
  }
  __syncthreads();

  // --- pass 6: arrows spawn on free arrow-walkable cells, first shooter
  // in direction order wins (B8 = spawn direction + 1).
  for (int i = tid; i < nd; i += nt) {
    if (!window_cell<kH>(P, W, i, px, py, w, h, k)) continue;
    const int c = k.c;
    int win = 0;
    if (T[c] == 0 && c != plant && ((walk_arrow >> M[c]) & 1)) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (win || !nbr_in(k, d)) continue;
        if (((FL[k.b - dir_dx(d) * bw - dir_dy(d)] >> 15) & 7) == d + 1) {
          T[c] = E_ARROW;
          Hs[c] = 0;
          A[c] = 0;
          F[c] = (uint8_t)d;
          win = d + 1;
        }
      }
    }
    B8[k.b] = (uint8_t)win;
  }
  __syncthreads();

  // --- pass 7: shooters whose arrow landed reload; the window's occupancy.
  for (int i = tid; i < nd; i += nt) {
    if (!window_cell<kH>(P, W, i, px, py, w, h, k)) continue;
    const int c = k.c;
    const int sdir = ((FL[k.b] >> 15) & 7) - 1;
    if (sdir >= 0) {
      int ddx, ddy;
      dirvec(sdir, ddx, ddy);
      const int tx = k.x + ddx, ty = k.y + ddy;
      if (tx >= 0 && tx < w && ty >= 0 && ty < h &&
          B8[k.b + ddx * bw + ddy] == sdir + 1)
        A[c] = 4;
    }
    if (occ_window && T[c] != 0) atomicOr(&P.OCC[c >> 5], 1u << (c & 31));
  }
  __syncthreads();

  // Every cell: the occupancy after tick 0, the tick's snapshot.
  if (occ_all || snap != nullptr) {
    if (occ_all) occ_sweep(P, C);
    if (snap != nullptr) write_snapshot(P, snap, C);
    __syncthreads();
  }
}

template <int kH>
__global__ void __launch_bounds__(kThreads, kMinBlocks) group_tick_kernel(
    const uint8_t* __restrict__ mat_in, const uint8_t* __restrict__ et_in,
    const uint8_t* __restrict__ hp_in, const int16_t* __restrict__ aux_in,
    const uint8_t* __restrict__ fac_in, const int32_t* __restrict__ actions,
    const RecIn rin, const int32_t* __restrict__ rules,
    uint8_t* __restrict__ mat_out, uint8_t* __restrict__ et_out,
    uint8_t* __restrict__ hp_out, int16_t* __restrict__ aux_out,
    uint8_t* __restrict__ fac_out, uint8_t* __restrict__ occ_out,
    int32_t* __restrict__ rec_out, float* __restrict__ reward,
    uint8_t* __restrict__ done, uint8_t* __restrict__ dead,
    uint8_t* __restrict__ snap_packed, int32_t* __restrict__ snap_px,
    int32_t* __restrict__ snap_py, int32_t* __restrict__ snap_fac,
    int32_t* __restrict__ snap_slp, int32_t* __restrict__ snap_inv, int n,
    int k, int w, int h_arg, int length, int upd) {
  extern __shared__ __align__(16) unsigned char crafter_smem[];
  const int h = kH > 0 ? kH : h_arg;
  const int env = blockIdx.x;
  const int C = w * h;
  const int lane = threadIdx.x & 31;
  const bool warp0 = threadIdx.x < 32;
  const Window W = window_of(upd);
  Scalars* Sp;
  const Planes P = load_env(crafter_smem, Sp, mat_in, et_in, hp_in, aux_in,
                            fac_in, rin, env, C, W);
  Scalars& S = *Sp;
  const int step0 = S.rec[R_STEP];

  for (int t = 0; t < k; ++t) {
    // --- player phase and the tick's seeds (_tick_seeds), on warp 0.
    if (warp0) {
      const uint32_t step_t = (uint32_t)(step0 + t + 1);
      const uint32_t base =
          fmix((uint32_t)S.rec[R_K0] ^
               fmix((uint32_t)S.rec[R_K1] + step_t * 0x9E3779B9u));
      if (lane == 0) S.s_mob = fmix(base + 0x85EBCA6Bu);
      player_phase<kH>(S, P, rules, actions[(size_t)t * n + env], base, w,
                       h);
    }
    __syncthreads();
    // Snapshots of ticks 0..K-2, tick-major (row K-1 is the caller's).
    const bool snap_t = snap_packed != nullptr && t < k - 1;
    const size_t row = (size_t)t * n + env;
    mob_phase<kH>(S, P, rules, w, h, upd, W, t >= 1 && t < k - 1,
                  t == 0 && k > 1, snap_t ? snap_packed + row * C : nullptr);

    // --- reward / done / dead (the non-balance part of _finish_tick), on
    // warp 0.
    if (warp0) {
      const int hp = apply_mob_damage(S);
      const bool got = lane < kAch && S.rec[kAchOff + lane] > 0;
      const bool new_unlock =
          __any_sync(kFull, got && S.rec[kUnl + lane] == 0);
      if (got) S.rec[kUnl + lane] = 1;
      if (lane == 0) {
        // (hp - elh) / 10 + bonus, fused as XLA fuses the reference.
        reward[row] = fmaf((float)(hp - S.rec[R_ELH]), 0.1f,
                           new_unlock ? 1.0f : 0.0f);
        S.rec[R_ELH] = hp;
        const bool is_dead = hp <= 0;
        dead[row] = is_dead ? 1 : 0;
        done[row] = (is_dead || (length > 0 && step0 + t + 1 >= length)) ? 1
                                                                         : 0;
      }
      if (snap_t) {
        if (lane == 0) snap_px[row] = S.rec[R_PX];
        if (lane == 1) snap_py[row] = S.rec[R_PY];
        if (lane == 2) snap_fac[row] = S.rec[R_FACING];
        if (lane == 3) snap_slp[row] = S.rec[R_SLEEP];
        if (lane < kItems) snap_inv[row * kItems + lane] = S.rec[kInv + lane];
      }
      __syncwarp();
    }
  }
  __syncthreads();
  store_env(P, S, mat_out, et_out, hp_out, aux_out, fac_out, occ_out, rec_out,
            env, C, step0 + k);
}

// One tick of player phase + mob phase with the tick's two seeds given
// (step.py:_tick_pallas): no reward / done / unlocked bookkeeping; the
// record's step, reward memory, key words and unlocked flags pass through.
template <int kH>
__global__ void __launch_bounds__(kThreads, kMinBlocks) tick_kernel(
    const uint8_t* __restrict__ mat_in, const uint8_t* __restrict__ et_in,
    const uint8_t* __restrict__ hp_in, const int16_t* __restrict__ aux_in,
    const uint8_t* __restrict__ fac_in, const int32_t* __restrict__ actions,
    const int32_t* __restrict__ s_player, const int32_t* __restrict__ s_mob,
    const RecIn rin, const int32_t* __restrict__ rules,
    uint8_t* __restrict__ mat_out, uint8_t* __restrict__ et_out,
    uint8_t* __restrict__ hp_out, int16_t* __restrict__ aux_out,
    uint8_t* __restrict__ fac_out, int32_t* __restrict__ rec_out, int w,
    int h_arg, int upd) {
  extern __shared__ __align__(16) unsigned char crafter_smem[];
  const int h = kH > 0 ? kH : h_arg;
  const int env = blockIdx.x;
  const int C = w * h;
  const bool warp0 = threadIdx.x < 32;
  const Window W = window_of(upd);
  Scalars* Sp;
  const Planes P = load_env(crafter_smem, Sp, mat_in, et_in, hp_in, aux_in,
                            fac_in, rin, env, C, W);
  Scalars& S = *Sp;
  if (warp0) {
    if (threadIdx.x == 0) S.s_mob = (uint32_t)s_mob[env];
    player_phase<kH>(S, P, rules, actions[env], (uint32_t)s_player[env], w,
                     h);
  }
  __syncthreads();
  mob_phase<kH>(S, P, rules, w, h, upd, W, false, false, nullptr);
  if (warp0) apply_mob_damage(S);
  __syncthreads();
  store_env(P, S, mat_out, et_out, hp_out, aux_out, fac_out, nullptr, rec_out,
            env, C, S.rec[R_STEP]);
}

// The shared memory of one block, or 0 for a window the offsets cannot
// hold (radius above 127).
size_t smem_bytes(int w, int h, int upd) {
  const Window W = window_of(upd);
  return W.u > 127 ? 0 : layout_of(w * h, W).total;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The instantiation for a world of height h: 64, or any.
using GroupFn = decltype(&group_tick_kernel<0>);
using TickFn = decltype(&tick_kernel<0>);

GroupFn group_kernel_for(int h) {
  return h == 64 ? group_tick_kernel<64> : group_tick_kernel<0>;
}

TickFn tick_kernel_for(int h) {
  return h == 64 ? tick_kernel<64> : tick_kernel<0>;
}

}  // namespace

// The snap_* pointers are all null (no snapshots) or all set: snap_packed
// (K, N, C) uint8 of which rows 0..K-2 are written, snap_px / py / fac /
// slp (K-1, N) int32, snap_inv (K-1, N, 16) int32.
extern "C" int crafter_group_tick(
    const uint8_t* mat, const uint8_t* et, const uint8_t* hp,
    const int16_t* aux, const uint8_t* fac, const int32_t* actions,
    const RecIn* rin, const int32_t* rules, uint8_t* mat_out,
    uint8_t* et_out, uint8_t* hp_out, int16_t* aux_out, uint8_t* fac_out,
    uint8_t* occ_out, int32_t* rec_out, float* reward, uint8_t* done,
    uint8_t* dead, uint8_t* snap_packed, int32_t* snap_px, int32_t* snap_py,
    int32_t* snap_fac, int32_t* snap_slp, int32_t* snap_inv, int n, int k,
    int w, int h, int length, int upd, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = smem_bytes(w, h, upd);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const auto kernel = group_kernel_for(h);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      mat, et, hp, aux, fac, actions, *rin, rules, mat_out, et_out, hp_out,
      aux_out, fac_out, occ_out, rec_out, reward, done, dead, snap_packed,
      snap_px, snap_py, snap_fac, snap_slp, snap_inv, n, k, w, h, length,
      upd);
  return (int)cudaGetLastError();
}

extern "C" int crafter_tick(
    const uint8_t* mat, const uint8_t* et, const uint8_t* hp,
    const int16_t* aux, const uint8_t* fac, const int32_t* actions,
    const int32_t* s_player, const int32_t* s_mob, const RecIn* rin,
    const int32_t* rules, uint8_t* mat_out, uint8_t* et_out, uint8_t* hp_out,
    int16_t* aux_out, uint8_t* fac_out, int32_t* rec_out, int n, int w, int h,
    int upd, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = smem_bytes(w, h, upd);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  const auto kernel = tick_kernel_for(h);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      mat, et, hp, aux, fac, actions, s_player, s_mob, *rin, rules, mat_out,
      et_out, hp_out, aux_out, fac_out, rec_out, w, h, upd);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the group kernel (which = 0) or the tick
// kernel (1) for this area and window, and the block's shared memory.
extern "C" int crafter_tick_occupancy(int which, int w, int h, int upd,
                                      int* blocks, int* smem_out) {
  const size_t smem = smem_bytes(w, h, upd);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  *smem_out = (int)smem;
  cudaError_t err;
  if (which == 0) {
    const auto kernel = group_kernel_for(h);
    err = prepare(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                          kThreads, smem);
  } else {
    const auto kernel = tick_kernel_for(h);
    err = prepare(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                          kThreads, smem);
  }
  return (int)err;
}
