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
// phase.  The kernel itself sweeps every cell of every tick, which is why
// it stands far above that bound.
// Design: the block keeps its env's planes in shared memory for all K
// ticks, so device memory sees one read and one write of them a group
// (the TPU kernel's reason to exist, kept).  The player phase is scalar
// decision logic and runs on one thread; the mob phase runs one thread per
// cell in seven barrier-separated passes, each reading only what earlier
// passes wrote, so the per-tick semantics of the JAX phase (all mobs decide
// against the post-player state, movement claims resolved by direction
// priority) hold without atomics except one sum for the player's damage.
// The last pass also writes the tick's snapshot byte of its own cell
// (material | sprite id << 4) straight from shared memory when asked.
#include "common.cuh"

namespace {

using crafter::cell_bits;
using crafter::fmix;
using crafter::u24;

constexpr int kThreads = 256;
constexpr int kItems = 16, kAch = 22;
constexpr int kRecScalars = 13;
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
              OFF_MAKE_ITEM = 657, OFF_MAKE_COUNT = 663, OFF_MAKE_ACH = 669,
              RULES_WORDS = 675, RULES_PADDED = 676;

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
// rules.DIRS: left, right, up, down.
__device__ __constant__ int kDX[4] = {-1, 1, 0, 0};
__device__ __constant__ int kDY[4] = {0, 0, -1, 1};

// 10-bit thresholds round(p * 1024) of the mob gates (step.py:558).
constexpr int P10_05 = 512, P10_09 = 922, P10_08 = 819, P10_06 = 614,
              P10_03 = 307, P10_02 = 205;

// Per-cell flag word of the mob phase (shared plane FL).
enum : int {
  FL_ACTIVE = 1 << 0, FL_DYING = 1 << 1, FL_VALID = 1 << 2,   // pdir: 3-4
  FL_FEASIBLE = 1 << 5, FL_RETREAT = 1 << 6, FL_CSHOOT = 1 << 7,
  FL_AHIT = 1 << 8, FL_ABLOCK = 1 << 9,                      // type: 10-12
  FL_RELOAD0 = 1 << 13, FL_HOSTILE = 1 << 14                 // sdir+1: 15-17
};

struct Scalars {
  int facing, px, py, sleeping, hunger, thirst, fatigue, recover,
      last_health, step, elh;
  uint32_t k0, k1;
  int inv[kItems], ach[kAch], unl[kAch];
  int plant_idx;
  uint32_t s_mob;
  int player_dmg, zdmg;
};

__device__ __forceinline__ void dirvec(int d, int& dx, int& dy) {
  dx = d == 0 ? -1 : (d == 1 ? 1 : 0);
  dy = d == 2 ? -1 : (d == 3 ? 1 : 0);
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

__device__ bool req_ok(const int* need, const int* inv) {
  for (int j = 0; j < kItems; ++j)
    if (need[j] != 0 && inv[j] < need[j]) return false;
  return true;
}

// Player.update (objects.py:99-131) for one env, on one thread
// (step.py:_player_core).
__device__ void player_phase(Scalars& S, uint8_t* M, uint8_t* T, uint8_t* Hp,
                             int* A, const int* R, int action, uint32_t seed,
                             int w, int h) {
  int* inv = S.inv;
  int* ach = S.ach;
  const int energy_max = R[OFF_ITEM_MAX + I_ENERGY];
  bool sleeping = S.sleeping != 0;
  const bool full = inv[I_ENERGY] >= energy_max;
  const bool wake = sleeping && full;
  if (sleeping && !full) action = A_SLEEP;
  sleeping = sleeping && !wake;
  if (wake) ach[ACH_WAKE_UP] += 1;

  const int px0 = S.px, py0 = S.py;
  int px = px0, py = py0, facing = S.facing;
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
  const int ttype = t_idx >= 0 ? T[t_idx] : 0;
  const int thp = t_idx >= 0 ? Hp[t_idx] : 0;
  const int taux = t_idx >= 0 ? A[t_idx] : 0;
  const bool t_occ = ttype > 0;
  const bool mt_occ = (m_idx >= 0 ? T[m_idx] : 0) > 0;
  const bool is_move = action >= 1 && action <= 4;
  const bool is_do = action == A_DO, is_sleep = action == A_SLEEP;
  const bool is_place = action >= 7 && action <= 10;
  const bool is_make = action >= 11 && action <= 16;

  // Move (objects.py:174-179): facing set even when blocked.
  if (is_move) facing = move_dir;
  const bool can_move = is_move && m_in &&
                        ((R[OFF_WALK_PLAYER] >> mtmat) & 1) && !mt_occ;
  if (can_move) {
    T[p_idx] = 0;
    T[m_idx] = E_PLAYER;
    px = mx;
    py = my;
  }
  if (is_move && (can_move ? mtmat : heremat) == MAT_LAVA) inv[I_HEALTH] = 0;

  // Do on an entity (objects.py:181-213).
  const bool do_obj = is_do && t_occ;
  int damage = 1;
  if (inv[I_WOOD_SWORD] > 0) damage = max(damage, 2);
  if (inv[I_STONE_SWORD] > 0) damage = max(damage, 3);
  if (inv[I_IRON_SWORD] > 0) damage = max(damage, 5);
  const bool eat_plant = do_obj && ttype == E_PLANT && taux > 300;
  if (eat_plant) A[t_idx] = 0;
  const bool hit_mob = do_obj && (ttype == E_ZOMBIE || ttype == E_SKELETON ||
                                  ttype == E_COW);
  const int hp_after = max(0, thp - damage);
  if (hit_mob) Hp[t_idx] = (uint8_t)hp_after;
  const bool killed = hit_mob && hp_after <= 0;
  const bool eat_cow = killed && ttype == E_COW;
  inv[I_FOOD] += (eat_plant ? 4 : 0) + (eat_cow ? 6 : 0);
  if (eat_plant) ach[ACH_EAT_PLANT] += 1;
  if (eat_cow) ach[ACH_EAT_COW] += 1;
  if (killed && ttype == E_ZOMBIE) ach[ACH_DEFEAT_ZOMBIE] += 1;
  if (killed && ttype == E_SKELETON) ach[ACH_DEFEAT_SKELETON] += 1;

  // Do on a material (objects.py:214-229).
  const bool do_mat = is_do && !t_occ;
  const bool drink_water = do_mat && tmat == MAT_WATER;
  const bool can_collect = do_mat && ((R[OFF_COLLECTIBLE] >> tmat) & 1) &&
                           req_ok(R + OFF_COLLECT_REQ + tmat * kItems, inv);
  if (can_collect) M[t_idx] = (uint8_t)R[OFF_COLLECT_LEAVES + tmat];
  const float prob = __int_as_float(R[OFF_COLLECT_PROB + tmat]);
  if (can_collect && u24(fmix(seed)) <= prob) {
    for (int j = 0; j < kItems; ++j)
      inv[j] += R[OFF_COLLECT_RECV + tmat * kItems + j];
    const int cach = R[OFF_COLLECT_ACH + tmat];
    if (cach >= 0) ach[cach] += 1;
  }

  // Sleep (objects.py:117-119).
  if (is_sleep && inv[I_ENERGY] < energy_max) sleeping = true;

  // Place (objects.py:231-249).
  const int pidx = min(max(action - 7, 0), 3);
  const bool place_ok = is_place && !t_occ &&
                        ((R[OFF_PLACE_WHERE + pidx] >> tmat) & 1) &&
                        req_ok(R + OFF_PLACE_USES + pidx * kItems, inv);
  bool plant_spawn = false;
  if (place_ok) {
    for (int j = 0; j < kItems; ++j)
      inv[j] -= R[OFF_PLACE_USES + pidx * kItems + j];
    if (R[OFF_PLACE_ISMAT + pidx])
      M[t_idx] = (uint8_t)R[OFF_PLACE_MAT + pidx];
    else
      plant_spawn = true;
    ach[R[OFF_PLACE_ACH + pidx]] += 1;
  }

  // Make (objects.py:251-261): 3x3 nearby window, empty at the x==0 or
  // y==0 edge (engine.py:95-103).
  if (is_make) {
    const int midx = min(max(action - 11, 0), 5);
    int present = 0;
    if (px0 >= 1 && py0 >= 1) {
      for (int wx = px0 - 1; wx <= px0 + 1; ++wx)
        for (int wy = py0 - 1; wy <= py0 + 1; ++wy)
          if (wx < w && wy < h) present |= 1 << M[wx * h + wy];
    }
    if ((R[OFF_MAKE_NEED + midx] & ~present) == 0 &&
        req_ok(R + OFF_MAKE_USES + midx * kItems, inv)) {
      for (int j = 0; j < kItems; ++j)
        inv[j] -= R[OFF_MAKE_USES + midx * kItems + j];
      inv[R[OFF_MAKE_ITEM + midx]] += R[OFF_MAKE_COUNT + midx];
      ach[R[OFF_MAKE_ACH + midx]] += 1;
    }
  }

  // Life stats in half units (objects.py:133-151).
  int hunger = eat_cow ? 0 : S.hunger;
  int thirst = drink_water ? 0 : S.thirst;
  int fatigue = S.fatigue, recover = S.recover;
  hunger += sleeping ? 1 : 2;
  if (hunger > 50) { hunger = 0; inv[I_FOOD] -= 1; }
  thirst += sleeping ? 1 : 2;
  if (thirst > 40) { thirst = 0; inv[I_DRINK] -= 1; }
  fatigue = sleeping ? min(fatigue - 2, 0) : fatigue + 2;
  const bool gain_e = fatigue < -20, lose_e = fatigue > 60;
  if (gain_e || lose_e) fatigue = 0;
  inv[I_ENERGY] += (gain_e ? 1 : 0) - (lose_e ? 1 : 0);

  // Health regen / degen (objects.py:153-167).
  const bool nec = inv[I_FOOD] > 0 && inv[I_DRINK] > 0 &&
                   (inv[I_ENERGY] > 0 || sleeping);
  recover += nec ? (sleeping ? 4 : 2) : (sleeping ? -1 : -2);
  const bool regen = recover > 50, degen = recover < -30;
  if (regen || degen) recover = 0;
  inv[I_HEALTH] = max(0, inv[I_HEALTH] + (regen ? 1 : 0) - (degen ? 1 : 0));

  // Clamp, then wake on hurt (objects.py:126-131, :169-172).
  for (int j = 0; j < kItems; ++j)
    inv[j] = min(max(inv[j], 0), R[OFF_ITEM_MAX + j]);
  const int hp = inv[I_HEALTH];
  if (hp < S.last_health) sleeping = false;

  S.px = px;
  S.py = py;
  S.facing = facing;
  S.sleeping = sleeping ? 1 : 0;
  S.hunger = hunger;
  S.thirst = thirst;
  S.fatigue = fatigue;
  S.recover = recover;
  S.last_health = hp;
  S.plant_idx = plant_spawn ? t_idx : -1;
}

// The env's working set in shared memory.
struct Planes {
  int* A;        // aux counters, int32 as in the JAX kernel
  int* FL;       // per-cell flags of the mob phase
  int* PK;       // packed movement claim words
  uint8_t *M, *T, *Hs, *F;
  uint8_t* B8;   // per-pass byte scratch (impacts, winners)
  uint8_t* OCC;  // occupancy OR of the group's earlier ticks
};

inline size_t smem_bytes(int C) {
  return sizeof(Scalars) + RULES_PADDED * sizeof(int) +
         3 * (size_t)C * sizeof(int) + 6 * (size_t)C;
}

// Carve the block's shared memory, load the rules, the env's planes and its
// record; ends with a barrier.
__device__ Planes load_env(unsigned char* smem, Scalars*& S, int*& R,
                           const uint8_t* mat_in, const uint8_t* et_in,
                           const uint8_t* hp_in, const int16_t* aux_in,
                           const uint8_t* fac_in, const int32_t* rec_in,
                           const int32_t* rules, int env, int C) {
  const int tid = threadIdx.x, nt = blockDim.x;
  S = reinterpret_cast<Scalars*>(smem);
  R = reinterpret_cast<int*>(smem + sizeof(Scalars));
  Planes P;
  P.A = R + RULES_PADDED;
  P.FL = P.A + C;
  P.PK = P.FL + C;
  P.M = reinterpret_cast<uint8_t*>(P.PK + C);
  P.T = P.M + C;
  P.Hs = P.T + C;
  P.F = P.Hs + C;
  P.B8 = P.F + C;
  P.OCC = P.B8 + C;
  const size_t off = (size_t)env * C;
  for (int i = tid; i < RULES_WORDS; i += nt) R[i] = rules[i];
  for (int c = tid; c < C; c += nt) {
    P.M[c] = mat_in[off + c];
    P.T[c] = et_in[off + c];
    P.Hs[c] = hp_in[off + c];
    P.A[c] = aux_in[off + c];
    P.F[c] = fac_in[off + c];
    P.OCC[c] = 0;
  }
  if (tid == 0) {
    const int32_t* r = rec_in + (size_t)env * kRec;
    S->facing = r[R_FACING]; S->px = r[R_PX]; S->py = r[R_PY];
    S->sleeping = r[R_SLEEP]; S->hunger = r[R_HUNGER];
    S->thirst = r[R_THIRST]; S->fatigue = r[R_FATIGUE];
    S->recover = r[R_RECOVER]; S->last_health = r[R_LASTH];
    S->step = r[R_STEP]; S->elh = r[R_ELH];
    S->k0 = (uint32_t)r[R_K0]; S->k1 = (uint32_t)r[R_K1];
    for (int j = 0; j < kItems; ++j) S->inv[j] = r[kRecScalars + j];
    for (int j = 0; j < kAch; ++j) {
      S->ach[j] = r[kRecScalars + kItems + j];
      S->unl[j] = r[kRecScalars + kItems + kAch + j];
    }
  }
  __syncthreads();
  return P;
}

// Write the env's planes and its record back; the caller has put a barrier
// after the last write to them.  occ_out may be null.
__device__ void store_env(const Planes& P, const Scalars& S,
                          uint8_t* mat_out, uint8_t* et_out, uint8_t* hp_out,
                          int16_t* aux_out, uint8_t* fac_out,
                          uint8_t* occ_out, int32_t* rec_out, int env, int C,
                          int step_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t off = (size_t)env * C;
  for (int c = tid; c < C; c += nt) {
    mat_out[off + c] = P.M[c];
    et_out[off + c] = P.T[c];
    hp_out[off + c] = P.Hs[c];
    aux_out[off + c] = (int16_t)P.A[c];
    fac_out[off + c] = P.F[c];
    if (occ_out != nullptr) occ_out[off + c] = P.OCC[c];
  }
  if (tid == 0) {
    int32_t* r = rec_out + (size_t)env * kRec;
    r[R_FACING] = S.facing; r[R_PX] = S.px; r[R_PY] = S.py;
    r[R_SLEEP] = S.sleeping; r[R_HUNGER] = S.hunger; r[R_THIRST] = S.thirst;
    r[R_FATIGUE] = S.fatigue; r[R_RECOVER] = S.recover;
    r[R_LASTH] = S.last_health; r[R_STEP] = step_out; r[R_ELH] = S.elh;
    r[R_K0] = (int32_t)S.k0; r[R_K1] = (int32_t)S.k1;
    for (int j = 0; j < kItems; ++j) r[kRecScalars + j] = S.inv[j];
    for (int j = 0; j < kAch; ++j) {
      r[kRecScalars + kItems + j] = S.ach[j];
      r[kRecScalars + kItems + kAch + j] = S.unl[j];
    }
  }
}

// All non-player entities for one tick (step.py:_mob_core), run by every
// thread of the block after the player phase and a barrier.  S.s_mob is the
// tick's mob seed; the player's damage is left in S.player_dmg + S.zdmg.
// mark_occ: OR the post-tick occupancy into OCC.  snap: where to write the
// tick's packed render plane of this env, or null.  Ends with a barrier.
__device__ void mob_phase(Scalars& S, const Planes& P, const int* R, int w,
                          int h, int upd, bool mark_occ,
                          uint8_t* __restrict__ snap) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int C = w * h;
  int* const A = P.A;
  int* const FL = P.FL;
  int* const PK = P.PK;
  uint8_t* const M = P.M;
  uint8_t* const T = P.T;
  uint8_t* const Hs = P.Hs;
  uint8_t* const F = P.F;
  uint8_t* const B8 = P.B8;
  uint8_t* const OCC = P.OCC;
  const int walk_mob = R[OFF_WALK_MOB], walk_arrow = R[OFF_WALK_ARROW];
  const int px = S.px, py = S.py, plant = S.plant_idx;
  const bool slp = S.sleeping != 0;
  const uint32_t sm = S.s_mob;

  // --- pass 1: every entity decides against the post-player state.
  for (int c = tid; c < C; c += nt) {
    const int x = c / h, y = c - x * h;
    const int Tc = T[c];
    const int offx = px - x, offy = py - y;
    const int ax = abs(offx), ay = abs(offy);
    const int pdist = ax + ay;
    const bool is_cow = Tc == E_COW, is_zom = Tc == E_ZOMBIE;
    const bool is_skel = Tc == E_SKELETON, is_arrow = Tc == E_ARROW;
    const bool active = Tc > E_PLAYER && pdist < upd;
    const bool dying = active && Hs[c] <= 0 && (is_cow || is_zom || is_skel);
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
        const int tc = c + kDX[pdir] * h + kDY[pdir];
        tmat = M[tc];
        tocc = T[tc] > 0 || tc == plant;
      } else {
        tmat = 0;
        tocc = false;
      }
    } else {
      inside = true;
      tmat = M[c];
      tocc = Tc > 0 || c == plant;
    }
    const bool walk_arrow_t = (walk_arrow >> tmat) & 1;
    const bool arrow_live = is_arrow && active;
    const bool a_hit = arrow_live && tocc;
    const bool a_block = arrow_live && !a_hit && !walk_arrow_t;
    const bool smash_src =
        a_block && (tmat == MAT_TABLE || tmat == MAT_FURNACE);
    const bool a_fly = arrow_live && !a_hit && !a_block;
    const bool wants = active && !dying && (wants_kind || a_fly);
    const bool walk_ok =
        is_arrow ? walk_arrow_t : (((walk_mob >> tmat) & 1) != 0);
    const bool feasible = inside && walk_ok && !tocc;
    const bool valid = wants && feasible && moving;
    FL[c] = (active ? FL_ACTIVE : 0) | (dying ? FL_DYING : 0) |
            (valid ? FL_VALID : 0) | (pdir << 3) |
            (feasible ? FL_FEASIBLE : 0) | (retreat ? FL_RETREAT : 0) |
            (c_shoot ? FL_CSHOOT : 0) | (a_hit ? FL_AHIT : 0) |
            (a_block ? FL_ABLOCK : 0) | (Tc << 10);
    B8[c] = (a_hit ? 1 : 0) | (smash_src ? 2 : 0);
  }
  __syncthreads();

  // --- pass 2: arrow impacts land, plants grow, skeletons reload, and
  // each cell packs the claim word its move would carry.
  for (int c = tid; c < C; c += nt) {
    const int x = c / h, y = c - x * h;
    const int fl = FL[c];
    const int Tc0 = (fl >> 10) & 7;
    int dmg = 0;
    bool smash = false;
    for (int d = 0; d < 4; ++d) {
      const int sx = x - kDX[d], sy = y - kDY[d];
      if (sx < 0 || sx >= w || sy < 0 || sy >= h) continue;
      const int s = sx * h + sy;
      if (F[s] == d) {
        dmg += 2 * (B8[s] & 1);
        smash = smash || (B8[s] & 2);
      }
    }
    if (x == px && y == py) S.player_dmg = dmg;
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
    PK[c] = Tc0 | ((F[c] & 3) << 3) | (Hc << 5) | ((Ac & 15) << 13) |
            (((fl >> 3) & 3) << 17) | ((fl & FL_VALID) ? (1 << 19) : 0);
    if (reload == 0) FL[c] = fl | FL_RELOAD0;
  }
  __syncthreads();

  // --- pass 3: each target takes the first valid claim in direction
  // order (B8 = winning direction + 1).
  for (int c = tid; c < C; c += nt) {
    const int x = c / h, y = c - x * h;
    int win = 0;
    for (int d = 0; d < 4 && !win; ++d) {
      const int sx = x - kDX[d], sy = y - kDY[d];
      if (sx < 0 || sx >= w || sy < 0 || sy >= h) continue;
      const int pd = PK[sx * h + sy];
      if (((pd >> 19) & 1) && ((pd >> 17) & 3) == d) win = d + 1;
    }
    B8[c] = (uint8_t)win;
  }
  __syncthreads();

  // --- pass 4: moves land, movers vacate, skeletons decide to shoot,
  // zombies strike.
  for (int c = tid; c < C; c += nt) {
    const int x = c / h, y = c - x * h;
    int fl = FL[c];
    const int Tc0 = (fl >> 10) & 7;
    int T1 = T[c], F1 = F[c], H1 = Hs[c], A1 = A[c];
    const int win = B8[c];
    if (win) {
      const int d = win - 1;
      const int pk = PK[(x - kDX[d]) * h + (y - kDY[d])];
      T1 = pk & 7;
      F1 = (pk >> 3) & 3;
      H1 = (pk >> 5) & 255;
      A1 = (pk >> 13) & 15;
    }
    bool success = false;
    if (fl & FL_VALID) {
      const int pdir = (fl >> 3) & 3;
      success = B8[(x + kDX[pdir]) * h + (y + kDY[pdir])] == pdir + 1;
    }
    if (success) T1 = 0;
    const bool dying = fl & FL_DYING, retreat = fl & FL_RETREAT;
    const bool s_moved = (dying && retreat && (fl & FL_FEASIBLE)) ||
                         (!dying && retreat && success);
    const bool shoot = (fl & FL_ACTIVE) && Tc0 == E_SKELETON && !s_moved &&
                       (fl & FL_CSHOOT) && (fl & FL_RELOAD0);
    int sdir = -1;
    if (shoot) {
      const int offx = px - x, offy = py - y;
      const bool x_longer = abs(offx) > abs(offy);
      const int shvx = x_longer ? sgn(offx) : 0;
      const int shvy = x_longer ? 0 : sgn(offy);
      sdir = shvx == -1 ? 0
                        : (shvx == 1 ? 1
                                     : (shvy == -1 ? 2 : (shvy == 1 ? 3 : -1)));
    }
    const int pdist = abs(px - x) + abs(py - y);
    const bool z_adj = T1 == E_ZOMBIE && pdist <= 1;
    const bool z_att = z_adj && A1 == 0;
    if (z_adj) A1 = z_att ? 5 : A1 - 1;
    if (z_att) atomicAdd(&S.zdmg, slp ? 7 : 2);
    const bool hostile = T1 == E_COW || T1 == E_ZOMBIE || T1 == E_SKELETON;
    T[c] = (uint8_t)T1;
    F[c] = (uint8_t)F1;
    Hs[c] = (uint8_t)H1;
    A[c] = A1;
    FL[c] = fl | (hostile ? FL_HOSTILE : 0) | ((sdir + 1) << 15);
  }
  __syncthreads();

  // --- pass 5: plants take damage from hostile neighbours; removals;
  // the pending plant materializes.
  for (int c = tid; c < C; c += nt) {
    const int x = c / h, y = c - x * h;
    const int fl = FL[c];
    const bool plant0 = (fl & FL_ACTIVE) && ((fl >> 10) & 7) == E_PLANT;
    int T1 = T[c], H1 = Hs[c], A1 = A[c];
    bool nbr_hostile = false;
    for (int d = 0; d < 4; ++d) {
      const int sx = x - kDX[d], sy = y - kDY[d];
      if (sx < 0 || sx >= w || sy < 0 || sy >= h) continue;
      nbr_hostile = nbr_hostile || (FL[sx * h + sy] & FL_HOSTILE);
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
  for (int c = tid; c < C; c += nt) {
    const int x = c / h, y = c - x * h;
    int win = 0;
    if (T[c] == 0 && c != plant && ((walk_arrow >> M[c]) & 1)) {
      for (int d = 0; d < 4 && !win; ++d) {
        const int sx = x - kDX[d], sy = y - kDY[d];
        if (sx < 0 || sx >= w || sy < 0 || sy >= h) continue;
        if (((FL[sx * h + sy] >> 15) & 7) == d + 1) {
          T[c] = E_ARROW;
          Hs[c] = 0;
          A[c] = 0;
          F[c] = (uint8_t)d;
          win = d + 1;
        }
      }
    }
    B8[c] = (uint8_t)win;
  }
  __syncthreads();

  // --- pass 7: shooters whose arrow landed reload; occupancy OR; the
  // cell's snapshot byte.
  for (int c = tid; c < C; c += nt) {
    const int x = c / h, y = c - x * h;
    const int sdir = ((FL[c] >> 15) & 7) - 1;
    if (sdir >= 0) {
      const int tx = x + kDX[sdir], ty = y + kDY[sdir];
      if (tx >= 0 && tx < w && ty >= 0 && ty < h &&
          B8[tx * h + ty] == sdir + 1)
        A[c] = 4;
    }
    if (mark_occ && T[c] != 0) OCC[c] = 1;
    if (snap != nullptr) {
      // The render.pack_cells encoding of this cell after the tick.
      const int Tc = T[c];
      const int ctex = Tc == E_PLAYER     ? 1
                       : Tc == E_COW      ? 6
                       : Tc == E_ZOMBIE   ? 7
                       : Tc == E_SKELETON ? 8
                       : Tc == E_ARROW    ? 9 + F[c]
                       : Tc == E_PLANT    ? 13 + (A[c] > 300 ? 1 : 0)
                                          : 0;
      snap[c] = (uint8_t)(M[c] | (ctex << 4));
    }
  }
  __syncthreads();
}

// The mob phase's damage lands on the player's health (objects.py:302-312).
__device__ __forceinline__ void apply_mob_damage(Scalars& S) {
  S.inv[I_HEALTH] = max(0, S.inv[I_HEALTH] - (S.player_dmg + S.zdmg));
}

__global__ void __launch_bounds__(kThreads) group_tick_kernel(
    const uint8_t* __restrict__ mat_in, const uint8_t* __restrict__ et_in,
    const uint8_t* __restrict__ hp_in, const int16_t* __restrict__ aux_in,
    const uint8_t* __restrict__ fac_in, const int32_t* __restrict__ actions,
    const int32_t* __restrict__ rec_in, const int32_t* __restrict__ rules,
    uint8_t* __restrict__ mat_out, uint8_t* __restrict__ et_out,
    uint8_t* __restrict__ hp_out, int16_t* __restrict__ aux_out,
    uint8_t* __restrict__ fac_out, uint8_t* __restrict__ occ_out,
    int32_t* __restrict__ rec_out, float* __restrict__ reward,
    uint8_t* __restrict__ done, uint8_t* __restrict__ dead,
    uint8_t* __restrict__ snap_packed, int32_t* __restrict__ snap_px,
    int32_t* __restrict__ snap_py, int32_t* __restrict__ snap_fac,
    int32_t* __restrict__ snap_slp, int32_t* __restrict__ snap_inv, int n,
    int k, int w, int h, int length, int upd) {
  extern __shared__ __align__(16) unsigned char crafter_smem[];
  const int env = blockIdx.x;
  const int C = w * h;
  const int tid = threadIdx.x;
  Scalars* Sp;
  int* R;
  const Planes P = load_env(crafter_smem, Sp, R, mat_in, et_in, hp_in, aux_in,
                            fac_in, rec_in, rules, env, C);
  Scalars& S = *Sp;

  for (int t = 0; t < k; ++t) {
    // --- player phase (one thread) and the tick's seeds (_tick_seeds).
    if (tid == 0) {
      const uint32_t step_t = (uint32_t)(S.step + t + 1);
      const uint32_t base = fmix(S.k0 ^ fmix(S.k1 + step_t * 0x9E3779B9u));
      S.s_mob = fmix(base + 0x85EBCA6Bu);
      player_phase(S, P.M, P.T, P.Hs, P.A, R, actions[(size_t)t * n + env],
                   base, w, h);
      S.player_dmg = 0;
      S.zdmg = 0;
    }
    __syncthreads();
    // Snapshots of ticks 0..K-2, tick-major (row K-1 is the caller's).
    const bool snap_t = snap_packed != nullptr && t < k - 1;
    const size_t row = (size_t)t * n + env;
    mob_phase(S, P, R, w, h, upd, t < k - 1,
              snap_t ? snap_packed + row * C : nullptr);

    // --- reward / done / dead (the non-balance part of _finish_tick).
    if (tid == 0) {
      apply_mob_damage(S);
      const int hp = S.inv[I_HEALTH];
      bool new_unlock = false;
      for (int j = 0; j < kAch; ++j) {
        if (S.ach[j] > 0 && !S.unl[j]) new_unlock = true;
        if (S.ach[j] > 0) S.unl[j] = 1;
      }
      // (hp - elh) / 10 + bonus, fused as XLA fuses the reference.
      const float rew = fmaf((float)(hp - S.elh), 0.1f,
                             new_unlock ? 1.0f : 0.0f);
      S.elh = hp;
      const bool is_dead = hp <= 0;
      const int step_t = S.step + t + 1;
      reward[row] = rew;
      dead[row] = is_dead ? 1 : 0;
      done[row] = (is_dead || (length > 0 && step_t >= length)) ? 1 : 0;
      if (snap_t) {
        snap_px[row] = S.px;
        snap_py[row] = S.py;
        snap_fac[row] = S.facing;
        snap_slp[row] = S.sleeping;
        for (int j = 0; j < kItems; ++j) snap_inv[row * kItems + j] = S.inv[j];
      }
    }
  }
  __syncthreads();
  store_env(P, S, mat_out, et_out, hp_out, aux_out, fac_out, occ_out, rec_out,
            env, C, S.step + k);
}

// One tick of player phase + mob phase with the tick's two seeds given
// (step.py:_tick_pallas): no reward / done / unlocked bookkeeping; the
// record's step, reward memory, key words and unlocked flags pass through.
__global__ void __launch_bounds__(kThreads) tick_kernel(
    const uint8_t* __restrict__ mat_in, const uint8_t* __restrict__ et_in,
    const uint8_t* __restrict__ hp_in, const int16_t* __restrict__ aux_in,
    const uint8_t* __restrict__ fac_in, const int32_t* __restrict__ actions,
    const int32_t* __restrict__ s_player, const int32_t* __restrict__ s_mob,
    const int32_t* __restrict__ rec_in, const int32_t* __restrict__ rules,
    uint8_t* __restrict__ mat_out, uint8_t* __restrict__ et_out,
    uint8_t* __restrict__ hp_out, int16_t* __restrict__ aux_out,
    uint8_t* __restrict__ fac_out, int32_t* __restrict__ rec_out, int w,
    int h, int upd) {
  extern __shared__ __align__(16) unsigned char crafter_smem[];
  const int env = blockIdx.x;
  const int C = w * h;
  Scalars* Sp;
  int* R;
  const Planes P = load_env(crafter_smem, Sp, R, mat_in, et_in, hp_in, aux_in,
                            fac_in, rec_in, rules, env, C);
  Scalars& S = *Sp;
  if (threadIdx.x == 0) {
    S.s_mob = (uint32_t)s_mob[env];
    player_phase(S, P.M, P.T, P.Hs, P.A, R, actions[env],
                 (uint32_t)s_player[env], w, h);
    S.player_dmg = 0;
    S.zdmg = 0;
  }
  __syncthreads();
  mob_phase(S, P, R, w, h, upd, false, nullptr);
  if (threadIdx.x == 0) apply_mob_damage(S);
  __syncthreads();
  store_env(P, S, mat_out, et_out, hp_out, aux_out, fac_out, nullptr, rec_out,
            env, C, S.step);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// The snap_* pointers are all null (no snapshots) or all set: snap_packed
// (K, N, C) uint8 of which rows 0..K-2 are written, snap_px / py / fac /
// slp (K-1, N) int32, snap_inv (K-1, N, 16) int32.
extern "C" int crafter_group_tick(
    const uint8_t* mat, const uint8_t* et, const uint8_t* hp,
    const int16_t* aux, const uint8_t* fac, const int32_t* actions,
    const int32_t* rec_in, const int32_t* rules, uint8_t* mat_out,
    uint8_t* et_out, uint8_t* hp_out, int16_t* aux_out, uint8_t* fac_out,
    uint8_t* occ_out, int32_t* rec_out, float* reward, uint8_t* done,
    uint8_t* dead, uint8_t* snap_packed, int32_t* snap_px, int32_t* snap_py,
    int32_t* snap_fac, int32_t* snap_slp, int32_t* snap_inv, int n, int k,
    int w, int h, int length, int upd, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = smem_bytes(w * h);
  cudaError_t err = allow_smem(group_tick_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  group_tick_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      mat, et, hp, aux, fac, actions, rec_in, rules, mat_out, et_out, hp_out,
      aux_out, fac_out, occ_out, rec_out, reward, done, dead, snap_packed,
      snap_px, snap_py, snap_fac, snap_slp, snap_inv, n, k, w, h, length,
      upd);
  return (int)cudaGetLastError();
}

extern "C" int crafter_tick(
    const uint8_t* mat, const uint8_t* et, const uint8_t* hp,
    const int16_t* aux, const uint8_t* fac, const int32_t* actions,
    const int32_t* s_player, const int32_t* s_mob, const int32_t* rec_in,
    const int32_t* rules, uint8_t* mat_out, uint8_t* et_out, uint8_t* hp_out,
    int16_t* aux_out, uint8_t* fac_out, int32_t* rec_out, int n, int w, int h,
    int upd, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = smem_bytes(w * h);
  cudaError_t err = allow_smem(tick_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tick_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      mat, et, hp, aux, fac, actions, s_player, s_mob, rec_in, rules, mat_out,
      et_out, hp_out, aux_out, fac_out, rec_out, w, h, upd);
  return (int)cudaGetLastError();
}
