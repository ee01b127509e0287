// Roll-and-select stages over int32 rows against an arithmetic control: the
// micro-bench kernel.
//
// Replaces the TPU kernel of tools/bench_roll.py:make, which measured what
// a cross-lane rotate costs inside a kernel on that machine.  On (n, 4096)
// int32 rows it applies R stages k = 0..R-1, b = k % 12:
//   x[j] = bit b of j set ? f_k(x)[j] : x[j]
// with f_k(x)[j] = x[(j + (1 << b)) mod 4096]   (kind 1, 'roll')
//                = x[(j + 1) mod 4096]          (kind 2, 'roll1')
//                = x[j] * 3 + k, wrapping       (kind 0, 'ctl').
// Computes the plain twin crafter_tpu_torch/ops/roll_cuda.py:
// roll_stages_plain bit for bit.  Every stage is its own rotate and select.
//
// Bound on the H100: bytes, one read and one write of the rows (0.4006 ms
// at 40960 rows); every rotate stage adds an exchange through shared
// memory, which has to hide under the stream of rows.
//
// Design: persistent blocks fed by Hopper's bulk copy.
//  * The grid is the SMs times the blocks that fit an SM; block g walks
//    rows g, g + grid, g + 2 grid, ...
//  * Rows stream in by the 1-D bulk copy (cp.async.bulk, no tensor map)
//    into a ring of kDepth row buffers, each with an mbarrier that expects
//    the row's 16 KB.  Once every thread has read row i out of its buffer
//    (the row's first barrier), thread 0 refills the buffer with row
//    i + kDepth: while the block runs row i's stages, the next rows are in
//    flight.  The use count of a buffer gives the parity to wait on.
//  * The row lives in registers between stages: thread t of 256 holds
//    elements j = t + 256 e, e = 0..15, so loads from the ring and the
//    stores to global memory are coalesced and free of bank conflicts.
//    A rotate by 256 << m moves e by 2^m inside a thread: 'roll' stages
//    with b >= 8 are register moves, with no shared memory and no barrier.
//  * A 'roll' stage with s = 2^b < 256: element j with bit b set reads
//    j + s, whose bit b is clear and which the stage leaves unchanged.  So
//    only the threads whose bit b is clear write their 16 values, into a
//    half-row buffer with a slot for each of them, one barrier, and the
//    threads whose bit b is set read their source thread's slot (rotated
//    by one element where j + s wraps past the row's end).  Values go in
//    and out 16 bytes at a time, consecutive slots in consecutive 16-byte
//    words: where only half the lanes of a warp write or read (b < 5),
//    four values an access take fewer shared-memory wavefronts than one.
//    Shuffles would not pay: the carry of j + s crosses warps at every
//    shift.
//  * 'roll1' (s = 1): its sources include positions the stage changes, so
//    every thread writes its values into a full-row buffer, one barrier,
//    and the changed positions read.  'ctl' stays in registers.
//  * Two exchange buffers alternate: the barrier of the next exchange
//    separates one exchange's reads from the writes of the one after.
//  * Results leave from registers as coalesced streaming stores (evict
//    first), nothing staged.
#include "common.cuh"

namespace {

constexpr int kCols = 4096;
constexpr int kThreads = 256;
constexpr int kPer = kCols / kThreads;   // 16 elements a thread
constexpr int kDepth = 2;                // row buffers in the ring
constexpr uint32_t kRowBytes = kCols * 4;

// Words of one exchange buffer: none for 'ctl', half a row for 'roll', a
// row for 'roll1'.
__host__ __device__ constexpr int exchange_words(int kind) {
  return kind == 1 ? kCols / 2 : kind == 2 ? kCols : 0;
}

// The ring, two exchange buffers, then the ring's mbarriers.
__host__ __device__ constexpr size_t smem_bytes(int kind) {
  return (size_t)kDepth * kRowBytes + 2 * (size_t)exchange_words(kind) * 4 +
         kDepth * sizeof(uint64_t);
}

// Hopper's bulk copy and mbarriers, in PTX.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: arm `bar` for a row's bytes and copy the row into `dst`.
// The proxy fence orders the block's earlier reads of `dst` (ordered
// before this thread by a barrier) before the copy's writes.
__device__ __forceinline__ void load_row(int32_t* dst, const int32_t* src,
                                         uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(kRowBytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(kRowBytes), "r"(smem_u32(bar))
      : "memory");
}

// Whether stage bit B selects element t + 256 e.
template <int B>
__device__ __forceinline__ bool selected(int t, int e) {
  if constexpr (B < 8) {
    return (t >> B) & 1;
  } else {
    return (e >> (B - 8)) & 1;
  }
}

template <int B>
__device__ __forceinline__ void ctl_stage(uint32_t (&v)[kPer], int t,
                                          uint32_t k) {
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (selected<B>(t, e)) v[e] = v[e] * 3u + k;
}

// A thread's 16 values to or from an exchange buffer of `slots` threads,
// 16 bytes at a time: value e of slot c is word 4 (slots (e / 4) + c) +
// e % 4, so consecutive slots are consecutive 16-byte words.
__device__ __forceinline__ void put16(int32_t* xb, int slots, int c,
                                      const uint32_t (&v)[kPer]) {
  uint4* p = reinterpret_cast<uint4*>(xb) + c;
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q)
    p[q * slots] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                              v[4 * q + 3]);
}

// Slot c's values, rotated by `wrap` (0 or 1) elements.
__device__ __forceinline__ void get16(const int32_t* xb, int slots, int c,
                                      int wrap, uint32_t (&w)[kPer]) {
  const uint4* p = reinterpret_cast<const uint4*>(xb) + c;
  uint32_t u[kPer];
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    const uint4 a = p[q * slots];
    u[4 * q] = a.x;
    u[4 * q + 1] = a.y;
    u[4 * q + 2] = a.z;
    u[4 * q + 3] = a.w;
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) w[e] = wrap ? u[(e + 1) & (kPer - 1)] : u[e];
}

// 'roll' with shift 2^B.
template <int B, typename Sync>
__device__ __forceinline__ void roll_stage(uint32_t (&v)[kPer], int32_t* xb,
                                           int t, Sync& sync) {
  if constexpr (B >= 8) {
    constexpr int m = 1 << (B - 8);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (e & m) v[e] = v[(e + m) & (kPer - 1)];
  } else {
    constexpr int s = 1 << B;
    // Thread u's slot among the threads whose bit B is clear.
    auto half = [](int u) { return ((u >> (B + 1)) << B) | (u & (s - 1)); };
    if (!((t >> B) & 1)) put16(xb, kThreads / 2, half(t), v);
    sync();
    if ((t >> B) & 1) {
      const int u = t + s;   // the source's thread, with the carry
      // u >> 8 = 1: the source of element e is element e + 1.
      get16(xb, kThreads / 2, half(u & (kThreads - 1)), u >> 8, v);
    }
  }
}

// 'roll1': shift 1.
template <int B, typename Sync>
__device__ __forceinline__ void roll1_stage(uint32_t (&v)[kPer], int32_t* xb,
                                            int t, Sync& sync) {
  put16(xb, kThreads, t, v);
  sync();
  const int u = t + 1;
  uint32_t w[kPer];
  get16(xb, kThreads, u & (kThreads - 1), u >> 8, w);
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (selected<B>(t, e)) v[e] = w[e];
}

template <int KIND, int B, typename Sync>
__device__ __forceinline__ void stage_b(uint32_t (&v)[kPer], int32_t* xb,
                                        int t, uint32_t k, Sync& sync) {
  if constexpr (KIND == 0) {
    ctl_stage<B>(v, t, k);
  } else if constexpr (KIND == 1) {
    roll_stage<B>(v, xb, t, sync);
  } else {
    roll1_stage<B>(v, xb, t, sync);
  }
}

// Stage k (b = k % 12, a branch on the block-uniform b: the register
// indices of each case are constants).
template <int KIND, typename Sync>
__device__ __forceinline__ void stage(int b, uint32_t (&v)[kPer], int32_t* xb,
                                      int t, uint32_t k, Sync& sync) {
  switch (b) {
    case 0: stage_b<KIND, 0>(v, xb, t, k, sync); break;
    case 1: stage_b<KIND, 1>(v, xb, t, k, sync); break;
    case 2: stage_b<KIND, 2>(v, xb, t, k, sync); break;
    case 3: stage_b<KIND, 3>(v, xb, t, k, sync); break;
    case 4: stage_b<KIND, 4>(v, xb, t, k, sync); break;
    case 5: stage_b<KIND, 5>(v, xb, t, k, sync); break;
    case 6: stage_b<KIND, 6>(v, xb, t, k, sync); break;
    case 7: stage_b<KIND, 7>(v, xb, t, k, sync); break;
    case 8: stage_b<KIND, 8>(v, xb, t, k, sync); break;
    case 9: stage_b<KIND, 9>(v, xb, t, k, sync); break;
    case 10: stage_b<KIND, 10>(v, xb, t, k, sync); break;
    default: stage_b<KIND, 11>(v, xb, t, k, sync); break;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, 4)
roll_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
            long long n, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int xw = exchange_words(KIND);
  int32_t* ring = reinterpret_cast<int32_t*>(smem);
  int32_t* xbuf = ring + kDepth * kCols;
  uint64_t* full = reinterpret_cast<uint64_t*>(xbuf + 2 * xw);
  const int t = threadIdx.x;
  const long long grid = gridDim.x;

  if (t == 0) {
    for (int d = 0; d < kDepth; ++d) mbar_init(&full[d]);
    fence_mbar_init();
  }
  __syncthreads();
  if (t == 0) {
    for (int d = 0; d < kDepth; ++d) {
      const long long row = blockIdx.x + d * grid;
      if (row < n) load_row(ring + d * kCols, x + row * kCols, &full[d]);
    }
  }

  int exchanges = 0;   // picks the exchange buffer
  int i = 0;
  for (long long row = blockIdx.x; row < n; row += grid, ++i) {
    const int slot = i % kDepth;
    int32_t* buf = ring + slot * kCols;
    mbar_wait(&full[slot], (uint32_t)(i / kDepth) & 1u);
    uint32_t v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = (uint32_t)buf[t + e * kThreads];

    // The row's first barrier frees its buffer for the row kDepth ahead.
    bool held = true;
    const long long next = row + kDepth * grid;
    auto sync = [&]() {
      __syncthreads();
      if (held) {
        held = false;
        if (t == 0 && next < n)
          load_row(buf, x + next * kCols, &full[slot]);
      }
    };
    for (int k = 0; k < stages; ++k) {
      const int b = k % 12;
      stage<KIND>(b, v, xbuf + (exchanges & 1) * xw, t, (uint32_t)k, sync);
      if (KIND == 2 || (KIND == 1 && b < 8)) ++exchanges;
    }
    if (held) sync();

    // Streaming stores (evict first): nothing reads the output again here.
    int32_t* dst = out + row * kCols;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      __stcs(dst + t + e * kThreads, (int32_t)v[e]);
  }
}

template <int KIND>
cudaError_t occupancy(int* blocks) {
  static int cached = 0;
  if (cached > 0) {
    *blocks = cached;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      roll_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(KIND));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, roll_kernel<KIND>, kThreads, smem_bytes(KIND));
  if (err == cudaSuccess) cached = *blocks;
  return err;
}

cudaError_t blocks_per_sm(int kind, int* blocks) {
  return kind == 0 ? occupancy<0>(blocks)
                   : kind == 1 ? occupancy<1>(blocks) : occupancy<2>(blocks);
}

}  // namespace

// Resident blocks of 256 threads an SM, shared memory a block and the
// ring's depth in rows, for kind 0 'ctl', 1 'roll', 2 'roll1'.
extern "C" int crafter_roll_occupancy(int kind, int* blocks, int* smem,
                                      int* depth) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  *smem = (int)smem_bytes(kind);
  *depth = kDepth;
  return (int)blocks_per_sm(kind, blocks);
}

// x, out: (n, 4096) int32, contiguous, 16-byte aligned (the bulk copy's
// rule).  kind: 0 'ctl', 1 'roll', 2 'roll1'.
extern "C" int crafter_roll(const int32_t* x, int32_t* out, long long n,
                            int kind, int stages, void* stream) {
  if (n <= 0) return 0;
  if (kind < 0 || kind > 2 || ((uintptr_t)x & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  int blocks = 0, device = 0, sms = 0;
  cudaError_t err = blocks_per_sm(kind, &blocks);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const long long full = (long long)sms * blocks;
  const long long grid = n < full ? n : full;
  const size_t smem = smem_bytes(kind);
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    roll_kernel<0><<<(unsigned)grid, kThreads, smem, s>>>(x, out, n, stages);
  else if (kind == 1)
    roll_kernel<1><<<(unsigned)grid, kThreads, smem, s>>>(x, out, n, stages);
  else
    roll_kernel<2><<<(unsigned)grid, kThreads, smem, s>>>(x, out, n, stages);
  return (int)cudaGetLastError();
}
