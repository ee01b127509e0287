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
// roll_stages_plain bit for bit.
//
// Bound on the H100: bytes (one read and one write of the rows) for a
// handful of stages; every stage adds a shared-memory round trip.  Design:
// one block per row, 1024 threads of four elements each, the row in
// registers between stages.  A rotate has no register form across a block,
// so a roll stage stores the row to shared memory, meets at a barrier and
// reads at the rotated index; two 16 KB buffers alternate, so one barrier a
// stage is enough (the barrier of stage k + 1 separates the reads of stage
// k from the writes of stage k + 2).  Consecutive threads hold consecutive
// elements, so global and shared accesses are coalesced and free of bank
// conflicts at any shift.  The control stage stays in registers.
#include "common.cuh"

namespace {

constexpr int kCols = 4096;
constexpr int kThreads = 1024;
constexpr int kPer = kCols / kThreads;

__global__ void __launch_bounds__(kThreads)
roll_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
            int kind, int stages) {
  __shared__ int32_t buf[2][kCols];
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const int32_t* src = x + row * kCols;
  uint32_t v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) v[e] = (uint32_t)src[t + e * kThreads];
  for (int k = 0; k < stages; ++k) {
    const int b = k % 12;
    if (kind == 0) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int j = t + e * kThreads;
        if ((j >> b) & 1) v[e] = v[e] * 3u + (uint32_t)k;
      }
    } else {
      int32_t* cur = buf[k & 1];
#pragma unroll
      for (int e = 0; e < kPer; ++e) cur[t + e * kThreads] = (int32_t)v[e];
      __syncthreads();
      const int shift = kind == 1 ? (1 << b) : 1;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int j = t + e * kThreads;
        if ((j >> b) & 1) v[e] = (uint32_t)cur[(j + shift) & (kCols - 1)];
      }
    }
  }
  int32_t* dst = out + row * kCols;
#pragma unroll
  for (int e = 0; e < kPer; ++e) dst[t + e * kThreads] = (int32_t)v[e];
}

}  // namespace

// x, out: (n, 4096) int32, contiguous.  kind: 0 'ctl', 1 'roll', 2 'roll1'.
extern "C" int crafter_roll(const int32_t* x, int32_t* out, long long n,
                            int kind, int stages, void* stream) {
  if (n <= 0) return 0;
  roll_kernel<<<(unsigned)n, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, kind, stages);
  return (int)cudaGetLastError();
}
