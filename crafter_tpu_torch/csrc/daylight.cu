// The day/night curve of a batch of steps (state.py:daylight) in one
// launch, one thread a step: the plain form is a chain of some sixty
// elementwise launches (the float64 cosine of ops/fma.py:cos32 among
// them), which the per-tick paths would pay every tick.  No TPU kernel
// computes it; XLA fuses the JAX function.  Bit for bit the plain form
// (common.cuh:daylight32).
#include "common.cuh"

namespace {

__global__ void daylight_kernel(const int32_t* __restrict__ step,
                                long long stride, int n, float inv_day,
                                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = crafter::daylight32(step[i * stride], inv_day);
}

}  // namespace

extern "C" int crafter_daylight(const int32_t* step, long long stride, int n,
                                float inv_day, float* out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  daylight_kernel<<<(n + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(step, stride, n, inv_day, out);
  return (int)cudaGetLastError();
}
