// Threefry-2x32 (20 rounds) draws: split, fold_in, random bits and float32
// uniforms, each one launch.
//
// Replaces no TPU kernel: the JAX package draws through jax.random, which
// XLA fuses.  The plain twin is crafter_tpu_torch/prng.py:threefry2x32,
// eager int64 PyTorch masked to 32 bits: some 170 elementwise launches a
// draw, each reading and writing full int64 tensors.  Here the two words,
// the key schedule and the 20 rounds stay in uint32 registers and each
// output is written once; the rotations are funnel shifts.  Bit for bit the
// twin: the block is integer-only, and the uniform is the twin's
// reinterpretation of (bits >> 9 | 0x3F800000) minus 1.0f, which is exact.
//
// Keys are the int64 words (..., 2) the API uses, read with their strides
// (a key stride of 0 broadcasts one key).  A draw's counters are the flat
// indices of prng._counters, computed here from the geometry (outer,
// axis_len, inner, start, total): element j of a key's n draws has counter
// j + start * inner + (j / (axis_len * inner)) * (total - axis_len) * inner,
// truncated to 32 bits as the twin masks it; rows=None is start 0, total
// axis_len.  fold_in's counter is the key's data word instead.
//
// Bound on the H100: 32-bit integer issue.  A block is ~75 integer
// instructions (20 rounds of add, funnel shift and xor, five key injections
// of two three-input adds, the output's xor, shift and or), plus the index
// arithmetic, against 4 to 16 bytes written an output: at 64 integer lanes
// an SM a clock, a 5,120-world uniform plane of (4, 64, 64) (84 M draws)
// needs ~0.38 ms of issue and ~0.1 ms of writes.  Design: one thread an
// output element in a grid-stride loop over a grid sized from the element
// count (at most the resident blocks of every SM), so a 4096 x 2 split and
// a 5,120-world plane run the same code.
// A thread divides its first index once; later steps of the loop advance
// (key, element) by the stride's precomputed quotient and remainder.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

enum Mode { kPairs = 0, kBits = 1, kUniform = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// The Threefry-2x32 block of prng.threefry2x32 on uint32 words.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// Where a draw's counters come from.
enum Counter { kGeometry = 0, kOne = 1, kInt32 = 2, kInt64 = 3 };

struct Draw {
  const long long* keys;       // key k's words at keys[k * key_stride + w]
  long long key_stride, word_stride;
  int counter;                 // a Counter
  const void* data;            // kInt32 / kInt64: key k's counter
  long long data_stride;
  uint32_t one;                // kOne: every key's counter
  long long n;                 // draws a key (1 for fold_in)
  long long keys_n;            // keys
  long long axis_len, inner, start, total;   // kGeometry
};

template <int MODE>
__global__ void __launch_bounds__(kThreads) threefry_kernel(Draw d,
                                                            void* out) {
  const long long count = d.keys_n * d.n;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long step_k = stride / d.n, step_j = stride % d.n;
  long long k = i / d.n, j = i % d.n;
  const long long block = d.axis_len * d.inner;
  const long long skip = (d.total - d.axis_len) * d.inner;
  const long long base = d.start * d.inner;
  for (; i < count; i += stride) {
    const long long* key = d.keys + k * d.key_stride;
    const uint32_t k0 = (uint32_t)key[0];
    const uint32_t k1 = (uint32_t)key[d.word_stride];
    uint32_t ctr;
    if (d.counter == kGeometry) {
      // skip is 0 for a whole draw: no division.
      ctr = (uint32_t)(j + base + (skip != 0 ? (j / block) * skip : 0));
    } else if (d.counter == kOne) {
      ctr = d.one;
    } else if (d.counter == kInt32) {
      ctr = (uint32_t)static_cast<const int32_t*>(d.data)[k * d.data_stride];
    } else {
      ctr = (uint32_t)static_cast<const long long*>(d.data)[k * d.data_stride];
    }
    uint32_t x0 = 0, x1 = ctr;
    threefry(k0, k1, x0, x1);
    if (MODE == kPairs) {
      reinterpret_cast<longlong2*>(out)[i] =
          make_longlong2((long long)x0, (long long)x1);
    } else if (MODE == kBits) {
      static_cast<long long*>(out)[i] = (long long)(x0 ^ x1);
    } else {
      static_cast<float*>(out)[i] =
          __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
    }
    j += step_j;
    k += step_k;
    if (j >= d.n) {
      j -= d.n;
      ++k;
    }
  }
}

template <int MODE>
cudaError_t occupancy(int* blocks) {
  static int cached = 0;
  if (cached > 0) {
    *blocks = cached;
    return cudaSuccess;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, threefry_kernel<MODE>, kThreads, 0);
  if (err == cudaSuccess) cached = *blocks;
  return err;
}

cudaError_t blocks_per_sm(int mode, int* blocks) {
  return mode == kPairs  ? occupancy<kPairs>(blocks)
         : mode == kBits ? occupancy<kBits>(blocks)
                         : occupancy<kUniform>(blocks);
}

}  // namespace

// Resident blocks of 256 threads an SM for mode 0 (key pairs), 1 (bits),
// 2 (uniform).
extern "C" int crafter_threefry_occupancy(int mode, int* blocks) {
  if (mode < kPairs || mode > kUniform) return (int)cudaErrorInvalidValue;
  return (int)blocks_per_sm(mode, blocks);
}

// One draw.  keys: int64 words, key k at keys + k * key_stride, its second
// word word_stride further.  counter: 0 the geometry's counters (axis_len,
// inner, start, total), 1 the counter `one` for every key, 2 / 3 key k's
// int32 / int64 counter at data + k * data_stride (fold_in).  out: keys_n *
// n outputs, contiguous: int64 pairs (mode 0, 16-byte aligned), int64 bits
// (1) or float32 (2).
extern "C" int crafter_threefry(const long long* keys, long long key_stride,
                                long long word_stride, int counter,
                                const void* data, long long data_stride,
                                long long one, long long keys_n, long long n,
                                long long axis_len, long long inner,
                                long long start, long long total, int mode,
                                void* out, void* stream) {
  if (keys_n <= 0 || n <= 0) return 0;
  if (mode < kPairs || mode > kUniform || counter < kGeometry
      || counter > kInt64 || ((counter >= kInt32) != (data != nullptr))
      || axis_len <= 0 || inner <= 0 || start < 0 || total < axis_len + start
      || (mode == kPairs && ((uintptr_t)out & 15)))
    return (int)cudaErrorInvalidValue;
  int blocks = 0, device = 0, sms = 0;
  cudaError_t err = blocks_per_sm(mode, &blocks);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const long long count = keys_n * n;
  const long long need = (count + kThreads - 1) / kThreads;
  const long long full = (long long)sms * blocks;
  const unsigned grid = (unsigned)(need < full ? need : full);
  const Draw d{keys, key_stride, word_stride, counter, data, data_stride,
               (uint32_t)one, n, keys_n, axis_len, inner, start, total};
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kPairs)
    threefry_kernel<kPairs><<<grid, kThreads, 0, s>>>(d, out);
  else if (mode == kBits)
    threefry_kernel<kBits><<<grid, kThreads, 0, s>>>(d, out);
  else
    threefry_kernel<kUniform><<<grid, kThreads, 0, s>>>(d, out);
  return (int)cudaGetLastError();
}
