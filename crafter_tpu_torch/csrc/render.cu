// Frame synthesis: each frame's window values (79 for the 9x9 view; one a
// world cell and 16 for a view of the whole area) and four scalars to its
// pixels, from the atlas's compact tables.
//
// Replaces the TPU kernel crafter_tpu/render.py:render_win79 (kernel body
// :598 over _render_core :316, pallas_call :612).  Its plain twins are
// crafter_tpu_torch/render.py:render_win79_plain (the atlas's per-pixel
// planes) and render_win79_compact (these tables, step for step as here);
// all three agree bit for bit.
//
// Bound on the H100: operations.  A frame reads 79 + 3 words and writes 3
// bytes (or one word) a pixel, while a pixel of the lit view costs ~105
// integer and float operations (blit, two lumas, desaturate, tint, blends)
// and ~25 more for the keyed noise at night.  The kernel issues ~80 warp
// instructions a pixel of the lit view by day, and the issue rate is what
// holds it (PERF.md).
// Design:
// * The tables hold every texture once (render.py:CompactTables): 14 + 15
//   tile textures, the item tiles of 16 slots x 10 amounts, and a code word
//   and the vignette a pixel; 69,812 bytes at 64x64, against 0.5 MB of
//   per-pixel planes that a pixel had to gather from L2.  The shared
//   instantiation stages them in shared memory once a block (material and
//   sprite rows padded to 16 with empty rows, so that no id needs a range
//   check) and loops over frames; the grid is SMs x resident blocks.  The
//   global instantiation reads the same tables from global memory, for
//   sizes whose tables do not fit (512x512: 4.5 MB).
// * Work items are segments of one frame (512 pixels, or up to 4096 while
//   every resident warp still gets kRounds of them), frame-major, one at a
//   time a warp: a warp stages its frame's values in its own slot of shared
//   memory (windows of up to kMaxWin values; larger ones, a view of the
//   whole area, are read from global memory where a pixel needs them), and
//   the day, night and sleep branches are uniform over it.
// * A pixel's code word is (source + 1) | view << S | offset << (S + 1),
//   S = src_bits: 8, or more for windows of 256 values or more
//   (render.py:code_src_bits).
// * Each lane makes runs of 4 consecutive pixels: predicated texel loads
//   (no branch on the pixel's kind), the canvas (the blit only for partial
//   alpha), the lighting where a pixel of the run is in the view, and whole
//   stores: three 32-bit words of RGB bytes, or one 16-byte word of packed
//   lanes.
// * A frame whose darkness is exactly 0 skips the keyed hash and the noise
//   blend: fmaf(1 - 0, canvas, 0 * noise) is the canvas itself.
// * No conversion instruction (16 lanes a clock on an SM) runs for a frame
//   whose daylight is in [0, 1]: its floors and integer-valued floats are
//   round-down additions to 2^23 and byte permutes, exact there.
// Every float expression ends in a floor, so each fused multiply-add of the
// reference is placed by hand (fmaf) and the file is built with -fmad=false.
#include <algorithm>

#include "common.cuh"

namespace {

using crafter::fmix;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;
constexpr int kSeg = 512;      // pixels of one work item, at least
constexpr int kRounds = 8;     // work items a resident warp should have
constexpr int kMaxWin = 128;   // window values staged in shared memory
constexpr int kStagedSrcBits = 8;   // the source field of such windows
constexpr int kRows = 16;      // material / sprite ids: 4 bits each

// The tables, in global or (staged) shared memory.
struct Tables {
  const int32_t* mat;    // (n_mat, T) material tile texels
  const int32_t* spr;    // (n_spr, T) sprite tile texels
  const int32_t* item;   // (items, n_amt, T) item tile texels
  const int32_t* code;   // (C,) (src + 1) | view << 8 | off << 9
  const float* vig;      // (C,) vignette
  int n_mat, n_spr, n_amt, texels;
};

struct Frame {
  float d, dark;
  bool slp;
  uint32_t seed;
};

// PIL's fixed-point ITU-R 601-2 luma (render.py:_luma_i).
__device__ __forceinline__ int luma(int r, int g, int b) {
  return (19595 * r + 38470 * g + 7471 * b + 32768) >> 16;
}

// floor((a*s + (255-a)*b) / 255) as an exact multiply-shift division.
__device__ __forceinline__ int blit(int a, int s, int b) {
  return ((a * s + (255 - a) * b) * 32897) >> 23;
}

template <bool kShared>
__device__ __forceinline__ int32_t load_i(const int32_t* p) {
  if (kShared) return *p;
  return __ldg(p);
}

// Integer <-> float without the conversion unit, which issues 16 lanes a
// clock on an SM against 128 for a float add: a float in [2^23, 2^24) has
// ulp 1, so its low mantissa bits are an integer.
constexpr float kMagic = 8388608.0f;   // 2^23
constexpr uint32_t kMagicBits = 0x4B000000u;

// Byte i of c (0 <= i < 3) as a float, exactly.
__device__ __forceinline__ float byte_f(uint32_t c, int i) {
  return __int_as_float(__byte_perm(c, kMagicBits, 0x7540 + i)) - kMagic;
}

// 2^23 + floor(x) for 0 <= x < 2^23: round-down addition, exact.
__device__ __forceinline__ float floor_b(float x) {
  return __fadd_rd(x, kMagic);
}

// floor(x) for 0 <= x < 2^23, as a float.
__device__ __forceinline__ float floor_f(float x) {
  return floor_b(x) - kMagic;
}

// luma() of three integer-valued floats in [0, 255], as a float: every
// partial sum is an integer below 2^24, so the float arithmetic is exact.
__device__ __forceinline__ float luma_f(float r, float g, float b) {
  float x = fmaf(r, 19595.0f, 32768.0f);
  x = fmaf(g, 38470.0f, x);
  x = fmaf(b, 7471.0f, x);
  return floor_f(x * (1.0f / 65536.0f));
}

// The canvas r | g<<8 | b<<16: the alpha-over blit of the sprite texel on
// the material texel.  Alpha 0 and 255 (most texels) give one of the two.
__device__ __forceinline__ uint32_t canvas(uint32_t base, uint32_t spr) {
  const uint32_t alpha = spr >> 24;
  uint32_t c = (alpha == 0u ? base : spr) & 0xFFFFFFu;
  if (alpha - 1u < 254u) {
    c = 0u;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      c |= (uint32_t)blit(alpha, (spr >> (8 * i)) & 255,
                          (base >> (8 * i)) & 255) << (8 * i);
  }
  return c;
}

// The canvas of the pixel with code word `code` in a frame whose values
// are in win[1..n] (win[0] = 0 reads for pixels that show no value) when
// staged in shared memory, else in global memory at win[0..n-1].  A
// view pixel blits its tile's sprite texel on its material texel; a strip
// pixel shows its slot's item tile at the amount it reads; the others
// nothing.  The loads are predicated, not branched over: shared rows are
// padded to 16 (empty beyond the table, and sprite row 0 empty), so only
// the global tables need the range checks.
template <bool kShared, bool kStaged>
__device__ __forceinline__ uint32_t pixel_canvas(const Tables& t,
                                                 const int* win, int code,
                                                 int src_bits) {
  const int src1 = code & ((1 << src_bits) - 1);
  const bool view = (code >> src_bits) & 1;
  const int off = (int)((uint32_t)code >> (src_bits + 1));
  const uint32_t id = kStaged ? (uint32_t)win[src1]
                              : (src1 ? (uint32_t)__ldg(win + src1 - 1) : 0u);
  const int mid = id & 15, tex = (id >> 4) & 15;
  const int m = mid * t.texels + off;
  const bool base_ok = view ? (kShared || mid < t.n_mat)
                            : (src1 != 0 && mid < t.n_amt);
  const bool spr_ok = view && (kShared || (tex >= 1 && tex < t.n_spr));
  const uint32_t base =
      base_ok ? (uint32_t)load_i<kShared>((view ? t.mat : t.item) + m) : 0u;
  const uint32_t spr =
      spr_ok ? (uint32_t)load_i<kShared>(t.spr + tex * t.texels + off) : 0u;
  return canvas(base, spr);
}

// The lit pixel p of the view from its canvas c (env.py:126-129 applies the
// lighting to the view only).  kUnit: the frame's daylight is in [0, 1], so
// that every floor below has an argument in [0, 2^23) and the
// conversion-free forms above give its bits; otherwise the conversions.
template <bool kUnit>
__device__ __forceinline__ uint32_t light(uint32_t c, float vig, int p,
                                          const Frame& f) {
  // Night lighting (engine.py:189-196): keyed noise under the vignette,
  // desaturate to 0.4, tint, blend by daylight; then the sleep overlay
  // (engine.py:198-202).  By day the noised canvas is the canvas.
  const float tint[3] = {0.0f, 16.0f, 64.0f};    // engine.py:195
  const float stint[3] = {0.0f, 0.0f, 16.0f};
  float canv[3], nf[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) canv[i] = byte_f(c, i);
  if (f.dark != 0.0f) {
    const uint32_t nbits = fmix(f.seed + (uint32_t)p * 0x9E3779B9u);
    const float noise = fmaf((float)(nbits >> 8), 95.0f / 16777216.0f,
                             32.0f);
    const float mask = f.dark * vig;
    const float mn = mask * noise, om = 1.0f - mask;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float v = fmaf(om, canv[i], mn);
      nf[i] = kUnit ? floor_f(v) : floorf(v);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) nf[i] = canv[i];
  }
  float lit[3];
  if (kUnit) {
    const float lum = luma_f(nf[0], nf[1], nf[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      // 0.5 * desat + 0.5 * tint with desat = floor(...): the sum of two
      // integers halved, exact either way.
      const float desat_tint =
          floor_b(fmaf(nf[i] - lum, 0.4f, lum)) - (kMagic - tint[i]);
      const float night = 0.5f * desat_tint;
      lit[i] = floor_b(fmaf(f.d, canv[i], (1.0f - f.d) * night));
    }
    if (f.slp) {
      const float lum2 = luma_f(lit[0] - kMagic, lit[1] - kMagic,
                                lit[2] - kMagic);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        lit[i] = floor_b(0.5f * lum2 + 0.5f * stint[i]);
    }
    // Each lit[i] is 2^23 + a channel value below 256: byte 0 of its bits.
    const uint32_t rg = __byte_perm(__float_as_uint(lit[0]),
                                    __float_as_uint(lit[1]), 0x1140);
    return __byte_perm(rg, __float_as_uint(lit[2]), 0x2410);
  }
  const float lum = (float)luma((int)nf[0], (int)nf[1], (int)nf[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float desat = floorf(fmaf(nf[i] - lum, 0.4f, lum));
    const float night = 0.5f * desat + 0.5f * tint[i];
    lit[i] = fmaf(f.d, canv[i], (1.0f - f.d) * night);
  }
  if (f.slp) {
    const float lum2 = (float)luma((int)floorf(lit[0]), (int)floorf(lit[1]),
                                   (int)floorf(lit[2]));
#pragma unroll
    for (int i = 0; i < 3; ++i) lit[i] = 0.5f * lum2 + 0.5f * stint[i];
  }
  return (uint32_t)(int)floorf(lit[0]) | ((uint32_t)(int)floorf(lit[1]) << 8)
         | ((uint32_t)(int)floorf(lit[2]) << 16);
}

// Shared memory a block needs: the window slots (windows of up to kMaxWin
// values), and for the shared instantiation the padded tables (each part a
// multiple of 16 bytes).
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline bool staged(int n_win) { return n_win <= kMaxWin; }

__host__ __device__ inline size_t smem_words(bool shared, int n_win,
                                             int items_words, int texels,
                                             int c) {
  size_t words = staged(n_win) ? (size_t)kWarps * round4(n_win + 1) : 0;
  if (shared)
    words += (size_t)round4(2 * kRows * texels) + round4(items_words)
             + 2 * (size_t)round4(c);
  return words;
}

template <bool kShared, bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks) render_kernel(
    const int32_t* __restrict__ win79, const float* __restrict__ daylight,
    const int32_t* __restrict__ sleeping, const int32_t* __restrict__ seeds,
    Tables t, int items_words, void* __restrict__ out, int bytes, int b,
    int n_win, int c, int seg_px, int src_bits) {
  extern __shared__ __align__(16) int smem[];
  const int slot = kStaged ? round4(n_win + 1) : 0;
  const int* win = smem + (threadIdx.x >> 5) * slot;
  if (kShared) {
    int* s = smem + kWarps * slot;
    int* s_mat = s;
    int* s_spr = s_mat + kRows * t.texels;
    int* s_item = s + round4(2 * kRows * t.texels);
    int* s_code = s_item + round4(items_words);
    float* s_vig = reinterpret_cast<float*>(s_code + round4(c));
    const int rows = kRows * t.texels;
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      const int k = i / t.texels;
      s_mat[i] = k < t.n_mat ? t.mat[i] : 0;
      s_spr[i] = (k >= 1 && k < t.n_spr) ? t.spr[i] : 0;
    }
    for (int i = threadIdx.x; i < items_words; i += kThreads)
      s_item[i] = t.item[i];
    for (int i = threadIdx.x; i < c; i += kThreads) {
      s_code[i] = t.code[i];
      s_vig[i] = t.vig[i];
    }
    __syncthreads();
    t.mat = s_mat;
    t.spr = s_spr;
    t.item = s_item;
    t.code = s_code;
    t.vig = s_vig;
  }

  // A staged window has fewer than 256 values: its source field is 8 bits
  // wide, a constant here.
  const int sb = kStaged ? kStagedSrcBits : src_bits;
  const int view_bit = 1 << sb;
  const int lane = threadIdx.x & 31;
  const int segs = (c + seg_px - 1) / seg_px;
  const long long n_work = (long long)b * segs;
  const bool whole = (c & 3) == 0;   // 4-pixel runs never straddle frames
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < n_work; w += (long long)gridDim.x * kWarps) {
    const int frame = (int)(w / segs);
    const int seg = (int)(w - (long long)frame * segs);
    if (kStaged) {
      int* slot_w = smem + (threadIdx.x >> 5) * slot;
      __syncwarp();
      for (int i = lane; i <= n_win; i += 32)
        slot_w[i] = i ? win79[(size_t)frame * n_win + i - 1] : 0;
      __syncwarp();
    } else {
      win = win79 + (size_t)frame * n_win;
    }
    Frame f;
    f.d = daylight[frame];
    f.slp = sleeping[frame] != 0;
    f.seed = (uint32_t)seeds[frame];
    // mask = max(0, 2 * (0.5 - daylight)) * vignette: 0 by day.
    f.dark = fmaxf(0.0f, 2.0f * (0.5f - f.d));
    const bool unit = f.d >= 0.0f && f.d <= 1.0f;   // uniform over the warp
    const int end = min(c, (seg + 1) * seg_px);
    for (int p0 = seg * seg_px + 4 * lane; p0 < end; p0 += 128) {
      const bool full = whole || p0 + 3 < end;
      int code[4];
      float vig[4];
      if (full) {
        const int4 cv = *reinterpret_cast<const int4*>(t.code + p0);
        const float4 vv = *reinterpret_cast<const float4*>(t.vig + p0);
        code[0] = cv.x; code[1] = cv.y; code[2] = cv.z; code[3] = cv.w;
        vig[0] = vv.x; vig[1] = vv.y; vig[2] = vv.z; vig[3] = vv.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          code[j] = p0 + j < end ? t.code[p0 + j] : 0;
          vig[j] = p0 + j < end ? t.vig[p0 + j] : 0.0f;
        }
      }
      uint32_t px[4];
      int view = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        px[j] = pixel_canvas<kShared, kStaged>(t, win, code[j], sb);
        view |= code[j];
      }
      // The item strip and the border keep their raw texels; the lighting
      // runs where a pixel of the run is in the view.
      if (view & view_bit) {
        if (unit) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t lit = light<true>(px[j], vig[j], p0 + j, f);
            px[j] = (code[j] & view_bit) ? lit : px[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t lit = light<false>(px[j], vig[j], p0 + j, f);
            px[j] = (code[j] & view_bit) ? lit : px[j];
          }
        }
      }
      const size_t lanes = (size_t)frame * c + p0;
      if (full && bytes) {
        // Four pixels' RGB bytes (bytes 0-2 of each packed lane) are three
        // whole little-endian words.
        uint32_t* o = reinterpret_cast<uint32_t*>(
            static_cast<uint8_t*>(out) + lanes * 3);
        o[0] = __byte_perm(px[0], px[1], 0x4210);
        o[1] = __byte_perm(px[1], px[2], 0x5421);
        o[2] = __byte_perm(px[2], px[3], 0x6542);
      } else if (full) {
        *reinterpret_cast<uint4*>(static_cast<int32_t*>(out) + lanes) =
            make_uint4(px[0], px[1], px[2], px[3]);
      } else {
        for (int j = 0; j < 4 && p0 + j < end; ++j) {
          if (bytes) {
            uint8_t* o8 = static_cast<uint8_t*>(out) + (lanes + j) * 3;
            o8[0] = px[j] & 255;
            o8[1] = (px[j] >> 8) & 255;
            o8[2] = (px[j] >> 16) & 255;
          } else {
            static_cast<uint32_t*>(out)[lanes + j] = px[j];
          }
        }
      }
    }
  }
}

using RenderFn = decltype(&render_kernel<true, true>);

RenderFn kernel_for(bool shared, int n_win) {
  if (staged(n_win))
    return shared ? render_kernel<true, true> : render_kernel<false, true>;
  return shared ? render_kernel<true, false> : render_kernel<false, false>;
}

cudaError_t prepare(RenderFn kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Resident blocks per SM of the shared (shared = 1) or global instantiation
// for these tables, and the block's shared memory; 0 blocks when the tables
// do not fit.
extern "C" int crafter_render_occupancy(int shared, int n_win,
                                        int items_words, int texels, int c,
                                        int* blocks, int* smem_out) {
  if (n_win <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * smem_words(shared != 0, n_win, items_words, texels,
                                     c);
  *smem_out = (int)smem;
  *blocks = 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess || smem > (size_t)optin) return (int)err;
  const RenderFn kernel = kernel_for(shared != 0, n_win);
  err = prepare(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        kThreads, smem);
  return (int)err;
}

// out: (B, C) int32 r|g<<8|b<<16 when bytes == 0, (B, C, 3) uint8
// otherwise.  shared: 1 for the shared-memory instantiation (the caller
// has checked with crafter_render_occupancy that it fits), 0 for global.
// src_bits: the width of the code words' source field.
extern "C" int crafter_render(
    const int32_t* win79, const float* daylight, const int32_t* sleeping,
    const int32_t* seeds, const int32_t* mat, int n_mat, const int32_t* spr,
    int n_spr, const int32_t* item, int n_items, int n_amt, int texels,
    const int32_t* code, const float* vig, void* out, int bytes, int shared,
    int b, int n_win, int c, int src_bits, void* stream) {
  if (b <= 0) return 0;
  if (n_win <= 0 || n_mat > kRows || n_spr > kRows || src_bits < 8
      || src_bits > 24 || n_win >= (1 << src_bits)
      || (staged(n_win) && src_bits != kStagedSrcBits))
    return (int)cudaErrorInvalidValue;
  const int items_words = n_items * n_amt * texels;
  const size_t smem = 4 * smem_words(shared != 0, n_win, items_words, texels,
                                     c);
  const RenderFn kernel = kernel_for(shared != 0, n_win);
  cudaError_t err = prepare(kernel, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  // Work items of kSeg pixels, or of 2, 4 or 8 times that while there are
  // still at least kRounds items for each resident warp: fewer items cost
  // fewer window stagings, and enough of them keep the warps evenly busy.
  const long long warps = (long long)per_sm * sms * kWarps;
  int seg_px = kSeg;
  while (seg_px < 8 * kSeg && seg_px < c
         && (long long)b * ((c + 2 * seg_px - 1) / (2 * seg_px))
                >= kRounds * warps)
    seg_px *= 2;
  const long long work = (long long)b * ((c + seg_px - 1) / seg_px);
  const long long grid = std::min<long long>(
      (long long)per_sm * sms, (work + kWarps - 1) / kWarps);
  const Tables t{mat, spr, item, code, vig, n_mat, n_spr, n_amt, texels};
  kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      win79, daylight, sleeping, seeds, t, items_words, out, bytes, b, n_win,
      c, seg_px, src_bits);
  return (int)cudaGetLastError();
}
