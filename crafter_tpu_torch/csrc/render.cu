// Frame synthesis: each frame's 79 window values and four scalars to its
// pixels, one thread block per frame, one thread per pixel lane.
//
// Replaces the TPU kernel crafter_tpu/render.py:render_win79 (kernel body
// :598 over _render_core :316, pallas_call :612).  Its plain twin is
// crafter_tpu_torch/render.py:render_win79_plain; the two agree bit for bit.
//
// Bound on the H100: operations.  A frame reads 79 + 3 words and writes 3
// bytes (or one word) a pixel, while a pixel of the lit view costs ~105
// integer and float operations (blit, two lumas, desaturate, tint, blends)
// and ~25 more for the keyed noise at night.
// The tables (material and sprite planes, source index, vignette, view
// mask: under 0.5 MB at 64x64) are shared by all frames and stay in L2.
// Design: the TPU kernel spreads the 79 values over the pixels with a
// one-hot matmul and picks texels with select chains over 14 material and
// 15 sprite planes; here the block holds the 79 values in shared memory and
// each pixel does three indexed loads: win[src[p]], mats[mid][p],
// sprs[tex][p].  The launch picks the output: packed int32 lanes, or the
// uint8 RGB bytes of the (H, W, 3) frame written directly (a separate
// slice copy on the TPU).  Every float expression ends in a floor, so each
// fused multiply-add of the reference is placed by hand (fmaf) and the file
// is built with -fmad=false.
#include "common.cuh"

namespace {

using crafter::fmix;

constexpr int kThreads = 256;
constexpr int kMaxWin = 128;   // window values a frame may have (79 here)

// PIL's fixed-point ITU-R 601-2 luma (render.py:_luma_i).
__device__ __forceinline__ int luma(int r, int g, int b) {
  return (19595 * r + 38470 * g + 7471 * b + 32768) >> 16;
}

// floor((a*s + (255-a)*b) / 255) as an exact multiply-shift division.
__device__ __forceinline__ int blit(int a, int s, int b) {
  return ((a * s + (255 - a) * b) * 32897) >> 23;
}

template <bool kBytes>
__global__ void __launch_bounds__(kThreads) render_kernel(
    const int32_t* __restrict__ win79, const float* __restrict__ daylight,
    const int32_t* __restrict__ sleeping, const int32_t* __restrict__ seeds,
    const int32_t* __restrict__ mats, int n_mat,
    const int32_t* __restrict__ sprs, int n_spr,
    const int32_t* __restrict__ src, const float* __restrict__ vignette,
    const int32_t* __restrict__ view_mask, void* __restrict__ out, int n_win,
    int P) {
  __shared__ int win[kMaxWin];
  const int frame = blockIdx.x;
  for (int i = threadIdx.x; i < n_win; i += blockDim.x)
    win[i] = win79[(size_t)frame * n_win + i];
  __syncthreads();
  const float d = daylight[frame];
  const bool slp = sleeping[frame] != 0;
  const uint32_t seed = (uint32_t)seeds[frame];
  // mask = max(0, 2 * (0.5 - daylight)) * vignette: 0 by day.
  const float dark = fmaxf(0.0f, 2.0f * (0.5f - d));
  const float tint[3] = {0.0f, 16.0f, 64.0f};    // engine.py:195
  const float stint[3] = {0.0f, 0.0f, 16.0f};    // engine.py:198-202

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int s = src[p];
    const int id = s >= 0 ? win[s] : 0;
    const int mid = id & 15, tex = (id >> 4) & 15;
    const uint32_t base = mid < n_mat ? (uint32_t)mats[(size_t)mid * P + p] : 0u;
    const uint32_t spr =
        (tex >= 1 && tex < n_spr) ? (uint32_t)sprs[(size_t)tex * P + p] : 0u;
    const int alpha = spr >> 24;
    float canv[3];
    for (int i = 0; i < 3; ++i)
      canv[i] = (float)blit(alpha, (spr >> (8 * i)) & 255,
                            (base >> (8 * i)) & 255);

    // Night lighting (engine.py:189-196): keyed noise under the vignette,
    // desaturate to 0.4, tint, blend by daylight.
    const uint32_t nbits = fmix(seed + (uint32_t)p * 0x9E3779B9u);
    const float noise = fmaf((float)(nbits >> 8), 95.0f / 16777216.0f, 32.0f);
    const float mask = dark * vignette[p];
    const float mn = mask * noise, om = 1.0f - mask;
    int nf[3];
    for (int i = 0; i < 3; ++i) nf[i] = (int)floorf(fmaf(om, canv[i], mn));
    const float lum = (float)luma(nf[0], nf[1], nf[2]);
    float lit[3];
    int lf[3];
    for (int i = 0; i < 3; ++i) {
      const float desat = floorf(fmaf((float)nf[i] - lum, 0.4f, lum));
      const float night = 0.5f * desat + 0.5f * tint[i];
      lit[i] = fmaf(d, canv[i], (1.0f - d) * night);
      lf[i] = (int)floorf(lit[i]);
    }
    // Sleep overlay, then the view mask: the item strip and the border keep
    // their raw texels (env.py:126-129).
    const float lum2 = (float)luma(lf[0], lf[1], lf[2]);
    const bool lit_px = view_mask[p] != 0;
    int rgb[3];
    for (int i = 0; i < 3; ++i) {
      const float o = slp ? 0.5f * lum2 + 0.5f * stint[i] : lit[i];
      rgb[i] = (int)floorf(lit_px ? o : canv[i]);
    }
    const size_t lane = (size_t)frame * P + p;
    if (kBytes) {
      uint8_t* o8 = static_cast<uint8_t*>(out) + lane * 3;
      o8[0] = (uint8_t)rgb[0];
      o8[1] = (uint8_t)rgb[1];
      o8[2] = (uint8_t)rgb[2];
    } else {
      static_cast<int32_t*>(out)[lane] = rgb[0] | (rgb[1] << 8) | (rgb[2] << 16);
    }
  }
}

}  // namespace

// out: (B, P) int32 r|g<<8|b<<16 when bytes == 0, (B, P, 3) uint8 otherwise.
extern "C" int crafter_render(
    const int32_t* win79, const float* daylight, const int32_t* sleeping,
    const int32_t* seeds, const int32_t* mats, int n_mat, const int32_t* sprs,
    int n_spr, const int32_t* src, const float* vignette,
    const int32_t* view_mask, void* out, int bytes, int b, int n_win, int p,
    void* stream) {
  if (b <= 0) return 0;
  if (n_win > kMaxWin) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bytes)
    render_kernel<true><<<b, kThreads, 0, st>>>(
        win79, daylight, sleeping, seeds, mats, n_mat, sprs, n_spr, src,
        vignette, view_mask, out, n_win, p);
  else
    render_kernel<false><<<b, kThreads, 0, st>>>(
        win79, daylight, sleeping, seeds, mats, n_mat, sprs, n_spr, src,
        vignette, view_mask, out, n_win, p);
  return (int)cudaGetLastError();
}
