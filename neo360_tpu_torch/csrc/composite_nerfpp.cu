// composite_nerfpp_fwd — NeRF++ foreground + background volume compositing
// of one level, fused.
//
// Replaces neo360_tpu/core/render.py:volumetric_rendering_nerfpp (55-96),
// called twice per level (fg, bg), plus the caller's combination at
// neo360_tpu/models/neo360.py:480 (comp = fg + bg_lambda * bg) and :499
// (depth). The JAX package leaves these to XLA scans and reductions; it is
// NOT a port of a Pallas kernel, since the JAX package has none.
//
// Per ray, fg then bg:
//   fg: delta_i = (t_{i+1} - t_i) * |d|, the last interval closed by the
//       sphere exit t_far; bg: delta_i = t_i - t_{i+1} (descending inverse
//       depth), the last interval 1e10 and not scaled by |d|.
//   alpha_i = 1 - exp(-sigma_i * delta_i); T_i = prod_{j<i} (1 - alpha_j +
//   1e-10); w_i = alpha_i * T_i; acc, rgb, depth = sums of w, w*rgb, w*t;
//   white_bkgd adds (1 - acc). bg_lambda = fg transmittance past the last
//   sample; comp = fg + bg_lambda * bg, depth = fg_depth + bg_lambda *
//   bg_depth.
//
// Bound: at the path's 256-ray tiles, launch latency. Each ray reads 5
// floats and writes 1 weight per sample (~0.8 MB a tile, < 1 us at the
// card's memory rate), with a dozen flops each. The first version gave
// each ray one thread, which walked the samples in order: 256 threads on
// 2 of 132 SMs, each waiting on a chain of dependent, uncoalesced loads.
// Design: one warp per ray, kWarps rays per block, so a tile spreads over
// 64 blocks. The lanes load 32 consecutive samples at a time (coalesced),
// the exclusive transmittance is a multiplicative warp scan
// (__shfl_up_sync, a product in tree order: no log / exp) carried from
// chunk to chunk, the weights are stored coalesced, and the sums are lane
// partials reduced once with __shfl_xor_sync. The fg and bg chunks of one
// step are independent, so their loads and scans overlap. fg, bg and
// their combination remain one launch instead of the ~30 elementwise /
// scan / reduce ops of the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays per block
constexpr unsigned kFull = 0xffffffffu;

struct Sums {
  float r, g, b, acc, depth;
};

// Samples [base, base + 32) of one branch of the warp's ray; lane i owns
// sample base + i. `trans` (warp-uniform) is the transmittance before the
// chunk and leaves it after; `o` takes the lane's partial sums.
__device__ __forceinline__ void composite_chunk(
    const float* __restrict__ rgb, const float* __restrict__ sigma,
    const float* __restrict__ t, int s, int base, int lane, bool fg,
    float t_far, float dnorm, float* __restrict__ weights, float& trans,
    Sums& o) {
  const int i = base + lane;
  const bool live = i < s;
  float alpha = 0.f, ti = 0.f, r = 0.f, g = 0.f, b = 0.f;
  if (live) {
    ti = t[i];
    float delta;
    if (fg) {
      delta = ((i + 1 < s) ? t[i + 1] : t_far) - ti;
      delta *= dnorm;
    } else {
      delta = (i + 1 < s) ? ti - t[i + 1] : 1e10f;
    }
    alpha = 1.0f - expf(-sigma[i] * delta);
    r = rgb[3 * i];
    g = rgb[3 * i + 1];
    b = rgb[3 * i + 2];
  }
  // inclusive product scan of q_i = 1 - alpha_i + 1e-10 (1 past the end)
  float incl = live ? (1.0f - alpha) + 1e-10f : 1.0f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl *= up;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 1.0f;
  const float w = alpha * (trans * excl);
  if (live) weights[i] = w;
  o.acc += w;
  o.r += w * r;
  o.g += w * g;
  o.b += w * b;
  o.depth += w * ti;
  trans *= __shfl_sync(kFull, incl, 31);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ void reduce(Sums& o) {
  o.r = warp_sum(o.r);
  o.g = warp_sum(o.g);
  o.b = warp_sum(o.b);
  o.acc = warp_sum(o.acc);
  o.depth = warp_sum(o.depth);
}

__global__ void __launch_bounds__(32 * kWarps) composite_nerfpp_kernel(
    const float* __restrict__ fg_rgb, const float* __restrict__ fg_sigma,
    const float* __restrict__ fg_t, int s_fg,
    const float* __restrict__ bg_rgb, const float* __restrict__ bg_sigma,
    const float* __restrict__ bg_t, int s_bg,
    const float* __restrict__ dirs, const float* __restrict__ far,
    int n_rays, int white_bkgd,
    float* __restrict__ comp, float* __restrict__ fg_comp,
    float* __restrict__ bg_comp, float* __restrict__ fg_acc,
    float* __restrict__ bg_acc, float* __restrict__ fg_w,
    float* __restrict__ bg_w, float* __restrict__ bg_lambda,
    float* __restrict__ depth, float* __restrict__ fg_depth) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // uniform across the warp
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float t_far = far[r];
  const long long of = (long long)r * s_fg;
  const long long ob = (long long)r * s_bg;

  Sums f{0.f, 0.f, 0.f, 0.f, 0.f}, b{0.f, 0.f, 0.f, 0.f, 0.f};
  float f_trans = 1.0f, b_trans = 1.0f;
  const int s_max = s_fg > s_bg ? s_fg : s_bg;
  for (int base = 0; base < s_max; base += 32) {
    if (base < s_fg)
      composite_chunk(fg_rgb + 3 * of, fg_sigma + of, fg_t + of, s_fg, base,
                      lane, true, t_far, dnorm, fg_w + of, f_trans, f);
    if (base < s_bg)
      composite_chunk(bg_rgb + 3 * ob, bg_sigma + ob, bg_t + ob, s_bg, base,
                      lane, false, 0.0f, dnorm, bg_w + ob, b_trans, b);
  }
  reduce(f);
  reduce(b);
  if (lane != 0) return;
  if (white_bkgd) {
    f.r += 1.0f - f.acc; f.g += 1.0f - f.acc; f.b += 1.0f - f.acc;
    b.r += 1.0f - b.acc; b.g += 1.0f - b.acc; b.b += 1.0f - b.acc;
  }
  const float lam = f_trans;
  fg_comp[3 * r] = f.r; fg_comp[3 * r + 1] = f.g; fg_comp[3 * r + 2] = f.b;
  bg_comp[3 * r] = b.r; bg_comp[3 * r + 1] = b.g; bg_comp[3 * r + 2] = b.b;
  comp[3 * r] = f.r + lam * b.r;
  comp[3 * r + 1] = f.g + lam * b.g;
  comp[3 * r + 2] = f.b + lam * b.b;
  fg_acc[r] = f.acc;
  bg_acc[r] = b.acc;
  bg_lambda[r] = lam;
  fg_depth[r] = f.depth;
  depth[r] = f.depth + lam * b.depth;
}

}  // namespace

// All tensors float32 and contiguous: rgb (B,S,3), sigma (B,S,1), t (B,S),
// dirs (B,3), far (B,1); outputs comp/fg_comp/bg_comp (B,3), fg_acc,
// bg_acc, depth, fg_depth (B,), fg_w (B,S_fg), bg_w (B,S_bg), bg_lambda
// (B,1). S_fg, S_bg >= 1. The wrapper (core/render.py:composite_nerfpp)
// checks them.
extern "C" int composite_nerfpp_fwd(
    const void* fg_rgb, const void* fg_sigma, const void* fg_t, int s_fg,
    const void* bg_rgb, const void* bg_sigma, const void* bg_t, int s_bg,
    const void* dirs, const void* far, int n_rays, int white_bkgd,
    void* comp, void* fg_comp, void* bg_comp, void* fg_acc, void* bg_acc,
    void* fg_w, void* bg_w, void* bg_lambda, void* depth, void* fg_depth,
    void* stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  if (s_fg < 1 || s_bg < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  composite_nerfpp_kernel<<<blocks, 32 * kWarps, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fg_rgb), static_cast<const float*>(fg_sigma),
      static_cast<const float*>(fg_t), s_fg,
      static_cast<const float*>(bg_rgb), static_cast<const float*>(bg_sigma),
      static_cast<const float*>(bg_t), s_bg,
      static_cast<const float*>(dirs), static_cast<const float*>(far),
      n_rays, white_bkgd, static_cast<float*>(comp),
      static_cast<float*>(fg_comp), static_cast<float*>(bg_comp),
      static_cast<float*>(fg_acc), static_cast<float*>(bg_acc),
      static_cast<float*>(fg_w), static_cast<float*>(bg_w),
      static_cast<float*>(bg_lambda), static_cast<float*>(depth),
      static_cast<float*>(fg_depth));
  return (int)cudaGetLastError();
}
