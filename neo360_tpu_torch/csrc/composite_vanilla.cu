// composite_vanilla_fwd — the plain NeRF volume composite of one level.
//
// Replaces neo360_tpu/core/render.py:volumetric_rendering (26-52), which
// the vanilla NeRF (neo360_tpu/models/vanilla.py:79) and PixelNeRF
// (neo360_tpu/models/pixelnerf.py:197) models call once per level. The JAX
// package leaves it to XLA scans and reductions; it is NOT a port of a
// Pallas kernel, since the JAX package has none.
//
// Per ray, in the JAX function's order:
//   delta_i = (t_{i+1} - t_i) * |d| for i < S-1, and 1e10 * |d| for the
//   last sample; alpha_i = 1 - exp(-sigma_i * delta_i); A_i = prod_{j<i}
//   ((1 - alpha_j) + 1e-10) (exclusive, A_0 = 1); w_i = alpha_i A_i;
//   rgb = sum w_i rgb_i, depth = sum w_i t_i, acc = sum w_i, and with
//   white_bkgd rgb += 1 - acc.
// This differs from kernel B's NeRF++ fg branch (composite_nerfpp.cu) in
// the last interval (1e10 scaled by |d|, not the sphere exit) and in
// having no transmittance output, so it is its own kernel.
//
// Bound: at the path's shapes (2048 rays x 65 or 193 samples in a vanilla
// step, 512 x 65 or 129 in a PixelNeRF step, 256-ray render tiles) a call
// moves 0.1-3.2 MB (< 1 us at the card's memory rate) with a dozen flops a
// sample: launch latency and the chain of dependent products set the
// pace. Design (kernel B's): one warp per ray, kWarps rays per block. The
// lanes load 32 consecutive samples at a time (coalesced); the exclusive
// transmittance is a multiplicative __shfl_up_sync scan in tree order (no
// log / exp), carried from chunk to chunk; the weights are stored
// coalesced; the sums are lane partials reduced once with __shfl_xor_sync.
// NaN and inf densities propagate as in the plain version: a product that
// meets a NaN stays NaN for every later sample.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays per block
constexpr unsigned kFull = 0xffffffffu;

struct Sums {
  float r, g, b, acc, depth;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__global__ void __launch_bounds__(32 * kWarps) composite_vanilla_kernel(
    const float* __restrict__ rgb, const float* __restrict__ sigma,
    const float* __restrict__ t, int s, const float* __restrict__ dirs,
    int n_rays, int white_bkgd, float* __restrict__ comp,
    float* __restrict__ acc, float* __restrict__ weights,
    float* __restrict__ depth) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // uniform across the warp
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const long long o = (long long)r * s;
  const float* rr = rgb + 3 * o;
  const float* sg = sigma + o;
  const float* tt = t + o;
  float* ww = weights + o;

  Sums p{0.f, 0.f, 0.f, 0.f, 0.f};
  float trans = 1.0f;  // warp-uniform: A at the chunk's first sample
  for (int base = 0; base < s; base += 32) {
    const int i = base + lane;
    const bool live = i < s;
    float alpha = 0.f, ti = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
    if (live) {
      ti = tt[i];
      const float delta = (i + 1 < s) ? (tt[i + 1] - ti) * dnorm
                                      : 1e10f * dnorm;
      alpha = 1.0f - expf(-sg[i] * delta);
      cr = rr[3 * i];
      cg = rr[3 * i + 1];
      cb = rr[3 * i + 2];
    }
    // inclusive product scan of q_i = (1 - alpha_i) + 1e-10 (1 past S)
    float incl = live ? (1.0f - alpha) + 1e-10f : 1.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl *= up;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    const float w = alpha * (trans * excl);
    if (live) ww[i] = w;
    p.acc += w;
    p.r += w * cr;
    p.g += w * cg;
    p.b += w * cb;
    p.depth += w * ti;
    trans *= __shfl_sync(kFull, incl, 31);
  }
  p.r = warp_sum(p.r);
  p.g = warp_sum(p.g);
  p.b = warp_sum(p.b);
  p.acc = warp_sum(p.acc);
  p.depth = warp_sum(p.depth);
  if (lane != 0) return;
  if (white_bkgd) {
    p.r += 1.0f - p.acc;
    p.g += 1.0f - p.acc;
    p.b += 1.0f - p.acc;
  }
  comp[3 * r] = p.r;
  comp[3 * r + 1] = p.g;
  comp[3 * r + 2] = p.b;
  acc[r] = p.acc;
  depth[r] = p.depth;
}

}  // namespace

// All tensors float32 and contiguous: rgb (B,S,3), sigma (B,S,1), t (B,S),
// dirs (B,3); outputs comp (B,3), acc (B,), weights (B,S), depth (B,).
// S >= 1. The wrapper (core/render.py:composite_vanilla) checks them.
extern "C" int composite_vanilla_fwd(const void* rgb, const void* sigma,
                                     const void* t, int s, const void* dirs,
                                     int n_rays, int white_bkgd, void* comp,
                                     void* acc, void* weights, void* depth,
                                     void* stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  if (s < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  composite_vanilla_kernel<<<blocks, 32 * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<const float*>(sigma),
      static_cast<const float*>(t), s, static_cast<const float*>(dirs),
      n_rays, white_bkgd, static_cast<float*>(comp), static_cast<float*>(acc),
      static_cast<float*>(weights), static_cast<float*>(depth));
  return (int)cudaGetLastError();
}
