// composite_mip_bwd — gradient of composite_mip_fwd with respect to the
// densities and colours.
//
// Replaces the transpose XLA derives for neo360_tpu/core/render.py:
// compute_alpha_weights + render_mip (124-163). The JAX package has no
// Pallas kernel for it.
//
// With e_i = exp(-dd_i), alpha_i = 1 - e_i, T_i and w_i = alpha_i T_i as
// in composite_mip.cu, and the output cotangents gw_i (weights), gc (rgb,
// 3), ga (acc), gd (depth):
//   h = d max(0, 1 - acc) / d(1 - acc): 1 above 0, 0 below, 0.5 at the
//       tie (jnp.maximum's and torch.maximum's rule), taken from the acc
//       that kernel E wrote (an input);
//   g_i = gw_i + ga - h * bg * sum(gc) + gc . c_i + gd * m_i
//       (m_i the interval's midpoint);
//   R_i = sum_{k>i} g_k w_k                        (a reverse scan)
//   dL/d density_i = delta_i (g_i e_i T_i - R_i), and 0 for the last
//       interval with opaque_background (its dd is the constant inf);
//   dL/d rgb_i = w_i gc.
// With opaque_background sum_i w_i is 1 whatever the densities, so a
// change of h shifts every g_i of the ray by one constant and changes d
// density only by rounding: the tie decides nothing beyond it. Nothing
// forms inf * 0: the infinite interval's e is 0 by definition. Any
// cotangent may be absent (a null pointer): it counts as zero. tdist and
// dirs get no gradient.
//
// Bound: latency, as kernel E's (at most a few MB a call, ~30 flops an
// interval in two dependent scans). Design (kernel D''s): one warp per
// ray, kWarps rays per block; lane i owns interval base + i of a
// 32-interval chunk, loads and stores coalesced.
//   forward: T_i by kernel E's __shfl_up_sync additive scan (E's bits);
//     T_i goes to the d density output (its own slot: no scratch).
//   reverse: from the last chunk down, an inclusive suffix sum of g_k w_k
//     with __shfl_down_sync; R_i is the sum carried from the chunks above
//     plus the lanes above i in this one.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float at(const float* p, long long i) {
  return p ? p[i] : 0.0f;
}

__global__ void __launch_bounds__(32 * kWarps) composite_mip_bwd_kernel(
    const float* __restrict__ density, const float* __restrict__ tdist,
    const float* __restrict__ dirs, const float* __restrict__ rgb, int s,
    int n_rays, float bg, int opaque, const float* __restrict__ acc,
    const float* g_w, const float* g_comp, const float* g_acc,
    const float* g_depth, float* __restrict__ d_density,
    float* __restrict__ d_rgb) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // uniform across the warp
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const long long o = (long long)r * s;
  const float* sg = density + o;
  const float* tt = tdist + (long long)r * (s + 1);
  const float* cc = rgb + 3 * o;
  const float* gw = g_w ? g_w + o : nullptr;
  float* ds = d_density + o;
  float* dr = d_rgb + 3 * o;

  // forward: T_i into ds[i]
  float carry = 0.f;
  for (int base = 0; base < s; base += 32) {
    const int i = base + lane;
    float x = 0.f;
    if (i < s - 1) x = sg[i] * ((tt[i + 1] - tt[i]) * dnorm);
    float incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0f;
    if (i < s) ds[i] = expf(-(carry + excl));
    carry += __shfl_sync(kFull, incl, 31);
  }

  float gc[3];
  for (int k = 0; k < 3; ++k) gc[k] = at(g_comp, 3LL * r + k);
  const float gd = at(g_depth, r);
  float ga = at(g_acc, r);
  if (g_comp) {
    const float om = 1.0f - acc[r];
    const float h = om > 0.0f ? 1.0f : (om == 0.0f ? 0.5f : 0.0f);
    ga -= h * (bg * (gc[0] + gc[1] + gc[2]));
  }

  // reverse: R carried from the chunks above, 0 above the last interval
  float R = 0.f;
  for (int base = (s - 1) & ~31; base >= 0; base -= 32) {
    const int i = base + lane;
    const bool live = i < s;
    const bool inf_last = opaque && i == s - 1;
    float v = 0.f, g = 0.f, e = 0.f, T = 0.f, w = 0.f, delta = 0.f;
    if (live) {
      const float t0 = tt[i], t1 = tt[i + 1];
      delta = (t1 - t0) * dnorm;
      e = inf_last ? 0.0f : expf(-(sg[i] * delta));
      T = ds[i];
      w = (1.0f - e) * T;
      g = (gw ? gw[i] : 0.0f) + ga + gc[0] * cc[3 * i] +
          gc[1] * cc[3 * i + 1] + gc[2] * cc[3 * i + 2] +
          gd * (0.5f * (t1 + t0));
      v = g * w;
    }
    float S = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float dn = __shfl_down_sync(kFull, S, d);
      if (lane + d < 32) S += dn;
    }
    float above = __shfl_down_sync(kFull, S, 1);
    if (lane == 31) above = 0.0f;
    if (live) {
      dr[3 * i] = w * gc[0];
      dr[3 * i + 1] = w * gc[1];
      dr[3 * i + 2] = w * gc[2];
      ds[i] = inf_last ? 0.0f : delta * (g * e * T - (R + above));
    }
    R += __shfl_sync(kFull, S, 0);
  }
}

}  // namespace

// Inputs as composite_mip_fwd's, then the forward's acc (B,). Cotangents,
// each float32 or null: weights (B,S), comp (B,3), acc (B,), depth (B,).
// Outputs: d density (B,S), d rgb (B,S,3). S >= 1. The wrapper
// (core/render.py:composite_mip_backward) checks them.
extern "C" int composite_mip_bwd(const void* density, const void* tdist,
                                 const void* dirs, const void* rgb, int s,
                                 int n_rays, float bg, int opaque,
                                 const void* acc, const void* g_w,
                                 const void* g_comp, const void* g_acc,
                                 const void* g_depth, void* d_density,
                                 void* d_rgb, void* stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  if (s < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  composite_mip_bwd_kernel<<<blocks, 32 * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      f(density), f(tdist), f(dirs), f(rgb), s, n_rays, bg, opaque, f(acc),
      f(g_w), f(g_comp), f(g_acc), f(g_depth),
      static_cast<float*>(d_density), static_cast<float*>(d_rgb));
  return (int)cudaGetLastError();
}
