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
// interval in two dependent scans). Device times below are
// scripts/torch_kernel_times.py --only E on an NVIDIA H100 80GB HBM3 at
// 700 W (launch floor 1.0 us).
//
// Before: one warp a ray, 4 a block, 32-interval chunks, three dependent
// round trips even at one chunk: a forward pass that loaded density and
// t, scanned and stored T_i into the d density output as scratch; then
// the per-ray cotangents and acc; then a reverse pass that re-read t,
// density, rgb, the weights cotangent and T_i before each chunk's suffix
// scan, and stored d rgb strided, 3 words a lane (2048 x 32: 2.5 us, 2048
// x 64: 3.0, 4096 x 64: 4.2).
//
// Design (composite_mip_common.cuh, composite_runs.cuh): kernel E's
// launch shape and register loads, with the weights cotangent and the
// per-ray cotangents and acc loaded beside the run's edges, densities and
// colours, all in flight at once; e_i, T_i and w_i by E's forward scan,
// kept in the lane's registers. Reverse: each lane folds v_j = g_j w_j of
// its run from its last interval down; one exclusive __shfl_down_sync
// suffix scan of the 32 lanes' totals gives the sum above each run, and
// R_i = (that sum + the lane's own sum above i). d density and d rgb go
// through shared memory and are stored coalesced. Up to S = 256 nothing
// is read twice from device memory and no scratch is used. Past 256 (no
// path of the port), a first pass over the segments writes the sum of dd
// before each later segment into d density's slot of that segment's first
// interval, where its own d density overwrites it; the reverse pass
// reloads each segment and reruns its forward scan.
//
// After: one memory round trip and the two scans; 2048 x 32 (weights and
// rgb cotangents) 2.51-2.52 -> 2.35-2.36 us, 2048 x 64 (weights) 3.00-3.01
// -> 2.69-2.70, 4096 x 64 (all four) 4.22-4.25 -> 3.51-3.53 (90% of its
// byte bound).

#include "composite_mip_common.cuh"

namespace {

using runs::at;
using runs::kFull;

template <int K>
__global__ void __launch_bounds__(32 * runs::kBlockWarps)
    composite_mip_bwd_kernel(
        const float* __restrict__ density, const float* __restrict__ tdist,
        const float* __restrict__ dirs, const float* __restrict__ rgb, int s,
        int n_rays, float bg, int opaque, const float* __restrict__ acc,
        const float* g_w, const float* g_comp, const float* g_acc,
        const float* g_depth, float* __restrict__ d_density,
        float* __restrict__ d_rgb) {
  constexpr int kSeg = 32 * K;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= n_rays) return;  // uniform across the warp
  // the warp's d density (kSeg) and d rgb (3 kSeg), stored coalesced
  float* ss = smem + warp * 4 * kSeg;
  float* rs = ss + kSeg;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  float gc[3];
  for (int k = 0; k < 3; ++k) gc[k] = at(g_comp, 3LL * r + k);
  const float gd = at(g_depth, r);
  float ga = at(g_acc, r);
  if (g_comp) {
    const float om = 1.0f - acc[r];
    const float h = om > 0.0f ? 1.0f : (om == 0.0f ? 0.5f : 0.0f);
    ga -= h * (bg * (gc[0] + gc[1] + gc[2]));
  }
  const long long o = (long long)r * s;
  const float* tt = tdist + (long long)r * (s + 1);
  const int first = lane * K;
  float* ds = d_density + o;

  const int segs = runs::segments<K>(s);
  if (segs > 1) {  // the sum of dd before each later segment
    float carry = 0.0f;
    for (int base = 0; base + kSeg < s; base += kSeg) {
      mip::Run<K> run;
      mip::load_run(run, tt + base, density + o + base, first, kSeg);
      carry = mip::forward(run, kSeg, s - 1 - base, opaque, dnorm, carry,
                           lane);
      if (lane == 0) ds[base + kSeg] = carry;
      __syncwarp();  // the write seen by every lane
    }
  }

  float R = 0.0f;  // the sum of g w past the segment: 0 past the ray
  for (int seg = segs - 1; seg >= 0; --seg) {
    const int base = seg * kSeg;
    const int n = min(kSeg, s - base), last = s - 1 - base;
    const float carry = base ? ds[base] : 0.0f;
    mip::Run<K> run;
    mip::load_run(run, tt + base, density + o + base, first, n);
    float c[3 * K], gw[K];
    const float* gws = g_w ? g_w + o + base + first : nullptr;
    runs::load(c, rgb + 3 * (o + base + first), 3 * (n - first));
    runs::load(gw, gws, gws ? n - first : 0);
    mip::forward(run, n, last, opaque, dnorm, carry, lane);

    // g_i of the run, and the sums of v = g w above each interval of it
    float g[K], above[K], v = 0.0f;
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      g[j] = 0.0f;
      above[j] = v;
      if (first + j < n) {
        g[j] = gw[j] + ga + gc[0] * c[3 * j] + gc[1] * c[3 * j + 1] +
               gc[2] * c[3 * j + 2] +
               gd * (0.5f * (run.t[j + 1] + run.t[j]));
        v += g[j] * run.w(j);
      }
    }
    // inclusive suffix sum over the lanes, then the lanes above this one
    float S = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float dn = __shfl_down_sync(kFull, S, d);
      if (lane + d < 32) S += dn;
    }
    float lanes_above = __shfl_down_sync(kFull, S, 1);
    if (lane == 31) lanes_above = 0.0f;
    const float top = R + lanes_above;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = first + j;
      if (i < n) {
        const float w = run.w(j);
        ss[i] = (opaque && i == last)
                    ? 0.0f
                    : run.delta[j] * (g[j] * run.e[j] * run.trans[j] -
                                      (top + above[j]));
        rs[3 * i] = w * gc[0];
        rs[3 * i + 1] = w * gc[1];
        rs[3 * i + 2] = w * gc[2];
      }
    }
    __syncwarp();
    runs::store<kSeg>(ds + base, ss, n, lane);
    runs::store<3 * kSeg>(d_rgb + 3 * (o + base), rs, 3 * n, lane);
    __syncwarp();  // before the segment below is written over these
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
  const int w = runs::rays_per_block(n_rays);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return runs::with_run_length(s, [&](auto k) {
    constexpr int K = decltype(k)::value;
    const size_t bytes = sizeof(float) * w * 4 * 32 * K;
    composite_mip_bwd_kernel<K><<<(n_rays + w - 1) / w, 32 * w, bytes,
                                  static_cast<cudaStream_t>(stream)>>>(
        f(density), f(tdist), f(dirs), f(rgb), s, n_rays, bg, opaque,
        f(acc), f(g_w), f(g_comp), f(g_acc), f(g_depth),
        static_cast<float*>(d_density), static_cast<float*>(d_rgb));
    return (int)cudaGetLastError();
  });
}
