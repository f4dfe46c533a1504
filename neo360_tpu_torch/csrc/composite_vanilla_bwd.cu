// composite_vanilla_bwd — gradient of composite_vanilla_fwd with respect
// to the colours and densities.
//
// Replaces the transpose XLA derives for neo360_tpu/core/render.py:
// volumetric_rendering (26-52). The JAX package has no Pallas kernel for
// it.
//
// With q_i = (1 - alpha_i) + 1e-10, A_i = prod_{j<i} q_j, w_i = alpha_i
// A_i (composite_vanilla.cu) and the output cotangents gc (rgb, 3), ga
// (acc), gd (depth), gw_i (weights):
//   g_i    = gw_i + ga' + gc . rgb_i + gd * t_i, ga' = ga - sum(gc) with
//            white_bkgd
//   G_{S-1} = 0 (no output reads the transmittance past the last sample),
//   G_{i-1} = q_i G_i + g_i alpha_i           (G_i = dL/dA_{i+1})
//   dL/dalpha_i = A_i (g_i - G_i)
//   dL/drgb_i = w_i gc,  dL/dsigma_i = dL/dalpha_i exp(-sigma_i d_i) d_i
// The reverse scan needs no division by q_i (torch's cumprod backward
// divides), so a ray whose transmittance underflows stays finite. Any
// output cotangent may be absent (a null pointer): it counts as zero. t
// and dirs get no gradient.
//
// Bound: latency, as kernel D's (a few MB a call at most, ~40 flops a
// sample in two dependent scans). Device times below are
// scripts/torch_kernel_times.py --only D on an NVIDIA H100 80GB HBM3 at
// 700 W (launch floor 1.0 us).
//
// Before: one warp a ray, 4 a block, 32-sample chunks, paying kernel D's
// chunk chain twice: a forward pass that stored A_i to the d sigma output,
// then a reverse pass that re-read sigma, t, rgb and A_i from device
// memory before each chunk's pair of 5-step scans; ~0.7-0.9 us a chunk
// (512 x 129: 4.6-4.9 us, 2048 x 193: 7.1-7.5).
//
// Design (composite_vanilla_common.cuh): kernel D's launch shape and
// register loads, with the weights cotangent loaded beside t, sigma and
// rgb, all in flight at once; alpha_i and A_i by D's forward scan, kept
// in the lane's registers between the passes. Reverse: each lane
// composes the affine maps f_i(G) = q_i G + g_i alpha_i of its run from
// its last sample down; one exclusive __shfl_down_sync suffix scan of the
// 32 lanes' maps, applied to the G from above (0 past the ray), gives G
// at each run's last sample, and the lane walks its run down. d sigma and
// d rgb go through shared memory and are stored coalesced: stored
// straight from the runs (3 K words a lane, 12 K bytes apart) they took
// 22 us at 2048 x 193 against 5.0-5.3, and 5.3 against 2.8-2.9 at 512 x
// 129. Up to S = 256 nothing is read twice from device memory and no
// scratch is used. Past 256 (no path of the port), a first pass over the
// segments writes the transmittance at each later segment's start into d
// sigma's slot of that segment's first sample, where its own d sigma
// overwrites it; the reverse pass reloads each segment and reruns its
// forward scan.
//
// After: one memory round trip and the two scans, 1.3-1.8 us above the
// 1.0 us launch floor at 512 rays (512 x 129: 2.7-2.8 us, 4.9 before);
// at 2048 x 193 (5.1 us) the kernel runs at 84% of its byte bound.

#include "composite_vanilla_common.cuh"

namespace {

using runs::at;
using runs::kFull;
using runs::store;

template <int K>
__global__ void __launch_bounds__(32 * runs::kBlockWarps)
    composite_vanilla_bwd_kernel(
        const float* __restrict__ rgb, const float* __restrict__ sigma,
        const float* __restrict__ t, int s, const float* __restrict__ dirs,
        int n_rays, int white_bkgd, const float* g_comp, const float* g_acc,
        const float* g_w, const float* g_depth, float* __restrict__ d_rgb,
        float* __restrict__ d_sigma) {
  constexpr int kSeg = 32 * K;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= n_rays) return;  // uniform across the warp
  // the warp's d sigma (kSeg) and d rgb (3 kSeg), stored coalesced
  float* ss = smem + warp * 4 * kSeg;
  float* rs = ss + kSeg;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  float gc[3];
  for (int k = 0; k < 3; ++k) gc[k] = at(g_comp, 3LL * r + k);
  const float gd = at(g_depth, r);
  float ga = at(g_acc, r);
  if (white_bkgd) ga -= gc[0] + gc[1] + gc[2];
  const long long o = (long long)r * s;
  const int first = lane * K;
  float* ds = d_sigma + o;

  const int segs = runs::segments<K>(s);
  if (segs > 1) {  // the transmittance at each later segment's start
    float trans = 1.0f;
    for (int base = 0; base + kSeg < s; base += kSeg) {
      vanilla::Run<K> run;
      vanilla::load_run(run, t + o + base, sigma + o + base, first, kSeg,
                        kSeg + 1);
      trans = vanilla::forward(run, kSeg, kSeg + 1, dnorm, trans, lane);
      if (lane == 0) ds[base + kSeg] = trans;
      __syncwarp();  // the write seen by every lane
    }
  }

  float G = 0.0f;  // G past the segment: 0 past the ray
  for (int seg = segs - 1; seg >= 0; --seg) {
    const int base = seg * kSeg;
    const int n = min(kSeg, s - base), nt = min(kSeg + 1, s - base);
    const float trans = base ? ds[base] : 1.0f;
    vanilla::Run<K> run;
    vanilla::load_run(run, t + o + base, sigma + o + base, first, n, nt);
    float c[3 * K], gw[K];
    const float* gws = g_w ? g_w + o + base + first : nullptr;
    runs::load(c, rgb + 3 * (o + base + first), 3 * (n - first));
    runs::load(gw, gws, gws ? n - first : 0);
    vanilla::forward(run, n, nt, dnorm, trans, lane);

    // g_i of the run, and the composition f_first o ... o f_last of its
    // maps (outer (q, c) o inner (q', c') = (q q', q c' + c))
    float g[K], Q = 1.0f, C = 0.0f;
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      g[j] = 0.0f;
      if (first + j < n) {
        g[j] = gw[j] + ga + gc[0] * c[3 * j] + gc[1] * c[3 * j + 1] +
               gc[2] * c[3 * j + 2] + gd * run.t[j];
        const float q = (1.0f - run.alpha[j]) + 1e-10f;
        C = q * C + g[j] * run.alpha[j];
        Q = q * Q;
      }
    }
    // inclusive suffix composition over the lanes: F_l o ... o F_31
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float qd = __shfl_down_sync(kFull, Q, d);
      const float cd = __shfl_down_sync(kFull, C, d);
      if (lane + d < 32) {
        C = Q * cd + C;
        Q = Q * qd;
      }
    }
    float qx = __shfl_down_sync(kFull, Q, 1);
    float cx = __shfl_down_sync(kFull, C, 1);
    if (lane == 31) {
      qx = 1.0f;
      cx = 0.0f;
    }
    float gi = qx * G + cx;  // G at the run's last sample
    const float carry =
        __shfl_sync(kFull, Q, 0) * G + __shfl_sync(kFull, C, 0);
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      const int i = first + j;
      if (i < n) {
        const float a = run.a[j], e = run.e[j];
        const float w = (1.0f - e) * a;
        ss[i] = a * (g[j] - gi) * e * run.delta[j];
        rs[3 * i] = w * gc[0];
        rs[3 * i + 1] = w * gc[1];
        rs[3 * i + 2] = w * gc[2];
        gi = ((1.0f - run.alpha[j]) + 1e-10f) * gi + g[j] * run.alpha[j];
      }
    }
    __syncwarp();
    store<kSeg>(ds + base, ss, n, lane);
    store<3 * kSeg>(d_rgb + 3 * (o + base), rs, 3 * n, lane);
    __syncwarp();  // before the segment below is written over these
    G = carry;
  }
}

}  // namespace

// Inputs as composite_vanilla_fwd's. Cotangents, each float32 or null:
// comp (B,3), acc (B,), weights (B,S), depth (B,). Outputs: d rgb (B,S,3),
// d sigma (B,S,1). S >= 1. The wrapper (core/render.py) checks them.
extern "C" int composite_vanilla_bwd(const void* rgb, const void* sigma,
                                     const void* t, int s, const void* dirs,
                                     int n_rays, int white_bkgd,
                                     const void* g_comp, const void* g_acc,
                                     const void* g_w, const void* g_depth,
                                     void* d_rgb, void* d_sigma,
                                     void* stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  if (s < 1) return (int)cudaErrorInvalidValue;
  const int w = runs::rays_per_block(n_rays);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return runs::with_run_length(s, [&](auto k) {
    constexpr int K = decltype(k)::value;
    const size_t bytes = sizeof(float) * w * 4 * 32 * K;
    composite_vanilla_bwd_kernel<K><<<(n_rays + w - 1) / w, 32 * w, bytes,
                                      static_cast<cudaStream_t>(stream)>>>(
        f(rgb), f(sigma), f(t), s, f(dirs), n_rays, white_bkgd, f(g_comp),
        f(g_acc), f(g_w), f(g_depth), static_cast<float*>(d_rgb),
        static_cast<float*>(d_sigma));
    return (int)cudaGetLastError();
  });
}
