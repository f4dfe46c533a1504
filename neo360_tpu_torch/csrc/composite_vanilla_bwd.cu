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
// sample in two dependent scans). Design (kernel B''s, for one branch):
// one warp per ray, kWarps rays per block; lane i owns sample base + i of
// a 32-sample chunk, loads and stores coalesced.
//   forward: alpha_i and the exclusive transmittance A_i by kernel D's
//     __shfl_up_sync product scan (A_i and w_i are D's bit for bit); A_i
//     goes to the d sigma output (its own slot: no scratch).
//   reverse: from the last chunk down, an exclusive suffix scan of the
//     affine maps f_i(G) = q_i G + g_i alpha_i with __shfl_down_sync
//     composes f_{i+1} o ... o f_31 for each lane, applied to the G carried
//     in from the chunk above; the carry to the chunk below is f_base
//     applied once more. Lanes past S are the identity map (q = 1, c = 0).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float interval(const float* t, int i, int s,
                                          float dnorm) {
  return (i + 1 < s) ? (t[i + 1] - t[i]) * dnorm : 1e10f * dnorm;
}

__device__ __forceinline__ float at(const float* p, long long i) {
  return p ? p[i] : 0.0f;
}

__global__ void __launch_bounds__(32 * kWarps) composite_vanilla_bwd_kernel(
    const float* __restrict__ rgb, const float* __restrict__ sigma,
    const float* __restrict__ t, int s, const float* __restrict__ dirs,
    int n_rays, int white_bkgd, const float* g_comp, const float* g_acc,
    const float* g_w, const float* g_depth, float* __restrict__ d_rgb,
    float* __restrict__ d_sigma) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // uniform across the warp
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const long long o = (long long)r * s;
  const float* rr = rgb + 3 * o;
  const float* sg = sigma + o;
  const float* tt = t + o;
  const float* gw = g_w ? g_w + o : nullptr;
  float* dr = d_rgb + 3 * o;
  float* ds = d_sigma + o;

  // forward: A_i into ds[i]
  float trans = 1.0f;
  for (int base = 0; base < s; base += 32) {
    const int i = base + lane;
    const bool live = i < s;
    float alpha = 0.f;
    if (live) alpha = 1.0f - expf(-sg[i] * interval(tt, i, s, dnorm));
    float incl = live ? (1.0f - alpha) + 1e-10f : 1.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl *= up;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    if (live) ds[i] = trans * excl;
    trans *= __shfl_sync(kFull, incl, 31);
  }

  float gc[3];
  for (int k = 0; k < 3; ++k) gc[k] = at(g_comp, 3LL * r + k);
  const float gd = at(g_depth, r);
  float ga = at(g_acc, r);
  if (white_bkgd) ga -= gc[0] + gc[1] + gc[2];

  // reverse: G carried from the chunk above, 0 above the last sample
  float G = 0.0f;
  for (int base = (s - 1) & ~31; base >= 0; base -= 32) {
    const int i = base + lane;
    const bool live = i < s;
    float q = 1.0f, c = 0.0f, a = 0.0f, e = 1.0f, delta = 0.0f, gi = 0.0f;
    if (live) {
      delta = interval(tt, i, s, dnorm);
      e = expf(-sg[i] * delta);
      const float alpha = 1.0f - e;
      a = ds[i];
      gi = (gw ? gw[i] : 0.0f) + ga + gc[0] * rr[3 * i] +
           gc[1] * rr[3 * i + 1] + gc[2] * rr[3 * i + 2] + gd * tt[i];
      q = (1.0f - alpha) + 1e-10f;
      c = gi * alpha;
    }
    // inclusive suffix composition F_i = f_i o f_{i+1} o ... o f_31:
    // (outer q, c) o (inner q', c') = (q q', q c' + c)
    float Q = q, C = c;
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
    const float g_next = qx * G + cx;  // G_i
    const float carry =
        __shfl_sync(kFull, Q, 0) * G + __shfl_sync(kFull, C, 0);
    if (live) {
      const float w = (1.0f - e) * a;
      dr[3 * i] = w * gc[0];
      dr[3 * i + 1] = w * gc[1];
      dr[3 * i + 2] = w * gc[2];
      ds[i] = a * (gi - g_next) * e * delta;
    }
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
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  composite_vanilla_bwd_kernel<<<blocks, 32 * kWarps, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      f(rgb), f(sigma), f(t), s, f(dirs), n_rays, white_bkgd, f(g_comp),
      f(g_acc), f(g_w), f(g_depth), static_cast<float*>(d_rgb),
      static_cast<float*>(d_sigma));
  return (int)cudaGetLastError();
}
