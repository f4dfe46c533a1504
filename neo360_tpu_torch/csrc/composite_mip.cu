// composite_mip_fwd — the MipNeRF-360 volume composite of one level.
//
// Replaces neo360_tpu/core/render.py:compute_alpha_weights + render_mip
// (124-163), which neo360_tpu/models/mipnerf360.py:230-247 calls once per
// level (3 times a step). The JAX package leaves them to XLA scans and
// reductions; it is NOT a port of a Pallas kernel, since the JAX package
// has none.
//
// Per ray, in the JAX functions' order:
//   delta_i = (t_{i+1} - t_i) * |d|, dd_i = density_i * delta_i, and with
//   opaque_background dd_{S-1} = inf (alpha 1); alpha_i = 1 - exp(-dd_i);
//   T_i = exp(-sum_{j<i} dd_j) over j < S-1 only (T_0 = 1); w_i = alpha_i
//   T_i; acc = sum w_i; rgb = sum w_i c_i + max(0, 1 - acc) * bg (NaN
//   propagates as torch.maximum's); depth = sum w_i (t_i + t_{i+1}) / 2.
// It differs from kernel D (composite_vanilla.cu) in the transmittance (an
// exp of a running sum, not a product of (1 - alpha + 1e-10)), in the
// S+1 interval edges, the infinite last interval, the background term and
// the midpoint depth, so it is its own kernel.
//
// Bound: at the path's shapes (2048 rays x 64, 64 and 32 intervals a
// training step, 4096-ray render tiles) a call moves 0.8-3.2 MB (< 1 us at
// the card's memory rate) with about 15 flops an interval: launch latency
// and the dependent scan set the pace. Design (kernel D's): one warp per
// ray, kWarps rays per block; the lanes take 32 consecutive intervals at a
// time (coalesced loads and weight stores); the exclusive running sum of
// dd is a __shfl_up_sync additive scan carried from chunk to chunk; the
// sums are lane partials reduced once with __shfl_xor_sync.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__global__ void __launch_bounds__(32 * kWarps) composite_mip_kernel(
    const float* __restrict__ density, const float* __restrict__ tdist,
    const float* __restrict__ dirs, const float* __restrict__ rgb, int s,
    int n_rays, float bg, int opaque, float* __restrict__ weights,
    float* __restrict__ comp, float* __restrict__ acc,
    float* __restrict__ depth) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // uniform across the warp
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const long long o = (long long)r * s;
  const float* sg = density + o;
  const float* tt = tdist + (long long)r * (s + 1);
  const float* cc = rgb + 3 * o;
  float* ww = weights + o;

  float pr = 0.f, pg = 0.f, pb = 0.f, pa = 0.f, pd = 0.f;
  float carry = 0.f;  // warp-uniform: sum of dd before the chunk
  for (int base = 0; base < s; base += 32) {
    const int i = base + lane;
    const bool live = i < s;
    float alpha = 0.f, mid = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, x = 0.f;
    if (live) {
      const float t0 = tt[i], t1 = tt[i + 1];
      mid = 0.5f * (t1 + t0);
      if (opaque && i == s - 1) {
        alpha = 1.0f;  // 1 - exp(-inf)
      } else {
        const float dd = sg[i] * ((t1 - t0) * dnorm);
        alpha = 1.0f - expf(-dd);
        if (i < s - 1) x = dd;  // the last dd enters no transmittance
      }
      cr = cc[3 * i];
      cg = cc[3 * i + 1];
      cb = cc[3 * i + 2];
    }
    float incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0f;
    const float w = alpha * expf(-(carry + excl));
    if (live) ww[i] = w;
    pa += w;
    pr += w * cr;
    pg += w * cg;
    pb += w * cb;
    pd += w * mid;
    carry += __shfl_sync(kFull, incl, 31);
  }
  pr = warp_sum(pr);
  pg = warp_sum(pg);
  pb = warp_sum(pb);
  pa = warp_sum(pa);
  pd = warp_sum(pd);
  if (lane != 0) return;
  const float om = 1.0f - pa;
  const float bg_w = (om != om) ? om : fmaxf(0.0f, om);
  comp[3 * r] = pr + bg_w * bg;
  comp[3 * r + 1] = pg + bg_w * bg;
  comp[3 * r + 2] = pb + bg_w * bg;
  acc[r] = pa;
  depth[r] = pd;
}

}  // namespace

// All tensors float32 and contiguous: density (B,S), tdist (B,S+1), dirs
// (B,3), rgb (B,S,3); outputs weights (B,S), comp (B,3), acc (B,), depth
// (B,). S >= 1. The wrapper (core/render.py:composite_mip) checks them.
extern "C" int composite_mip_fwd(const void* density, const void* tdist,
                                 const void* dirs, const void* rgb, int s,
                                 int n_rays, float bg, int opaque,
                                 void* weights, void* comp, void* acc,
                                 void* depth, void* stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  if (s < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  composite_mip_kernel<<<blocks, 32 * kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      f(density), f(tdist), f(dirs), f(rgb), s, n_rays, bg, opaque,
      static_cast<float*>(weights), static_cast<float*>(comp),
      static_cast<float*>(acc), static_cast<float*>(depth));
  return (int)cudaGetLastError();
}
