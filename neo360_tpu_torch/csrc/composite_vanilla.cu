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
// moves 0.8-9.6 MB (0.2-2.9 us at the card's memory rate) with a dozen
// flops a sample, so latency sets the pace. Device times below are
// scripts/torch_kernel_times.py --only D on an NVIDIA H100 80GB HBM3 at
// 700 W, whose launch floor (a 1-element zero_()) is 1.0 us.
//
// Before: one warp a ray, 4 rays a block, 32-sample chunks. Each chunk's
// loads were issued only after the previous chunk's 5-step warp scan and
// carry, so a ray waited on ceil(S / 32) memory round trips and scans in
// a row: ~0.35-0.45 us a chunk at 256, 512 and 2048 rays alike (256 x
// 193: 3.6-3.9 us, 2048 x 193: 4.1-4.4), and a 256-ray tile filled 64 of
// the 132 SMs.
//
// Design (composite_vanilla_common.cuh): each lane owns a run of K =
// ceil(S / 32) consecutive samples and loads its t, sigma and rgb straight
// into registers in unrolled loops, templated on K, so every load is in
// flight before the first scan step; it folds its run, one warp scan
// combines the lanes, and it stores its weights itself. The sums are lane
// partials reduced once with __shfl_xor_sync. Rays a block: as few as keep
// one block an SM where the rays allow (256 rays: 128 blocks of 2), at
// most 4. S > 256 runs the same code over segments of 256 with a carried
// transmittance. What chose it, device us at 256 x 193 / 2048 x 193:
// staging the ray into shared memory by 4-byte cp.async in a loop, one ray
// a block: 3.4-3.5 / 5.0-5.1 (so many one-warp blocks cost more than the
// chain saved); 4 rays a block: 3.2-3.3 / 4.1-4.3; 16-byte copies: 3.4 /
// 4.8; the copy loops unrolled: 2.8-2.9 / 4.2; a TMA bulk copy of each
// span's 16-byte words (cp.async.bulk and an mbarrier, the ragged ends
// by cp.async): 2.8 / 5.6-5.7; registers, no shared memory: 2.3-2.5 /
// 3.7-4.0. 8 rays a block: 3.3-3.5 / 6.2-6.4; 2 rays a block at 256
// rays: 2.2-2.3 against 2.4 at 4.
//
// After: a ray waits on one memory round trip, one warp scan and the
// reduction. At 256-512 rays that is 1.0-1.3 us above the launch floor
// (256 x 193: 2.3 us, 512 x 65: 1.95); at 2048 x 193 (3.7 us) the kernel
// runs at 77% of its byte bound.

#include "composite_vanilla_common.cuh"

namespace {

using runs::warp_sum;

template <int K>
__global__ void __launch_bounds__(32 * runs::kBlockWarps)
    composite_vanilla_kernel(const float* __restrict__ rgb,
                             const float* __restrict__ sigma,
                             const float* __restrict__ t, int s,
                             const float* __restrict__ dirs, int n_rays,
                             int white_bkgd, float* __restrict__ comp,
                             float* __restrict__ acc,
                             float* __restrict__ weights,
                             float* __restrict__ depth) {
  constexpr int kSeg = 32 * K;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // uniform across the warp
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const long long o = (long long)r * s;
  const int first = lane * K;

  float pr = 0.f, pg = 0.f, pb = 0.f, pacc = 0.f, pdepth = 0.f;
  float trans = 1.0f;  // the transmittance at the segment's start
  for (int seg = 0; seg < runs::segments<K>(s); ++seg) {
    const int base = seg * kSeg;
    const int n = min(kSeg, s - base), nt = min(kSeg + 1, s - base);
    vanilla::Run<K> run;
    vanilla::load_run(run, t + o + base, sigma + o + base, first, n, nt);
    float c[3 * K];
    runs::load(c, rgb + 3 * (o + base + first), 3 * (n - first));
    const float next = vanilla::forward(run, n, nt, dnorm, trans, lane);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (first + j < n) {
        const float w = run.alpha[j] * run.a[j];
        weights[o + base + first + j] = w;
        pacc += w;
        pr += w * c[3 * j];
        pg += w * c[3 * j + 1];
        pb += w * c[3 * j + 2];
        pdepth += w * run.t[j];
      }
    }
    trans = next;
  }
  pr = warp_sum(pr);
  pg = warp_sum(pg);
  pb = warp_sum(pb);
  pacc = warp_sum(pacc);
  pdepth = warp_sum(pdepth);
  if (lane != 0) return;
  if (white_bkgd) {
    pr += 1.0f - pacc;
    pg += 1.0f - pacc;
    pb += 1.0f - pacc;
  }
  comp[3 * r] = pr;
  comp[3 * r + 1] = pg;
  comp[3 * r + 2] = pb;
  acc[r] = pacc;
  depth[r] = pdepth;
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
  const int w = runs::rays_per_block(n_rays);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  return runs::with_run_length(s, [&](auto k) {
    constexpr int K = decltype(k)::value;
    composite_vanilla_kernel<K><<<(n_rays + w - 1) / w, 32 * w, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        f(rgb), f(sigma), f(t), s, f(dirs), n_rays, white_bkgd, out(comp),
        out(acc), out(weights), out(depth));
    return (int)cudaGetLastError();
  });
}
