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
// training step, 4096-ray render tiles) a call moves 0.8-3.2 MB (0.2-0.9
// us at the card's memory rate) with about 15 flops an interval: launch
// latency and the dependent memory round trips and scans set the pace.
// Device times below are scripts/torch_kernel_times.py --only E on an
// NVIDIA H100 80GB HBM3 at 700 W, whose launch floor (a 1-element zero_())
// is 1.0 us.
//
// Before: kernel D's old design, one warp a ray, 4 rays a block, 32-
// interval chunks; each chunk's loads were issued only after the previous
// chunk's 5-step warp scan and its carry, so a ray waited on ceil(S / 32)
// memory round trips and scans in a row (2048 x 32: 2.2 us, 2048 x 64:
// 2.5, 4096 x 64: 3.1).
//
// Design (composite_mip_common.cuh, composite_runs.cuh): each lane owns a
// run of K = ceil(S / 32) consecutive intervals and loads its K + 1
// edges, densities and 3 K colours straight into registers in unrolled
// loops, templated on K, so every load is in flight before the first scan
// step; it folds its run, one warp scan combines the lanes, and it stores
// its weights itself. The sums are lane partials reduced once with
// __shfl_xor_sync. Rays a block: as few as keep one block an SM where the
// rays allow, at most 4. S > 256 runs the same code over segments of 256
// with a carried sum. What chose it, device us at 2048 x 64 / 4096 x 32:
// the weights stored through shared memory, coalesced, 2.43-2.44 /
// 2.44 against 2.37-2.38 / 2.35-2.40 stored from the runs (K <= 2 at every
// path shape: at most two 128-byte lines a store instruction).
//
// After: a ray waits on one memory round trip, one warp scan and the
// reduction, 1.0 us above the launch floor at 2048 x 32 (2.11-2.12 ->
// 1.98-1.99 us); 2048 x 64 2.50 -> 2.37-2.38, 4096 x 32 2.61 -> 2.35-2.40,
// and 4096 x 64 3.09-3.10 -> 2.95 (65% of its byte bound).

#include "composite_mip_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(32 * runs::kBlockWarps)
    composite_mip_kernel(const float* __restrict__ density,
                         const float* __restrict__ tdist,
                         const float* __restrict__ dirs,
                         const float* __restrict__ rgb, int s, int n_rays,
                         float bg, int opaque, float* __restrict__ weights,
                         float* __restrict__ comp, float* __restrict__ acc,
                         float* __restrict__ depth) {
  constexpr int kSeg = 32 * K;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // uniform across the warp
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const long long o = (long long)r * s;
  const float* tt = tdist + (long long)r * (s + 1);
  const int first = lane * K;

  float pr = 0.f, pg = 0.f, pb = 0.f, pa = 0.f, pd = 0.f;
  float carry = 0.f;  // the sum of dd before the segment
  for (int seg = 0; seg < runs::segments<K>(s); ++seg) {
    const int base = seg * kSeg;
    const int n = min(kSeg, s - base);
    mip::Run<K> run;
    mip::load_run(run, tt + base, density + o + base, first, n);
    float c[3 * K];
    runs::load(c, rgb + 3 * (o + base + first), 3 * (n - first));
    const float next =
        mip::forward(run, n, s - 1 - base, opaque, dnorm, carry, lane);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (first + j < n) {
        const float w = run.w(j);
        weights[o + base + first + j] = w;
        pa += w;
        pr += w * c[3 * j];
        pg += w * c[3 * j + 1];
        pb += w * c[3 * j + 2];
        pd += w * (0.5f * (run.t[j + 1] + run.t[j]));
      }
    }
    carry = next;
  }
  pr = runs::warp_sum(pr);
  pg = runs::warp_sum(pg);
  pb = runs::warp_sum(pb);
  pa = runs::warp_sum(pa);
  pd = runs::warp_sum(pd);
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
  const int w = runs::rays_per_block(n_rays);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  return runs::with_run_length(s, [&](auto k) {
    constexpr int K = decltype(k)::value;
    composite_mip_kernel<K><<<(n_rays + w - 1) / w, 32 * w, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        f(density), f(tdist), f(dirs), f(rgb), s, n_rays, bg, opaque,
        out(weights), out(comp), out(acc), out(depth));
    return (int)cudaGetLastError();
  });
}
