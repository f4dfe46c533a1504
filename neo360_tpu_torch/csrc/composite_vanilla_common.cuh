// Device code shared by kernels D (composite_vanilla.cu) and D'
// (composite_vanilla_bwd.cu): the loads of a lane's run of samples, the
// forward scan that gives alpha_i and the exclusive transmittance A_i
// (both kernels compute them by this one function, so D' differentiates
// exactly the weights D returned), the launch shape and the dispatch on
// the run length.
//
// Layout. One warp per ray. A ray is taken in segments of 32 K samples, K
// = ceil(S / 32) <= kMaxRun, so up to S = kSegment = 256 the whole ray is
// one segment; past that (no path of the port) segments of 256 follow one
// another with a carried transmittance. Lane l owns the run of K
// consecutive samples [l K, l K + K) of a segment and loads its t (and
// the next sample's), sigma and rgb straight into registers in unrolled
// loops: every load of the segment is in flight before the first scan
// step, so a ray waits on one memory round trip, not one a chunk.
//
// Forward scan of a segment (carry T = the transmittance at its start):
//   each lane folds its run in order, keeping the exclusive products
//   P_j = prod_{m<j} q_m (q_i = (1 - alpha_i) + 1e-10) and its total;
//   one __shfl_up_sync Hillis-Steele scan of the 32 totals gives the
//   lane's exclusive product E_l; A_i = (T E_l) P_j, and the carry past
//   the segment is T incl_31. A NaN or inf density propagates as in the
//   plain version: lane l's products see only samples before its own.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace vanilla {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRun = 8;               // samples a lane owns at most
constexpr int kSegment = 32 * kMaxRun;   // samples loaded at once at most
constexpr int kBlockWarps = 4;           // rays a block at most
constexpr int kSMs = 132;                // streaming multiprocessors

// Rays a block: as few as keep the blocks at one an SM where the rays
// allow it (a 256-ray tile is 128 blocks of 2), at most kBlockWarps
inline int rays_per_block(int n_rays) {
  const int w = (n_rays + kSMs - 1) / kSMs;
  return w < 1 ? 1 : w > kBlockWarps ? kBlockWarps : w;
}

// Segments of 32 K samples a ray of S samples takes: one below the
// largest run length, whatever S is, so that the loop over them unrolls
template <int K>
__device__ __forceinline__ int segments(int s) {
  return K < kMaxRun ? 1 : (s + 32 * K - 1) / (32 * K);
}

// Samples a lane owns for S samples a ray
inline int run_length(int s) {
  return s <= kSegment ? (s + 31) / 32 : kMaxRun;
}

// f(std::integral_constant<int, K>) for the run length of S
template <typename F>
int with_run_length(int s, F&& f) {
  switch (run_length(s)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, kMaxRun>{});
  }
}

// x[j] = src[j] for j < m, else 0: one load a register, unrolled, so
// that every load is issued before any result is used
template <int M>
__device__ __forceinline__ void load(float (&x)[M], const float* src,
                                     int m) {
#pragma unroll
  for (int j = 0; j < M; ++j) x[j] = j < m ? src[j] : 0.0f;
}

// One lane's run of K samples of a segment: its t (and the next sample's)
// and sigma, then alpha_i, e_i = exp(-sigma_i delta_i), delta_i and A_i
// (alpha 0, e 1, delta 0 past the segment)
template <int K>
struct Run {
  float t[K + 1], sigma[K];
  float alpha[K], e[K], delta[K], a[K];
};

// Load the run's t and sigma from a segment of n samples starting at t
// and sigma (nt t values: n + 1 where a sample follows the segment, else
// n); the lane's first sample is `first`
template <int K>
__device__ __forceinline__ void load_run(Run<K>& run, const float* t,
                                         const float* sigma, int first,
                                         int n, int nt) {
  load(run.t, t + first, nt - first);
  load(run.sigma, sigma + first, n - first);
}

// The forward scan of a loaded segment of n samples (nt t values; the
// interval past the ray's last sample is 1e10 |d|), `carry` the
// transmittance at its start. Fills the lane's run and returns the
// transmittance past the segment (warp-uniform).
template <int K>
__device__ __forceinline__ float forward(Run<K>& run, int n, int nt,
                                         float dnorm, float carry, int lane) {
  const int first = lane * K;
  float p = 1.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = first + j;
    run.a[j] = p;
    run.alpha[j] = 0.0f;
    run.e[j] = 1.0f;
    run.delta[j] = 0.0f;
    if (i < n) {
      const float delta = (i + 1 < nt) ? (run.t[j + 1] - run.t[j]) * dnorm
                                       : 1e10f * dnorm;
      const float e = expf(-run.sigma[j] * delta);
      const float alpha = 1.0f - e;
      run.delta[j] = delta;
      run.e[j] = e;
      run.alpha[j] = alpha;
      p *= (1.0f - alpha) + 1e-10f;
    }
  }
  float incl = p;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl *= up;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 1.0f;
  const float base = carry * excl;
#pragma unroll
  for (int j = 0; j < K; ++j) run.a[j] = base * run.a[j];
  return carry * __shfl_sync(kFull, incl, 31);
}

}  // namespace vanilla
