// Device code shared by kernels E (composite_mip.cu) and E'
// (composite_mip_bwd.cu): the loads of a lane's run of intervals and the
// forward scan that gives e_i = exp(-dd_i), the transmittance T_i and the
// weight w_i = (1 - e_i) T_i. Both kernels compute them by this one
// function, so E' differentiates exactly the weights E returned. The
// layout (one warp a ray, a run of K = ceil(S / 32) intervals a lane,
// segments of 256 past S = 256), the launch shape and the dispatch on the
// run length are composite_runs.cuh's.
//
// Forward scan of a segment (carry = the sum of dd before its start):
//   each lane folds its run in order, keeping the exclusive sums P_j =
//   sum_{m<j} x_m of x_i = dd_i = density_i delta_i (0 for the ray's last
//   interval, which enters no transmittance, and with opaque_background
//   e = 0 there: 1 - exp(-inf)) and its total; one __shfl_up_sync
//   Hillis-Steele scan of the 32 totals gives the lane's exclusive sum
//   E_l; T_i = exp(-((carry + E_l) + P_j)), and the carry past the
//   segment is carry + incl_31. A NaN or inf density propagates as in the
//   plain version: lane l's sums see only intervals before its own.

#pragma once

#include "composite_runs.cuh"

namespace mip {

// One lane's run of K intervals of a segment: its K + 1 edges t and its
// densities, then delta_i = (t_{i+1} - t_i) |d|, e_i and T_i (delta 0, e
// 1, T 0 past the segment)
template <int K>
struct Run {
  float t[K + 1], density[K];
  float delta[K], e[K], trans[K];

  // w_i = alpha_i T_i, alpha_i = 1 - e_i
  __device__ __forceinline__ float w(int j) const {
    return (1.0f - e[j]) * trans[j];
  }
};

// Load the run's edges and densities from a segment of n intervals
// starting at t (n + 1 edges) and density; the lane's first interval is
// `first`
template <int K>
__device__ __forceinline__ void load_run(Run<K>& run, const float* t,
                                         const float* density, int first,
                                         int n) {
  runs::load(run.t, t + first, n + 1 - first);
  runs::load(run.density, density + first, n - first);
}

// The forward scan of a loaded segment of n intervals whose ray ends at
// interval `last` of the segment (>= n where it goes on), `carry` the
// sum of dd before the segment. Fills the lane's run and returns the sum
// past the segment (warp-uniform).
template <int K>
__device__ __forceinline__ float forward(Run<K>& run, int n, int last,
                                         bool opaque, float dnorm,
                                         float carry, int lane) {
  const int first = lane * K;
  float p = 0.0f, pre[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = first + j;
    pre[j] = p;
    run.delta[j] = 0.0f;
    run.e[j] = 1.0f;
    if (i < n) {
      const float delta = (run.t[j + 1] - run.t[j]) * dnorm;
      run.delta[j] = delta;
      if (opaque && i == last) {
        run.e[j] = 0.0f;
      } else {
        const float dd = run.density[j] * delta;
        run.e[j] = expf(-dd);
        if (i < last) p += dd;
      }
    }
  }
  float incl = p;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(runs::kFull, incl, d);
    if (lane >= d) incl += up;
  }
  float excl = __shfl_up_sync(runs::kFull, incl, 1);
  if (lane == 0) excl = 0.0f;
  const float base = carry + excl;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    run.trans[j] = first + j < n ? expf(-(base + pre[j])) : 0.0f;
  }
  return carry + __shfl_sync(runs::kFull, incl, 31);
}

}  // namespace mip
