// Device code shared by kernels D (composite_vanilla.cu) and D'
// (composite_vanilla_bwd.cu): the loads of a lane's run of samples and
// the forward scan that gives alpha_i and the exclusive transmittance A_i
// (both kernels compute them by this one function, so D' differentiates
// exactly the weights D returned). The layout, the launch shape and the
// dispatch on the run length are composite_runs.cuh's.
//
// Forward scan of a segment (carry T = the transmittance at its start):
//   each lane folds its run in order, keeping the exclusive products
//   P_j = prod_{m<j} q_m (q_i = (1 - alpha_i) + 1e-10) and its total;
//   one __shfl_up_sync Hillis-Steele scan of the 32 totals gives the
//   lane's exclusive product E_l; A_i = (T E_l) P_j, and the carry past
//   the segment is T incl_31. A NaN or inf density propagates as in the
//   plain version: lane l's products see only samples before its own.

#pragma once

#include "composite_runs.cuh"

namespace vanilla {

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
  runs::load(run.t, t + first, nt - first);
  runs::load(run.sigma, sigma + first, n - first);
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
    const float up = __shfl_up_sync(runs::kFull, incl, d);
    if (lane >= d) incl *= up;
  }
  float excl = __shfl_up_sync(runs::kFull, incl, 1);
  if (lane == 0) excl = 1.0f;
  const float base = carry * excl;
#pragma unroll
  for (int j = 0; j < K; ++j) run.a[j] = base * run.a[j];
  return carry * __shfl_sync(runs::kFull, incl, 31);
}

}  // namespace vanilla
