// Device code shared by the composite kernels that give each lane a run
// of consecutive samples of its ray: D / D' (composite_vanilla*.cu, with
// composite_vanilla_common.cuh) and E / E' (composite_mip*.cu, with
// composite_mip_common.cuh). It knows nothing of either composite: the
// launch shape, the run length and its dispatch, the unrolled register
// loads, the warp sum and the backward kernels' coalesced stores.
//
// Layout. One warp per ray. A ray is taken in segments of 32 K samples, K
// = ceil(S / 32) <= kMaxRun, so up to S = kSegment = 256 the whole ray is
// one segment; past that (no path of the port) segments of 256 follow one
// another with a carry. Lane l owns the run of K consecutive samples [l K,
// l K + K) of a segment and loads it straight into registers in unrolled
// loops: every load of the segment is in flight before the first scan
// step, so a ray waits on one memory round trip, not one a 32-sample
// chunk.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace runs {

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

// p[i], or 0 where the pointer is null (an absent cotangent)
__device__ __forceinline__ float at(const float* p, long long i) {
  return p ? p[i] : 0.0f;
}

// the sum over the warp's lanes, in __shfl_xor_sync tree order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// n <= N floats from shared memory to device memory, coalesced, unrolled
template <int N>
__device__ __forceinline__ void store(float* dst, const float* src, int n,
                                      int lane) {
#pragma unroll
  for (int k = 0; k < (N + 31) / 32; ++k) {
    const int i = lane + 32 * k;
    if (i < n) dst[i] = src[i];
  }
}

}  // namespace runs
