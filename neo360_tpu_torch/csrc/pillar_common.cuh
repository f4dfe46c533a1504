// Device code shared by kernels C (pillar_collapse.cu) and C'
// (pillar_collapse_bwd.cu): type conversions, 8- and 16-byte vectors, the
// pillars of the three floors, and the f32 softmax along one pillar, which
// both kernels must compute bit for bit alike (C' rounds the same weights
// the forward used).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace pillar {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// VEC elements of T as one 16- or 8-byte word
template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  using W = float4;
  __device__ static void unpack(W w, float* v) {
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
  __device__ static W pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <int VEC>
struct BfVec {
  using W = typename std::conditional<VEC == 8, uint4, uint2>::type;
  __device__ static void unpack(W w, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ static W pack(const float* v) {
    W w;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    return w;
  }
};
template <>
struct Vec<__nv_bfloat16, 8> : BfVec<8> {};
template <>
struct Vec<__nv_bfloat16, 4> : BfVec<4> {};

struct Pillar {
  long long cell0, stride;  // first cell of the pillar, step along it
  int len, floor;           // floor: 0 = yz (over X), 1 = xz (Y), 2 = xy (Z)
};

// Pillar p of NV * (Y*Z + X*Z + X*Y): view-major, then the floors; within
// a floor the kept axis that is last in memory varies fastest, so
// neighbouring threads read neighbouring cells (yz, xz).
__device__ __forceinline__ Pillar pillar_at(long long p, int X, int Y,
                                            int Z) {
  const long long n_yz = (long long)Y * Z, n_xz = (long long)X * Z,
                  n_xy = (long long)X * Y;
  const long long per_view = n_yz + n_xz + n_xy;
  const long long xyz = (long long)X * Y * Z;
  const long long view = p / per_view;
  long long rem = p - view * per_view;
  if (rem < n_yz)  // sum over X, keep (y, z)
    return {view * xyz + rem, (long long)Y * Z, X, 0};
  rem -= n_yz;
  if (rem < n_xz) {  // sum over Y, keep (x, z)
    const long long x = rem / Z, z = rem % Z;
    return {view * xyz + x * Y * Z + z, Z, Y, 1};
  }
  rem -= n_xz;  // sum over Z, keep (x, y)
  return {view * xyz + rem * Z, 1, Z, 2};
}

// The f32 softmax of one pillar's logits, exp(l - max) / sum with the sum
// in axis order and IEEE division, as ops/pillar.py's plain version takes
// it: calls put(i, w) for each of its len cells.
template <typename T, typename Put>
__device__ __forceinline__ void softmax(const T* logit, long long stride,
                                        int len, Put put) {
  float m = -INFINITY;
  for (int i = 0; i < len; ++i) m = fmaxf(m, to_float(logit[i * stride]));
  float sum = 0.0f;
  for (int i = 0; i < len; ++i) sum += expf(to_float(logit[i * stride]) - m);
  for (int i = 0; i < len; ++i)
    put(i, expf(to_float(logit[i * stride]) - m) / sum);
}

}  // namespace pillar
