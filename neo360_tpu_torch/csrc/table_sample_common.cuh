// table_sample_common.cuh — the corner-table fold shared by kernel A
// (table_sample.cu), the fused tri-plane gather (triplane_sample.cu) and
// the fused local gather (local_sample.cu).
//
// A corner table holds, per cell (y0+1, x0+1), the row
// [P(y0,x0), P(y0,x1), P(y1,x0), P(y1,x1)] of 4C values (f32 or bf16), so
// a bilinear sample is one row read and a 4-term fold.
//
// Bound: device memory, and at the call shapes the L2-to-SM traffic in
// front of it. A point writes C values but reads 4C: the first design
// (one row gather per point) asked L2 for four times the bytes it wrote.
// Consecutive points (the z cells of one grid pillar, the samples of one
// ray) often fall in one cell, so the design here:
// - a block first computes, one thread per point, each point's row and
//   four f32 weights into shared memory (`corner`), once and not once per
//   channel lane;
// - a group of C/VEC threads (VEC = 16 bytes of the table's type) then
//   walks a run of consecutive points and reloads its 16-byte slices of
//   the four corners only when the point's row changes (`RowCache`): the
//   forward form of kernel A''s run merging;
// - the fold runs in f32 registers, the same expression in every entry
//   point, and the output is written with 16-byte stores where the type
//   allows (8 bytes for 4 bf16); the fused gathers write it where a
//   caller's rows want it (`Dest`).
//
// Points outside the zeros-mode pad, and non-finite points in zeros mode,
// get zero weights and read nothing. In border mode a NaN coordinate gives
// NaN, as the plain version and the JAX code do; infinities clamp to the
// edge. Indices are clamped in float before any float->int conversion.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace neo360 {

constexpr int kThreads = 256;

template <typename T>
struct VecOf;
template <>
struct VecOf<float> {
  static constexpr int N = 4;
};
template <>
struct VecOf<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void unpack(const uint4& t, float (&v)[4]) {
  v[0] = __uint_as_float(t.x);
  v[1] = __uint_as_float(t.y);
  v[2] = __uint_as_float(t.z);
  v[3] = __uint_as_float(t.w);
}

__device__ __forceinline__ void unpack(const uint4& t, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]),
                                            pack2(v[2], v[3]));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}

// One point's table row (-1: outside, nothing read) and corner weights.
struct Corner {
  int row;
  float4 w;  // (w00, w01, w10, w11)
};

// The corner of normalized (u, v) (align_corners=True) in an h x w map of
// table view `view`, in the operation order of the plain version
// (ops/interpolate.py:_corners).
__device__ __forceinline__ Corner corner(float u, float v, int h, int w,
                                         bool zeros_mode, int view) {
  float ix = (u + 1.0f) * 0.5f * (float)(w - 1);
  float iy = (v + 1.0f) * 0.5f * (float)(h - 1);
  if (!zeros_mode) {  // clamp, keeping NaN as torch.clamp does
    ix = isnan(ix) ? ix : fminf(fmaxf(ix, 0.0f), (float)(w - 1));
    iy = isnan(iy) ? iy : fminf(fmaxf(iy, 0.0f), (float)(h - 1));
  }
  const float x0 = floorf(ix);
  const float y0 = floorf(iy);
  Corner k;
  // NaN compares false, so a non-finite point is never inside
  const bool inside = !zeros_mode ||
      (x0 >= -1.0f && x0 <= (float)(w - 1) && y0 >= -1.0f &&
       y0 <= (float)(h - 1));
  if (!inside) {
    k.row = -1;
    k.w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return k;
  }
  const float fx = ix - x0;
  const float fy = iy - y0;
  k.w = make_float4((1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                    (1.0f - fx) * fy, fx * fy);
  const int xb = (int)fminf(fmaxf(x0 + 1.0f, 0.0f), (float)w);
  const int yb = (int)fminf(fmaxf(y0 + 1.0f, 0.0f), (float)h);
  k.row = (view * (h + 1) + yb) * (w + 1) + xb;
  return k;
}

// A thread's 16-byte slices of the four corner blocks of the last row it
// read.
struct RowCache {
  int row = -1;
  uint4 r[4];
};

// acc = this lane's VEC channels of the bilinear sample at corner `k`:
// the four corners folded in f32, rows reloaded only when k.row changes.
// `slice`: the lane's first channel.
template <typename Tin, int VEC>
__device__ __forceinline__ void fold(const Tin* __restrict__ table, int c,
                                     int slice, const Corner& k,
                                     RowCache& cache, float (&acc)[VEC]) {
  if (k.row < 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    return;
  }
  if (k.row != cache.row) {
    const Tin* p = table + (long long)k.row * 4 * c + slice;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cache.r[j] = __ldg(reinterpret_cast<const uint4*>(p + j * c));
    cache.row = k.row;
  }
  float r0[VEC], r1[VEC], r2[VEC], r3[VEC];
  unpack(cache.r[0], r0);
  unpack(cache.r[1], r1);
  unpack(cache.r[2], r2);
  unpack(cache.r[3], r3);
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    acc[i] = r0[i] * k.w.x + r1[i] * k.w.y + r2[i] * k.w.z + r3[i] * k.w.w;
}

// Where the fused gathers write a point's C values (their output
// contract): the points of each of the call's views are split at `split`;
// point n < split of view b is row b * split + n of `first`, point
// n >= split is row b * (per - split) + n - split of `second` (`per`: a
// view's points); a row of `first` is `ld_first` values, one of `second`
// `ld_second`, and the point's start at column `col`. One contiguous
// (views, per, C) output is first = second, split = per, both ld = C,
// col = 0. The wrapper checks that both ld and col are multiples of VEC
// and both buffers 16-byte aligned, so the stores stay 16 (or 8) bytes
// wide.
template <typename T>
struct Dest {
  T* first;
  T* second;
  long long per, split, ld_first, ld_second;
  int col;

  __device__ __forceinline__ T* at(long long b, long long n) const {
    return n < split
               ? first + (b * split + n) * ld_first + col
               : second + (b * (per - split) + (n - split)) * ld_second + col;
  }
};

// The output contract as a C entry takes it, before the output's type is
// known: a Dest without `per`.
struct Rows {
  void* first;
  void* second;
  long long split, ld_first, ld_second;
  int col;

  template <typename T>
  Dest<T> as(long long per) const {
    return {static_cast<T*>(first), static_cast<T*>(second), per, split,
            ld_first, ld_second, col};
  }
};

// How a block divides its points: groups of C/VEC threads, each walking
// `run` consecutive points; the block owns groups * run points from
// blockIdx.x * groups * run.
struct Walk {
  int tpp, groups, slot, lane;
  long long base;

  __device__ __forceinline__ Walk(int c, int vec, int run) {
    tpp = c / vec;
    groups = kThreads / tpp;
    slot = threadIdx.x / tpp;
    lane = threadIdx.x - slot * tpp;
    base = (long long)blockIdx.x * groups * run;
  }
};

// Blocks and dynamic shared memory for `total` points, C channels and
// `tables` corners per point; `run` (points a group walks) is cut so that
// the block's corners fit the 48 KB a launch may take without opting in.
template <typename Tin>
inline void grid_of(long long total, int c, int tables, int* run,
                    long long* blocks, size_t* smem) {
  const int groups = kThreads / (c / VecOf<Tin>::N);
  const int most = (48 * 1024) / (int)(groups * tables * sizeof(Corner));
  *run = std::max(1, std::min(*run, most));
  const long long per_block = (long long)groups * *run;
  *blocks = (total + per_block - 1) / per_block;
  *smem = (size_t)per_block * tables * sizeof(Corner);
}

}  // namespace neo360
