// grid_sample_bwd — kernel G': the gradient of grid_sample_fwd (kernel G)
// with respect to the image, from a float32 output cotangent.
//
// Replaces the transpose of neo360_tpu/ops/interpolate.py:grid_sample_2d
// (62-114), which XLA lowers to scatter-adds of the four corner gathers
// (no Pallas kernel).
//
//   dI[b, y_k(p), x_k(p), c] += w_k(p) * g[p, c],  k = 00, 01, 10, 11,
//
// over the corners inside the image, with x_k, y_k and w_k computed as G
// computes them (zeros or border mode). Points with non-finite uv add
// nothing (the plain version, grid_sample_2d_backward_reference, skips
// them too; autograd through the JAX function would add NaN in border
// mode). uv gets no gradient. The f32 sums go into an f32 buffer zeroed
// here; a bf16 image gets them rounded once to bf16 by a second small
// kernel. The order of the atomic adds varies from run to run, so f32 sums
// may differ in the last bits between runs.
//
// Bound: device memory. The least a call moves is the cotangent and uv
// read once and the image gradient written once; the adds collide (every
// pixel gathers the points around it), so they are atomics, and their
// count, not the bytes, is what the design cuts:
// - a group of tpp lanes per point (tpp = C / 4 rounded up to a power of
//   two, at most a warp), each lane owning vectors of V = 4 channels where
//   C allows (2 or 1 otherwise): one vector atomic (atomicAdd on float4,
//   sm_90, global memory) per lane, corner and vector;
// - merge before the atomics: a group walks `run` consecutive points and
//   keeps the four corner sums of the current cell (x0, y0) in registers.
//   A point in the same cell adds to them; a point in the next cell to the
//   right (x0 + 1, the step of a homography along a row) hands the old
//   cell's right corners on as its left ones and issues the atomics of the
//   two it leaves behind; any other point flushes all four. So a run along
//   a row costs about two atomics a point instead of four.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "round_bf16.cuh"

namespace {

constexpr int kThreads = 256;

// A point's cell (image b, corner (x0, y0)) and its four corner weights,
// in G's order and arithmetic; false for a point that adds nothing.
struct Cell {
  int b, x0, y0;
};

__device__ __forceinline__ bool cell_of(const float* __restrict__ uv,
                                        long long p, long long n_points,
                                        int h, int w, bool zeros_mode,
                                        Cell& cell, float (&wk)[4]) {
  const float u = uv[2 * p];
  const float v = uv[2 * p + 1];
  if (!isfinite(u) || !isfinite(v)) return false;
  const float fw = (float)(w - 1);
  const float fh = (float)(h - 1);
  float ix = __fmul_rn(__fmul_rn(__fadd_rn(u, 1.0f), 0.5f), fw);
  float iy = __fmul_rn(__fmul_rn(__fadd_rn(v, 1.0f), 0.5f), fh);
  if (!zeros_mode) {
    ix = fminf(fmaxf(ix, 0.0f), fw);
    iy = fminf(fmaxf(iy, 0.0f), fh);
  }
  const float x0 = floorf(ix);
  const float y0 = floorf(iy);
  // NaN compares false; a cell with no corner inside adds nothing
  if (!(x0 >= -1.0f && x0 <= fw && y0 >= -1.0f && y0 <= fh)) return false;
  const float x1 = __fadd_rn(x0, 1.0f);
  const float y1 = __fadd_rn(y0, 1.0f);
  const float ax = __fsub_rn(x1, ix), bx = __fsub_rn(ix, x0);
  const float ay = __fsub_rn(y1, iy), by = __fsub_rn(iy, y0);
  wk[0] = __fmul_rn(ax, ay);
  wk[1] = __fmul_rn(bx, ay);
  wk[2] = __fmul_rn(ax, by);
  wk[3] = __fmul_rn(bx, by);
  cell.b = (int)(p / n_points);
  cell.x0 = (int)x0;
  cell.y0 = (int)y0;
  return true;
}

template <int V>
__device__ __forceinline__ void load_grad(const float* p, float (&g)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    g[0] = t.x; g[1] = t.y; g[2] = t.z; g[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    g[0] = t.x; g[1] = t.y;
  } else {
    g[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void red(float* p, const float (&s)[V]) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(s[0], s[1], s[2],
                                                        s[3]));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) atomicAdd(p + e, s[e]);
  }
}

// Add corner k's sums of `cell` into the image gradient, if the corner
// lies inside the image.
template <int V>
__device__ __forceinline__ void flush(float* __restrict__ dimage,
                                      const Cell& cell, int k, int h, int w,
                                      int c, int j, const float (&s)[V]) {
  const int x = cell.x0 + (k & 1);
  const int y = cell.y0 + (k >> 1);
  if (x < 0 || x >= w || y < 0 || y >= h) return;
  red<V>(dimage + (((long long)cell.b * h + y) * w + x) * c + j, s);
}

template <int V>
__global__ void __launch_bounds__(kThreads) grid_scatter_kernel(
    const float* __restrict__ grad, const float* __restrict__ uv,
    float* __restrict__ dimage, long long total, long long n_points, int h,
    int w, int c, int tpp, int run, int zeros_mode) {
  const int groups = kThreads / tpp;
  const int slot = threadIdx.x / tpp;
  const int lane = threadIdx.x - slot * tpp;
  const long long p0 = ((long long)blockIdx.x * groups + slot) * run;
  if (p0 >= total) return;
  const long long p1 = min(p0 + run, total);
  const bool zeros = zeros_mode != 0;

  for (int j = lane * V; j < c; j += tpp * V) {
    float acc[4][V];
    Cell cur{-1, 0, 0};
    for (long long p = p0; p < p1; ++p) {
      Cell q;
      float wk[4];
      if (!cell_of(uv, p, n_points, h, w, zeros, q, wk)) continue;
      float g[V];
      load_grad<V>(grad + p * c + j, g);
      // the cell is uniform across the group: every lane has point p
      const bool row = q.b == cur.b && q.y0 == cur.y0;
      if (!(row && q.x0 == cur.x0)) {
        if (row && q.x0 == cur.x0 + 1) {  // step right: keep x1 as x0
          flush<V>(dimage, cur, 0, h, w, c, j, acc[0]);
          flush<V>(dimage, cur, 2, h, w, c, j, acc[2]);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[0][e] = acc[1][e];
            acc[2][e] = acc[3][e];
            acc[1][e] = 0.0f;
            acc[3][e] = 0.0f;
          }
        } else {
          if (cur.b >= 0) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              flush<V>(dimage, cur, k, h, w, c, j, acc[k]);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[k][e] = 0.0f;
        }
        cur = q;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[k][e] += wk[k] * g[e];
    }
    if (cur.b >= 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) flush<V>(dimage, cur, k, h, w, c, j, acc[k]);
    }
  }
}

__global__ void grid_round_bf16_kernel(const float* __restrict__ src,
                                       __nv_bfloat16* __restrict__ dst,
                                       long long n) {
  neo360::round_to_bf16(src, dst, n);
}

template <int V>
void scatter(const float* grad, const float* uv, float* dimage,
             long long total, long long n_points, int h, int w, int c,
             int tpp, int run, int zeros, cudaStream_t s) {
  const long long per_block = (long long)(kThreads / tpp) * run;
  const unsigned blocks = (unsigned)((total + per_block - 1) / per_block);
  grid_scatter_kernel<V><<<blocks, kThreads, 0, s>>>(
      grad, uv, dimage, total, n_points, h, w, c, tpp, run, zeros);
}

}  // namespace

// grad (B, N, C) f32 and uv (B, N, 2) f32, contiguous; scratch: an f32
// buffer of the image's B * H * W * C elements, 16-byte aligned; dimage:
// the gradient in image_dtype (0 = float32: the same buffer as scratch,
// no rounding pass; 1 = bfloat16). run: consecutive points a group walks
// (>= 1). The wrapper (ops/interpolate.py:grid_sample_2d_backward) checks
// devices, types, shapes, contiguity and B * H * W < 2^31.
extern "C" int grid_sample_bwd(const void* grad, const void* uv,
                               void* scratch, void* dimage, int image_dtype,
                               int n_images, long long n_points, int h, int w,
                               int c, int zeros_mode, int run, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(scratch);
  if ((image_dtype == 0) != (dimage == scratch) || image_dtype < 0 ||
      image_dtype > 1 || run < 1)
    return (int)cudaErrorInvalidValue;
  const long long elems = (long long)n_images * h * w * c;
  cudaError_t err = cudaMemsetAsync(acc, 0, elems * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)n_images * n_points;
  if (total > 0 && c > 0) {
    const float* g = static_cast<const float*>(grad);
    const float* u = static_cast<const float*>(uv);
    int v = 4;
    while (v > 1 && (c % v || reinterpret_cast<uintptr_t>(g) % (4 * v)))
      v /= 2;
    const int want = (c + 3) / 4;
    int tpp = 1;
    while (tpp < want && tpp < 32) tpp *= 2;
    if (v == 4)
      scatter<4>(g, u, acc, total, n_points, h, w, c, tpp, run, zeros_mode, s);
    else if (v == 2)
      scatter<2>(g, u, acc, total, n_points, h, w, c, tpp, run, zeros_mode, s);
    else
      scatter<1>(g, u, acc, total, n_points, h, w, c, tpp, run, zeros_mode, s);
  }
  if (image_dtype == 1 && elems > 0)
    grid_round_bf16_kernel<<<neo360::round_blocks(elems),
                             neo360::kRoundThreads, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(dimage), elems);
  return (int)cudaGetLastError();
}
