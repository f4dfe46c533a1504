// table_sample_bwd — gradient of table_sample_fwd with respect to the
// corner table: a scatter-add of each point's output cotangent into the
// four corner blocks of the one row it read.
//
// Replaces the transpose of the row gather at
// neo360_tpu/ops/interpolate.py:221 (table_sample, 147-232), which XLA
// lowers to a scatter-add in the table's type. The JAX package has no
// Pallas kernel for it.
//
//   dT[row(p), k*C + c] += w_k(p) * g[p, c],  k = 00, 01, 10, 11
//
// with row(p) and w_k(p) recomputed exactly as the forward computes them
// (zeros or border mode, view b reading view clip(b + view_offset, 0,
// V-1)). Points outside the zeros-mode pad and points with non-finite uv
// write nothing. uv gets no gradient.
//
// Accumulation: f32 atomicAdd into an f32 scratch of the table's size,
// zeroed here, then rounded once to the table's type (bf16 at neo360_fast).
// The JAX code accumulates in the table's type; like the forward's f32
// fold, this is a deliberate difference, shared with the plain PyTorch
// version (ops/interpolate.py:table_sample_backward_reference). The order
// of the atomic adds varies from run to run, so f32 sums may differ in the
// last bits between runs.
//
// Bound: atomic throughput in L2 and device memory. Each point reads C
// cotangents and makes 4C f32 atomic adds to one 4C row (2 KB at C=128);
// the grid lift (3 x 131,072 points) makes 2e8 of them into a 120 MB f32
// scratch, mostly L2-resident. Design: C/4 threads per point, each owning
// four consecutive channels, so a warp's adds to one corner block hit
// consecutive addresses; the zeroing and the final rounding are one memset
// and one vectorised pass over the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // channels per thread

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename Tg>
__global__ void __launch_bounds__(kThreads) table_scatter_kernel(
    const Tg* __restrict__ grad, const float* __restrict__ uv,
    float* __restrict__ dtable, int n_views, long long n_points, int h, int w,
    int c, int zeros_mode, int view_offset, int total_views) {
  const int tpp = c / kVec;  // threads per point
  const int ppb = kThreads / tpp;
  const int slot = threadIdx.x / tpp;
  const int lane = threadIdx.x - slot * tpp;
  const long long p = (long long)blockIdx.x * ppb + slot;
  if (slot >= ppb || p >= (long long)n_views * n_points) return;

  const float u = uv[2 * p];
  const float v = uv[2 * p + 1];
  if (!isfinite(u) || !isfinite(v)) return;
  float ix = (u + 1.0f) * 0.5f * (float)(w - 1);
  float iy = (v + 1.0f) * 0.5f * (float)(h - 1);
  if (!zeros_mode) {
    ix = fminf(fmaxf(ix, 0.0f), (float)(w - 1));
    iy = fminf(fmaxf(iy, 0.0f), (float)(h - 1));
  }
  const float x0 = floorf(ix);
  const float y0 = floorf(iy);
  if (zeros_mode && !(x0 >= -1.0f && x0 <= (float)(w - 1) && y0 >= -1.0f &&
                      y0 <= (float)(h - 1)))
    return;
  const float fx = ix - x0;
  const float fy = iy - y0;
  const float wk[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                       (1.0f - fx) * fy, fx * fy};
  const int xb = (int)fminf(fmaxf(x0 + 1.0f, 0.0f), (float)w);
  const int yb = (int)fminf(fmaxf(y0 + 1.0f, 0.0f), (float)h);
  const int b = (int)(p / n_points);
  const int view = min(max(b + view_offset, 0), total_views - 1);
  float* row = dtable +
      (((long long)view * (h + 1) + yb) * (w + 1) + xb) * 4LL * c +
      lane * kVec;
  float g[4];
  load4(grad + p * c + lane * kVec, g);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) atomicAdd(row + k * c + i, wk[k] * g[i]);
  }
}

__global__ void round_to_bf16_kernel(const float* __restrict__ src,
                                     __nv_bfloat16* __restrict__ dst,
                                     long long n2) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n2; i += (long long)gridDim.x * blockDim.x) {
    const float2 f = reinterpret_cast<const float2*>(src)[i];
    reinterpret_cast<__nv_bfloat162*>(dst)[i] = __floats2bfloat162_rn(f.x, f.y);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. grad (B, N, C) in grad_dtype; uv
// (B, N, 2) f32; scratch: an f32 buffer of the table's element count
// (table_elems, even); dtable: the gradient, in table_dtype. For an f32
// table, scratch and dtable may be the same buffer (no rounding pass). The
// wrapper (ops/interpolate.py) checks shapes, types and C % 4 == 0,
// C / 4 <= 256.
extern "C" int table_sample_bwd(const void* grad, int grad_dtype,
                                const void* uv, void* scratch, void* dtable,
                                int table_dtype, int n_views,
                                long long n_points, int h, int w, int c,
                                int zeros_mode, int view_offset,
                                int total_views, long long table_elems,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(scratch);
  cudaError_t err = cudaMemsetAsync(acc, 0, table_elems * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const int ppb = kThreads / (c / kVec);
  const long long total = (long long)n_views * n_points;
  const long long blocks = (total + ppb - 1) / ppb;
  const float* uvf = static_cast<const float*>(uv);
  if (blocks > 0) {
    if (grad_dtype == 0)
      table_scatter_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
          static_cast<const float*>(grad), uvf, acc, n_views, n_points, h, w,
          c, zeros_mode, view_offset, total_views);
    else if (grad_dtype == 1)
      table_scatter_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0,
                                            s>>>(
          static_cast<const __nv_bfloat16*>(grad), uvf, acc, n_views,
          n_points, h, w, c, zeros_mode, view_offset, total_views);
    else
      return (int)cudaErrorInvalidValue;
  }
  if (table_dtype == 1) {
    const long long n2 = table_elems / 2;
    const long long want = (n2 + 255) / 256;
    const unsigned grid = (unsigned)(want < 132 * 16 ? want : 132 * 16);
    if (grid > 0)
      round_to_bf16_kernel<<<grid, 256, 0, s>>>(
          acc, static_cast<__nv_bfloat16*>(dtable), n2);
  } else if (table_dtype != 0 || dtable != scratch) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
