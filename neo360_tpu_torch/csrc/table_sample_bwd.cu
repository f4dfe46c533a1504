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
// Two contracts share one scatter kernel:
// - dense (table_sample_bwd): the table-shaped gradient. f32 adds into an
//   f32 scratch of the table's size, zeroed here, then rounded once to the
//   table's type (bf16 at neo360_fast). The JAX code accumulates in the
//   table's type; like the forward's f32 fold, this is a deliberate
//   difference, shared with the plain PyTorch version
//   (ops/interpolate.py:table_sample_backward_reference).
// - accumulate (table_sample_bwd_acc): f32 adds straight into a caller's
//   f32 accumulator of the table's shape (the stage trainer's), with no
//   scratch, no memset and no rounding pass; the plain version is
//   ops/interpolate.py:table_sample_accumulate_reference.
// The order of the atomic adds varies from run to run, so f32 sums may
// differ in the last bits between runs.
//
// Bound: device-memory traffic. The least a call must move is the
// cotangent (C values a point) and uv read once plus, per distinct row
// the points touch, 4C f32 read and written (accumulate), or the whole
// table written (dense). The rows are data-dependent and collide, so the
// adds are atomics; their count, not the bytes, limited the first
// version (one f32 atomic per channel and corner, 4C a point). Design:
// - C/4 threads per point, each owning four consecutive channels, so a
//   warp's adds to one corner block cover consecutive addresses;
// - one vector atomic (atomicAdd on float4, sm_90, global memory) per
//   thread and corner block: four channels per atomic instead of one;
// - each thread group walks kRun consecutive points (consecutive samples
//   of one ray) and sums, in registers, the contributions of a run of
//   points that read the same row, issuing the atomics once per run;
// - the dense contract's zeroing and rounding are one memset and one
//   vectorised pass over the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "round_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // channels per thread
constexpr int kRun = 8;  // consecutive points per thread group

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

// Row index and corner weights of point p, as table_sample_fwd computes
// them; false for a point that writes nothing.
__device__ __forceinline__ bool point_row(
    const float* __restrict__ uv, long long p, long long n_points, int h,
    int w, int zeros_mode, int view_offset, int total_views, long long& row,
    float (&wk)[4]) {
  const float u = uv[2 * p];
  const float v = uv[2 * p + 1];
  if (!isfinite(u) || !isfinite(v)) return false;
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
    return false;
  const float fx = ix - x0;
  const float fy = iy - y0;
  wk[0] = (1.0f - fx) * (1.0f - fy);
  wk[1] = fx * (1.0f - fy);
  wk[2] = (1.0f - fx) * fy;
  wk[3] = fx * fy;
  const int xb = (int)fminf(fmaxf(x0 + 1.0f, 0.0f), (float)w);
  const int yb = (int)fminf(fmaxf(y0 + 1.0f, 0.0f), (float)h);
  const int b = (int)(p / n_points);
  const int view = min(max(b + view_offset, 0), total_views - 1);
  row = ((long long)view * (h + 1) + yb) * (w + 1) + xb;
  return true;
}

__device__ __forceinline__ void flush(float* __restrict__ dst, int c,
                                      const float4 (&sum)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    atomicAdd(reinterpret_cast<float4*>(dst + k * c), sum[k]);
}

template <typename Tg>
__global__ void __launch_bounds__(kThreads) table_scatter_kernel(
    const Tg* __restrict__ grad, const float* __restrict__ uv,
    float* __restrict__ dtable, long long total, long long n_points, int h,
    int w, int c, int zeros_mode, int view_offset, int total_views) {
  const int tpp = c / kVec;  // threads per point
  const int groups = kThreads / tpp;
  const int slot = threadIdx.x / tpp;
  const int lane = threadIdx.x - slot * tpp;
  const long long p0 = ((long long)blockIdx.x * groups + slot) * kRun;
  if (slot >= groups || p0 >= total) return;
  const long long p1 = min(p0 + kRun, total);

  float4 sum[4] = {};
  long long cur = -1;
  for (long long p = p0; p < p1; ++p) {
    long long row;
    float wk[4];
    if (!point_row(uv, p, n_points, h, w, zeros_mode, view_offset,
                   total_views, row, wk))
      continue;
    float g[4];
    load4(grad + p * c + lane * kVec, g);
    if (row != cur) {  // uniform across the group: every thread has row
      if (cur >= 0) flush(dtable + cur * 4LL * c + lane * kVec, c, sum);
      cur = row;
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sum[k].x += wk[k] * g[0];
      sum[k].y += wk[k] * g[1];
      sum[k].z += wk[k] * g[2];
      sum[k].w += wk[k] * g[3];
    }
  }
  if (cur >= 0) flush(dtable + cur * 4LL * c + lane * kVec, c, sum);
}

__global__ void round_to_bf16_kernel(const float* __restrict__ src,
                                     __nv_bfloat16* __restrict__ dst,
                                     long long n) {
  neo360::round_to_bf16(src, dst, n);
}

int scatter(const void* grad, int grad_dtype, const void* uv, float* dst,
            int n_views, long long n_points, int h, int w, int c,
            int zeros_mode, int view_offset, int total_views,
            cudaStream_t s) {
  const int groups = kThreads / (c / kVec);
  const long long total = (long long)n_views * n_points;
  const long long per_block = (long long)groups * kRun;
  const long long blocks = (total + per_block - 1) / per_block;
  const float* uvf = static_cast<const float*>(uv);
  if (blocks == 0) return (int)cudaSuccess;
  if (grad_dtype == 0)
    table_scatter_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(grad), uvf, dst, total, n_points, h, w, c,
        zeros_mode, view_offset, total_views);
  else if (grad_dtype == 1)
    table_scatter_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(grad), uvf, dst, total, n_points, h,
        w, c, zeros_mode, view_offset, total_views);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// The dense contract. dtype codes: 0 = float32, 1 = bfloat16. grad
// (B, N, C) in grad_dtype; uv (B, N, 2) f32; scratch: an f32 buffer of the
// table's element count (table_elems, even); dtable: the gradient, in
// table_dtype. For an f32 table, scratch and dtable may be the same buffer
// (no rounding pass). The wrapper (ops/interpolate.py) checks shapes,
// types, 16-byte alignment and C % 4 == 0, C / 4 <= 256.
extern "C" int table_sample_bwd(const void* grad, int grad_dtype,
                                const void* uv, void* scratch, void* dtable,
                                int table_dtype, int n_views,
                                long long n_points, int h, int w, int c,
                                int zeros_mode, int view_offset,
                                int total_views, long long table_elems,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(scratch);
  if (table_dtype != 0 && table_dtype != 1) return (int)cudaErrorInvalidValue;
  if (table_dtype == 0 && dtable != scratch) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(acc, 0, table_elems * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const int rc = scatter(grad, grad_dtype, uv, acc, n_views, n_points, h, w,
                         c, zeros_mode, view_offset, total_views, s);
  if (rc != 0) return rc;
  if (table_dtype == 1 && table_elems > 0)
    round_to_bf16_kernel<<<neo360::round_blocks(table_elems),
                           neo360::kRoundThreads, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(dtable), table_elems);
  return (int)cudaGetLastError();
}

// The accumulate contract: adds the gradient into `acc`, an f32 tensor of
// the table's shape, which the caller owns and zeroes. Same arguments as
// above otherwise.
extern "C" int table_sample_bwd_acc(const void* grad, int grad_dtype,
                                    const void* uv, void* acc, int n_views,
                                    long long n_points, int h, int w, int c,
                                    int zeros_mode, int view_offset,
                                    int total_views, void* stream) {
  return scatter(grad, grad_dtype, uv, static_cast<float*>(acc), n_views,
                 n_points, h, w, c, zeros_mode, view_offset, total_views,
                 static_cast<cudaStream_t>(stream));
}
