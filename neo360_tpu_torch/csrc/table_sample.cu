// table_sample_fwd — bilinear sampling from a 2x2 corner table, one row
// per point.
//
// Replaces neo360_tpu/ops/interpolate.py:table_sample (147-232), which the
// JAX package leaves to an XLA row gather plus an elementwise fold. It is
// NOT a port of a Pallas kernel: the JAX package has none. Caller: the
// grid lift of nn/triplane.py (GridEncoder._grid); the tri-plane and local
// gathers of the model have their own fused kernels (triplane_sample.cu,
// local_sample.cu) over the same fold.
//
// Table: (V, H+1, W+1, 4C) rows of the 2x2 neighbourhood
// [P(y0,x0), P(y0,x1), P(y1,x0), P(y1,x1)] (build_corner_table), f32 or
// bf16. uv: (B, N, 2) f32 in [-1, 1] (align_corners=True). Output (B, N, C),
// f32 or bf16. View b reads table view clip(b + view_offset, 0, V-1).
//
// Bound: device memory (4 flops per byte at most). At the neo360 lift
// (a 64^3 grid of 3 views, C = 512 f32) the first design, one point per
// group of threads, moved 8 KB of corner rows through L2 per 2 KB it
// wrote. Design (table_sample_common.cuh): corners computed once per
// point into shared memory, then a group of C/VEC threads walks `run`
// consecutive points (the z cells of a grid pillar) and rereads its corner
// slices only when the row changes; 16-byte stores. The fold runs in f32
// registers and is rounded once to the output type. The JAX code folds
// in the table's type (bf16 at neo360_fast); the f32 fold here is a
// deliberate difference, shared with the plain PyTorch version.

#include "table_sample_common.cuh"

namespace {

using neo360::Corner;
using neo360::kThreads;

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) table_sample_kernel(
    const Tin* __restrict__ table, const float* __restrict__ uv,
    Tout* __restrict__ out, int n_views, long long n_points, int h, int w,
    int c, int zeros_mode, int view_offset, int total_views, int run) {
  constexpr int VEC = neo360::VecOf<Tin>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  Corner* corners = reinterpret_cast<Corner*>(smem);
  const neo360::Walk walk(c, VEC, run);
  const long long total = (long long)n_views * n_points;
  const int slice = walk.lane * VEC;
  const int count = walk.groups * run;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const long long p = walk.base + i;
    if (p >= total) break;
    const int b = (int)(p / n_points);
    const int view = min(max(b + view_offset, 0), total_views - 1);
    corners[i] = neo360::corner(uv[2 * p], uv[2 * p + 1], h, w,
                                zeros_mode != 0, view);
  }
  __syncthreads();
  if (walk.slot >= walk.groups) return;

  neo360::RowCache cache;
  for (int k = 0; k < run; ++k) {
    const int i = walk.slot * run + k;
    const long long p = walk.base + i;
    if (p >= total) break;
    float acc[VEC];
    neo360::fold<Tin, VEC>(table, c, slice, corners[i], cache, acc);
    neo360::store_vec(out + p * c + slice, acc);
  }
}

template <typename Tin, typename Tout>
void launch(const void* table, const float* uv, void* out, int n_views,
            long long n_points, int h, int w, int c, int zeros_mode,
            int view_offset, int total_views, int run, cudaStream_t stream) {
  long long blocks;
  size_t smem;
  neo360::grid_of<Tin>((long long)n_views * n_points, c, 1, &run, &blocks,
                       &smem);
  if (blocks == 0) return;
  table_sample_kernel<Tin, Tout><<<(unsigned)blocks, kThreads, smem,
                                   stream>>>(
      static_cast<const Tin*>(table), uv, static_cast<Tout*>(out), n_views,
      n_points, h, w, c, zeros_mode, view_offset, total_views, run);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. The wrapper
// (ops/interpolate.py:table_sample) checks shapes, types, contiguity,
// that C is a multiple of VEC with C / VEC <= 256, and run >= 1.
extern "C" int table_sample_fwd(const void* table, int table_dtype,
                                const void* uv, void* out, int out_dtype,
                                int n_views, long long n_points, int h, int w,
                                int c, int zeros_mode, int view_offset,
                                int total_views, int run, void* stream) {
  const float* uvf = static_cast<const float*>(uv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 0 && out_dtype == 0)
    launch<float, float>(table, uvf, out, n_views, n_points, h, w, c,
                         zeros_mode, view_offset, total_views, run, s);
  else if (table_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(table, uvf, out, n_views, n_points, h, w, c,
                                 zeros_mode, view_offset, total_views, run,
                                 s);
  else if (table_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(table, uvf, out, n_views, n_points, h, w, c,
                                 zeros_mode, view_offset, total_views, run,
                                 s);
  else if (table_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(table, uvf, out, n_views, n_points,
                                         h, w, c, zeros_mode, view_offset,
                                         total_views, run, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
