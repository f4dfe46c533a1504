// triplane_sample_fwd — the tri-plane world latent of camera-frame points:
// the sum of three zeros-mode corner-table samples in one pass.
//
// Replaces neo360_tpu/nn/triplane.py:index_grid_tables (328-352, the
// semantics of index_grid, 303-325) after its world2camera: the three
// uv slices (x, z), (x, y), (y, z) of the camera points, three
// table_sample calls and their sum, which XLA leaves to gathers and adds.
// The JAX package has no Pallas kernel for it.
//
//   out[b, n] = (A(t_xz, (x, z)) + A(t_xy, (x, y))) + A(t_yz, (y, z))
//
// with (x, y, z) = cam[b, n], each A the f32 fold of kernel A in zeros
// mode reading table view clip(b + view_offset, 0, V-1), and the two adds
// rounded in that order (the plain version's). Tables (V, H+1, W+1, 4C),
// f32 or bf16; cam (B, N, 3) f32; out[b, n] goes where `Dest` puts point
// n of view b (table_sample_common.cuh): rows of f32 or bf16 (rounded to
// nearest even, as `.to(torch.bfloat16)` rounds), one (B, N, C) output or
// the [fg | bg] halves of each view's points into two callers' buffers at
// a row stride and a column offset.
//
// Bound: device memory. The least a call moves is cam and the output once
// and the distinct rows the points touch; the unfused chain (three uv
// copies, three f32 outputs, two adds) moved about nine times the output.
// Design: the fold of table_sample_common.cuh with one row cache per
// plane, so a group of C/VEC threads walking consecutive samples of a ray
// rereads a plane's corner slices only when that plane's row changes; the
// three folds and the sum stay in registers; one write, into the first
// GEMM's operand of the conditioned MLP on the model's path, so that no
// copy of the latent follows.

#include "table_sample_common.cuh"

namespace {

using neo360::Corner;
using neo360::kThreads;

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) triplane_sample_kernel(
    const Tin* __restrict__ t_xz, const Tin* __restrict__ t_xy,
    const Tin* __restrict__ t_yz, const float* __restrict__ cam,
    neo360::Dest<Tout> out, int n_views, long long n_points, int h, int w,
    int c, int view_offset, int total_views, int run) {
  constexpr int VEC = neo360::VecOf<Tin>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  Corner* corners = reinterpret_cast<Corner*>(smem);  // (count, 3)
  const neo360::Walk walk(c, VEC, run);
  const long long total = (long long)n_views * n_points;
  const int count = walk.groups * run;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const long long p = walk.base + i;
    if (p >= total) break;
    const int b = (int)(p / n_points);
    const int view = min(max(b + view_offset, 0), total_views - 1);
    const float x = cam[3 * p], y = cam[3 * p + 1], z = cam[3 * p + 2];
    corners[3 * i] = neo360::corner(x, z, h, w, true, view);
    corners[3 * i + 1] = neo360::corner(x, y, h, w, true, view);
    corners[3 * i + 2] = neo360::corner(y, z, h, w, true, view);
  }
  __syncthreads();
  if (walk.slot >= walk.groups) return;

  neo360::RowCache c_xz, c_xy, c_yz;
  const int slice = walk.lane * VEC;
  // the run's first point as (view, point of the view), then stepped
  long long view = (walk.base + walk.slot * run) / n_points;
  long long n = walk.base + walk.slot * run - view * n_points;
  for (int k = 0; k < run; ++k, ++n) {
    const int i = walk.slot * run + k;
    const long long p = walk.base + i;
    if (p >= total) break;
    if (n == n_points) {
      n = 0;
      ++view;
    }
    float a[VEC], b[VEC], d[VEC];
    neo360::fold<Tin, VEC>(t_xz, c, slice, corners[3 * i], c_xz, a);
    neo360::fold<Tin, VEC>(t_xy, c, slice, corners[3 * i + 1], c_xy, b);
    neo360::fold<Tin, VEC>(t_yz, c, slice, corners[3 * i + 2], c_yz, d);
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[j] = __fadd_rn(__fadd_rn(a[j], b[j]), d[j]);
    neo360::store_vec(out.at(view, n) + slice, a);
  }
}

template <typename Tin, typename Tout>
void launch(const void* t_xz, const void* t_xy, const void* t_yz,
            const float* cam, const neo360::Rows& rows, int n_views,
            long long n_points, int h, int w, int c, int view_offset,
            int total_views, int run, cudaStream_t stream) {
  long long blocks;
  size_t smem;
  neo360::grid_of<Tin>((long long)n_views * n_points, c, 3, &run, &blocks,
                       &smem);
  if (blocks == 0) return;
  triplane_sample_kernel<Tin, Tout>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          static_cast<const Tin*>(t_xz), static_cast<const Tin*>(t_xy),
          static_cast<const Tin*>(t_yz), cam, rows.as<Tout>(n_points),
          n_views, n_points, h, w, c, view_offset, total_views, run);
}

template <typename Tin>
int launch_to(int out_dtype, const void* t_xz, const void* t_xy,
              const void* t_yz, const float* cam, const neo360::Rows& rows,
              int n_views, long long n_points, int h, int w, int c,
              int view_offset, int total_views, int run,
              cudaStream_t stream) {
  if (out_dtype == 0)
    launch<Tin, float>(t_xz, t_xy, t_yz, cam, rows, n_views, n_points, h, w,
                       c, view_offset, total_views, run, stream);
  else if (out_dtype == 1)
    launch<Tin, __nv_bfloat16>(t_xz, t_xy, t_yz, cam, rows, n_views,
                               n_points, h, w, c, view_offset, total_views,
                               run, stream);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (all three tables; the output
// rows). first, second, split, ld_first, ld_second, col: the output
// contract (`Dest`). The wrapper (ops/interpolate.py:triplane_sample)
// checks shapes, types, contiguity, that C is a multiple of VEC with
// C / VEC <= 256, that both ld and col are multiples of VEC, and run >= 1.
extern "C" int triplane_sample_fwd(const void* t_xz, const void* t_xy,
                                   const void* t_yz, int table_dtype,
                                   const void* cam, void* first,
                                   void* second, int out_dtype,
                                   long long split, long long ld_first,
                                   long long ld_second, int col, int n_views,
                                   long long n_points, int h, int w, int c,
                                   int view_offset, int total_views, int run,
                                   void* stream) {
  const float* camf = static_cast<const float*>(cam);
  const neo360::Rows rows{first, second, split, ld_first, ld_second, col};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (table_dtype == 0)
    err = launch_to<float>(out_dtype, t_xz, t_xy, t_yz, camf, rows, n_views,
                           n_points, h, w, c, view_offset, total_views, run,
                           s);
  else if (table_dtype == 1)
    err = launch_to<__nv_bfloat16>(out_dtype, t_xz, t_xy, t_yz, camf, rows,
                                   n_views, n_points, h, w, c, view_offset,
                                   total_views, run, s);
  else
    return (int)cudaErrorInvalidValue;
  return err ? err : (int)cudaGetLastError();
}
