// local_sample_fwd — the pixel-aligned local latent of the fg and bg
// branches: projection into source view 0's image and a border-mode
// corner-table sample of the stacked fg/bg table, in one pass.
//
// Replaces the uv prologue and the table_sample call of
// neo360_tpu/models/neo360.py:NeRFTP._local_feats_pair (276-305): two
// world2camera, two projections, a concatenation, a scale and a subtract
// before the gather, which XLA leaves to elementwise ops and a gather. The
// JAX package has no Pallas kernel for it.
//
// cam (NV, 2M, 3) f32: the camera points of the concatenated [fg | bg]
// points of every source view. Output row r of (2NV, M, C) draws its
// point from branch r / NV (0 fg, 1 bg), view r % NV, and reads table
// view clip(r + view_offset, 0, V-1) of the stacked table (fg rows, then
// bg rows). The output's 2NV·M points go where `Dest` puts the points of
// one view (table_sample_common.cuh): rows of f32 or bf16 (rounded to
// nearest even), one (2NV, M, C) output or the fg and bg branches' NV·M
// points each into a caller's buffer at a row stride and a column offset.
// Per point, with view 0's focal f and centre c (the JAX code takes c[:1]
// and focal[0] for every view):
//   uv = (-xy / (z + 1e-9) * (f, -f) + c) * scale - 1
// each operation rounded on its own (__fdiv_rn, __fmul_rn, __fadd_rn), as
// the plain version's elementwise ops are, so that no contraction into a
// fused multiply-add moves a point across a cell edge.
//
// Bound: device memory: cam and the output once, and the distinct rows
// the points touch. Design: the fold of table_sample_common.cuh; the
// projection is computed once per point in the block's corner pass, and a
// group of C/VEC threads walking consecutive samples of a ray (whose
// projections move a fraction of a cell per sample) rereads its corner
// slices only when the row changes.

#include "table_sample_common.cuh"

namespace {

using neo360::Corner;
using neo360::kThreads;

__device__ __forceinline__ float project(float a, float zd, float f,
                                         float centre, float scale) {
  const float pix = __fadd_rn(__fmul_rn(__fdiv_rn(-a, zd), f), centre);
  return __fsub_rn(__fmul_rn(pix, scale), 1.0f);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) local_sample_kernel(
    const Tin* __restrict__ table, const float* __restrict__ cam,
    const float* __restrict__ focal, const float* __restrict__ centre,
    float sx, float sy, neo360::Dest<Tout> out, int n_views,
    long long m_points, int h, int w, int c, int view_offset,
    int total_views, int run) {
  constexpr int VEC = neo360::VecOf<Tin>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  Corner* corners = reinterpret_cast<Corner*>(smem);
  const neo360::Walk walk(c, VEC, run);
  const long long total = 2LL * n_views * m_points;
  const int count = walk.groups * run;
  const float fx = focal[0], fy = -focal[0];
  const float cx = centre[0], cy = centre[1];
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const long long p = walk.base + i;
    if (p >= total) break;
    const int r = (int)(p / m_points);
    const long long m = p - (long long)r * m_points;
    const int branch = r / n_views;
    const int view = r - branch * n_views;
    const long long q = ((long long)view * 2 + branch) * m_points + m;
    const float zd = __fadd_rn(cam[3 * q + 2], 1e-9f);
    const float u = project(cam[3 * q], zd, fx, cx, sx);
    const float v = project(cam[3 * q + 1], zd, fy, cy, sy);
    const int tview = min(max(r + view_offset, 0), total_views - 1);
    corners[i] = neo360::corner(u, v, h, w, false, tview);
  }
  __syncthreads();
  if (walk.slot >= walk.groups) return;

  neo360::RowCache cache;
  const int slice = walk.lane * VEC;
  for (int k = 0; k < run; ++k) {
    const int i = walk.slot * run + k;
    const long long p = walk.base + i;
    if (p >= total) break;
    float acc[VEC];
    neo360::fold<Tin, VEC>(table, c, slice, corners[i], cache, acc);
    neo360::store_vec(out.at(0, p) + slice, acc);
  }
}

template <typename Tin, typename Tout>
void launch(const void* table, const float* cam, const float* focal,
            const float* centre, float sx, float sy,
            const neo360::Rows& rows, int n_views, long long m_points, int h,
            int w, int c, int view_offset, int total_views, int run,
            cudaStream_t stream) {
  long long blocks;
  size_t smem;
  const long long total = 2LL * n_views * m_points;
  neo360::grid_of<Tin>(total, c, 1, &run, &blocks, &smem);
  if (blocks == 0) return;
  local_sample_kernel<Tin, Tout>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          static_cast<const Tin*>(table), cam, focal, centre, sx, sy,
          rows.as<Tout>(total), n_views, m_points, h, w, c, view_offset,
          total_views, run);
}

template <typename Tin>
int launch_to(int out_dtype, const void* table, const float* cam,
              const float* focal, const float* centre, float sx, float sy,
              const neo360::Rows& rows, int n_views, long long m_points,
              int h, int w, int c, int view_offset, int total_views, int run,
              cudaStream_t stream) {
  if (out_dtype == 0)
    launch<Tin, float>(table, cam, focal, centre, sx, sy, rows, n_views,
                       m_points, h, w, c, view_offset, total_views, run,
                       stream);
  else if (out_dtype == 1)
    launch<Tin, __nv_bfloat16>(table, cam, focal, centre, sx, sy, rows,
                               n_views, m_points, h, w, c, view_offset,
                               total_views, run, stream);
  else
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (the table; the output rows).
// focal: (NV,) f32, centre (NV, 2) f32, both on the card (only view 0's
// are read). first, second, split, ld_first, ld_second, col: the output
// contract (`Dest`, over the 2NV·M output points as one view). The wrapper
// (ops/interpolate.py:local_sample) checks shapes, types, contiguity,
// that C is a multiple of VEC with C / VEC <= 256, that both ld and col
// are multiples of VEC, and run >= 1.
extern "C" int local_sample_fwd(const void* table, int table_dtype,
                                const void* cam, const void* focal,
                                const void* centre, float sx, float sy,
                                void* first, void* second, int out_dtype,
                                long long split, long long ld_first,
                                long long ld_second, int col, int n_views,
                                long long m_points, int h, int w, int c,
                                int view_offset, int total_views, int run,
                                void* stream) {
  const float* camf = static_cast<const float*>(cam);
  const float* ff = static_cast<const float*>(focal);
  const float* cf = static_cast<const float*>(centre);
  const neo360::Rows rows{first, second, split, ld_first, ld_second, col};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (table_dtype == 0)
    err = launch_to<float>(out_dtype, table, camf, ff, cf, sx, sy, rows,
                           n_views, m_points, h, w, c, view_offset,
                           total_views, run, s);
  else if (table_dtype == 1)
    err = launch_to<__nv_bfloat16>(out_dtype, table, camf, ff, cf, sx, sy,
                                   rows, n_views, m_points, h, w, c,
                                   view_offset, total_views, run, s);
  else
    return (int)cudaErrorInvalidValue;
  return err ? err : (int)cudaGetLastError();
}
