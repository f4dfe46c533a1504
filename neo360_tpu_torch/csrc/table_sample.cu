// table_sample_fwd — bilinear sampling from a 2x2 corner table, one row
// gather per point.
//
// Replaces neo360_tpu/ops/interpolate.py:table_sample (147-232), which the
// JAX package leaves to an XLA row gather plus an elementwise fold. It is
// NOT a port of a Pallas kernel: the JAX package has none. Callers:
// nn/triplane.py grid lift, index_grid_tables (three planes) and
// NeRFTP._local_feats_pair (stacked fg/bg pixel-latent table).
//
// Table: (V, H+1, W+1, 4C) rows of the 2x2 neighbourhood
// [P(y0,x0), P(y0,x1), P(y1,x0), P(y1,x1)] (build_corner_table), f32 or
// bf16. uv: (B, N, 2) f32 in [-1, 1] (align_corners=True). Output (B, N, C),
// f32 or bf16. View b reads table view clip(b + view_offset, 0, V-1).
//
// Bound: device memory. Each point reads one 4C row (1 KB at C=128 bf16)
// at a data-dependent address and writes C values; there are 4 flops per
// byte at most. Design: C/VEC threads cooperate on one point, each loading
// one 16-byte vector of every corner (VEC = 8 bf16 or 4 f32), so a warp
// reads whole contiguous 512-byte corner slices; the fold runs in f32
// registers and is rounded once to the output type. The JAX code folds in
// the table's type (bf16 at neo360_fast); the f32 fold here is a deliberate
// difference, shared with the plain PyTorch version.
//
// Non-finite or huge uv (points behind a camera): `inside` is tested and
// indices are clamped in float before any float->int conversion, and
// outside points write zeros without reading the table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2)
    *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(p + i) =
        __floats2bfloat162_rn(v[i], v[i + 1]);
}

constexpr int kThreads = 256;

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) table_sample_kernel(
    const Tin* __restrict__ table, const float* __restrict__ uv,
    Tout* __restrict__ out, int n_views, long long n_points, int h, int w,
    int c, int zeros_mode, int view_offset, int total_views) {
  constexpr int VEC = 16 / sizeof(Tin);
  const int tpp = c / VEC;  // threads per point
  const int ppb = kThreads / tpp;
  const int slot = threadIdx.x / tpp;
  const int lane = threadIdx.x - slot * tpp;
  const long long p = (long long)blockIdx.x * ppb + slot;
  if (slot >= ppb || p >= (long long)n_views * n_points) return;

  const float u = uv[2 * p];
  const float v = uv[2 * p + 1];
  float ix = (u + 1.0f) * 0.5f * (float)(w - 1);
  float iy = (v + 1.0f) * 0.5f * (float)(h - 1);
  if (!zeros_mode) {
    ix = fminf(fmaxf(ix, 0.0f), (float)(w - 1));
    iy = fminf(fmaxf(iy, 0.0f), (float)(h - 1));
  }
  const float x0 = floorf(ix);
  const float y0 = floorf(iy);
  const float fx = ix - x0;
  const float fy = iy - y0;

  float acc[VEC];
  // NaN compares false, so non-finite uv is never inside
  const bool inside = !zeros_mode ||
      (x0 >= -1.0f && x0 <= (float)(w - 1) && y0 >= -1.0f &&
       y0 <= (float)(h - 1));
  if (inside) {
    const float w00 = (1.0f - fx) * (1.0f - fy);
    const float w01 = fx * (1.0f - fy);
    const float w10 = (1.0f - fx) * fy;
    const float w11 = fx * fy;
    const int xb = (int)fminf(fmaxf(x0 + 1.0f, 0.0f), (float)w);
    const int yb = (int)fminf(fmaxf(y0 + 1.0f, 0.0f), (float)h);
    const int b = (int)(p / n_points);
    const int view = min(max(b + view_offset, 0), total_views - 1);
    const Tin* row = table +
        (((long long)view * (h + 1) + yb) * (w + 1) + xb) * 4LL * c +
        lane * VEC;
    float r0[VEC], r1[VEC], r2[VEC], r3[VEC];
    load_vec(row, r0);
    load_vec(row + c, r1);
    load_vec(row + 2 * c, r2);
    load_vec(row + 3 * c, r3);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc[i] = r0[i] * w00 + r1[i] * w01 + r2[i] * w10 + r3[i] * w11;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  }
  store_vec(out + p * c + lane * VEC, acc);
}

template <typename Tin, typename Tout>
void launch(const void* table, const float* uv, void* out, int n_views,
            long long n_points, int h, int w, int c, int zeros_mode,
            int view_offset, int total_views, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(Tin);
  const int ppb = kThreads / (c / VEC);
  const long long total = (long long)n_views * n_points;
  const long long blocks = (total + ppb - 1) / ppb;
  if (blocks == 0) return;
  table_sample_kernel<Tin, Tout><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const Tin*>(table), uv, static_cast<Tout*>(out), n_views,
      n_points, h, w, c, zeros_mode, view_offset, total_views);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. The wrapper
// (ops/interpolate.py:table_sample) checks shapes, types, contiguity and
// that C is a multiple of VEC with C / VEC <= 256.
extern "C" int table_sample_fwd(const void* table, int table_dtype,
                                const void* uv, void* out, int out_dtype,
                                int n_views, long long n_points, int h, int w,
                                int c, int zeros_mode, int view_offset,
                                int total_views, void* stream) {
  const float* uvf = static_cast<const float*>(uv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 0 && out_dtype == 0)
    launch<float, float>(table, uvf, out, n_views, n_points, h, w, c,
                         zeros_mode, view_offset, total_views, s);
  else if (table_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(table, uvf, out, n_views, n_points, h, w, c,
                                 zeros_mode, view_offset, total_views, s);
  else if (table_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(table, uvf, out, n_views, n_points, h, w, c,
                                 zeros_mode, view_offset, total_views, s);
  else if (table_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(table, uvf, out, n_views, n_points,
                                         h, w, c, zeros_mode, view_offset,
                                         total_views, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
