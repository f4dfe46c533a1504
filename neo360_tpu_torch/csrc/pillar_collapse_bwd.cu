// pillar_collapse_bwd — gradient of pillar_collapse_fwd with respect to the
// latent and the three logit maps.
//
// Replaces the transpose XLA derives for neo360_tpu/nn/triplane.py:268-294
// (three f32 softmaxes rounded to the latent's type, three f32
// contractions). The JAX package has no Pallas kernel for it.
//
// For each floor f in (yz, xz, xy), with w32 the f32 softmax along its
// axis, wb = round(w32) the weights the forward used, and g_f the floor's
// cotangent:
//   d latent[n,x,y,z,c] = sum_f wb_f[n,x,y,z] * g_f[n,<kept>,c]
//                         (f32, rounded once to the latent's type)
//   dw_f[cell]          = round(sum_c g_f[n,<kept>,c] * latent[cell,c])
//   d logit_f[cell]     = round(w32 * (dw_f - sum_axis w32 * dw_f))
// Rounding follows the plain version's autograd (ops/pillar.py): the
// cotangent of the rounded weights is rounded to the latent's type, and
// the logit gradient to the logits' type.
//
// Bound: device memory. The latent (403 MB in bf16 at neo360_fast) is read
// once per floor for dw and its gradient written once: ~1.6 GB, ~0.5 ms at
// the card's bandwidth. Design: two launches.
//   1. One block per (view, floor, pillar), as the forward: the pillar's
//      logits and weights in shared memory; each warp takes cells of the
//      pillar and reduces g . latent over C with coalesced reads and a
//      shuffle; the block then forms the softmax gradient. The rounded
//      weights wb go to an f32 scratch (3 x NV*X*Y*Z floats).
//   2. One thread per (cell, 4 channels) sums the three wb * g terms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLen = 256;  // longest pillar (grid axis); the wrapper checks

template <typename T>
__global__ void __launch_bounds__(kThreads) pillar_dlogit_kernel(
    const T* __restrict__ latent, const T* __restrict__ logit_yz,
    const T* __restrict__ logit_xz, const T* __restrict__ logit_xy,
    const T* __restrict__ g_yz, const T* __restrict__ g_xz,
    const T* __restrict__ g_xy, T* __restrict__ d_yz, T* __restrict__ d_xz,
    T* __restrict__ d_xy, float* __restrict__ wb_yz,
    float* __restrict__ wb_xz, float* __restrict__ wb_xy, int X, int Y,
    int Z, int C) {
  __shared__ float s_w[kMaxLen];   // f32 softmax weights
  __shared__ float s_dw[kMaxLen];  // rounded weight cotangents
  __shared__ float s_red[kWarps];
  const long long n_yz = (long long)Y * Z;
  const long long n_xz = (long long)X * Z;
  const long long n_xy = (long long)X * Y;
  const long long per_view = n_yz + n_xz + n_xy;
  const long long xyz = (long long)X * Y * Z;
  const long long view = blockIdx.x / per_view;
  long long rem = blockIdx.x - view * per_view;

  long long cell0, stride;
  int len;
  const T* logit;
  const T* g;
  T* dlogit;
  float* wb;
  if (rem < n_yz) {               // sum over X, keep (y, z)
    const long long y = rem / Z, z = rem % Z;
    cell0 = view * xyz + y * Z + z;
    stride = (long long)Y * Z;
    len = X;
    logit = logit_yz; dlogit = d_yz; wb = wb_yz;
    g = g_yz + ((view * Y + y) * Z + z) * C;
  } else if (rem < n_yz + n_xz) { // sum over Y, keep (x, z)
    rem -= n_yz;
    const long long x = rem / Z, z = rem % Z;
    cell0 = view * xyz + x * Y * Z + z;
    stride = Z;
    len = Y;
    logit = logit_xz; dlogit = d_xz; wb = wb_xz;
    g = g_xz + ((view * X + x) * Z + z) * C;
  } else {                        // sum over Z, keep (x, y)
    rem -= n_yz + n_xz;
    const long long x = rem / Y, y = rem % Y;
    cell0 = view * xyz + (x * Y + y) * Z;
    stride = 1;
    len = Z;
    logit = logit_xy; dlogit = d_xy; wb = wb_xy;
    g = g_xy + ((view * X + x) * Y + y) * C;
  }

  // softmax in f32, exp(l - max) / sum with the sum in axis order, as the
  // forward kernel computes it
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    s_w[i] = to_float(logit[cell0 + i * stride]);
  __syncthreads();
  float m = -INFINITY;
  for (int i = 0; i < len; ++i) m = fmaxf(m, s_w[i]);
  float sum = 0.0f;
  for (int i = 0; i < len; ++i) sum += expf(s_w[i] - m);
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const float w = expf(s_w[i] - m) / sum;
    s_w[i] = w;
    wb[cell0 + i * stride] = round_to(w, (T*)nullptr);
  }
  __syncthreads();

  // dw_k = sum_c g[c] * latent[cell_k, c], one warp per cell
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = warp; k < len; k += kWarps) {
    const T* row = latent + (cell0 + k * stride) * C;
    float acc = 0.0f;
    for (int c = lane; c < C; c += 32)
      acc += to_float(g[c]) * to_float(row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s_dw[k] = round_to(acc, (T*)nullptr);
  }
  __syncthreads();

  // s = sum_k w32_k dw_k (block reduction), then the softmax gradient
  float part = 0.0f;
  for (int i = threadIdx.x; i < len; i += blockDim.x) part += s_w[i] * s_dw[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) s_red[warp] = part;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < kWarps; ++i) s += s_red[i];
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    from_float(s_w[i] * (s_dw[i] - s), dlogit + cell0 + i * stride);
}

template <typename T>
__global__ void __launch_bounds__(256) pillar_dlatent_kernel(
    const T* __restrict__ g_yz, const T* __restrict__ g_xz,
    const T* __restrict__ g_xy, const float* __restrict__ wb_yz,
    const float* __restrict__ wb_xz, const float* __restrict__ wb_xy,
    T* __restrict__ d_latent, long long n_cells, int X, int Y, int Z,
    int C) {
  const int per_cell = C / 4;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_cells * per_cell) return;
  const long long cell = idx / per_cell;
  const int c0 = (int)(idx - cell * per_cell) * 4;
  const long long z = cell % Z;
  const long long y = (cell / Z) % Y;
  const long long x = (cell / ((long long)Y * Z)) % X;
  const long long n = cell / ((long long)X * Y * Z);
  const T* gyz = g_yz + ((n * Y + y) * Z + z) * C + c0;
  const T* gxz = g_xz + ((n * X + x) * Z + z) * C + c0;
  const T* gxy = g_xy + ((n * X + x) * Y + y) * C + c0;
  const float a = wb_yz[cell], b = wb_xz[cell], c = wb_xy[cell];
  T* dst = d_latent + cell * C + c0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = a * to_float(gyz[i]);
    v += b * to_float(gxz[i]);
    v += c * to_float(gxy[i]);
    from_float(v, dst + i);
  }
}

template <typename T>
int launch(const void* latent, const void* l_yz, const void* l_xz,
           const void* l_xy, const void* g_yz, const void* g_xz,
           const void* g_xy, void* d_latent, void* d_yz, void* d_xz,
           void* d_xy, float* scratch, int nv, int X, int Y, int Z, int C,
           cudaStream_t stream) {
  const long long n_cells = (long long)nv * X * Y * Z;
  const long long blocks =
      (long long)nv * ((long long)Y * Z + (long long)X * Z + (long long)X * Y);
  if (blocks == 0) return (int)cudaSuccess;
  float* wb_yz = scratch;
  float* wb_xz = scratch + n_cells;
  float* wb_xy = scratch + 2 * n_cells;
  pillar_dlogit_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(latent), static_cast<const T*>(l_yz),
      static_cast<const T*>(l_xz), static_cast<const T*>(l_xy),
      static_cast<const T*>(g_yz), static_cast<const T*>(g_xz),
      static_cast<const T*>(g_xy), static_cast<T*>(d_yz),
      static_cast<T*>(d_xz), static_cast<T*>(d_xy), wb_yz, wb_xz, wb_xy, X,
      Y, Z, C);
  const long long threads = n_cells * (C / 4);
  pillar_dlatent_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0,
                             stream>>>(
      static_cast<const T*>(g_yz), static_cast<const T*>(g_xz),
      static_cast<const T*>(g_xy), wb_yz, wb_xz, wb_xy,
      static_cast<T*>(d_latent), n_cells, X, Y, Z, C);
  return (int)cudaSuccess;
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16, for the latent, logits, floor
// cotangents and all gradients alike. latent (NV,X,Y,Z,C), logits
// (NV,X,Y,Z), g_yz (NV,Y,Z,C), g_xz (NV,X,Z,C), g_xy (NV,X,Y,C); scratch:
// f32, 3*NV*X*Y*Z floats. The wrapper (ops/pillar.py) checks shapes,
// C % 4 == 0 and max(X, Y, Z) <= 256.
extern "C" int pillar_collapse_bwd(const void* latent, const void* logit_yz,
                                   const void* logit_xz, const void* logit_xy,
                                   const void* g_yz, const void* g_xz,
                                   const void* g_xy, void* d_latent,
                                   void* d_yz, void* d_xz, void* d_xy,
                                   void* scratch, int dtype, int nv, int X,
                                   int Y, int Z, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    launch<float>(latent, logit_yz, logit_xz, logit_xy, g_yz, g_xz, g_xy,
                  d_latent, d_yz, d_xz, d_xy, sc, nv, X, Y, Z, C, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(latent, logit_yz, logit_xz, logit_xy, g_yz, g_xz,
                          g_xy, d_latent, d_yz, d_xz, d_xy, sc, nv, X, Y, Z,
                          C, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
