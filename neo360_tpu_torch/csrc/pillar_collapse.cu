// pillar_collapse_fwd — the three softmax-weighted axis collapses of the
// tri-planar encoder, in one launch.
//
// Replaces neo360_tpu/nn/triplane.py:GridEncoder.__call__ (268-294): three
// f32 softmaxes of the TriPillarAggregator logits, each along one grid axis,
// then three dot_general contractions of the (NV, X, Y, Z, C) latent with
// the weights. The JAX package leaves these to XLA; this is NOT a port of a
// Pallas kernel, since the JAX package has none.
//
//   floor_yz[n,y,z,c] = sum_x softmax_x(logit_yz[n,:,y,z])[x] * L[n,x,y,z,c]
//   floor_xz[n,x,z,c] = sum_y softmax_y(logit_xz[n,x,:,z])[y] * L[n,x,y,z,c]
//   floor_xy[n,x,y,c] = sum_z softmax_z(logit_xy[n,x,y,:])[z] * L[n,x,y,z,c]
//
// As in the JAX code, each softmax runs in f32 and its weights are rounded
// to the latent's type (the `.astype(latent.dtype)` at triplane.py:269-274);
// products are summed in f32 and rounded once to the latent's type.
//
// Bound: device memory. The latent is 403 MB in bf16 at neo360_fast
// (3 x 64 x 64 x 32 x 512) and each floor reads all of it once, with two
// flops per element. Design: one block per (view, floor, kept-axis pair)
// loads that pillar's L <= 64 logits into shared memory, computes the
// softmax there, and then its threads walk the C channels, reading each
// pillar cell's channels contiguously (coalesced) and accumulating in
// registers. No weight broadcast or f32 copy of the latent touches device
// memory; the plain version materialises both.

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

template <typename T>
__global__ void __launch_bounds__(kThreads) pillar_collapse_kernel(
    const T* __restrict__ latent, const T* __restrict__ logit_yz,
    const T* __restrict__ logit_xz, const T* __restrict__ logit_xy,
    T* __restrict__ out_yz, T* __restrict__ out_xz, T* __restrict__ out_xy,
    int X, int Y, int Z, int C) {
  extern __shared__ float s_w[];
  const long long n_yz = (long long)Y * Z;
  const long long n_xz = (long long)X * Z;
  const long long n_xy = (long long)X * Y;
  const long long per_view = n_yz + n_xz + n_xy;
  const long long xyz = (long long)X * Y * Z;
  const long long view = blockIdx.x / per_view;
  long long rem = blockIdx.x - view * per_view;

  long long cell0, stride;  // first cell of the pillar, step along it
  int len;
  const T* logit;
  T* dst;
  if (rem < n_yz) {               // sum over X, keep (y, z)
    const long long y = rem / Z, z = rem % Z;
    cell0 = view * xyz + y * Z + z;
    stride = (long long)Y * Z;
    len = X;
    logit = logit_yz;
    dst = out_yz + ((view * Y + y) * Z + z) * C;
  } else if (rem < n_yz + n_xz) { // sum over Y, keep (x, z)
    rem -= n_yz;
    const long long x = rem / Z, z = rem % Z;
    cell0 = view * xyz + x * Y * Z + z;
    stride = Z;
    len = Y;
    logit = logit_xz;
    dst = out_xz + ((view * X + x) * Z + z) * C;
  } else {                        // sum over Z, keep (x, y)
    rem -= n_yz + n_xz;
    const long long x = rem / Y, y = rem % Y;
    cell0 = view * xyz + (x * Y + y) * Z;
    stride = 1;
    len = Z;
    logit = logit_xy;
    dst = out_xy + ((view * X + x) * Y + y) * C;
  }

  for (int i = threadIdx.x; i < len; i += blockDim.x)
    s_w[i] = to_float(logit[cell0 + i * stride]);
  __syncthreads();
  float m = -INFINITY;
  for (int i = 0; i < len; ++i) m = fmaxf(m, s_w[i]);
  float sum = 0.0f;
  for (int i = 0; i < len; ++i) sum += expf(s_w[i] - m);
  __syncthreads();  // every thread has read the logits
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    s_w[i] = round_to(expf(s_w[i] - m) / sum, (T*)nullptr);
  __syncthreads();

  const T* base = latent + cell0 * C;
  const long long step = stride * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < len; ++k)
      acc += s_w[k] * to_float(base[k * step + c]);
    from_float(acc, dst + c);
  }
}

template <typename T>
void launch(const void* latent, const void* l_yz, const void* l_xz,
            const void* l_xy, void* o_yz, void* o_xz, void* o_xy, int nv,
            int X, int Y, int Z, int C, cudaStream_t stream) {
  const long long blocks =
      (long long)nv * ((long long)Y * Z + (long long)X * Z + (long long)X * Y);
  if (blocks == 0) return;
  const int lmax = X > Y ? (X > Z ? X : Z) : (Y > Z ? Y : Z);
  pillar_collapse_kernel<T><<<(unsigned)blocks, kThreads,
                              lmax * sizeof(float), stream>>>(
      static_cast<const T*>(latent), static_cast<const T*>(l_yz),
      static_cast<const T*>(l_xz), static_cast<const T*>(l_xy),
      static_cast<T*>(o_yz), static_cast<T*>(o_xz), static_cast<T*>(o_xy),
      X, Y, Z, C);
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16, for the latent, the logits and the
// outputs alike. latent (NV,X,Y,Z,C); logits (NV,X,Y,Z); outputs
// (NV,Y,Z,C), (NV,X,Z,C), (NV,X,Y,C). The wrapper (ops/pillar.py) checks
// them.
extern "C" int pillar_collapse_fwd(const void* latent, const void* logit_yz,
                                   const void* logit_xz, const void* logit_xy,
                                   void* out_yz, void* out_xz, void* out_xy,
                                   int dtype, int nv, int X, int Y, int Z,
                                   int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(latent, logit_yz, logit_xz, logit_xy, out_yz, out_xz,
                  out_xy, nv, X, Y, Z, C, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(latent, logit_yz, logit_xz, logit_xy, out_yz,
                          out_xz, out_xy, nv, X, Y, Z, C, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
