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
// Bound: device memory. The latent (403 MB in bf16 at neo360_fast,
// (3,64,64,32,512)) has to be read once and d latent (403 MB) written
// once; the floors, logits and logit gradients add ~32 MB: ~0.84 GB,
// 0.25 ms at 3.35 TB/s. The first version read the latent once per floor
// with 2-byte loads and wrote d latent in a second launch (~1.2 ms).
// Design: three launches, one of which touches the latent.
//   1. pillar_softmax_kernel, one thread per (view, floor, pillar): the f32
//      softmax of pillar_common.cuh, which the forward kernel's prologue
//      computes too, so that wb = round(w32) is the forward's bit for bit;
//      w32 of the three floors to f32 scratch.
//   2. pillar_dlatent_kernel, the one pass over the latent: a block owns a
//      fixed (view, x), a run of kRunY values of y (one warp each) and all
//      z. Each latent row is loaded once, each d latent row stored once,
//      with 16-byte (or, for a bf16 C that 8 does not divide, 8-byte)
//      vectors; the three dot products dw_f = g_f . latent are f32 warp
//      reductions, rounded to the latent's type and written to a second f32
//      scratch. The floor cotangents (6 + 6 + 12.6 MB at the path's shape)
//      stay in L2: g_xz[n,x,:,:], shared by every y of the block, is staged
//      in shared memory when it fits in 48 KB; g_xy[n,x,y,:] is the same
//      row for every z of a warp (L1); g_yz is read through L2. The latent
//      and d latent stream past the caches (__ldcs / __stcs).
//   3. pillar_dlogit_kernel, one thread per pillar: s = sum_axis w32 * dw
//      in axis order, then the logit gradient.

#include "pillar_common.cuh"

namespace {

using namespace pillar;

constexpr int kThreads = 128;  // threads per block, kernels 1 and 3
constexpr int kRunY = 8;       // warps (values of y) per block, kernel 2
constexpr int kUnroll = 2;     // vectors per lane loaded together, kernel 2
constexpr int kStageBytes = 48 * 1024;

// w32[floor * n_cells + cell] = the floor's f32 softmax weight at the cell
template <typename T>
__global__ void __launch_bounds__(kThreads) pillar_softmax_kernel(
    const T* __restrict__ logit_yz, const T* __restrict__ logit_xz,
    const T* __restrict__ logit_xy, float* __restrict__ w32,
    long long n_pillars, long long n_cells, int X, int Y, int Z) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pillars) return;
  const Pillar pl = pillar_at(p, X, Y, Z);
  const T* logit = pl.floor == 0 ? logit_yz : pl.floor == 1 ? logit_xz
                                                            : logit_xy;
  float* w = w32 + pl.floor * n_cells + pl.cell0;
  softmax(logit + pl.cell0, pl.stride, pl.len,
          [&](int i, float v) { w[i * pl.stride] = v; });
}

template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kRunY) pillar_dlatent_kernel(
    const T* __restrict__ latent, const T* __restrict__ g_yz,
    const T* __restrict__ g_xz, const T* __restrict__ g_xy,
    const float* __restrict__ w32, float* __restrict__ dw,
    T* __restrict__ d_latent, long long n_cells, int X, int Y, int Z, int C,
    int stage) {
  using V = Vec<T, VEC>;
  using W = typename V::W;
  extern __shared__ __align__(16) unsigned char smem[];
  const int runs = (Y + kRunY - 1) / kRunY;
  const long long nx = blockIdx.x / runs;  // n * X + x
  const int y = (int)(blockIdx.x - nx * runs) * kRunY + (threadIdx.x >> 5);
  const long long n = nx / X;
  const int lane = threadIdx.x & 31;
  const int n_vec = C / VEC;

  // g_xz[n, x, :, :] (Z rows of C), staged or read in place
  const T* gxz = g_xz + nx * Z * C;
  if (stage) {
    const W* src = reinterpret_cast<const W*>(gxz);
    W* dst = reinterpret_cast<W*>(smem);
    for (int i = threadIdx.x; i < Z * n_vec; i += blockDim.x)
      dst[i] = __ldg(src + i);
    __syncthreads();
    gxz = reinterpret_cast<const T*>(smem);
  }
  if (y >= Y) return;  // after the only barrier

  const T* gxy = g_xy + (nx * Y + y) * C;
  const long long cell0 = (nx * Y + y) * Z;
  for (int z = 0; z < Z; ++z) {
    const long long cell = cell0 + z;
    const T* lat = latent + cell * C;
    const T* gyz = g_yz + ((n * Y + y) * Z + z) * C;
    const T* gxzr = gxz + (long long)z * C;
    T* dst = d_latent + cell * C;
    const float wyz = round_to(w32[cell], (T*)nullptr);
    const float wxz = round_to(w32[n_cells + cell], (T*)nullptr);
    const float wxy = round_to(w32[2 * n_cells + cell], (T*)nullptr);
    float s_yz = 0.0f, s_xz = 0.0f, s_xy = 0.0f;
    for (int v0 = lane; v0 < n_vec; v0 += 32 * kUnroll) {
      // all of this step's loads first, so that they are in flight together
      W lw[kUnroll], aw[kUnroll], bw[kUnroll], cw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v < n_vec) {
          lw[u] = __ldcs(reinterpret_cast<const W*>(lat) + v);
          aw[u] = __ldg(reinterpret_cast<const W*>(gyz) + v);
          bw[u] = reinterpret_cast<const W*>(gxzr)[v];
          cw[u] = __ldg(reinterpret_cast<const W*>(gxy) + v);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v >= n_vec) break;
        float l[VEC], a[VEC], b[VEC], c[VEC], o[VEC];
        V::unpack(lw[u], l);
        V::unpack(aw[u], a);
        V::unpack(bw[u], b);
        V::unpack(cw[u], c);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s_yz += a[k] * l[k];
          s_xz += b[k] * l[k];
          s_xy += c[k] * l[k];
          float d = wyz * a[k];
          d += wxz * b[k];
          d += wxy * c[k];
          o[k] = d;
        }
        __stcs(reinterpret_cast<W*>(dst) + v, V::pack(o));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s_yz += __shfl_xor_sync(0xffffffffu, s_yz, off);
      s_xz += __shfl_xor_sync(0xffffffffu, s_xz, off);
      s_xy += __shfl_xor_sync(0xffffffffu, s_xy, off);
    }
    if (lane == 0) {
      dw[cell] = round_to(s_yz, (T*)nullptr);
      dw[n_cells + cell] = round_to(s_xz, (T*)nullptr);
      dw[2 * n_cells + cell] = round_to(s_xy, (T*)nullptr);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) pillar_dlogit_kernel(
    const float* __restrict__ w32, const float* __restrict__ dw,
    T* __restrict__ d_yz, T* __restrict__ d_xz, T* __restrict__ d_xy,
    long long n_pillars, long long n_cells, int X, int Y, int Z) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pillars) return;
  const Pillar pl = pillar_at(p, X, Y, Z);
  T* dlogit = (pl.floor == 0 ? d_yz : pl.floor == 1 ? d_xz : d_xy) +
              pl.cell0;
  const long long off = pl.floor * n_cells + pl.cell0;
  const float* w = w32 + off;
  const float* g = dw + off;
  float s = 0.0f;
  for (int i = 0; i < pl.len; ++i) s += w[i * pl.stride] * g[i * pl.stride];
  for (int i = 0; i < pl.len; ++i) {
    const long long k = i * pl.stride;
    from_float(w[k] * (g[k] - s), dlogit + k);
  }
}

template <typename T, int VEC>
int launch(const void* latent, const void* l_yz, const void* l_xz,
           const void* l_xy, const void* g_yz, const void* g_xz,
           const void* g_xy, void* d_latent, void* d_yz, void* d_xz,
           void* d_xy, float* scratch, int nv, int X, int Y, int Z, int C,
           cudaStream_t stream) {
  const long long n_cells = (long long)nv * X * Y * Z;
  const long long n_pillars =
      (long long)nv * ((long long)Y * Z + (long long)X * Z + (long long)X * Y);
  if (n_cells == 0) return (int)cudaSuccess;
  float* w32 = scratch;
  float* dw = scratch + 3 * n_cells;
  const unsigned pillar_blocks =
      (unsigned)((n_pillars + kThreads - 1) / kThreads);
  pillar_softmax_kernel<T><<<pillar_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(l_yz), static_cast<const T*>(l_xz),
      static_cast<const T*>(l_xy), w32, n_pillars, n_cells, X, Y, Z);
  const long long stage_bytes = (long long)Z * C * sizeof(T);
  const int stage = stage_bytes <= kStageBytes;
  const long long blocks = (long long)nv * X * ((Y + kRunY - 1) / kRunY);
  pillar_dlatent_kernel<T, VEC><<<(unsigned)blocks, 32 * kRunY,
                                  stage ? (size_t)stage_bytes : 0, stream>>>(
      static_cast<const T*>(latent), static_cast<const T*>(g_yz),
      static_cast<const T*>(g_xz), static_cast<const T*>(g_xy), w32, dw,
      static_cast<T*>(d_latent), n_cells, X, Y, Z, C, stage);
  pillar_dlogit_kernel<T><<<pillar_blocks, kThreads, 0, stream>>>(
      w32, dw, static_cast<T*>(d_yz), static_cast<T*>(d_xz),
      static_cast<T*>(d_xy), n_pillars, n_cells, X, Y, Z);
  return (int)cudaSuccess;
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16, for the latent, logits, floor
// cotangents and all gradients alike. latent (NV,X,Y,Z,C), logits
// (NV,X,Y,Z), g_yz (NV,Y,Z,C), g_xz (NV,X,Z,C), g_xy (NV,X,Y,C); scratch:
// f32, 6*NV*X*Y*Z floats. The latent, the cotangents and d latent must be
// 16-byte aligned. The wrapper (ops/pillar.py) checks shapes, alignment,
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
  if (C % 4) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch<float, 4>(latent, logit_yz, logit_xz, logit_xy, g_yz, g_xz, g_xy,
                     d_latent, d_yz, d_xz, d_xy, sc, nv, X, Y, Z, C, s);
  else if (dtype == 1 && C % 8 == 0)
    launch<__nv_bfloat16, 8>(latent, logit_yz, logit_xz, logit_xy, g_yz,
                             g_xz, g_xy, d_latent, d_yz, d_xz, d_xy, sc, nv,
                             X, Y, Z, C, s);
  else if (dtype == 1)
    launch<__nv_bfloat16, 4>(latent, logit_yz, logit_xz, logit_xy, g_yz,
                             g_xz, g_xy, d_latent, d_yz, d_xz, d_xy, sc, nv,
                             X, Y, Z, C, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
