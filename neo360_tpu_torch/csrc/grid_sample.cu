// grid_sample_fwd — kernel G: bilinear sample of NHWC images at normalized
// points, reading the four corner pixels straight from the image.
//
// Replaces neo360_tpu/ops/interpolate.py:grid_sample_2d (62-114), which
// the JAX package leaves to four XLA row gathers and an elementwise fold
// (no Pallas kernel). Callers: ops/interpolate.py:grid_sample_2d and,
// through it, core/geometry.py:homography_warp.
//
// image (B, H, W, C) f32 or bf16; uv (B, N, 2) f32 in [-1, 1]
// (align_corners=True: -1 is the centre of pixel 0); out (B, N, C) f32.
// Zeros mode: a corner outside the image weighs 0 and is not read, so a
// non-finite point samples 0. Border mode: the pixel coordinates are
// clamped to the image first, keeping NaN (torch.clamp and jnp.clip do),
// so a NaN point samples NaN.
//
// The arithmetic is the plain version's (grid_sample_2d_reference), one
// rounding per operation, with __fadd_rn / __fmul_rn wherever nvcc would
// otherwise contract to an FMA:
//   ix = ((u + 1) * 0.5) * (w - 1), x0 = floor(ix), x1 = x0 + 1,
//   w00 = (x1 - ix) * (y1 - iy), w01 = (ix - x0) * (y1 - iy), ...,
//   out = ((p00 * w00 + p01 * w01) + p10 * w10) + p11 * w11,
// with a bf16 pixel widened exactly to f32 first (the plain version's
// type promotion), so the f32 output equals the plain version's values
// for an image of finite values. In zeros mode the plain version (and the
// JAX code) multiplies the clamped edge pixel by a weight of 0 for a
// corner outside the image; G reads nothing there and adds +0, so where
// that edge pixel is inf or NaN the plain version gives NaN and G the sum
// of the corners inside (ROADMAP, divergences from the JAX package).
//
// Bound: device memory. A point reads up to 4C pixel values, mostly from
// L2 (neighbouring points share pixels), its uv once and writes C f32.
// Design:
// - a block owns 256 consecutive points; first one thread per point
//   computes its four corner offsets, weights and in-image mask (`Taps`),
//   once per point, into shared memory (coalesced uv loads);
// - then a group of tpp lanes per point (tpp = C / 16 bytes of the image
//   type rounded up to a power of two, at most a warp) samples the
//   group's tpp points one after another, each lane looping over its
//   vectors of V channels (V: the widest load up to 16 bytes that C and
//   the image's alignment allow, so any C >= 1 is one launch); for
//   C <= 16 bytes of the type one thread per point needs no shared
//   memory;
// - 16-byte streaming stores (__stcs) where V allows: the output is
//   written once and never re-read here, and the image should stay in
//   L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads and points per block

// One point's corners: pixel indices (b, y, x) flattened, in the order
// (x0, y0), (x1, y0), (x0, y1), (x1, y1); their weights; bit k of
// `read`: corner k is read.
struct Taps {
  int pix[4];
  float w[4];
  int read;
};

__device__ __forceinline__ Taps taps_of(float u, float v, int b, int h, int w,
                                        bool zeros_mode) {
  const float fw = (float)(w - 1);
  const float fh = (float)(h - 1);
  float ix = __fmul_rn(__fmul_rn(__fadd_rn(u, 1.0f), 0.5f), fw);
  float iy = __fmul_rn(__fmul_rn(__fadd_rn(v, 1.0f), 0.5f), fh);
  if (!zeros_mode) {  // clamp, keeping NaN as torch.clamp does
    ix = isnan(ix) ? ix : fminf(fmaxf(ix, 0.0f), fw);
    iy = isnan(iy) ? iy : fminf(fmaxf(iy, 0.0f), fh);
  }
  const float x0 = floorf(ix);
  const float y0 = floorf(iy);
  const float x1 = __fadd_rn(x0, 1.0f);
  const float y1 = __fadd_rn(y0, 1.0f);
  const float ax = __fsub_rn(x1, ix), bx = __fsub_rn(ix, x0);
  const float ay = __fsub_rn(y1, iy), by = __fsub_rn(iy, y0);
  Taps t;
  t.w[0] = __fmul_rn(ax, ay);
  t.w[1] = __fmul_rn(bx, ay);
  t.w[2] = __fmul_rn(ax, by);
  t.w[3] = __fmul_rn(bx, by);
  // clamped indices (a NaN coordinate reads pixel 0: fmaxf drops NaN, as
  // the plain version's nan_to_num does); NaN compares false
  const int cx0 = (int)fminf(fmaxf(x0, 0.0f), fw);
  const int cx1 = (int)fminf(fmaxf(x1, 0.0f), fw);
  const int row0 = (b * h + (int)fminf(fmaxf(y0, 0.0f), fh)) * w;
  const int row1 = (b * h + (int)fminf(fmaxf(y1, 0.0f), fh)) * w;
  t.pix[0] = row0 + cx0;
  t.pix[1] = row0 + cx1;
  t.pix[2] = row1 + cx0;
  t.pix[3] = row1 + cx1;
  if (zeros_mode) {
    const bool vx0 = x0 >= 0.0f && x0 <= fw, vx1 = x1 >= 0.0f && x1 <= fw;
    const bool vy0 = y0 >= 0.0f && y0 <= fh, vy1 = y1 >= 0.0f && y1 <= fh;
    t.read = (vx0 && vy0) | (vx1 && vy0) << 1 | (vx0 && vy1) << 2 |
             (vx1 && vy1) << 3;
  } else {
    t.read = 0xF;
  }
  return t;
}

template <typename T, int V>
struct Vec;  // V values of T from one aligned load of V * sizeof(T) bytes

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};
template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[2]) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  }
};
template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldg(p);
  }
};

__device__ __forceinline__ void widen(uint32_t bits, float* v) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
  v[0] = f.x;
  v[1] = f.y;
}

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    widen(t.x, v); widen(t.y, v + 2); widen(t.z, v + 4); widen(t.w, v + 6);
  }
};
template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[4]) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    widen(t.x, v); widen(t.y, v + 2);
  }
};
template <>
struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[2]) {
    widen(__ldg(reinterpret_cast<const unsigned int*>(p)), v);
  }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <int V>
__device__ __forceinline__ void store_stream(float* p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      __stcs(reinterpret_cast<float4*>(p + i),
             make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// dst[0, C) = the sample at `t`: this lane's vectors of V channels, from
// channel lane * V in steps of tpp * V.
template <typename T, int V>
__device__ __forceinline__ void sample(const T* __restrict__ image,
                                       const Taps& t, float* __restrict__ dst,
                                       int c, int lane, int tpp) {
  for (int j = lane * V; j < c; j += tpp * V) {
    float p[4][V];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t.read >> k & 1) {
        Vec<T, V>::load(image + (long long)t.pix[k] * c + j, p[k]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) p[k][e] = 0.0f;
      }
    }
    float out[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float s = (t.read & 1) ? __fmul_rn(p[0][e], t.w[0]) : 0.0f;
#pragma unroll
      for (int k = 1; k < 4; ++k)
        s = __fadd_rn(s, (t.read >> k & 1) ? __fmul_rn(p[k][e], t.w[k])
                                            : 0.0f);
      out[e] = s;
    }
    store_stream<V>(dst + j, out);
  }
}

// kOne: one thread per point (tpp == 1), no shared memory.
template <typename T, int V, bool kOne>
__global__ void __launch_bounds__(kThreads) grid_sample_kernel(
    const T* __restrict__ image, const float* __restrict__ uv,
    float* __restrict__ out, long long total, long long n_points, int h,
    int w, int c, int tpp, int zeros_mode) {
  __shared__ Taps shared[kOne ? 1 : kThreads];
  const long long base = (long long)blockIdx.x * kThreads;
  const long long p = base + threadIdx.x;
  if (p < total) {
    const Taps t = taps_of(uv[2 * p], uv[2 * p + 1], (int)(p / n_points), h,
                           w, zeros_mode != 0);
    if constexpr (kOne)
      sample<T, V>(image, t, out + p * c, c, 0, 1);
    else
      shared[threadIdx.x] = t;
  }
  if constexpr (kOne) return;
  __syncthreads();
  // group `slot` samples the block's points slot * tpp ... + tpp - 1
  const int slot = threadIdx.x / tpp;
  const int lane = threadIdx.x - slot * tpp;
  for (int k = 0; k < tpp; ++k) {
    const int i = slot * tpp + k;
    if (base + i >= total) break;
    sample<T, V>(image, shared[i], out + (base + i) * c, c, lane, tpp);
  }
}

template <typename T, int V>
void launch_v(const T* image, const float* uv, float* out, long long total,
              long long n_points, int h, int w, int c, int tpp, int zeros,
              cudaStream_t s) {
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (tpp == 1)
    grid_sample_kernel<T, V, true><<<blocks, kThreads, 0, s>>>(
        image, uv, out, total, n_points, h, w, c, 1, zeros);
  else
    grid_sample_kernel<T, V, false><<<blocks, kThreads, 0, s>>>(
        image, uv, out, total, n_points, h, w, c, tpp, zeros);
}

template <typename T>
void launch(const void* image, const float* uv, float* out, long long total,
            long long n_points, int h, int w, int c, int zeros,
            cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);  // values in 16 bytes
  // the widest load that every pixel row's start allows
  int v = kVec;
  while (v > 1 && (c % v || reinterpret_cast<uintptr_t>(image) %
                                (v * sizeof(T))))
    v /= 2;
  const int want = (c + kVec - 1) / kVec;
  int tpp = 1;
  while (tpp < want && tpp < 32) tpp *= 2;
  const T* im = static_cast<const T*>(image);
  switch (v) {
    case 8:
      if constexpr (kVec >= 8)
        launch_v<T, 8>(im, uv, out, total, n_points, h, w, c, tpp, zeros, s);
      break;
    case 4:
      launch_v<T, 4>(im, uv, out, total, n_points, h, w, c, tpp, zeros, s);
      break;
    case 2:
      launch_v<T, 2>(im, uv, out, total, n_points, h, w, c, tpp, zeros, s);
      break;
    default:
      launch_v<T, 1>(im, uv, out, total, n_points, h, w, c, tpp, zeros, s);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. image (B, H, W, C) contiguous in
// image_dtype, uv (B, N, 2) f32 and out (B, N, C) f32 contiguous; out
// 16-byte aligned. The wrapper (ops/interpolate.py:grid_sample_2d) checks
// devices, types, shapes, contiguity, C >= 1 and B * H * W < 2^31.
extern "C" int grid_sample_fwd(const void* image, int image_dtype,
                               const void* uv, void* out, int n_images,
                               long long n_points, int h, int w, int c,
                               int zeros_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n_images * n_points;
  const float* uvf = static_cast<const float*>(uv);
  float* o = static_cast<float*>(out);
  if (image_dtype != 0 && image_dtype != 1) return (int)cudaErrorInvalidValue;
  if (total == 0 || c == 0) return (int)cudaSuccess;
  if (image_dtype == 0)
    launch<float>(image, uvf, o, total, n_points, h, w, c, zeros_mode, s);
  else
    launch<__nv_bfloat16>(image, uvf, o, total, n_points, h, w, c,
                          zeros_mode, s);
  return (int)cudaGetLastError();
}
