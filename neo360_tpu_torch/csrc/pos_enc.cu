// pos_enc_into — the positional encoding of a conditioned level's points,
// written straight into their rows of the conditioned MLP's input.
//
// Replaces neo360_tpu/core/encoding.py:pos_enc at the conditioned MLPs'
// inputs (neo360_tpu/models/neo360.py: the camera-frame points and, in the
// bg branch, their concatenation with the inverse depth), which XLA fuses
// into the input's concatenation. The JAX package has no Pallas kernel for
// it.
//
//   out[r, col + j] = j-th value of [x, sin(2^i x), sin(2^i x + pi/2)]
//
// for the D channels x of point n of view v (row r = v * N + n): the 3
// coordinates of pts and, given `extra` (D = 4), extra[n], shared by every
// view; i in [min_deg, min_deg + L), frequency-major and channel-minor
// within each half, as pos_enc orders them (D (1 + 2L) columns), then
// zeros to the row's end, so that no column of the rows is left undefined
// (a GEMM that reads its operand past the last column, in pairs or
// vectors, must meet zeros there, not NaN). Each value is pos_enc's,
// operation for operation: the f32 product x * 2^i (exact), the f32 add of
// (float)(pi / 2), sinf (no fast math); rounded once to the output type
// (bf16: to nearest even, as `.to(torch.bfloat16)` rounds).
//
// Bound: device memory: the points read and the row's columns from col
// written once. Design: a block of 32 x 8 threads owns 32 rows of one view; the 32
// lanes of a warp take consecutive columns of one row, so a point is read
// once a warp (a broadcast) and the stores are coalesced, and each thread
// decodes its columns' (channel, frequency, phase) once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRowsAPass = 8;
constexpr int kRowsABlock = 32;
constexpr float kHalfPi = 1.57079637050628662109375f;  // (float)(pi / 2)

__device__ __forceinline__ void put(float* p, float v) { *p = v; }

__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Tout>
__global__ void __launch_bounds__(kLanes * kRowsAPass) pos_enc_into_kernel(
    const float* __restrict__ pts, long long view_stride,
    const float* __restrict__ extra, long long extra_stride,
    Tout* __restrict__ out, long long ld, int col, long long n_points,
    int dims, int min_deg, int n_deg) {
  const int width = dims * (1 + 2 * n_deg);
  const int last = (int)(ld - col);  // the encoding's columns and the pad
  const long long view = blockIdx.y;
  const long long first = (long long)blockIdx.x * kRowsABlock;
  for (int j = threadIdx.x; j < last; j += kLanes) {
    // column j holds channel ch itself (deg < 0), or sin(2^(min_deg + deg)
    // x_ch), plus pi / 2 in the second half (shift)
    int ch = j, deg = -1;
    bool shift = false;
    if (j >= dims) {
      int k = j - dims;
      shift = k >= dims * n_deg;
      if (shift) k -= dims * n_deg;
      deg = k / dims;
      ch = k - deg * dims;
    }
    const float scale = ldexpf(1.0f, min_deg + max(deg, 0));
    for (int y = threadIdx.y; y < kRowsABlock; y += kRowsAPass) {
      const long long n = first + y;
      if (n >= n_points) break;
      float x = j >= width ? 0.0f
                : ch < 3 ? pts[(view * view_stride + n) * 3 + ch]
                         : extra[n * extra_stride];
      if (deg >= 0 && j < width) {
        x = __fmul_rn(x, scale);
        if (shift) x = __fadd_rn(x, kHalfPi);
        x = sinf(x);
      }
      put(out + (view * n_points + n) * ld + col + j, x);
    }
  }
}

template <typename Tout>
void launch(const float* pts, long long view_stride, const float* extra,
            long long extra_stride, void* out, long long ld, int col,
            int n_views, long long n_points, int dims, int min_deg,
            int n_deg, cudaStream_t stream) {
  if (n_views == 0 || n_points == 0) return;
  const dim3 grid((unsigned)((n_points + kRowsABlock - 1) / kRowsABlock),
                  (unsigned)n_views);
  pos_enc_into_kernel<Tout><<<grid, dim3(kLanes, kRowsAPass), 0, stream>>>(
      pts, view_stride, extra, extra_stride, static_cast<Tout*>(out), ld,
      col, n_points, dims, min_deg, n_deg);
}

}  // namespace

// pts: f32, point n of view v at pts + 3 (v * view_stride + n); extra: f32
// (null unless dims = 4), point n's at extra + n * extra_stride; out: rows
// of `ld` values, f32 (out_dtype 0) or bf16 (1), row v * n_points + n
// written at columns col .. col + dims (1 + 2 n_deg), and zeros from there
// to the row's end. The wrapper (ops/encoding.py:pos_enc_into) checks
// shapes, types and the rows' bounds.
extern "C" int pos_enc_into(const void* pts, long long view_stride,
                            const void* extra, long long extra_stride,
                            void* out, int out_dtype, long long ld, int col,
                            int n_views, long long n_points, int dims,
                            int min_deg, int n_deg, void* stream) {
  const float* p = static_cast<const float*>(pts);
  const float* e = static_cast<const float*>(extra);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dims != 3 && dims != 4) || (dims == 4) != (e != nullptr))
    return (int)cudaErrorInvalidValue;
  if (out_dtype == 0)
    launch<float>(p, view_stride, e, extra_stride, out, ld, col, n_views,
                  n_points, dims, min_deg, n_deg, s);
  else if (out_dtype == 1)
    launch<__nv_bfloat16>(p, view_stride, e, extra_stride, out, ld, col,
                          n_views, n_points, dims, min_deg, n_deg, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
