// composite_nerfpp_bwd — gradient of composite_nerfpp_fwd with respect to
// the fg and bg colours and densities.
//
// Replaces the transpose XLA derives for neo360_tpu/core/render.py:
// volumetric_rendering_nerfpp (55-96), called for fg and bg, and for the
// combination at neo360_tpu/models/neo360.py:471-480 (comp = fg + bg_lambda
// * bg) and :499 (depth). The JAX package has no Pallas kernel for it.
//
// Per branch, with q_i = (1 - alpha_i) + 1e-10 (the +1e-10 of
// render.py:85), A_i = prod_{j<i} q_j, w_i = alpha_i A_i, T = prod_j q_j:
//   gw_i   = dL/dw_i + dL/dacc + dL/dcomp . rgb_i + dL/ddepth * t_i
//   G_{S-1} = dL/dT,  G_{i-1} = q_i G_i + gw_i alpha_i
//   dL/dalpha_i = A_i (gw_i - G_i)
//   dL/drgb_i = w_i dL/dcomp,  dL/dsigma_i = dL/dalpha_i exp(-sigma_i d_i) d_i
// The reverse scan needs no division by q_i (the plain autograd of torch's
// cumprod divides), so a ray whose transmittance underflows stays finite.
// white_bkgd adds -sum(dL/dcomp) to dL/dacc. The combination feeds the fg
// branch dL/dT = dL/dbg_lambda + dL/drgb . bg_comp + dL/ddepth * bg_depth
// and the bg branch bg_lambda * dL/drgb and bg_lambda * dL/ddepth.
// Any output cotangent may be absent (a null pointer): it counts as zero.
// t, dirs and far get no gradient.
//
// Bound: latency. At the path's 250 rays x 61-65 samples a call moves
// ~0.6 MB (< 0.5 us at the card's memory rate) with ~40 flops per sample,
// in two dependent scans per branch. The first version gave each ray one
// thread, which walked its samples twice through dependent, uncoalesced
// loads: 250 threads on 2 of 132 SMs, ~0.1 ms a call. Design (kernel B's,
// csrc/composite_nerfpp.cu): one warp per ray, kWarps rays per block, so
// the rays spread over ~63 blocks. Lane i owns sample base + i of a
// 32-sample chunk; loads and stores are coalesced.
//   forward: alpha_i, the exclusive transmittance A_i by a multiplicative
//     __shfl_up_sync scan carried from chunk to chunk (kernel B's, so A_i
//     and w_i are B's bit for bit), lane partial sums reduced once with
//     __shfl_xor_sync. A_i goes to the d sigma output (its own slot: no
//     scratch). Both branches' forwards run before either backward: the fg
//     branch's dL/dT needs the bg sums, the bg cotangents need bg_lambda.
//   reverse: from the last chunk down, G_{i-1} = f_i(G_i) with the affine
//     map f_i(G) = q_i G + gw_i alpha_i. An exclusive suffix scan of the
//     (q, c) pairs with __shfl_down_sync composes f_{i+1} o ... o f_31 for
//     each lane, applied to the G carried in from the chunk above; the
//     carry to the chunk below is f_base applied once more. Lanes past S
//     are the identity map (q = 1, c = 0), so any S >= 1 works.
// The fg and bg chunks of one step are independent, so their loads and
// scans overlap.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rays per block
constexpr unsigned kFull = 0xffffffffu;

struct Sums {
  float r, g, b, acc, depth;
};

__device__ __forceinline__ float interval(const float* t, int i, int s,
                                          bool fg, float t_far, float dnorm) {
  if (fg) return (((i + 1 < s) ? t[i + 1] : t_far) - t[i]) * dnorm;
  return (i + 1 < s) ? t[i] - t[i + 1] : 1e10f;
}

// Forward of samples [base, base + 32) of one branch, as kernel B computes
// it; lane i owns sample base + i and writes A_i to a_out[i]. `trans`
// (warp-uniform) is the transmittance before the chunk and leaves it after;
// `o` takes the lane's partial sums.
__device__ __forceinline__ void forward_chunk(
    const float* __restrict__ rgb, const float* __restrict__ sigma,
    const float* __restrict__ t, int s, int base, int lane, bool fg,
    float t_far, float dnorm, float* __restrict__ a_out, float& trans,
    Sums& o) {
  const int i = base + lane;
  const bool live = i < s;
  float alpha = 0.f, ti = 0.f, r = 0.f, g = 0.f, b = 0.f;
  if (live) {
    ti = t[i];
    alpha = 1.0f - expf(-sigma[i] * interval(t, i, s, fg, t_far, dnorm));
    r = rgb[3 * i];
    g = rgb[3 * i + 1];
    b = rgb[3 * i + 2];
  }
  float incl = live ? (1.0f - alpha) + 1e-10f : 1.0f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl *= up;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 1.0f;
  const float a = trans * excl;
  const float w = alpha * a;
  if (live) a_out[i] = a;
  o.acc += w;
  o.r += w * r;
  o.g += w * g;
  o.b += w * b;
  o.depth += w * ti;
  trans *= __shfl_sync(kFull, incl, 31);
}

// Reverse pass over samples [base, base + 32) of one branch. gc: dL/dcomp
// (3), gd: dL/ddepth, ga: dL/dacc (white_bkgd already folded in), gw:
// dL/dweights (S) or null. `G` (warp-uniform) is G at sample base + 31 on
// entry (dL/dT above the last sample) and G at base - 1 on exit. dsigma
// holds A_i on entry and d sigma_i on exit.
__device__ __forceinline__ void backward_chunk(
    const float* __restrict__ rgb, const float* __restrict__ sigma,
    const float* __restrict__ t, int s, int base, int lane, bool fg,
    float t_far, float dnorm, const float (&gc)[3], float gd, float ga,
    const float* __restrict__ gw, float* __restrict__ drgb,
    float* __restrict__ dsigma, float& G) {
  const int i = base + lane;
  const bool live = i < s;
  float q = 1.0f, c = 0.0f, a = 0.0f, e = 1.0f, delta = 0.0f, gwi = 0.0f;
  if (live) {
    delta = interval(t, i, s, fg, t_far, dnorm);
    e = expf(-sigma[i] * delta);
    const float alpha = 1.0f - e;
    a = dsigma[i];
    gwi = (gw ? gw[i] : 0.0f) + ga + gc[0] * rgb[3 * i] +
          gc[1] * rgb[3 * i + 1] + gc[2] * rgb[3 * i + 2] + gd * t[i];
    q = (1.0f - alpha) + 1e-10f;
    c = gwi * alpha;
  }
  // inclusive suffix composition F_i = f_i o f_{i+1} o ... o f_31:
  // (outer q, c) o (inner q', c') = (q q', q c' + c)
  float Q = q, C = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float qd = __shfl_down_sync(kFull, Q, d);
    const float cd = __shfl_down_sync(kFull, C, d);
    if (lane + d < 32) {
      C = Q * cd + C;
      Q = Q * qd;
    }
  }
  float qx = __shfl_down_sync(kFull, Q, 1);
  float cx = __shfl_down_sync(kFull, C, 1);
  if (lane == 31) {
    qx = 1.0f;
    cx = 0.0f;
  }
  const float g_i = qx * G + cx;
  const float next = __shfl_sync(kFull, Q, 0) * G + __shfl_sync(kFull, C, 0);
  if (live) {
    const float w = (1.0f - e) * a;
    drgb[3 * i] = w * gc[0];
    drgb[3 * i + 1] = w * gc[1];
    drgb[3 * i + 2] = w * gc[2];
    dsigma[i] = a * (gwi - g_i) * e * delta;
  }
  G = next;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ void reduce(Sums& o) {
  o.r = warp_sum(o.r);
  o.g = warp_sum(o.g);
  o.b = warp_sum(o.b);
  o.acc = warp_sum(o.acc);
  o.depth = warp_sum(o.depth);
}

__device__ __forceinline__ float at(const float* p, long long i) {
  return p ? p[i] : 0.0f;
}

__global__ void __launch_bounds__(32 * kWarps) composite_nerfpp_bwd_kernel(
    const float* __restrict__ fg_rgb, const float* __restrict__ fg_sigma,
    const float* __restrict__ fg_t, int s_fg,
    const float* __restrict__ bg_rgb, const float* __restrict__ bg_sigma,
    const float* __restrict__ bg_t, int s_bg,
    const float* __restrict__ dirs, const float* __restrict__ far,
    int n_rays, int white_bkgd, const float* g_comp, const float* g_fg_comp,
    const float* g_bg_comp, const float* g_fg_acc, const float* g_bg_acc,
    const float* g_fg_w, const float* g_bg_w, const float* g_lambda,
    const float* g_depth, const float* g_fg_depth,
    float* __restrict__ d_fg_rgb, float* __restrict__ d_fg_sigma,
    float* __restrict__ d_bg_rgb, float* __restrict__ d_bg_sigma) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // uniform across the warp
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float t_far = far[r];
  const long long of = (long long)r * s_fg;
  const long long ob = (long long)r * s_bg;
  const float *frgb = fg_rgb + 3 * of, *fsig = fg_sigma + of,
              *ft = fg_t + of;
  const float *brgb = bg_rgb + 3 * ob, *bsig = bg_sigma + ob,
              *bt = bg_t + ob;

  Sums f{0.f, 0.f, 0.f, 0.f, 0.f}, b{0.f, 0.f, 0.f, 0.f, 0.f};
  float f_trans = 1.0f, b_trans = 1.0f;
  const int s_max = s_fg > s_bg ? s_fg : s_bg;
  for (int base = 0; base < s_max; base += 32) {
    if (base < s_fg)
      forward_chunk(frgb, fsig, ft, s_fg, base, lane, true, t_far, dnorm,
                    d_fg_sigma + of, f_trans, f);
    if (base < s_bg)
      forward_chunk(brgb, bsig, bt, s_bg, base, lane, false, 0.0f, dnorm,
                    d_bg_sigma + ob, b_trans, b);
  }
  reduce(b);  // every lane holds the sums; the fg sums are not needed
  if (white_bkgd) {
    b.r += 1.0f - b.acc; b.g += 1.0f - b.acc; b.b += 1.0f - b.acc;
  }

  const float lam = f_trans;
  float gc[3], gf[3], gb[3];
  for (int k = 0; k < 3; ++k) {
    gc[k] = at(g_comp, 3LL * r + k);
    gf[k] = gc[k] + at(g_fg_comp, 3LL * r + k);
    gb[k] = lam * gc[k] + at(g_bg_comp, 3LL * r + k);
  }
  const float gdepth = at(g_depth, r);
  float G_f = at(g_lambda, r) + gc[0] * b.r + gc[1] * b.g + gc[2] * b.b +
              gdepth * b.depth;
  float G_b = 0.0f;
  const float gd_f = gdepth + at(g_fg_depth, r), gd_b = lam * gdepth;
  float ga_f = at(g_fg_acc, r), ga_b = at(g_bg_acc, r);
  if (white_bkgd) {
    ga_f -= gf[0] + gf[1] + gf[2];
    ga_b -= gb[0] + gb[1] + gb[2];
  }
  const float* gw_f = g_fg_w ? g_fg_w + of : nullptr;
  const float* gw_b = g_bg_w ? g_bg_w + ob : nullptr;
  for (int base = (s_max - 1) & ~31; base >= 0; base -= 32) {
    if (base < s_fg)
      backward_chunk(frgb, fsig, ft, s_fg, base, lane, true, t_far, dnorm,
                     gf, gd_f, ga_f, gw_f, d_fg_rgb + 3 * of,
                     d_fg_sigma + of, G_f);
    if (base < s_bg)
      backward_chunk(brgb, bsig, bt, s_bg, base, lane, false, 0.0f, dnorm,
                     gb, gd_b, ga_b, gw_b, d_bg_rgb + 3 * ob,
                     d_bg_sigma + ob, G_b);
  }
}

}  // namespace

// Inputs as composite_nerfpp_fwd's. Cotangents, each float32 or null:
// comp, fg_comp, bg_comp (B,3); fg_acc, bg_acc (B,); fg_w (B,S_fg); bg_w
// (B,S_bg); bg_lambda (B,1); depth, fg_depth (B,). Outputs: d fg/bg rgb
// (B,S,3), d fg/bg sigma (B,S,1). S_fg, S_bg >= 1. The wrapper
// (core/render.py) checks them.
extern "C" int composite_nerfpp_bwd(
    const void* fg_rgb, const void* fg_sigma, const void* fg_t, int s_fg,
    const void* bg_rgb, const void* bg_sigma, const void* bg_t, int s_bg,
    const void* dirs, const void* far, int n_rays, int white_bkgd,
    const void* g_comp, const void* g_fg_comp, const void* g_bg_comp,
    const void* g_fg_acc, const void* g_bg_acc, const void* g_fg_w,
    const void* g_bg_w, const void* g_lambda, const void* g_depth,
    const void* g_fg_depth, void* d_fg_rgb, void* d_fg_sigma, void* d_bg_rgb,
    void* d_bg_sigma, void* stream) {
  if (n_rays == 0) return (int)cudaSuccess;
  if (s_fg < 1 || s_bg < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  composite_nerfpp_bwd_kernel<<<blocks, 32 * kWarps, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      f(fg_rgb), f(fg_sigma), f(fg_t), s_fg, f(bg_rgb), f(bg_sigma), f(bg_t),
      s_bg, f(dirs), f(far), n_rays, white_bkgd, f(g_comp), f(g_fg_comp),
      f(g_bg_comp), f(g_fg_acc), f(g_bg_acc), f(g_fg_w), f(g_bg_w),
      f(g_lambda), f(g_depth), f(g_fg_depth), static_cast<float*>(d_fg_rgb),
      static_cast<float*>(d_fg_sigma), static_cast<float*>(d_bg_rgb),
      static_cast<float*>(d_bg_sigma));
  return (int)cudaGetLastError();
}
