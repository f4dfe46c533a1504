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
//   G_{S-1} = dL/dT,  G_{i-1} = gw_i alpha_i + q_i G_i
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
// Bound: latency. Each ray reads 5 floats per sample twice and writes 4,
// with ~30 flops per sample, in two dependent scans. Design: one thread per
// ray; the forward is recomputed in a first pass that stores A_i in the
// dsigma output (its own slot, so no scratch), then the reverse pass
// reads A_i back, recomputes alpha_i, carries G in a register and
// overwrites dsigma_i.

#include <cuda_runtime.h>

namespace {

struct Fwd {
  float r, g, b, acc, depth, trans;
};

__device__ __forceinline__ float interval(const float* t, int i, int s,
                                          bool fg, float t_far, float dnorm) {
  if (fg) return (((i + 1 < s) ? t[i + 1] : t_far) - t[i]) * dnorm;
  return (i + 1 < s) ? t[i] - t[i + 1] : 1e10f;
}

// Forward pass of one branch, as composite_nerfpp_fwd computes it; A_i is
// written to a_out[i].
__device__ Fwd branch_forward(const float* __restrict__ rgb,
                              const float* __restrict__ sigma,
                              const float* __restrict__ t, int s, bool fg,
                              float t_far, float dnorm, int white_bkgd,
                              float* __restrict__ a_out) {
  Fwd o{0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
  for (int i = 0; i < s; ++i) {
    const float delta = interval(t, i, s, fg, t_far, dnorm);
    const float alpha = 1.0f - expf(-sigma[i] * delta);
    const float w = alpha * o.trans;
    a_out[i] = o.trans;
    o.trans *= (1.0f - alpha) + 1e-10f;
    o.acc += w;
    o.r += w * rgb[3 * i];
    o.g += w * rgb[3 * i + 1];
    o.b += w * rgb[3 * i + 2];
    o.depth += w * t[i];
  }
  if (white_bkgd) {
    o.r += 1.0f - o.acc; o.g += 1.0f - o.acc; o.b += 1.0f - o.acc;
  }
  return o;
}

// Reverse pass of one branch. gc: dL/dcomp (3), gd: dL/ddepth, ga:
// dL/dacc, gw: dL/dweights (S) or null, gT: dL/dT. dsigma holds A_i on
// entry.
__device__ void branch_backward(const float* __restrict__ rgb,
                                const float* __restrict__ sigma,
                                const float* __restrict__ t, int s, bool fg,
                                float t_far, float dnorm, int white_bkgd,
                                const float (&gc)[3], float gd, float ga,
                                const float* __restrict__ gw, float gT,
                                float* __restrict__ drgb,
                                float* __restrict__ dsigma) {
  if (white_bkgd) ga -= gc[0] + gc[1] + gc[2];
  float G = gT;
  for (int i = s - 1; i >= 0; --i) {
    const float delta = interval(t, i, s, fg, t_far, dnorm);
    const float e = expf(-sigma[i] * delta);
    const float alpha = 1.0f - e;
    const float a = dsigma[i];
    const float w = alpha * a;
    const float gwi = (gw ? gw[i] : 0.0f) + ga + gc[0] * rgb[3 * i] +
                      gc[1] * rgb[3 * i + 1] + gc[2] * rgb[3 * i + 2] +
                      gd * t[i];
    drgb[3 * i] = w * gc[0];
    drgb[3 * i + 1] = w * gc[1];
    drgb[3 * i + 2] = w * gc[2];
    const float galpha = a * (gwi - G);
    G = gwi * alpha + ((1.0f - alpha) + 1e-10f) * G;
    dsigma[i] = galpha * e * delta;
  }
}

__device__ __forceinline__ float at(const float* p, long long i) {
  return p ? p[i] : 0.0f;
}

__global__ void composite_nerfpp_bwd_kernel(
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
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
  const long long of = (long long)r * s_fg;
  const long long ob = (long long)r * s_bg;

  const Fwd f = branch_forward(fg_rgb + 3 * of, fg_sigma + of, fg_t + of,
                               s_fg, true, far[r], dnorm, white_bkgd,
                               d_fg_sigma + of);
  const Fwd b = branch_forward(bg_rgb + 3 * ob, bg_sigma + ob, bg_t + ob,
                               s_bg, false, 0.0f, dnorm, white_bkgd,
                               d_bg_sigma + ob);
  const float lam = f.trans;
  float gc[3], gf[3], gb[3];
  for (int k = 0; k < 3; ++k) {
    gc[k] = at(g_comp, 3LL * r + k);
    gf[k] = gc[k] + at(g_fg_comp, 3LL * r + k);
    gb[k] = lam * gc[k] + at(g_bg_comp, 3LL * r + k);
  }
  const float gdepth = at(g_depth, r);
  const float gT = at(g_lambda, r) + gc[0] * b.r + gc[1] * b.g +
                   gc[2] * b.b + gdepth * b.depth;
  branch_backward(fg_rgb + 3 * of, fg_sigma + of, fg_t + of, s_fg, true,
                  far[r], dnorm, white_bkgd, gf,
                  gdepth + at(g_fg_depth, r), at(g_fg_acc, r),
                  g_fg_w ? g_fg_w + of : nullptr, gT, d_fg_rgb + 3 * of,
                  d_fg_sigma + of);
  branch_backward(bg_rgb + 3 * ob, bg_sigma + ob, bg_t + ob, s_bg, false,
                  0.0f, dnorm, white_bkgd, gb, lam * gdepth,
                  at(g_bg_acc, r), g_bg_w ? g_bg_w + ob : nullptr, 0.0f,
                  d_bg_rgb + 3 * ob, d_bg_sigma + ob);
}

}  // namespace

// Inputs as composite_nerfpp_fwd's. Cotangents, each float32 or null:
// comp, fg_comp, bg_comp (B,3); fg_acc, bg_acc (B,); fg_w (B,S_fg); bg_w
// (B,S_bg); bg_lambda (B,1); depth, fg_depth (B,). Outputs: d fg/bg rgb
// (B,S,3), d fg/bg sigma (B,S,1). The wrapper (core/render.py) checks them.
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
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  composite_nerfpp_bwd_kernel<<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      f(fg_rgb), f(fg_sigma), f(fg_t), s_fg, f(bg_rgb), f(bg_sigma), f(bg_t),
      s_bg, f(dirs), f(far), n_rays, white_bkgd, f(g_comp), f(g_fg_comp),
      f(g_bg_comp), f(g_fg_acc), f(g_bg_acc), f(g_fg_w), f(g_bg_w),
      f(g_lambda), f(g_depth), f(g_fg_depth), static_cast<float*>(d_fg_rgb),
      static_cast<float*>(d_fg_sigma), static_cast<float*>(d_bg_rgb),
      static_cast<float*>(d_bg_sigma));
  return (int)cudaGetLastError();
}
