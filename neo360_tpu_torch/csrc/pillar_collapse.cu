// pillar_collapse_fwd — the three softmax-weighted axis collapses of the
// tri-planar encoder.
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
// (3 x 64 x 64 x 32 x 512); read once, with the logits and the floors it
// is ~430 MB, 0.128 ms at 3.35 TB/s; at the neo360 preset's f32 latent
// (3 x 64 x 64 x 64 x 512, 1.61 GB) ~1.70 GB, 0.51 ms. The first version
// gave each floor its own blocks, so the latent came from device memory
// three times, 2 bytes a load (~0.51 ms at neo360_fast).
//
// Design: two launches, one of which touches the latent.
//   1. pillar_weights_kernel, one thread per (view, floor, pillar): the f32
//      softmax of pillar_common.cuh (kernel C' recomputes the same bits),
//      rounded to the latent's type, into a (cell, 4) scratch: the three
//      floors' weights of a cell side by side, one 8- or 16-byte load.
//   2. pillar_collapse_kernel, the one pass over the latent. A block owns
//      (view, channel slice) and walks every x, y and z of the view, so no
//      sum crosses blocks and none needs atomics: a slice is kLanesPerZ
//      vectors of VEC channels (16-byte vectors; 8-byte for a bf16 C that
//      8 does not divide), 32 bytes of each 1 KB latent row at the path's
//      shape, one 32-byte sector per row. Blocks are numbered slice-fastest,
//      so the slices of one view run together and read each row's sectors
//      at about the same time. Lane (zl, h) of warp w takes z = zl + cz *
//      32 / kLanesPerZ and vector h of the slice; warp w takes y = w + sy *
//      kWarps: each thread has up to 8 (y, z) slots. Per x:
//        floor_yz: each slot sums over x in registers;
//        floor_xy: over the thread's z chunks, then over the z lanes of the
//          warp in xor-tree order (halving the channels a lane carries at
//          each of the first log2(VEC) levels, so a warp reduces VEC values
//          with ~VEC + 2 shuffles instead of 5 * VEC);
//        floor_xz: over the thread's y slots, then one partial per warp in
//          shared memory (two buffers, by x parity: one barrier per x),
//          summed over the warps in order.
//      Latent words and weights come in by cp.async into the thread's own
//      shared-memory words, one commit group per slot and x, in a ring of
//      kDepth slots: the row kDepth slots ahead in (x, slot) order is
//      requested as soon as the current one is used, so kDepth loads stay in
//      flight without holding registers (16-byte copies bypass L1).
//      At the neo360_fast shape (Z <= 32: 2 z chunks, the ring as deep as
//      the 8 slots): 96 blocks of 512 threads, one per SM (128 registers a
//      thread, 160 KB of shared memory). On an H100 the one pass runs at
//      ~1.85 TB/s; one lane per z (16 bytes a row, 192 blocks of 256), the
//      y range split over two blocks, and clusters of slices stepping x
//      together were all slower.
//   Z in 33..64 (the neo360 preset's 64^3 grid) takes 4 z chunks. Doubling
//   the slots doubles floor_yz's accumulators, so the slice halves instead:
//   4-channel vectors in both types (16 bytes of each f32 row, 8 of each
//   bf16 row, 192 blocks), which keeps 64 accumulators a thread; the ring
//   holds 8 slots in f32 and all 16 in bf16, 192 KB of shared memory with
//   the floor_xz partials of 64 z.
// Every sum has a fixed order, so the output is the same bits on every run.

#include "pillar_common.cuh"

namespace {

using namespace pillar;

constexpr int kThreads = 128;    // threads per block, kernel 1
constexpr int kLanesPerZ = 2;    // lanes sharing one z: vectors per slice
constexpr int kMaxY = 64;        // kWarps x y slots
constexpr int kMaxZ = 64;        // z lanes x z chunks, at most 4 chunks

// wb[cell * 4 + floor] = the floor's softmax weight at the cell, rounded
template <typename T>
__global__ void __launch_bounds__(kThreads) pillar_weights_kernel(
    const T* __restrict__ logit_yz, const T* __restrict__ logit_xz,
    const T* __restrict__ logit_xy, T* __restrict__ wb, long long n_pillars,
    int X, int Y, int Z) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pillars) return;
  const Pillar pl = pillar_at(p, X, Y, Z);
  const T* logit = pl.floor == 0 ? logit_yz : pl.floor == 1 ? logit_xz
                                                            : logit_xy;
  T* w = wb + pl.cell0 * 4 + pl.floor;
  softmax(logit + pl.cell0, pl.stride, pl.len,
          [&](int i, float v) { from_float(v, w + i * pl.stride * 4); });
}

// v[0..N) summed over the lanes that differ in bits OFF, OFF/2, ..., H of
// the lane index, in xor-tree order. While a lane carries N > 1 values,
// each level keeps half of them and adds the partner's copy of that half;
// `ch` gathers which of the original values v[0] holds at the end. Every
// value is combined in the same tree as a plain xor reduction of it alone.
template <int N, int OFF, int H>
struct LaneSum {
  __device__ __forceinline__ static void run(float* v, int lane, int& ch) {
    if constexpr (OFF >= H) {
      if constexpr (N > 1) {
        constexpr int M = N / 2;
        const bool up = lane & OFF;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const float send = up ? v[j] : v[j + M];
          const float keep = up ? v[j + M] : v[j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
        }
        if (up) ch += M;
        LaneSum<M, OFF / 2, H>::run(v, lane, ch);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
        LaneSum<1, OFF / 2, H>::run(v, lane, ch);
      }
    }
  }
};

// cp.async of one 8- or 16-byte word from device to shared memory (16-byte
// words past L1), and the group commit / wait of the pipeline
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
}
__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ZC: z chunks a thread holds (Z <= 16 * ZC); D: slots in the load ring
// (a divisor of the thread's 4 * ZC slots)
template <typename T, int VEC, int ZC, int D>
struct Shape {
  static constexpr int H = kLanesPerZ;
  static constexpr int kWarps = 8 * H;    // y values in flight
  static constexpr int kBlock = 32 * kWarps;
  static constexpr int kZLanes = 32 / H;  // z values in flight
  static constexpr int kYSlots = kMaxY / kWarps;
  static constexpr int kZChunks = ZC;
  static constexpr int kSlots = kYSlots * kZChunks;
  static constexpr int kDepth = D;
  static_assert(kSlots % kDepth == 0, "the ring must divide the slots");
  using W = typename Vec<T, VEC>::W;
  using W4 = typename Vec<T, 4>::W;
  // shared memory: the ring of each thread's latent words and weights,
  // then the per-warp floor_xz partials, two buffers
  static constexpr int kSlabBytes =
      kDepth * kBlock * (sizeof(W) + sizeof(W4));
  static int bytes(int Z) {
    return kSlabBytes + 2 * kWarps * Z * H * VEC * (int)sizeof(float);
  }
};

template <typename T, int VEC, int ZC, int D>
__global__ void __launch_bounds__(256 * kLanesPerZ, 2 / kLanesPerZ)
    pillar_collapse_kernel(const T* __restrict__ latent,
                           const T* __restrict__ wb, T* __restrict__ out_yz,
                           T* __restrict__ out_xz, T* __restrict__ out_xy,
                           int X, int Y, int Z, int C) {
  using S = Shape<T, VEC, ZC, D>;
  constexpr int H = kLanesPerZ;
  constexpr int kWarps = S::kWarps, kZLanes = S::kZLanes;
  constexpr int kYSlots = S::kYSlots, kZChunks = S::kZChunks;
  constexpr int kSlots = S::kSlots, kDepth = S::kDepth;
  using V = Vec<T, VEC>;
  using V4 = Vec<T, 4>;
  using W = typename S::W;
  using W4 = typename S::W4;
  extern __shared__ __align__(16) unsigned char smem[];
  W* s_lat = reinterpret_cast<W*>(smem);                   // [ring][thread]
  W4* s_w = reinterpret_cast<W4*>(s_lat + kDepth * S::kBlock);
  float* s_xz = reinterpret_cast<float*>(smem + S::kSlabBytes);

  const int n_vec = C / VEC;
  const int slices = (n_vec + H - 1) / H;
  const int n = blockIdx.x / slices;
  const int slice = blockIdx.x - n * slices;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int zl = lane / H, h = lane % H;
  const int v = slice * H + h;
  const bool v_ok = v < n_vec;

  auto live = [&](int sy, int cz) {
    return v_ok && sy * kWarps + warp < Y && cz * kZLanes + zl < Z;
  };
  // slot (sy, cz) of x into this thread's words of ring entry slot % kDepth:
  // one commit group per slot and x, empty where the slot is dead or x is
  // past the end, so that the group of (x, slot) is always kDepth - 1
  // groups behind
  auto fetch = [&](int x, int sy, int cz) {
    const int ring = (sy * kZChunks + cz) % kDepth;
    if (x < X && live(sy, cz)) {
      const long long cell =
          (((long long)n * X + x) * Y + sy * kWarps + warp) * Z +
          cz * kZLanes + zl;
      copy_async<sizeof(W)>(s_lat + ring * S::kBlock + threadIdx.x,
                            reinterpret_cast<const W*>(latent + cell * C) + v);
      copy_async<sizeof(W4)>(s_w + ring * S::kBlock + threadIdx.x,
                             wb + cell * 4);
    }
    commit_async();
  };
#pragma unroll
  for (int sy = 0; sy < kYSlots; ++sy)
#pragma unroll
    for (int cz = 0; cz < kZChunks; ++cz)
      if (sy * kZChunks + cz < kDepth) fetch(0, sy, cz);

  float acc[kYSlots][kZChunks][VEC] = {};  // floor_yz over x
  for (int x = 0; x < X; ++x) {
    float* sx = s_xz + (x & 1) * kWarps * Z * H * VEC;
    float pxz[kZChunks][VEC] = {};  // floor_xz over this thread's y
#pragma unroll
    for (int sy = 0; sy < kYSlots; ++sy) {
      float pxy[VEC] = {};  // floor_xy over this thread's z
#pragma unroll
      for (int cz = 0; cz < kZChunks; ++cz) {
        const int slot = sy * kZChunks + cz;
        wait_async<kDepth - 1>();
        if (live(sy, cz)) {
          float l[VEC], w[4];
          V::unpack(s_lat[(slot % kDepth) * S::kBlock + threadIdx.x], l);
          V4::unpack(s_w[(slot % kDepth) * S::kBlock + threadIdx.x], w);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            acc[sy][cz][k] += w[0] * l[k];
            pxz[cz][k] += w[1] * l[k];
            pxy[k] += w[2] * l[k];
          }
        }
        // the row kDepth slots ahead into the words just read (the
        // products above have waited for them): with the ring as deep as
        // the slots, the same slot of the next x
        if constexpr (kDepth == kSlots) {
          fetch(x + 1, sy, cz);
        } else {
          const int next = (slot + kDepth) % kSlots;
          fetch(slot + kDepth < kSlots ? x : x + 1, next / kZChunks,
                next % kZChunks);
        }
      }
      const int y = sy * kWarps + warp;
      if (y < Y) {  // the same for the whole warp
        int ch = 0;
        LaneSum<VEC, 16, H>::run(pxy, lane, ch);
        if (v_ok && zl % (kZLanes / VEC) == 0)
          from_float(pxy[0], out_xy + (((long long)n * X + x) * Y + y) * C +
                                 v * VEC + ch);
      }
    }
#pragma unroll
    for (int cz = 0; cz < kZChunks; ++cz) {
      const int z = cz * kZLanes + zl;
      if (z >= Z) continue;
      float4* dst = reinterpret_cast<float4*>(
          sx + ((warp * Z + z) * H + h) * VEC);
#pragma unroll
      for (int k = 0; k < VEC; k += 4)
        dst[k / 4] = make_float4(pxz[cz][k], pxz[cz][k + 1], pxz[cz][k + 2],
                                 pxz[cz][k + 3]);
    }
    __syncthreads();  // the other buffer is rewritten only after the next
    // one vector of one z per thread: the warps' partials in warp order
    for (int i = threadIdx.x; i < Z * H; i += blockDim.x) {
      const int z = i / H, vv = slice * H + i % H;
      if (vv >= n_vec) continue;
      float s[VEC] = {};
      for (int w = 0; w < kWarps; ++w) {
        const float* src = sx + (w * Z * H + i) * VEC;
#pragma unroll
        for (int k = 0; k < VEC; ++k) s[k] += src[k];
      }
      reinterpret_cast<W*>(out_xz + (((long long)n * X + x) * Z + z) * C)[vv] =
          V::pack(s);
    }
  }
#pragma unroll
  for (int sy = 0; sy < kYSlots; ++sy)
#pragma unroll
    for (int cz = 0; cz < kZChunks; ++cz) {
      if (!live(sy, cz)) continue;
      const int y = sy * kWarps + warp, z = cz * kZLanes + zl;
      reinterpret_cast<W*>(out_yz + (((long long)n * Y + y) * Z + z) * C)[v] =
          V::pack(acc[sy][cz]);
    }
}

template <typename T, int VEC, int ZC, int D>
int launch(const void* latent, const void* l_yz, const void* l_xz,
           const void* l_xy, void* o_yz, void* o_xz, void* o_xy,
           void* scratch, int nv, int X, int Y, int Z, int C,
           cudaStream_t stream) {
  constexpr int H = kLanesPerZ;
  using S = Shape<T, VEC, ZC, D>;
  const long long n_pillars =
      (long long)nv * ((long long)Y * Z + (long long)X * Z + (long long)X * Y);
  T* wb = static_cast<T*>(scratch);
  pillar_weights_kernel<T><<<(unsigned)((n_pillars + kThreads - 1) /
                                        kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(l_yz), static_cast<const T*>(l_xz),
      static_cast<const T*>(l_xy), wb, n_pillars, X, Y, Z);
  const long long blocks = (long long)nv * ((C / VEC + H - 1) / H);
  const int smem = S::bytes(Z);
  auto kernel = pillar_collapse_kernel<T, VEC, ZC, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, S::kBlock, smem, stream>>>(
      static_cast<const T*>(latent), wb, static_cast<T*>(o_yz),
      static_cast<T*>(o_xz), static_cast<T*>(o_xy), X, Y, Z, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16, for the latent, the logits and the
// outputs alike. latent (NV,X,Y,Z,C), 16-byte aligned; logits (NV,X,Y,Z);
// outputs (NV,Y,Z,C), (NV,X,Z,C), (NV,X,Y,C); scratch: NV*X*Y*Z*4 elements
// of the latent's type, 16-byte aligned. Takes 1 <= X, 1 <= Y <= 64,
// 1 <= Z <= 64, 4 <= C with C % 4 == 0; the wrapper (ops/pillar.py)
// checks all of it. Z <= 32 keeps two z chunks (and bf16 its 8-channel
// vectors where 8 divides C); 32 < Z <= 64 takes four, with 4-channel
// vectors.
extern "C" int pillar_collapse_fwd(const void* latent, const void* logit_yz,
                                   const void* logit_xz, const void* logit_xy,
                                   void* out_yz, void* out_xz, void* out_xy,
                                   void* scratch, int dtype, int nv, int X,
                                   int Y, int Z, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nv < 1 || X < 1 || Y < 1 || Y > kMaxY || Z < 1 || Z > kMaxZ || C < 4 ||
      C % 4)
    return (int)cudaErrorInvalidValue;
  const bool wide = Z > 32;
  if (dtype == 0 && !wide)
    return launch<float, 4, 2, 8>(latent, logit_yz, logit_xz, logit_xy,
                                  out_yz, out_xz, out_xy, scratch, nv, X, Y,
                                  Z, C, s);
  if (dtype == 0)
    return launch<float, 4, 4, 8>(latent, logit_yz, logit_xz, logit_xy,
                                  out_yz, out_xz, out_xy, scratch, nv, X, Y,
                                  Z, C, s);
  if (dtype == 1 && !wide && C % 8 == 0)
    return launch<__nv_bfloat16, 8, 2, 8>(latent, logit_yz, logit_xz,
                                          logit_xy, out_yz, out_xz, out_xy,
                                          scratch, nv, X, Y, Z, C, s);
  if (dtype == 1 && !wide)
    return launch<__nv_bfloat16, 4, 2, 8>(latent, logit_yz, logit_xz,
                                          logit_xy, out_yz, out_xz, out_xy,
                                          scratch, nv, X, Y, Z, C, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 4, 4, 16>(latent, logit_yz, logit_xz,
                                           logit_xy, out_yz, out_xz, out_xy,
                                           scratch, nv, X, Y, Z, C, s);
  return (int)cudaErrorInvalidValue;
}
