// round_bf16.cuh — the rounding pass of the bf16 gradients. Kernel A''s
// dense contract (table_sample_bwd.cu) and kernel G' (grid_sample_bwd.cu)
// sum a bf16 operand's gradient in an f32 buffer and round it once to bf16
// here. Each source launches it from a __global__ of its own name, so a
// profile tells the two apart.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace neo360 {

// dst[i] = bf16(src[i]) for i < n, to nearest even, over a grid-stride
// loop: four values a step (16-byte loads, 8-byte stores: src 16-byte and
// dst 8-byte aligned, as torch's allocations are), then the tail one by
// one.
__device__ __forceinline__ void round_to_bf16(const float* __restrict__ src,
                                              __nv_bfloat16* __restrict__ dst,
                                              long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = n / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 f = reinterpret_cast<const float4*>(src)[i];
    const __nv_bfloat162 a = __floats2bfloat162_rn(f.x, f.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.z, f.w);
    uint2 bits;
    bits.x = *reinterpret_cast<const uint32_t*>(&a);
    bits.y = *reinterpret_cast<const uint32_t*>(&b);
    reinterpret_cast<uint2*>(dst)[i] = bits;
  }
  for (long long i = 4 * n4 + (long long)blockIdx.x * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    dst[i] = __float2bfloat16_rn(src[i]);
}

// Blocks of kRoundThreads for n values: one vector a thread, at most 16
// blocks a multiprocessor of an H100 (132), at least one.
constexpr int kRoundThreads = 256;
inline unsigned round_blocks(long long n) {
  const long long want = (n / 4 + kRoundThreads - 1) / kRoundThreads;
  return (unsigned)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

}  // namespace neo360
