"""Kernel E, the MipNeRF-360 composite of every level: each interval's
density, the S + 1 edges, the ray's direction and the samples' rgb read
once, the weights and the ray's rgb, acc and depth written once,
float32."""

KERNELS = (r"composite_mip_kernel",)


def least_bytes(w):
    return sum(w.rays * (5 * s + 9) * 4 for s in w.intervals)
