"""Kernel D, the plain NeRF composite of every level: each sample's rgb,
density and depth and the ray's direction read once, the weights and the
ray's rgb, acc and depth written once, float32."""

KERNELS = (r"composite_vanilla_kernel",)


def least_bytes(w):
    rays = w.scenes * w.rays
    return sum(rays * (6 * s + 8) * 4 for s in w.samples)
