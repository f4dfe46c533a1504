"""The plain NeRF composite of both levels: every sample's rgb, density
and t read once, its weight written once, the ray's direction read and
its rgb, opacity and depth written once, float32."""

KERNELS = (r"composite_vanilla_kernel",)


def least_bytes(w):
    per_ray = sum(6 * s + 3 + 5 for s in w.samples)
    return w.batches * w.rays * per_ray * 4
