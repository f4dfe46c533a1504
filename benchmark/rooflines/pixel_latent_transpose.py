"""Kernel A' on PixelNeRF's latent in training, under the dense contract:
each level's latent gradient and the points' uv read once (the corner
rows it adds into are data-dependent, and the table-shaped gradient's
zeroing is a memset, not a kernel: neither is counted)."""

KERNELS = (r"table_scatter_kernel",)


def least_bytes(w):
    if not w.train:
        return 0
    return sum(w.points(level) * (2 * 4 + w.d_latent * 4)
               for level in range(len(w.samples)))
