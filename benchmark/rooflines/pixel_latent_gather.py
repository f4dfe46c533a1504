"""Kernel A on PixelNeRF's latent: every sample of both levels, in each
of its scene's source views, sampled from the border-padded corner table
of all the step's source images. Least bytes: the points' uv read and the
float32 latents written once (the table's rows read are data-dependent
and not counted)."""

KERNELS = (r"table_sample_kernel",)


def least_bytes(w):
    return sum(w.points(level) * (2 * 4 + w.d_latent * 4)
               for level in range(len(w.samples)))
