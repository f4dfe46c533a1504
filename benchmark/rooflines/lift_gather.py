"""The lift: every grid point of every view projected into its view and
sampled from the (lifted) pixel latent, once per encode. Least bytes: the
points' uv read and the sampled rows written once, in the compute dtype
(the latent's rows read are data-dependent and not counted)."""

KERNELS = (r"table_sample_kernel",)


def least_bytes(w):
    gx, gy, gz = w.grid
    pts = w.nv * gx * gy * gz
    return w.encodes * pts * (2 * 4 + w.lift_width * w.elt)
