"""The transposes of the three gathers in training (one family: they share
their kernels): each gather's output gradient and its points read once;
the lifted latent's gradient written whole once per encode, and with the
per-step trainer the planes' and local maps' gradients written whole once
a step (the stage trainer adds them up at the rows the points touch,
which is data-dependent and not counted)."""

KERNELS = (r"table_scatter_kernel", r"round_to_bf16_kernel")


def least_bytes(w):
    if not w.train:
        return 0
    gx, gy, gz = w.grid
    lh, lw = w.latent_hw
    pts = w.nv * gx * gy * gz
    total = w.encodes * (pts * (2 * 4 + w.lift_width * w.elt)
                         + w.nv * lh * lw * w.lift_width * w.elt)
    for count, rays, s_fg, s_bg in w.conditioned():
        p = w.nv * rays * (s_fg + s_bg)
        total += count * p * (2 * 3 * 4 + (w.plane_dim + w.local_dim) * 4)
        if w.dense_tables:
            ph, pw = w.plane_hw
            total += count * (3 * w.nv * ph * pw * w.plane_dim
                              + 2 * w.nv * lh * lw * w.local_dim) * w.elt
    return total
