"""The local sample: every fg and bg point of a conditioned level
projected into each source view and sampled from that branch's projected
pixel latent (border padding). Least bytes: the camera points read and the
float32 samples written once (the latent's rows read are data-dependent
and not counted)."""

KERNELS = (r"local_sample_kernel",)


def least_bytes(w):
    total = 0
    for count, rays, s_fg, s_bg in w.conditioned():
        pts = w.nv * rays * (s_fg + s_bg)
        total += count * pts * (3 * 4 + w.local_dim * 4)
    return total
