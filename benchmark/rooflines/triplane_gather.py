"""The tri-plane sample: every fg and bg point of a conditioned level, in
each view's camera frame, sampled from the xz, xy and yz planes and the
three summed. Least bytes: the camera points read and the float32 sums
written once (the planes' rows read are data-dependent and not
counted)."""

KERNELS = (r"triplane_sample_kernel",)


def least_bytes(w):
    total = 0
    for count, rays, s_fg, s_bg in w.conditioned():
        pts = w.nv * rays * (s_fg + s_bg)
        total += count * pts * (3 * 4 + w.plane_dim * 4)
    return total
