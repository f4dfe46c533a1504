"""The NeRF++ composite's transpose in training: the forward's inputs read
once and the rgb and density gradients of both branches written once,
float32 (which output cotangents are read depends on the loss and is not
counted)."""

KERNELS = (r"composite_nerfpp_bwd_kernel",)


def least_bytes(w):
    if not w.train:
        return 0
    total = 0
    for count, rays, s_fg, s_bg in w.all_levels():
        per_ray = 5 * (s_fg + s_bg) + 4 + 4 * (s_fg + s_bg)
        total += count * rays * per_ray * 4
    return total
