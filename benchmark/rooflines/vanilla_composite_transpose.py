"""Kernel D', the plain NeRF composite's transpose in training: the
forward's inputs (each sample's rgb, density and depth, the ray's
direction) read once, the rgb and density gradients written once, float32
(which output cotangents are read depends on the loss and is not
counted)."""

KERNELS = (r"composite_vanilla_bwd_kernel",)


def least_bytes(w):
    if not w.train:
        return 0
    rays = w.scenes * w.rays
    return sum(rays * (9 * s + 3) * 4 for s in w.samples)
