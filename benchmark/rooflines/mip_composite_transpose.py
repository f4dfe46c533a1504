"""Kernel E', the MipNeRF-360 composite's transpose in training: the
forward's inputs (density, the S + 1 edges, the direction, the samples'
rgb) and its acc read once, the density and rgb gradients written once,
float32 (which output cotangents are read depends on the loss and is not
counted)."""

KERNELS = (r"composite_mip_bwd_kernel",)


def least_bytes(w):
    if not w.train:
        return 0
    return sum(w.rays * (9 * s + 5) * 4 for s in w.intervals)
