"""The pillar collapse's transpose in training: the grid latent, its logits
and the floorplans' gradients read once, the latent's and the logits'
gradients written once, in the compute dtype."""

KERNELS = (r"pillar_softmax_kernel", r"pillar_dlatent_kernel",
           r"pillar_dlogit_kernel")


def least_bytes(w):
    if not w.train:
        return 0
    gx, gy, gz = w.grid
    cells = w.nv * gx * gy * gz
    floors = w.nv * (gy * gz + gx * gz + gx * gy) * w.encoder_width
    return w.encodes * (2 * cells * (w.encoder_width + 3) + floors) * w.elt
