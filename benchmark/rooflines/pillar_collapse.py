"""The softmax pillar collapse of every encode: the grid latent and its
three logit maps read once, the three floorplans written once, in the
compute dtype."""

KERNELS = (r"pillar_weights_kernel", r"pillar_collapse_kernel")


def least_bytes(w):
    gx, gy, gz = w.grid
    cells = w.nv * gx * gy * gz
    floors = w.nv * (gy * gz + gx * gz + gx * gy) * w.encoder_width
    return w.encodes * (cells * (w.encoder_width + 3) + floors) * w.elt
