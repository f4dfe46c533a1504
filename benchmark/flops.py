"""Model FLOPs of one item: the convolutions and dense layers of NeO-360 at
the item's shapes (work.py), two per multiply-add; three times the
forward for a training item (forward, and the backward's two products);
a recompute is not counted. Whatever implements a layer, it counts the
same."""

from __future__ import annotations

from benchmark.work import Work


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(h, w, cin, cout, k, s, p):
    """(MACs, out h, out w) of a k x k convolution."""
    ho, wo = _conv_out(h, k, s, p), _conv_out(w, k, s, p)
    return ho * wo * cout * cin * k * k, ho, wo


def resnet34_macs(h: int, w: int) -> int:
    macs, h, w = _conv(h, w, 3, 64, 7, 2, 3)
    h, w = _conv_out(h, 3, 2, 1), _conv_out(w, 3, 2, 1)
    cin = 64
    for stage, (blocks, width) in enumerate(((3, 64), (4, 128), (6, 256))):
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            m1, ho, wo = _conv(h, w, cin, width, 3, stride, 1)
            m2, _, _ = _conv(ho, wo, width, width, 3, 1, 1)
            macs += m1 + m2
            if stride != 1 or cin != width:
                macs += _conv(h, w, cin, width, 1, stride, 0)[0]
            h, w, cin = ho, wo, width
    return macs


def floorplan_macs(a: int, b: int, cin: int, plane_hw, plane_dim: int
                   ) -> int:
    m0, a, b = _conv(a, b, cin, 256, 3, 2, 1)
    m1, a, b = _conv(a, b, 256, 128, 3, 2, 1)
    m2, a, b = _conv(a, b, 128, 128, 3, 1, 1)
    m3, _, _ = _conv(2 * a, 2 * b, 128, 128, 3, 1, 1)
    m4, _, _ = _conv(plane_hw[0], plane_hw[1], 128, plane_dim, 3, 1, 1)
    return m0 + m1 + m2 + m3 + m4


def encode_macs(w: Work) -> int:
    nv, (h, wd) = w.nv, w.image_hw
    lh, lw = w.latent_hw
    gx, gy, gz = w.grid
    g = gx * gy * gz
    e, f = w.encoder_width, w.pillar_width
    macs = nv * resnet34_macs(h, wd)
    if w.lift_proj:
        macs += nv * lh * lw * 512 * w.lift_width
    depth = (w.lift_width + 6) * e + (w.depth_fc_layers - 1) * e * e + e * e
    if w.depth_fc_layers == 0:
        depth = (w.lift_width + 6) * e
    macs += nv * g * (depth + e * 3 * f + 3 * f)
    for a, b in ((gy, gz), (gx, gz), (gx, gy)):
        macs += nv * floorplan_macs(a, b, e, w.plane_hw, w.plane_dim)
    macs += w.local_maps * 2 * nv * lh * lw * 512 * w.local_dim
    return macs


def mlp_macs(w: Work, rays: int, samples: int, point_dim: int,
             conditioned: bool) -> int:
    pe = point_dim * 21
    if not conditioned:
        return rays * samples * (pe * 128 + 3 * 128 * 128 + 128)
    d_in = pe + w.local_dim + w.plane_dim
    per_view = (d_in * 128 + 2 * 128 * 128 + (128 + d_in) * 128
                + 128 * 128 + (128 + 27) * 64)
    per_point = 128 + 64 * 64 + 64 * 3
    return w.nv * rays * samples * per_view + rays * samples * per_point


def item_flops(w: Work) -> float:
    macs = w.encodes * encode_macs(w)
    for count, lvls in w.batches:
        for rays, s_fg, s_bg, cond in lvls:
            macs += count * (mlp_macs(w, rays, s_fg, 3, cond)
                             + mlp_macs(w, rays, s_bg, 4, cond))
    return 2.0 * macs * (3 if w.train else 1)
