"""NeO-360's FLOP counter and roofline families (its adapter's `Work`,
`item_flops` and `FAMILIES`) against counts made by hand at one small
shape, and the FLOP counter against torch's own count of the reference's
dense layers and convolutions at a tiny size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import scenes, weights
from benchmark.reference import model as ref
from benchmark.registry import Registry

NEO = Registry().architecture(Registry().config("neo360"))


def tiny_weights(cfg: dict, seed: int = 5) -> dict:
    """Seeded weights of a port NeRFTP built at `cfg`'s sizes."""
    from neo360_tpu_torch.models.neo360 import NeRFTP
    from neo360_tpu_torch.nn.triplane import GridEncoder
    saved = GridEncoder.plane_hw
    GridEncoder.plane_hw = tuple(cfg["plane_hw"])
    try:
        model = NeRFTP(num_src_views=cfg["num_src_views"],
                       grid_size=tuple(cfg["grid_size"]),
                       encoder_width=cfg["encoder_width"],
                       lift_dim=cfg["lift_dim"],
                       pillar_width=cfg["pillar_width"],
                       plane_dim=cfg["plane_dim"],
                       local_proj_dim=cfg["local_proj_dim"],
                       use_proposal=cfg["use_proposal"],
                       num_prop_samples=cfg["num_prop_samples"],
                       num_coarse_samples=cfg["num_coarse_samples"],
                       num_fine_samples=cfg["num_fine_samples"])
    finally:
        GridEncoder.plane_hw = saved
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    return weights.make(shapes, seed, "cpu")


def tiny_scene(nv: int, w: int, h: int, n_rays: int, seed: int = 3):
    pool = scenes.ScenePool(seed, 1, 12, (w, h), 8.0, "cpu")
    gen = torch.Generator().manual_seed(seed)
    view = torch.randint(nv, 12, (n_rays,), generator=gen).numpy()
    xs = torch.randint(0, w, (n_rays,), generator=gen).numpy()
    ys = torch.randint(0, h, (n_rays,), generator=gen).numpy()
    rays = pool.dest_rays(0, view, xs, ys)
    return pool.source_stack(0, range(nv)), {k: rays[k]
                                            for k in scenes.RAY_KEYS}


def small_work(**kw):
    base = dict(nv=2, image_hw=(8, 8), latent_hw=(3, 4), grid=(2, 2, 2),
                plane_hw=(5, 6), encoder_width=4, lift_width=4,
                lift_proj=True, plane_dim=3, local_dim=5, local_maps=1,
                pillar_width=4, depth_fc_layers=2, elt=2,
                encodes=1, batches=[(2, [(3, 5, 5, False), (3, 4, 4, True)])],
                train=True, dense_tables=True)
    base.update(kw)
    return NEO.Work(**base)


# least bytes at small_work(), counted by hand (see each family's doc):
HAND = {
    # 1 encode x 2 views x 8 points x (uv 8 B + 4 channels x 2 B)
    "lift_gather": 16 * (8 + 8),
    # 2 batches x 2 views x 3 rays x (4 + 4) samples x (cam 12 B + 3 x 4 B)
    "triplane_gather": 2 * 48 * (12 + 12),
    "local_gather": 2 * 48 * (12 + 5 * 4),
    # per ray: 5 reads a sample, 4 a ray, a weight a sample, 12 outputs
    "nerfpp_composite": 2 * 3 * ((5 * 8 + 4 + 8 + 12)
                                 + (5 * 10 + 4 + 10 + 12)) * 4,
    # (16 cells x (4 + 3) + floors 2 x 12 x 4) x 2 B
    "pillar_collapse": (16 * 7 + 96) * 2,
    # lift: points + lifted map 2 x 3 x 4 x 4 x 2 B; the two gathers'
    # cotangents and points; whole planes 3 x 2 x 5 x 6 x 3 and local maps
    # 2 x 2 x 3 x 4 x 5, 2 B, each batch
    "gather_transpose": (16 * 16 + 2 * 12 * 4 * 2) + 2 * 48 * (24 + 32)
    + 2 * (540 + 240) * 2,
    "composite_transpose": 2 * 3 * ((5 * 8 + 4 + 4 * 8)
                                    + (5 * 10 + 4 + 4 * 10)) * 4,
    "pillar_transpose": (2 * 16 * 7 + 96) * 2,
}


def test_every_family_is_readable():
    """The families counted by hand here are NeO-360's; each names its
    kernels and counts bytes at any shape."""
    fams = Registry().families(NEO.FAMILIES)
    assert set(HAND) == set(fams)
    for fam in fams.values():
        assert fam.KERNELS and fam.least_bytes(small_work()) >= 0


@pytest.mark.parametrize("family", sorted(HAND))
def test_family_least_bytes_by_hand(family):
    fam = Registry().families([family])[family]
    assert fam.least_bytes(small_work()) == HAND[family]
    assert fam.KERNELS
    if family.endswith("transpose"):
        assert fam.least_bytes(small_work(train=False)) == 0


def test_conditioned_mlp_macs_by_hand():
    w = small_work()
    # fg: 63 encoded + 5 local + 3 plane inputs; per view: 71x128, two
    # 128x128, (128 + 71) x 128 after the skip, the 128x128 bottleneck and
    # the (128 + 27) x 64 view layer; per averaged point: density 128,
    # 64 x 64 and rgb 64 x 3
    per_view = 71 * 128 + 2 * 128 * 128 + 199 * 128 + 128 * 128 + 155 * 64
    per_point = 128 + 64 * 64 + 64 * 3
    assert NEO.mlp_macs(w, 3, 4, 3, True) == 2 * 3 * 4 * per_view \
        + 3 * 4 * per_point
    assert NEO.mlp_macs(w, 3, 5, 4, False) == 3 * 5 * (
        84 * 128 + 3 * 128 * 128 + 128)


def test_resnet34_macs_by_hand_at_8x8():
    conv1 = 4 * 4 * 64 * 3 * 49
    layer1 = 6 * 2 * 2 * 64 * 64 * 9
    layer2 = 128 * 64 * 9 + 128 * 128 * 9 + 128 * 64 + 6 * 128 * 128 * 9
    layer3 = 256 * 128 * 9 + 256 * 256 * 9 + 256 * 128 \
        + 10 * 256 * 256 * 9
    assert NEO.resnet34_macs(8, 8) == conv1 + layer1 + layer2 + layer3


@pytest.mark.parametrize("proposal", [True, False])
def test_item_flops_match_torch_count_of_the_reference(proposal):
    """A render item (forward only) at a tiny size: the adapter's item_flops
    against FlopCounterMode's count of the reference's convolutions and
    matrix products, over the encode and one batch of 256 rays (a dense
    layer on a permuted map runs as bmm; the few small einsums of the
    geometry and the pillar collapse, also bmm, are within the
    tolerance)."""
    cfg = {"num_src_views": 2, "grid_size": [4, 4, 2], "encoder_width": 16,
           "lift_dim": 8 if proposal else None, "encoder_channels": 512,
           "pillar_width": 16, "depth_fc_layers": 2, "plane_hw": [6, 8],
           "plane_dim": 8, "local_proj_dim": 8, "use_proposal": proposal,
           "num_prop_samples": 4, "num_coarse_samples": 4,
           "num_fine_samples": 3, "precision": "float32"}
    arch = ref.Arch.from_config(cfg)
    wts = tiny_weights(cfg)
    src, rays = tiny_scene(2, 16, 16, 256)
    wk = NEO.of(cfg, "view", (16, 16), 1, 1, 256, 256)
    wk.encodes = 1
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        enc = [ref.encode(wts, ref.Precision(), arch, src)]
        ref.render_rays(wts, ref.Precision(), arch, enc, src, rays)
    ops = counter.get_flop_counts()["Global"]
    counted = sum(v for k, v in ops.items()
                  if str(k).split(".")[1] in ("convolution", "mm", "addmm",
                                              "bmm"))
    assert counted == pytest.approx(NEO.item_flops(wk), rel=1e-3)
