"""The port's test-split loaders against the JAX package's: NeRDS360AE on
the fixture scenes on disk, and MemoryScenes, which renders the same scenes
in memory without image files. Both do the same float64 numpy arithmetic as
the JAX loader and quantize pixels to 8 bits as the PNGs are, so every
array must be equal."""

import numpy as np
import pytest

from neo360_tpu.data.nerds360_ae import NeRDS360AE as JNeRDS360AE
from neo360_tpu_torch.data.fixtures import MemoryScenes
from neo360_tpu_torch.data.nerds360_ae import NeRDS360AE

WH = (40, 30)


@pytest.fixture(scope="module")
def loaders(multi_scene_root):
    return (JNeRDS360AE(multi_scene_root, "test", WH, 3),
            NeRDS360AE(multi_scene_root, "test", WH, 3),
            MemoryScenes(3, WH, 3))


@pytest.mark.parametrize("scene,view", [(0, 0), (1, 2), (2, 4)])
@pytest.mark.parametrize("port", ["disk", "memory"])
def test_sample_test_matches_jax(loaders, port, scene, view):
    jds, disk, memory = loaders
    ref = jds.sample_test(scene, view)
    ds = disk if port == "disk" else memory
    assert ds.num_test_views(scene) == len(
        jds.scene_meta(jds.scene_ids[scene]).c2w_test)
    sample = ds.sample_test(scene, view)
    assert set(sample) == {"src_imgs", "src_poses", "src_focal", "src_c",
                           "rays_o", "viewdirs", "rays_d", "target",
                           "instance_mask", "img_wh"}
    for k, v in sample.items():
        assert v.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
