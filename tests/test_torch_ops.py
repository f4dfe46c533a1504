"""Parity of the port's sampling ops (neo360_tpu_torch.ops.interpolate) with
neo360_tpu.ops.interpolate on the same numpy inputs.

On CPU tensors `table_sample` runs its plain version (kernel A's oracle);
the kernel itself is held against that version on the card by
tests/test_torch_kernels.py and chip_smoke.py.

Tolerance: 1e-5 (float32 lerp of float32 rows; the two frameworks may fuse
the multiply-adds differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neo360_tpu.ops import interpolate as jinterp
from neo360_tpu_torch.ops import interpolate, kernels

torch.set_num_threads(1)

TOL = 1e-5


def _case(seed, v=4, h=7, w=9, c=8, b=3, n=40, lim=1.4):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(v, h, w, c)).astype(np.float32)
    uv = rng.uniform(-lim, lim, size=(b, n, 2)).astype(np.float32)
    return img, uv


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_build_corner_table_matches_jax(mode):
    img, _ = _case(0)
    np.testing.assert_array_equal(
        interpolate.build_corner_table(torch.from_numpy(img), mode).numpy(),
        np.asarray(jinterp.build_corner_table(jnp.asarray(img), mode)))


@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("view_offset", [0, 1, 5])
def test_table_sample_matches_jax(mode, view_offset):
    """Both padding modes, and flat multi-view tables addressed from a view
    offset (an offset past the end clips to the last view, as in JAX)."""
    img, uv = _case(1)
    table = jinterp.build_corner_table(jnp.asarray(img), mode)
    ref = jinterp.table_sample(table, jnp.asarray(uv), img.shape[1:3], mode,
                               view_offset=view_offset,
                               total_views=img.shape[0])
    before = kernels.launches["table_sample_fwd"]
    ours = interpolate.table_sample(torch.tensor(np.asarray(table)),
                                    torch.from_numpy(uv), img.shape[1:3],
                                    mode, view_offset=view_offset)
    assert kernels.launches["table_sample_fwd"] == before   # no kernel on CPU
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_table_sample_nonfinite_uv_zeros_mode():
    """Points behind a camera project to huge or non-finite uv: in zeros
    mode they sample zeros, as in JAX, and nothing else is disturbed."""
    img, uv = _case(2)
    uv[0, :6] = [[1e30, 0.0], [-1e30, 0.5], [np.inf, 0.0],
                 [0.0, -np.inf], [np.nan, 0.1], [0.2, np.nan]]
    table = jinterp.build_corner_table(jnp.asarray(img), "zeros")
    ref = np.asarray(jinterp.table_sample(table, jnp.asarray(uv),
                                          img.shape[1:3], "zeros",
                                          total_views=img.shape[0]))
    ours = interpolate.table_sample(torch.tensor(np.asarray(table)),
                                    torch.from_numpy(uv), img.shape[1:3],
                                    "zeros").numpy()
    np.testing.assert_array_equal(ours[0, :6], 0.0)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=TOL)


def test_table_sample_bf16_table_folds_in_f32():
    """A bf16 table is folded in float32 and cast once (the deliberate
    difference from the JAX code's bf16 fold): equal to JAX sampling the
    same bf16 values held in a float32 table."""
    img, uv = _case(3, c=16)
    table = interpolate.build_corner_table(torch.from_numpy(img), "border",
                                           dtype=torch.bfloat16)
    as_f32 = table.float().numpy()
    ref = jinterp.table_sample(jnp.asarray(as_f32), jnp.asarray(uv),
                               img.shape[1:3], "border",
                               total_views=img.shape[0])
    ours = interpolate.table_sample(table, torch.from_numpy(uv),
                                    img.shape[1:3], "border")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    out_bf16 = interpolate.table_sample(table, torch.from_numpy(uv),
                                        img.shape[1:3], "border",
                                        out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(out_bf16.float().numpy(),
                                  ours.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("out_hw", [(14, 18), (5, 4), (7, 9)])
def test_interpolate_matches_jax_resize(out_hw):
    """The port resizes with F.interpolate(bilinear, align_corners=True)
    where the JAX package multiplies by interpolation matrices."""
    img, _ = _case(4)
    ours = F.interpolate(torch.from_numpy(img).permute(0, 3, 1, 2),
                         size=out_hw, mode="bilinear",
                         align_corners=True).permute(0, 2, 3, 1)
    ref = jinterp.resize_bilinear_align_corners(jnp.asarray(img), out_hw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def test_table_sample_rejects_unknown_mode():
    img, uv = _case(5)
    table = interpolate.build_corner_table(torch.from_numpy(img))
    with pytest.raises(ValueError):
        interpolate.table_sample(table, torch.from_numpy(uv), (7, 9),
                                 "reflect")
