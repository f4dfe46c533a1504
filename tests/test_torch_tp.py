"""The port's tensor-parallel placement (`parallel.sharding.
tp_param_shardings`, `distribute_params`) against the JAX package's
`tp_param_shardings`, on the CPU.

Two gloo ranks, started by the port's launcher (`sharding.launch`, a file
store under the test's tmp dir), build a {"data": 1, "model": 2}
DeviceMesh and the full-width MipNeRF-360 (8 x 1024 NeRF MLP, two 4 x 256
proposal MLPs) from one seed: its placements, parameter by parameter, must
be JAX's specs for the same Flax variables on tests/conftest.py's {"data":
4, "model": 2} mesh of 8 host devices (a Flax kernel (in, out) sharded on
"model" in its last axis is a torch weight (out, in) sharded in dimension
0). The NeRF MLP, sharded by those placements, runs a forward on both
ranks that must equal the unsharded forward in this process to 1e-5
relative (float32; each output column is the same dot product, only the
matrix products are split over the ranks).

The children import this module to find their rank function, so it
imports nothing of JAX at its top.
"""

import numpy as np
import pytest
import torch

from neo360_tpu_torch.models.mipnerf360 import MipNeRF360
from neo360_tpu_torch.parallel import sharding

torch.set_num_threads(1)

SEED = 0
SYNTHETIC = {"big.weight": (1024, 256), "big.bias": (1024,),
             "small.weight": (16, 16), "small.bias": (16,),
             "odd.weight": (1025, 8), "narrow.bias": (510,),
             "conv.weight": (1024, 3, 3, 3)}


def _points():
    """Conical-frustum Gaussians of 4 rays x 8 samples and view dirs."""
    rng = np.random.default_rng(1)
    means = torch.as_tensor(rng.normal(size=(4, 8, 3)) * 0.5,
                            dtype=torch.float32)
    a = rng.normal(size=(4, 8, 3, 3)) * 0.05
    covs = torch.as_tensor(a @ np.swapaxes(a, -1, -2) + 1e-4 * np.eye(3),
                           dtype=torch.float32)
    d = rng.normal(size=(4, 3))
    viewdirs = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                               dtype=torch.float32)
    return means, covs, viewdirs


def _model():
    return MipNeRF360(generator=torch.Generator().manual_seed(SEED))


def _placements(shardings):
    return {k: [repr(p) for p in v] for k, v in shardings.items()}


def _tp_rank():
    """One rank: the placements of the full MipNeRF-360 and of the
    synthetic tensors, and the forward of its sharded NeRF MLP."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    model = _model()
    model_placements = _placements(sharding.tp_param_shardings(model, mesh))
    synthetic = _placements(sharding.tp_param_shardings(
        {k: torch.zeros(s) for k, s in SYNTHETIC.items()}, mesh))
    mlp = model.nerf_mlp
    sharding.distribute_params(mlp, mesh,
                               sharding.tp_param_shardings(mlp, mesh))
    local = {n: (type(p).__name__, tuple(p.to_local().shape))
             for n, p in mlp.named_parameters() if isinstance(p, DTensor)}
    with torch.no_grad():
        out = mlp(*_points())
    nested = torch.nn.Sequential(torch.nn.Linear(2, 2))
    nested.register_parameter("scale", torch.nn.Parameter(torch.ones(1)))
    try:
        sharding.distribute_params(nested, mesh, sharding.tp_param_shardings(
            nested, mesh))
        local["nested"] = "distributed"
    except ValueError as e:
        local["nested"] = str(e)
    return model_placements, synthetic, local, {k: v.clone()
                                                for k, v in out.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return sharding.launch(_tp_rank, 2, device="cpu",
                           init_method=f"file://{tmp}/store")


def _jax_specs():
    """The {"data": 4, "model": 2} mesh and name -> PartitionSpec of JAX's
    tp_param_shardings over the MipNeRF-360 variables' shapes, with the
    port's parameter names (kernel -> weight)."""
    import jax
    import jax.numpy as jnp

    from neo360_tpu.models.mipnerf360 import MipNeRF360 as JMipNeRF360
    from neo360_tpu.parallel import sharding as jsh

    mesh = jsh.make_mesh({"data": 4, "model": 2})
    rays = {k: jnp.zeros((4, n)) for k, n in (("rays_o", 3), ("rays_d", 3),
                                               ("viewdirs", 3), ("radii", 1))}
    model = JMipNeRF360()
    shapes = jax.eval_shape(lambda r: model.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        r, 0.5, False, 0.2, 3.0), rays)["params"]
    specs = jsh.tp_param_shardings(shapes, mesh)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = [k.key for k in path]
        keys[-1] = {"kernel": "weight"}.get(keys[-1], keys[-1])
        out[".".join(keys)] = s.spec
    return mesh, out


def _sharded(placements) -> bool:
    """Whether the port's placements on the ("data", "model") mesh shard
    the parameter (in dimension 0, on "model")."""
    assert placements[0] == "Replicate()"
    assert placements[1] in ("Replicate()", "Shard(dim=0)")
    return placements[1] == "Shard(dim=0)"


def test_tp_placements_match_jax(ranks):
    """Every MipNeRF-360 parameter's placement is JAX's spec: the trunk
    layers and biases of the 1024-wide NeRF MLP sharded on "model", the
    rest replicated; the ranks agree."""
    from jax.sharding import PartitionSpec as P

    _, specs = _jax_specs()
    (ours, _, _, _), (other, _, _, _) = ranks
    assert ours == other
    assert sorted(ours) == sorted(specs)
    for name, spec in specs.items():
        want = (P(None, "model"), P("model")) if _sharded(ours[name]) \
            else (P(),)
        assert spec in want, (name, spec, ours[name])
    sharded = sorted(n for n, p in ours.items() if _sharded(p))
    assert sharded == sorted(f"nerf_mlp.pts_{i}.{leaf}" for i in range(8)
                             for leaf in ("weight", "bias"))


def test_tp_rule_matches_jax_on_synthetic_tensors(ranks):
    """tests/test_parallel.py's tensors (and a width that does not divide,
    one below the minimum, a 4-D kernel): a Flax kernel (in, out) is the
    port's (out, in) weight."""
    import jax.numpy as jnp

    from neo360_tpu.parallel import sharding as jsh

    mesh, _ = _jax_specs()
    flax_shape = lambda name, s: s[::-1] if name.endswith("weight") and \
        len(s) == 2 else (s[2:] + s[1:2] + s[:1] if len(s) == 4 else s)
    specs = jsh.tp_param_shardings(
        {k: jnp.zeros(flax_shape(k, s)) for k, s in SYNTHETIC.items()}, mesh)
    (_, ours, _, _), _ = ranks
    for name in SYNTHETIC:
        assert _sharded(ours[name]) == (specs[name].spec != ()), name
    assert [n for n in SYNTHETIC if _sharded(ours[n])] == \
        ["big.weight", "big.bias"]


def test_tp_forward_matches_one_rank(ranks):
    """The NeRF MLP with its trunk sharded over two ranks (each holds half
    of every 1024-wide layer) gives the unsharded forward, on both ranks."""
    model = _model()
    with torch.no_grad():
        ref = model.nerf_mlp(*_points())
    for _, _, local, out in ranks:
        assert local["pts_0.weight"] == ("DTensor", (512, 504))
        assert local["pts_5.weight"] == ("DTensor", (512, 1528))
        assert local["density.weight"] == ("DTensor", (1, 1024))
        # a module that owns parameters and holds another that does
        assert "both own parameters" in local["nested"]
        for k in ("density", "rgb"):
            r = ref[k].numpy()
            np.testing.assert_allclose(out[k].numpy(), r, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(r).max()))
