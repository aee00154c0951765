"""The port's sharding rules (``repro_torch.models.sharding``) against the
JAX package's (``repro.models.sharding``): parameter, batch and cache specs
leaf for leaf, equal to the reference's ``tuple(PartitionSpec)``, for every
arch at five mesh shapes with fsdp off and on; the port's mirrors of the
reference's own assertions; and each rank's shard from ``distribute``
against the slice the reference's spec gives that rank's coordinates, on a
fake world of 4 and of 8 ranks."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import sharding as jshd
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import Grid, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as shd

ARCHS = configs.ARCHS
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}


class FakeMesh:
    """Duck-typed mesh carrying only what the reference's sharding.py reads
    (tests/test_sharding_rules.py's)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)
        self.shape = dict(zip(names, shape))


def _cfgs(arch, fsdp):
    return (dataclasses.replace(jconfigs.get_config(arch), fsdp=fsdp),
            dataclasses.replace(configs.get_config(arch), fsdp=fsdp))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(functools.partial(jtf.init_params, cfg=jconfigs.get_config(arch)),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return dr.abstract_params(configs.get_config(arch), device="cpu")


def _jax_flat(tree, specs):
    """{leaf path: (shape, tuple(spec))} of a reference tree and its specs."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return {"/".join(str(getattr(k, "key", k)) for k in path): (tuple(leaf.shape), tuple(s))
            for (path, leaf), s in zip(leaves, spec_leaves)}


def _port_flat(tree, specs, prefix=""):
    out = {}
    for k in tree:
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_port_flat(tree[k], specs[k], path))
        else:
            out[path] = (tuple(tree[k].shape), specs[k])
    return out


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, fsdp):
    shape, names = MESHES[mesh]
    jcfg, cfg = _cfgs(arch, fsdp)
    jp = _jax_params(arch)
    want = _jax_flat(jp, jshd.param_specs(jcfg, jp, FakeMesh(shape, names)))
    pp = _port_params(arch)
    got = _port_flat(pp, shd.param_specs(cfg, pp, Grid(shape, names)))
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    shape, names = MESHES[mesh]
    jmesh, grid = FakeMesh(shape, names), Grid(shape, names)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for b in (1, 8, 256):
        jb = {"tokens": jax.ShapeDtypeStruct((b, 128), jnp.int32),
              "frontend": jax.ShapeDtypeStruct((b, 4, 8), jnp.bfloat16)}
        pb = {"tokens": torch.empty(b, 128, dtype=torch.int32),
              "frontend": torch.empty(b, 4, 8, dtype=torch.bfloat16)}
        want = {k: tuple(v) for k, v in jshd.batch_specs(jcfg, jb, jmesh).items()}
        assert shd.batch_specs(cfg, pb, grid) == want
    for name in ("decode_32k", "long_500k"):
        b, s = dr.SHAPES[name]["batch"], dr.SHAPES[name]["seq"]
        jc = jax.eval_shape(functools.partial(jmodel.make_caches, jcfg, b, s,
                                              dtype=jnp.bfloat16))
        with dr._fake_mode():
            pc = M.make_caches(cfg, b, s, dtype=torch.bfloat16, device="cpu")
        want = _jax_flat(jc, jshd.cache_specs(jcfg, jc, jmesh))
        assert _port_flat(pc, shd.cache_specs(cfg, pc, grid)) == want


# --------------------------------------------------------------------------
# The reference's own assertions (tests/test_sharding_rules.py), on the port
# --------------------------------------------------------------------------

MESH = make_production_mesh()
MESH3 = make_production_mesh(multi_pod=True)


def _specs(arch, mesh=MESH):
    cfg = configs.get_config(arch)
    params = _port_params(arch)
    return cfg, _port_flat(params, shd.param_specs(cfg, params, mesh))


def test_every_sharded_dim_is_divisible():
    for arch in ("gemma_7b", "llama4_maverick_400b_a17b", "smollm_360m",
                 "granite_moe_3b_a800m", "mamba2_370m"):
        _, flat = _specs(arch)
        for key, (shape, spec) in flat.items():
            for dim, ax in enumerate(spec):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                size = int(np.prod([MESH.shape[a] for a in axes]))
                assert shape[dim] % size == 0, (arch, key, shape, spec)


def test_embed_never_fsdp_on_dmodel():
    for arch in ("gemma_7b", "gemma2_27b", "llama4_maverick_400b_a17b"):
        cfg = dataclasses.replace(configs.get_config(arch), fsdp=True)
        params = _port_params(arch)
        spec = shd.param_specs(cfg, params, MESH)["embed"]
        assert spec[0] in ("model", None)
        assert spec[1] is None, (arch, spec)


def test_nondivisible_heads_replicated():
    _, flat = _specs("smollm_360m")  # 15 heads, kv 5: not /16
    for key, (_, spec) in flat.items():
        if key.endswith("wq") or key.endswith("wk"):
            assert spec[2] is None


def test_moe_experts_sharded_on_model():
    _, flat = _specs("llama4_maverick_400b_a17b")
    moe_wi = [s for k, (_, s) in flat.items() if "moe" in k and k.endswith("wi")]
    assert moe_wi and all(s[1] == "model" for s in moe_wi)  # stacked dim 0


def test_batch_specs_replicate_when_indivisible():
    cfg = configs.get_config("mamba2_370m")
    big = {"tokens": torch.empty(256, 128, dtype=torch.int32)}
    one = {"tokens": torch.empty(1, 128, dtype=torch.int32)}
    assert shd.batch_specs(cfg, big, MESH3)["tokens"][0] == ("pod", "data")
    assert shd.batch_specs(cfg, one, MESH3)["tokens"][0] is None  # long_500k batch=1


def test_axis_sizes():
    sizes, ndp, tp = shd.axis_sizes(MESH3)
    assert ndp == 32 and tp == 16 and sizes == {"pod": 2, "data": 16, "model": 16}
    sizes, ndp, tp = shd.axis_sizes(MESH)
    assert ndp == 16 and tp == 16
    assert shd.data_axes(MESH3) == ("pod", "data") and shd.data_axes(MESH) == ("data",)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Named:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    class OnePod(Named):
        shape = (1, 16, 16)
    assert shd.placements(Named, (("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shd.placements(Named, (None, "data")) == [Replicate(), Shard(1), Replicate()]
    assert shd.placements(Named, ()) == [Replicate()] * 3
    assert shd.placements(OnePod, (("pod", "data"),)) == [Replicate(), Shard(0), Replicate()]
    with pytest.raises(ValueError):
        shd.placements(Named, (("data", "pod"),))


# --------------------------------------------------------------------------
# Each rank's shard: DTensor's placements against the reference's slicing
# --------------------------------------------------------------------------

def _reference_slice(full: np.ndarray, spec: tuple, coords: dict, sizes: dict):
    """The block of ``full`` that a ``PartitionSpec`` gives the device at
    ``coords``: a dim over axes (a1, a2, ...) splits into prod(sizes) even
    blocks, indexed row-major by the axes in the spec's order."""
    index = []
    for d, entry in enumerate(spec + (None,) * (full.ndim - len(spec))):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        k = int(np.ravel_multi_index([coords[a] for a in axes],
                                     [sizes[a] for a in axes])) if axes else 0
        step = full.shape[d] // n
        index.append(slice(k * step, (k + 1) * step))
    return full[tuple(index)]


def _tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_tensors(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("dims,names", [((2, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_distribute_gives_each_rank_the_reference_slice(dims, names):
    from torch.distributed.device_mesh import DeviceMesh
    arch = "granite_moe_3b_a800m"       # experts, heads and FFN on 'model'
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    params = M.init_params(cfg, device="cpu")
    jp = jax.eval_shape(functools.partial(jtf.init_params, cfg=jcfg), jax.random.PRNGKey(0))
    jmesh, grid = FakeMesh(dims, names), Grid(dims, names)
    jspecs = _jax_flat(jp, jshd.param_specs(jcfg, jp, jmesh))
    batch = {"tokens": torch.arange(8 * 6, dtype=torch.int32).reshape(8, 6)}
    bspec = tuple(jshd.batch_specs(
        jcfg, {"tokens": jax.ShapeDtypeStruct((8, 6), jnp.int32)}, jmesh)["tokens"])
    assert bspec[0] == (("pod", "data") if len(dims) == 3 else "data")
    assert any(spec[1][1] == "model" for spec in jspecs.values())
    world, sizes = int(np.prod(dims)), dict(zip(names, dims))
    flat = _tensors(params)
    for rank in range(world):
        coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, dims))))
        with dr.fake_world(world, rank=rank):
            mesh = DeviceMesh("cpu", torch.arange(world).reshape(dims), mesh_dim_names=names)
            placed = _tensors(shd.distribute(params, mesh, shd.param_specs(cfg, params, grid)))
            placed_batch = shd.distribute(batch, mesh, shd.batch_specs(cfg, batch, grid))
        assert set(placed) == set(jspecs)
        for path, leaf in placed.items():
            want = _reference_slice(flat[path].numpy(), jspecs[path][1], coords, sizes)
            np.testing.assert_array_equal(leaf.to_local().numpy(), want, err_msg=path)
        want = _reference_slice(batch["tokens"].numpy(), bspec, coords, sizes)
        np.testing.assert_array_equal(placed_batch["tokens"].to_local().numpy(), want)
    assert not dist.is_initialized()


def test_local_mesh_is_the_world_over_data():
    from repro_torch.launch import dist_index as di
    from repro_torch.launch.mesh import make_local_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(device="cpu")
    with di.single_process_group("gloo"):
        mesh = make_local_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device.type == "cpu"
    grid = make_production_mesh(multi_pod=True)
    assert (grid.dims, grid.axis_names, grid.size, grid.label) == \
        ((2, 16, 16), ("pod", "data", "model"), 512, "2x16x16")
