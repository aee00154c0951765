"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's: the cell table, each cell's inputs and shardings, and the traced
cells of the attention archs (reduced) on the production (16, 16) world;
the ANN cell under the three merges.  The SSM archs' cells are in
``test_torch_dryrun_ssm*.py``, the counts against a direct count of the
unsharded step in ``test_torch_dryrun_counts.py``.

The reference's module appends a 512-device flag to ``XLA_FLAGS`` when it
is imported: it is imported here only, after jax has made its devices, and
the flag is taken back at once."""
import json
import os

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import Grid

import torch_dryrun_cases as cases

ARCHS = configs.ARCHS
ATTN_ARCHS = tuple(a for a in ARCHS if a not in cases.SSM_ARCHS)


class FakeMesh:
    """Duck-typed mesh carrying only what the reference reads
    (tests/test_sharding_rules.py's)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, object)
        self.shape = dict(zip(names, shape))


@pytest.fixture(scope="module")
def jdr():
    jax.devices()                       # the device count is fixed from here on
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


def test_cell_table_equals_the_reference(jdr):
    assert dr.SHAPES == jdr.SHAPES
    assert dr.LONG_OK_KINDS == jdr.LONG_OK_KINDS
    for arch in ARCHS:
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_reduced, jconfigs.get_reduced)):
            for shape in dr.SHAPES:
                assert dr.cell_supported(get(arch), shape) == \
                    jdr.cell_supported(jget(arch), shape), (arch, shape)


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _jax_args(args):
    return {"/".join(_key(k) for k in path): (tuple(leaf.shape), np.dtype(leaf.dtype).name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(args)[0]}


def _jax_specs(specs):
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(_key(k) for k in path): tuple(s) for path, s in flat}


def _port_flat(tree, leaf, prefix=""):
    """{path: leaf(x)} over tuples (top level) and dicts of ``tree``."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_port_flat(v, leaf, path) if isinstance(v, dict) else {path: leaf(v)})
    return out


def _arg(v):
    if isinstance(v, int):              # decode's position, a Python int
        return ((), "int32")
    return (tuple(v.shape), str(v.dtype).replace("torch.", ""))


@pytest.mark.parametrize("shape", list(dr.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(jdr, arch, shape):
    dims, names = (16, 16), ("data", "model")
    want = jdr.input_specs(jconfigs.get_config(arch), shape, FakeMesh(dims, names))
    with FakeTensorMode():
        got = dr.input_specs(configs.get_config(arch), shape, Grid(dims, names), "cpu")
    assert (got["tokens"], got["kind"]) == (want["tokens"], want["kind"])
    assert _port_flat(got["args"], _arg) == _jax_args(want["args"])
    specs = {}
    for i, tree in enumerate(got["in_shardings"]):     # a spec tree, or one spec
        specs.update(_port_flat(tree, lambda s: s, str(i)) if isinstance(tree, dict)
                     else {str(i): tree})
    assert specs == _jax_specs(want["in_shardings"])


@pytest.mark.parametrize("shape", list(dr.SHAPES))
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_reduced_cell_traces(arch, shape):
    cases.check_reduced_cell(arch, shape)


@pytest.mark.parametrize("merge", ["allgather", "ring", "tree"])
def test_ann_cell_collectives_are_the_exchanges(merge):
    before = dict(_build.LAUNCHES)
    r = dr.lower_ann_cell(n_global=1 << 14, q_global=256, merge=merge, device="cpu")
    assert r["launches"] == {k: 0 for k in _build.LAUNCHES}
    assert r["status"] == "ok" and r["mesh"] == "16x16"
    assert r["shape"] == "query_q256_k50" and r["bytes"] > 0
    rows, payload = 16, 2 * (256 // 16) * 50 * 4        # (d, i) int32 of a query block
    if merge == "allgather":
        # the result holds every row shard's block; the exchange sends the others
        assert r["coll_breakdown"] == {"all-gather": rows * payload}
        assert r["sent_bytes"] == (rows - 1) * payload
    else:
        steps = rows - 1 if merge == "ring" else 4
        assert r["coll_breakdown"] == {"collective-permute": steps * payload}
        assert r["sent_bytes"] == steps * payload == r["coll_bytes"]
    assert dict(_build.LAUNCHES) == before


def test_cli_writes_the_ann_cell(tmp_path):
    out = tmp_path / "cells.json"
    dr.main(["--ann", "--merge", "tree", "--device", "cpu", "--json", str(out)])
    (cell,) = json.loads(out.read_text())
    assert cell["status"] == "ok"
    assert cell["arch"] == "mp-rw-lsh-index(n=134217728,m=128,merge=tree,dt=int32)"
    assert cell["coll_breakdown"] == {"collective-permute": cell["sent_bytes"]}


def test_dry_run_refuses_a_live_group():
    import torch.distributed as dist
    with dr.fake_world(2):
        with pytest.raises(RuntimeError, match="initialized already"):
            dr.lower_cell("smollm_360m", "decode_32k",
                          cfg_override=configs.get_reduced("smollm_360m"), device="cpu")
    assert not dist.is_initialized()
