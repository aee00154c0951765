"""The dry-run's counts against a direct count: a reduced cell's FLOPs on a
world of one equal ``FlopCounterMode``'s count of the unsharded step, and on
the (16, 16) world a rank's lie between that count / 256 and the count; a
world whose 'model' axis has one rank exchanges nothing in a forward; and
the SSM archs' decode cells and zamba2's train cell."""
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import Grid

import torch_dryrun_cases as cases


def _direct_flops(cfg, shape):
    """FLOPs of the unsharded step on fake tensors (no DTensor)."""
    with FakeTensorMode():
        spec = dr.input_specs(cfg, shape, Grid((1, 1), ("data", "model")), "cpu")
        with FlopCounterMode(display=False) as counter:
            spec["fn"](*spec["args"])
    return counter.get_total_flops()


@pytest.mark.parametrize("arch,shape", [("smollm_360m", "train_4k"),
                                        ("smollm_360m", "prefill_32k"),
                                        ("smollm_360m", "decode_32k"),
                                        ("granite_moe_3b_a800m", "train_4k"),
                                        ("seamless_m4t_medium", "decode_32k")])
def test_flops_against_the_unsharded_count(arch, shape):
    cfg = configs.get_reduced(arch)
    want = _direct_flops(cfg, shape)
    one = dr.lower_cell(arch, shape, cfg_override=cfg, device="cpu",
                        mesh=Grid((1, 1), ("data", "model")))
    assert one["mesh"] == "1x1" and one["flops"] == want
    assert one["coll_bytes"] == 0
    full = dr.lower_cell(arch, shape, cfg_override=cfg, device="cpu")
    assert want / 256 <= full["flops"] <= want


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_every_leaf_replicated_means_no_collective(shape):
    """A (16, 1) world: 'model' has one rank, so every parameter is whole on
    every rank and the batch splits over 'data'; a forward exchanges
    nothing."""
    cfg = configs.get_reduced("gemma_2b")
    r = dr.lower_cell("gemma_2b", shape, cfg_override=cfg, device="cpu",
                      mesh=Grid((16, 1), ("data", "model")))
    assert r["status"] == "ok" and r["coll_bytes"] == 0 and r["coll_breakdown"] == {}


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", cases.SSM_ARCHS)
def test_reduced_ssm_decode_cell_traces(arch, shape):
    cases.check_reduced_cell(arch, shape)


def test_reduced_hybrid_train_cell_traces():
    cases.check_reduced_cell("zamba2_1_2b", "train_4k")
