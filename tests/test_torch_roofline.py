"""The port's roofline tooling (``repro_torch.launch.roofline``) against the
JAX package's: ``model_flops`` for every arch, the terms and bottleneck under
the H100 constants, and ``collective_bytes`` of a fake-world trace of each
collective kind against the hand count (as ``HLO_SAMPLE`` holds the
reference's parser in tests/test_roofline_tools.py)."""
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch import roofline as jrl
from repro_torch import configs
from repro_torch.launch import dryrun as dr
from repro_torch.launch import roofline as rl


@pytest.mark.parametrize("kind", ["train", "fwd"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_model_flops_equal_the_reference(arch, kind):
    for tokens in (1, 4096 * 256, 524288):
        want = jrl.model_flops(jconfigs.get_config(arch), tokens, kind)
        assert rl.model_flops(configs.get_config(arch), tokens, kind) == want
        want = jrl.model_flops(jconfigs.get_reduced(arch), tokens, kind)
        assert rl.model_flops(configs.get_reduced(arch), tokens, kind) == want


def test_h100_constants():
    assert rl.PEAK_FLOPS == 989e12       # dense bf16, not the 1,979e12 sparse figure
    assert rl.HBM_BW == 3.35e12
    assert rl.LINK_BW == 450e9           # one direction of NVLink 4's 900 GB/s


def test_roofline_terms_and_bottleneck():
    r = rl.Roofline(flops=989e12, bytes_accessed=3.35e12 * 2,
                    coll_bytes=450e9 * 0.5, coll_breakdown={"all-gather": 1, "all-reduce": 0},
                    peak_bytes_device=1e9)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(0.5)
    assert r.bottleneck == "memory"
    s = r.summary()
    assert set(s) == set(jrl.Roofline(1, 1, 1, {}, 1).summary())
    assert s["coll_breakdown"] == {"all-gather": 1}
    r.coll_bytes = 450e9 * 3
    assert r.bottleneck == "collective"


def test_model_flops_moe_counts_active_only():
    dense = configs.get_config("gemma_2b")
    moe = configs.get_config("llama4_maverick_400b_a17b")
    assert rl.model_flops(dense, 1000, "train") == pytest.approx(
        6.0 * dense.param_count() * 1000)
    active = rl.model_flops(moe, 1000, "train") / (6.0 * 1000)
    assert 8e9 < active < 30e9


def _traced(world, fn):
    """``fn(group)`` on rank 0 of a fake world of ``world`` ranks, under
    fake tensors and a ``dryrun.Trace``."""
    with dr.fake_world(world), FakeTensorMode() as mode:
        trace = dr.Trace(mode)
        with trace:
            fn(dist.group.WORLD)
    return trace


def test_collective_bytes_of_a_trace_equal_the_hand_count():
    def step(group):
        a = torch.empty(16, 1024, 512, dtype=torch.bfloat16)
        funcol.all_gather_tensor(a, 0, group)                      # (64, 1024, 512) bf16
        b = torch.empty(256, 128)
        funcol.all_reduce(b, "sum", group)                         # (256, 128) f32
        c = torch.empty(8, 64)
        funcol.reduce_scatter_tensor(c, "sum", 0, group)           # (2, 64) f32
        d = torch.empty(4, 8, dtype=torch.int32)
        funcol.all_to_all_single(d, None, None, group)             # (4, 8) s32
        e = torch.empty(3, 5, dtype=torch.int8)                    # eager, the ANN path's
        dist.all_gather([torch.empty_like(e) for _ in range(4)], e, group=group)
        dist.all_reduce(torch.empty(7), group=group)
        f, g = torch.empty(6, dtype=torch.int64), torch.empty(6, dtype=torch.int64)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, f, 1, group),
                                           dist.P2POp(dist.irecv, g, 3, group)]):
            req.wait()

    trace = _traced(4, step)
    out = rl.collective_bytes(trace.collectives)
    assert out["all-gather"] == 64 * 1024 * 512 * 2 + 4 * 3 * 5
    assert out["all-reduce"] == 256 * 128 * 4 + 7 * 4
    assert out["reduce-scatter"] == 2 * 64 * 4
    assert out["all-to-all"] == 4 * 8 * 4
    assert out["collective-permute"] == 6 * 8          # the receive, once
    roof = rl.analyze(trace)
    assert roof.coll_bytes == sum(out.values())
    assert roof.flops == 0 and roof.peak_bytes_device > 0


def test_trace_counts_flops_bytes_and_peak():
    def step(group):
        x = torch.empty(64, 32)
        w = torch.empty(32, 48)
        y = x @ w                                   # 2*64*32*48 flops
        z = y.t()                                   # a view: no bytes
        del z
        (y + 1.0).sum()

    trace = _traced(1, step)
    assert trace.flops == 2 * 64 * 32 * 48
    # mm reads x and w, writes y; add reads y, writes y+1; sum reads y+1, writes 4 bytes
    mm = (64 * 32 + 32 * 48 + 64 * 48) * 4
    assert trace.bytes == mm + 2 * 64 * 48 * 4 + 64 * 48 * 4 + 4
    assert trace.peak_bytes >= 2 * 64 * 48 * 4


def test_unknown_collective_is_refused():
    with pytest.raises(ValueError, match="no kind"):
        rl.collective_bytes([("c10d.broadcast_", 4)])
