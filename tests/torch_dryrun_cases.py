"""Checks shared by ``tests/test_torch_dryrun*.py`` (several files, so that
each stays short under ``--dist loadfile``)."""
import pytest

from repro_torch import configs
from repro_torch.launch import dryrun as dr

SSM_ARCHS = ("zamba2_1_2b", "mamba2_370m")


def check_reduced_cell(arch, shape):
    """``lower_cell`` of the reduced config on the (16, 16) world: skipped
    where the reference skips it, else ``ok`` with every count present."""
    cfg = configs.get_reduced(arch)
    r = dr.lower_cell(arch, shape, cfg_override=cfg, device="cpu")
    if not dr.cell_supported(cfg, shape):
        assert r["status"] == "skipped"
        return
    assert r["status"] == "ok" and r["mesh"] == "16x16"
    assert r["flops"] > 0 and r["bytes"] > 0 and r["coll_bytes"] > 0
    assert r["peak_bytes_device"] > 0 and 0 < r["useful_flops_frac"] <= 1.05
    assert r["bottleneck"] in ("compute", "memory", "collective")
    info = dr.SHAPES[shape]
    tokens = info["batch"] * (1 if info["step"] == "decode" else info["seq"])
    kind = "train" if info["step"] == "train" else "fwd"
    assert r["model_flops_device"] * 256 == pytest.approx(dr.rl.model_flops(cfg, tokens, kind))
