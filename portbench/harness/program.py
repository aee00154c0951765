"""The system under test: ``repro_torch``'s serving engine, built from a
configuration's ``index`` block, a traffic mix's ``serve`` block and the
benchmark's inputs.  This module and ``profiling``'s kernel names are all the
benchmark takes from the program; the reference imports neither.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["KERNELS", "SOMETIMES", "kernels_of", "build_engine", "launches"]

# The port's kernel entry points (``kernels._build.LAUNCHES`` keys) and the
# device kernels each launch records under in a profiler trace: one entry
# point call launches one of its ``KERNELS`` once, which the profiler guard
# counts; the ``SOMETIMES`` kernels run on some calls only (``fused_rerank``'s
# slice merge, when a query is split over several blocks) and are not
# counted.
KERNELS = {
    "fused_probe_extents": ("extents_kernel",),
    "fused_probe_gather": ("gather_kernel",),
    "fused_rerank": ("rerank_slice_kernel",),
    "rw_hash": ("rw_hash_kernel",),
    "rw_prefix_table": ("rw_table_kernel",),
    "topk_merge": ("topk_merge_reg_kernel", "topk_merge_smem_kernel"),
}
SOMETIMES = {
    "fused_rerank": ("merge_slices_kernel",),
}


def kernels_of(entry: str) -> tuple:
    """Every device kernel an entry point's launch may record."""
    return KERNELS[entry] + SOMETIMES.get(entry, ())


def build_engine(config: Dict, traffic: Dict, inputs: Dict, device):
    """``AnnServingEngine`` over the inputs' points, its hash parameters the
    benchmark's (through ``params_fn``); construction warms the traffic's
    batch shape at every rung of the candidate ladder."""
    from repro_torch.core.hashes import LshParams
    from repro_torch.core.index import IndexConfig
    from repro_torch.core.walks import WalkTable, prefix_from_pairs
    from repro_torch.serve.engine import AnnServingEngine, ServeConfig

    cfg = IndexConfig(**config["index"])
    p = inputs["params"]

    def params_fn(index_cfg, dim):
        if dim != inputs["points"].shape[1] or index_cfg != cfg:
            raise ValueError("the engine asked for parameters of another configuration")
        walks = WalkTable(pairs=p["pairs"], prefix=prefix_from_pairs(p["pairs"]))
        return LshParams("rw", float(cfg.width), p["offsets"], p["mix_a"], p["mix_c"],
                         walks=walks)

    return AnnServingEngine(cfg, ServeConfig(**traffic["serve"]), inputs["points"],
                            device=device, params_fn=params_fn)


def launches() -> Dict[str, int]:
    """A copy of the port's launch counters."""
    from repro_torch.kernels import _build
    with _build._LOCK:
        return dict(_build.LAUNCHES)

