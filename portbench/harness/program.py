"""The system under test: ``repro_torch``'s serving engine, built from a
configuration's ``index`` block, a traffic mix's ``serve`` block and the
benchmark's inputs; or, for a configuration whose ``index`` block declares
``"row_shards": R``, its distributed index (``launch.dist_index``), one rank
a card.  This module and ``profiling``'s kernel names are all the benchmark
takes from the program; the reference imports neither.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["KERNELS", "SOMETIMES", "SHARDING", "kernels_of", "row_shards", "build_engine",
           "build_sharded", "launches"]

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


# Keys of a configuration's ``index`` block that say how the index is split
# over ranks, not how each shard is built: ``row_shards`` (R, one rank and
# one card a shard) and ``merge`` (the fold of the per-shard top-k lists,
# ``'allgather'`` unless ``'ring'`` or ``'tree'`` is named).
SHARDING = ("row_shards", "merge")


def row_shards(config: Dict) -> int:
    """The row shards a configuration declares (1 when it declares none)."""
    return int(config["index"].get("row_shards", 1))


def _lsh_params(config: Dict, p: Dict):
    """The port's hash parameters from the benchmark's tensors."""
    from repro_torch.core.hashes import LshParams
    from repro_torch.core.walks import WalkTable, prefix_from_pairs
    walks = WalkTable(pairs=p["pairs"], prefix=prefix_from_pairs(p["pairs"]))
    return LshParams("rw", float(config["index"]["width"]), p["offsets"], p["mix_a"],
                     p["mix_c"], walks=walks)


def kernels_of(entry: str) -> tuple:
    """Every device kernel an entry point's launch may record."""
    return KERNELS[entry] + SOMETIMES.get(entry, ())


def build_engine(config: Dict, traffic: Dict, inputs: Dict, device):
    """``AnnServingEngine`` over the inputs' points, its hash parameters the
    benchmark's (through ``params_fn``); construction warms the traffic's
    batch shape at every rung of the candidate ladder."""
    from repro_torch.core.index import IndexConfig
    from repro_torch.serve.engine import AnnServingEngine, ServeConfig

    cfg = IndexConfig(**config["index"])

    def params_fn(index_cfg, dim):
        if dim != inputs["points"].shape[1] or index_cfg != cfg:
            raise ValueError("the engine asked for parameters of another configuration")
        return _lsh_params(config, inputs["params"])

    return AnnServingEngine(cfg, ServeConfig(**traffic["serve"]), inputs["points"],
                            device=device, params_fn=params_fn)


class _ShardRows:
    """The global (n, m) point set as ``dist_build_fn`` takes it, holding
    only this rank's rows: indexing it by the shard's own slice gives them."""

    def __init__(self, rows, n: int, first_row: int):
        self.rows, self.first_row = rows, first_row
        self.shape = (n, rows.shape[1])

    def __getitem__(self, sl: slice):
        if (sl.start, sl.stop) != (self.first_row, self.first_row + self.rows.shape[0]):
            raise IndexError(f"rows {sl.start}:{sl.stop} asked of the shard of rows "
                             f"{self.first_row}:{self.first_row + self.rows.shape[0]}")
        return self.rows


def build_sharded(config: Dict, inputs: Dict, device):
    """The distributed index over an (R, 1) ``('data', 'model')`` mesh of the
    default process group (one rank a row shard, ``make_mesh``), built by
    ``dist_build_fn`` over this rank's rows (``datagen.make_shard_inputs``)
    -> ``serve(queries) -> (dists, ids)``, host arrays of the whole batch's
    global top-k: ``dist_query_fn``'s call, which every rank makes for every
    request."""
    from repro_torch.core.index import IndexConfig
    from repro_torch.launch import dist_index as di

    ix = config["index"]
    cfg = IndexConfig(**{k: v for k, v in ix.items() if k not in SHARDING})
    mesh = di.make_mesh((row_shards(config), 1), ("data", "model"), device)
    n = int(config["data"]["n"])
    rows = _ShardRows(inputs["points"], n, int(inputs["first_row"]))
    state = di.dist_build_fn(cfg, mesh)(rows, _lsh_params(config, inputs["params"]))
    query = di.dist_query_fn(cfg, mesh, ix.get("merge", "allgather"))

    def serve(queries):
        d, i = query(state, queries)
        return d.cpu().numpy(), i.cpu().numpy()

    return serve


def launches() -> Dict[str, int]:
    """A copy of the port's launch counters."""
    from repro_torch.kernels import _build
    with _build._LOCK:
        return dict(_build.LAUNCHES)

