"""Tiny cells for the benchmark's CPU tests: the harness's paths at sizes a
test run holds, on the port's plain versions."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.harness import spec  # noqa: E402

CONFIG = {
    "name": "tiny",
    "data": {"n": 6000, "dim": 16, "universe": 64, "num_queries": 300, "num_clusters": 8,
             "cluster_spread": 0.03, "perturb_frac": 0.02, "stray_frac": 0.1},
    "index": {"family": "rw", "hash_impl": "pallas", "dataset_dtype": "int32",
              "num_tables": 4, "num_hashes": 6, "width": 16, "num_probes": 20,
              "candidate_cap": 8, "universe": 64, "k": 10},
}
TRAFFIC = {"kind": "closed_loop", "warm_requests": 1,
           "serve": {"batch_size": 64, "bucket_min": 64}}
E2E = [{"name": "qps", "unit": "queries/s"}, {"name": "p95_ms", "unit": "ms"},
       {"name": "peak_gib", "unit": "GiB"}, {"name": "setup_s", "unit": "s"}]
PER_LAYER = [{"name": n, "unit": "x"} for n in
             ("idle_share.bulk", "rerank_roofline.bulk", "gather_roofline.bulk",
              "phase_b_ms.bulk", "phase_a_ms.online", "launches_per_batch.online",
              "p95_ms.online")]


def cell(config=None, traffic=None, root=ROOT) -> spec.Cell:
    return spec.Cell("tiny.cell", 1, copy.deepcopy(config or CONFIG),
                     copy.deepcopy(traffic or TRAFFIC), E2E, PER_LAYER, Path(root))


def run(c=None, seed: int = 2 ** 31 + 5, seconds: float = 0.3, trace: bool = False,
        lines=None) -> dict:
    from portbench.harness import cell as cell_run
    log = (lambda m: lines.append(m)) if lines is not None else (lambda m: None)
    return cell_run.run(c or cell(), seed, seconds, trace, "cpu", time.perf_counter(), log)



def sharded_cell(shards: int = 4) -> spec.Cell:
    """The tiny cell on ``shards`` ranks: its configuration declares as many
    row shards."""
    config = copy.deepcopy(CONFIG)
    config["index"]["row_shards"] = shards
    return spec.Cell(f"tiny.dist{shards}", shards, config, copy.deepcopy(TRAFFIC), E2E,
                     PER_LAYER, ROOT)


def run_sharded(c=None, seed: int = 2 ** 31 + 7, seconds: float = 0.3, trace: bool = False,
                lines=None, limit_s: float = 150.0, fault=None) -> dict:
    """A run of a sharded tiny cell, one gloo rank a shard on the CPU."""
    from portbench.harness import cell as cell_run
    log = (lambda m: lines.append(m)) if lines is not None else (lambda m: None)
    return cell_run.run_sharded(c or sharded_cell(), seed, seconds, trace, "gloo", "cpu",
                                time.perf_counter(), log, {"jax", "jaxlib", "flax", "repro"},
                                limit_s=limit_s, fault=fault)


def _rerank_ids(change, rank: int, broken: int) -> None:
    """On rank ``broken``, pass each shard-local rerank's ids through
    ``change(ids, calls)`` (``calls`` counts the reranks so far)."""
    if rank != broken:
        return
    from repro_torch.core import pipeline as pipe
    real, calls = pipe.stage_rerank, [0]

    def rerank(cfg, dataset, queries, ids, impl=None):
        d, i = real(cfg, dataset, queries, ids, impl)
        calls[0] += 1
        return d, change(i, calls[0])

    pipe.stage_rerank = rerank


def _shifted(i, calls):
    import torch
    return torch.where(i >= 0, i + 1, i)


def _raises_second(i, calls):
    if calls >= 2:
        raise RuntimeError("the card went away")
    return i


def shift_ids(rank: int, broken: int = 1) -> None:
    """A fault for ``run_sharded``: rank ``broken``'s own top-k ids shifted
    by one where they are produced, before the ranks exchange them."""
    _rerank_ids(_shifted, rank, broken)


def raise_on_second_request(rank: int, broken: int = 2) -> None:
    """A fault for ``run_sharded``: rank ``broken`` raises in its second
    request, while its peers wait in that request's exchange."""
    _rerank_ids(_raises_second, rank, broken)


def _own_list_only(self, t):
    return t[None].expand(self.mesh.num_row_shards, *t.shape).contiguous()


def leave_out_exchange(rank: int) -> None:
    """A fault for ``run_sharded``: every rank's all-gather of the per-shard
    top-k lists left out, each rank folding its own list in every shard's
    place."""
    from repro_torch.launch import dist_index
    dist_index.Exchange.all_gather = _own_list_only
