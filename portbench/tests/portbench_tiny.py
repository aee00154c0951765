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

