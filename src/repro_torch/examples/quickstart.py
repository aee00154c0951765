"""Quickstart: build an MP-RW-LSH index, query it, verify against brute force.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.baselines import brute_force_l1, overall_ratio, recall
from repro_torch.core.index import IndexConfig, build_index, query_index
from repro_torch.data import ann_synthetic as ds
from repro_torch.data.normalize import normalize_even
from repro_torch.examples import cli_device

RAW_SHAPE = (5000, 32)
SPEC = ds.DatasetSpec("quickstart", n=20000, dim=64, universe=128,
                      num_clusters=32)
NUM_QUERIES = 64


def main(device=None, params_fn=None):
    device = resolve_device(device)
    # 1. Any real-valued dataset -> nonnegative even ints (paper Sect. 3.2).
    raw = np.random.default_rng(0).normal(size=RAW_SHAPE) * 3.0
    data = normalize_even(raw, target_universe=256)
    print("normalized:", data.shape, data.dtype, "universe<=", data.max())

    # 2. A clustered benchmark dataset + queries with known near neighbors.
    spec = SPEC
    data = ds.make_dataset(spec)
    queries = ds.make_queries(spec, data, NUM_QUERIES)

    # 3. Build: L tables x M random-walk hashes, sorted-key layout.
    cfg = IndexConfig(num_tables=8, num_hashes=12, width=56, num_probes=200,
                      candidate_cap=128, universe=spec.universe, k=10)
    params = None if params_fn is None else params_fn(cfg, spec.dim).to(device)
    points = torch.from_numpy(data).to(device)
    state = build_index(cfg, points, params=params)
    print(f"index: {cfg.num_tables} tables, {cfg.num_hashes} hashes/table, "
          f"T={cfg.num_probes} probes (template, paper refinement 3)")

    # 4. Query (batched) + exact L1 rerank.
    q = torch.from_numpy(queries).to(device)
    d, i = query_index(cfg, state, q)

    # 5. Quality vs exact brute force.
    td, ti = brute_force_l1(points, q, 10)
    d, i, td, ti = (t.cpu().numpy() for t in (d, i, td, ti))
    r, ratio = recall(i, ti), overall_ratio(d, td)
    print("recall@10 :", round(r, 4))
    print("overall ratio:", round(ratio, 4))
    return {"recall": r, "overall_ratio": ratio, "answers": {"query": (d, i)}}


if __name__ == "__main__":
    main(cli_device(__doc__))
