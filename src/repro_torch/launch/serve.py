"""ANN serving launcher of the port: serve a synthetic index with batched
requests and print a JSON summary (the counterpart of
``python -m repro.launch.serve``, with the same flags plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 4000 --dim 32 --queries 48 --batch 16 --probes 60
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.core.baselines import brute_force_l1, recall
from repro_torch.core.index import IndexConfig
from repro_torch.data import ann_synthetic as ds
from repro_torch.serve.engine import AnnServingEngine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--tables", type=int, default=8)
    ap.add_argument("--width", type=int, default=56)
    ap.add_argument("--probes", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--target-recall", type=float, default=None,
                    help="recall autotuning is not ported yet; must be unset")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card ('cuda')")
    args = ap.parse_args(argv)
    if args.target_recall is not None:
        ap.error("--target-recall: the recall autotuner is not ported yet")
    device = resolve_device(args.device)

    spec = ds.DatasetSpec("serve", n=args.n, dim=args.dim, universe=128,
                          num_clusters=32)
    data = ds.make_dataset(spec)
    queries = ds.make_queries(spec, data, args.queries)

    cfg = IndexConfig(num_tables=args.tables, num_hashes=12, width=args.width,
                      num_probes=args.probes, candidate_cap=128,
                      universe=spec.universe, k=args.k, rerank_chunk=1024)
    engine = AnnServingEngine(cfg, ServeConfig(batch_size=args.batch), data,
                              device=device)
    engine.submit(queries)
    _, i = engine.drain()

    _, ti = brute_force_l1(torch.from_numpy(data).to(device),
                           torch.from_numpy(queries).to(device), args.k)
    r = recall(i, ti.cpu().numpy())
    print(json.dumps({"recall": round(r, 4), **engine.summary()}, indent=1))


if __name__ == "__main__":
    main()
