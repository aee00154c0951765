"""Work out a configuration's bucket width W once, on the card.

For ``--queries`` of the configuration's queries (``--seed``) the exact 10
nearest points are found by L1 distance.  dbar is the mean distance to the
nearest, and the chip smoke's rule gives W = max(8, int(3 * sqrt(dbar)))
rounded down to even.  For that W, and for each of ``--widths`` and
``--caps`` given, the plain reference answers the queries and one line
prints the recall@10 of its answers against the exact 10 nearest and the
work it asked for: candidate slots a query (sum of min(occupancy, C) over
its probes), the share of probes whose bucket holds C points or more, and
the distinct (query, row) pairs a query.  ``--tables`` and ``--hashes``
try other L and M; ``--clusters`` overrides the configuration's
``num_clusters``.  The chosen W is then written into the
configuration as a fixed number; runs never recompute it.

    python3 portbench/tools/find_width.py portbench/configs/sift50m.json --seed 0 \
        --widths 96 64 --caps 128 256
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

import torch  # noqa: E402

from portbench.harness import datagen  # noqa: E402
from portbench.reference import lsh as ref  # noqa: E402

POINTS_PER_STEP = 1 << 20


def exact_knn(points: torch.Tensor, queries: torch.Tensor, k: int):
    """(dists, ids) of the k nearest points by L1, exact in float32 (every
    distance is an integer below 2^24)."""
    q = queries.to(torch.float32)
    best_d = torch.full((q.shape[0], k), float("inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
    for lo in range(0, points.shape[0], POINTS_PER_STEP):
        d = torch.cdist(q, points[lo:lo + POINTS_PER_STEP].to(torch.float32), p=1)
        i = torch.arange(lo, lo + d.shape[1], device=q.device).expand_as(d)
        cd, ci = torch.cat([best_d, d], 1), torch.cat([best_i, i], 1)
        sel = torch.topk(cd, k, dim=1, largest=False).indices
        best_d, best_i = torch.gather(cd, 1, sel), torch.gather(ci, 1, sel)
    return best_d, best_i


def smoke_width(dbar: float) -> int:
    return max(8, int(3.0 * math.sqrt(dbar))) & ~1


def measure(config, points, queries, gt_i, width: int, cap: int, tables: int,
            hashes: int) -> dict:
    """Recall@10 of the reference's answers at (L, M, W, C), and the work asked."""
    ix = dict(config["index"], width=width, candidate_cap=cap, num_tables=tables,
              num_hashes=hashes)
    params = ref.as_params(width, datagen.make_hash_params(ix, points.shape[1],
                                                           datagen.BASE_SEED, points.device))
    built = ref.build(params, points, int(ix["num_probes"]))
    _, got_i = ref.answer(params, built, points, queries, cap, 10)
    hits = sum(len(set(g.tolist()) & set(e.tolist())) for g, e in zip(got_i.cpu(), gt_i.cpu()))
    _, occ = ref.extents(built, ref.probe_keys(params, built, queries))
    work = ref.work(params, built, queries, cap)
    nq = queries.shape[0]
    return {"tables": tables, "hashes": hashes, "width": width, "cap": cap,
            "recall_at_10": hits / (10 * nq),
            "slots_per_query": work["slots"] / nq, "pairs_per_query": work["pairs"] / nq,
            "probes_at_cap": float((occ >= cap).float().mean()),
            "mean_occupancy": float(occ.float().mean())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--widths", type=int, nargs="*", default=[])
    ap.add_argument("--caps", type=int, nargs="*", default=[])
    ap.add_argument("--tables", type=int, nargs="*", default=[])
    ap.add_argument("--hashes", type=int, nargs="*", default=[])
    ap.add_argument("--clusters", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    config = json.loads(Path(args.config).read_text())
    if args.clusters is not None:
        config["data"] = dict(config["data"], num_clusters=args.clusters)
    t = time.perf_counter()
    inputs = datagen.make_inputs(config, args.seed, args.device)
    points, queries = inputs["points"], inputs["queries"][:args.queries]
    gt_d, gt_i = exact_knn(points, queries, 10)
    dbar = float(gt_d[:, 0].mean())
    rule = smoke_width(dbar)
    head = {"config": config.get("name"), "seed": args.seed,
            "num_clusters": int(config["data"]["num_clusters"]),
            "queries": int(queries.shape[0]), "dbar": dbar, "dbar10": float(gt_d[:, 9].mean()),
            "rule_width": rule}
    ix = config["index"]
    caps = args.caps or [int(ix["candidate_cap"])]
    for tables in args.tables or [int(ix["num_tables"])]:
        for hashes in args.hashes or [int(ix["num_hashes"])]:
            for width in [rule] + [w for w in args.widths if w != rule]:
                for cap in caps:
                    out = dict(head, **measure(config, points, queries, gt_i, width, cap,
                                               tables, hashes))
                    out["seconds"] = time.perf_counter() - t
                    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
