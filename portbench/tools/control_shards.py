"""The control of a sharded cell's ``correct``, shard by shard on one card:
``tools/control.py``'s control (the plain reference with its bucket
quantisation, (f + b) / W and the offsets, in bfloat16 instead of the
configuration's float32) for a configuration that declares ``"row_shards":
R``, whose points and two sets of reference tables do not fit one card.

For each seed, the queries of the requests ``check.draw`` picks from
``--requests`` requests of the cell's traffic are answered over each shard
in turn (``datagen.make_shard_inputs``): once by the bfloat16 control and
once by the float32 reference, each with the shard's first row added to its
ids, the shard then freed.  The R lists of each are merged as the cell's
check merges them (``reference.lsh.merge``), and the harness's own check
holds the control's merged answers against the reference's.  Prints one
JSON line a seed with the numbers compared; the control has to fail one of
them on every seed.

    python3 portbench/tools/control_shards.py --workload bigann100m.dist4 --seeds 11 12 13
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench.harness import check, datagen, program, spec  # noqa: E402
from portbench.reference import lsh as ref  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def _answers(params, tables, points, rows, cap, k, first_row, quant_dtype):
    """Each drawn request's (dists, ids) over one shard, ids global, on the host."""
    out = {}
    for index, queries in rows.items():
        d, i = ref.answer(params, tables, points, queries, cap, k, quant_dtype=quant_dtype)
        out[index] = (d.cpu(), torch.where(i >= 0, i + int(first_row), -1).cpu())
    return out


def control_checks(cell: spec.Cell, seed: int, requests: int, device) -> dict:
    ix = cell.config["index"]
    cap, k, probes = int(ix["candidate_cap"]), int(ix["k"]), int(ix["num_probes"])
    shards = program.row_shards(cell.config)
    lp = spec.loop(cell.root, cell.traffic["kind"])
    drawn, control, reference = None, [], []
    for shard in range(shards):
        inputs = datagen.make_shard_inputs(cell.config, seed, device, shard, shards)
        points, queries = inputs["points"], inputs["queries"]
        params = ref.as_params(ix["width"], inputs["params"])
        if drawn is None:
            stream = lp.Requests(queries.cpu().numpy(), cell.traffic)
            drawn = check.draw([lp.Request(r) for r in range(requests)], stream.size, seed)
        rows = {req.index: queries[torch.from_numpy(stream.rows(req.index)).to(points.device)]
                for req in drawn}
        for quant, out in ((CONTROL_DTYPE, control), (torch.float32, reference)):
            tables = ref.build(params, points, probes, quant_dtype=quant)
            out.append(_answers(params, tables, points, rows, cap, k, inputs["first_row"],
                                quant))
            del tables
        del inputs, points, queries, rows
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    for req in drawn:
        d, i = ref.merge([shard[req.index] for shard in control], k)
        req.dists, req.ids = d.numpy(), i.numpy()
    merged = {req.index: tuple(x.numpy() for x in
                               ref.merge([shard[req.index] for shard in reference], k))
              for req in drawn}
    checks = check.judge(drawn, lambda req: merged[req.index])
    return {"workload": cell.name, "seed": seed, "control": str(CONTROL_DTYPE),
            "shards": shards, "correct": check.correct(checks), "checks": checks}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = spec.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        out = control_checks(cell, seed, args.requests, args.device)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
