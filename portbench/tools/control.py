"""The control of a cell's ``correct``: the plain reference put in the
program's place with its bucket quantisation, (f + b) / W and the offsets,
computed in bfloat16 instead of the configuration's float32.  For each seed
the cell's inputs are made, the control answers the queries of the requests
``check.draw`` picks from ``--requests`` requests of the cell's traffic,
and the harness's own check holds them against the float32 reference.
Prints one JSON line a seed with the numbers compared; the control has to
fail one of them on every seed.

    python3 portbench/tools/control.py --workload sift50m.bulk1024 --seeds 11 12 13
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench.harness import check, datagen, spec  # noqa: E402
from portbench.reference import lsh as ref  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def control_checks(cell: spec.Cell, seed: int, requests: int, device) -> dict:
    ix = cell.config["index"]
    inputs = datagen.make_inputs(cell.config, seed, device)
    points, queries = inputs["points"], inputs["queries"]
    params = ref.as_params(ix["width"], inputs["params"])
    cap, k, probes = int(ix["candidate_cap"]), int(ix["k"]), int(ix["num_probes"])
    lp = spec.loop(cell.root, cell.traffic["kind"])
    stream = lp.Requests(queries.cpu().numpy(), cell.traffic)
    drawn = check.draw([lp.Request(r) for r in range(requests)], stream.size, seed)
    rows = {req.index: queries[torch.from_numpy(stream.rows(req.index)).to(points.device)]
            for req in drawn}
    low = ref.build(params, points, probes, quant_dtype=CONTROL_DTYPE)
    for req in drawn:
        d, i = ref.answer(params, low, points, rows[req.index], cap, k,
                          quant_dtype=CONTROL_DTYPE)
        req.dists, req.ids = d.cpu().numpy(), i.cpu().numpy()
    del low
    tables = ref.build(params, points, probes)

    def answer(req):
        d, i = ref.answer(params, tables, points, rows[req.index], cap, k)
        return d.cpu().numpy(), i.cpu().numpy()

    checks = check.judge(drawn, answer)
    return {"workload": cell.name, "seed": seed, "control": str(CONTROL_DTYPE),
            "correct": check.correct(checks), "checks": checks}


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
