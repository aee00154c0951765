"""A cell's traced run with its stage attribution held against the
profiler's own links, and the rerank's slot fill.

    python3 portbench/tools/stage_links.py --workload sift50m.bulk1024 --seed 7 --seconds 20

Runs the cell's traced run (``harness.cell.run``, trace on, on the card)
with three functions of the harness wrapped in this process alone: the
profiler's events are read a second time with their correlation ids, the
launch counters are read with ``SLOTS`` beside them, and the metric readers
hand over the run.  For the kept window it prints one JSON line with:

* ``agree``: the share of device time whose stack (``harness/stages.py``,
  by launch order, what the readers use) equals the stack by the
  profiler's link: a device record's correlation id names the host launch
  call that shares it (``by_call``), and its linked correlation id the
  operation or range around that call (``by_op``);
* ``device_ms`` and ``idle_ms``: ms a batch by innermost stage;
* ``ops``: the ten device ops with the most time, split by stage, in ms a
  batch;
* ``slot_fill``: the reference's valid slots of the window's batches over
  ``SLOTS["fused_rerank"]`` in the window, in percent;
* ``repro_device_records`` (must be 0) and ``repro_user_annotations``
  (must be 0);

then the result line of the run.  ``--out`` writes the JSON line to a file
as well.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench.harness import cell as cell_run  # noqa: E402
from portbench.harness import profiling, program, spec, stages  # noqa: E402


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class _Taps:
    """The wrapped harness functions' catch."""

    def __init__(self):
        self.windows = []         # (records list, raw events) a profiled window
        self.slots = []           # SLOTS at each read of the launch counters
        self.run = None

    def install(self):
        from repro_torch.kernels import _build
        read, launches, reader = (profiling.records_from_profiler, program.launches,
                                  spec.reader)

        def records(prof):
            out = read(prof)
            raw = [(e.name(), str(e.device_type()).endswith("CUDA"), e.start_ns() / 1e3,
                    e.duration_ns() / 1e3, e.correlation_id(), e.linked_correlation_id(),
                    bool(e.is_user_annotation()), e.device_resource_id())
                   for e in prof.profiler.kineto_results.events()]
            self.windows.append((out, raw))
            return out

        def counted():
            with _build._LOCK:
                self.slots.append(dict(_build.SLOTS))
            return launches()

        def wrapped_reader(root, name):
            fn = reader(root, name)

            def read_metric(run):
                self.run = run
                return fn(run)
            return read_metric

        profiling.records_from_profiler = records
        program.launches = counted
        spec.reader = wrapped_reader


def _by_link(st: stages.Stages, raw) -> dict:
    """Each device record's stack by the profiler's links, both ways."""
    host = [e for e in raw if not e[1]]
    calls = {e[4]: e for e in host if e[0].startswith(stages.LAUNCH_CALLS)}
    ops = {}
    for e in host:
        if not e[0].startswith(stages.LAUNCH_CALLS) and not e[0].startswith("cuda"):
            ops.setdefault(e[4], e)
    device = sorted((e for e in raw if e[1] and not e[0].startswith(profiling.ANNOTATION_PREFIX)),
                    key=lambda e: e[2])
    out = {}
    for how, table, key in (("by_call", calls, 4), ("by_op", ops, 5)):
        starts = [table[e[key]][2] if e[key] in table else float("nan") for e in device]
        found = [s == s for s in starts]
        stacks = stages._stacks(st.ranges, [s if s == s else -1.0 for s in starts])
        stacks = [s if ok else () for s, ok in zip(stacks, found)]
        total = agree = 0.0
        for rec, mine, theirs in zip(st.device, st.stacks, stacks):
            us = rec.end_us - rec.start_us
            total += us
            agree += us if mine == theirs else 0.0
        out[how] = {"linked": sum(found), "of": len(device),
                    "agree": 100.0 * agree / total if total else None}
    return out


def _owner_of_ops(st: stages.Stages, n: int = 10) -> list:
    """The ``n`` device ops with the most time, split by the innermost
    stage that launched them: (op, stage, us), longest first."""
    by = {}
    for r, s in zip(st.device, st.stacks):
        key = (profiling.short_name(r.name), s[-1] if s else stages.UNATTRIBUTED)
        by[key] = by.get(key, 0.0) + r.end_us - r.start_us
    ops = {}
    for (op, _), us in by.items():
        ops[op] = ops.get(op, 0.0) + us
    top = sorted(ops, key=lambda op: -ops[op])[:n]
    return sorted(((op, stage, us) for (op, stage), us in by.items() if op in top),
                  key=lambda x: (-ops[x[0]], -x[2]))


def _count(names) -> dict:
    out = {}
    for n in names:
        out[n] = out.get(n, 0) + 1
    return out


def inspect(cell: spec.Cell, seed: int, seconds: float, device: str = "cuda") -> tuple:
    """The cell's traced run with the taps in -> (stage line, result)."""
    taps = _Taps()
    taps.install()
    result = cell_run.run(cell, seed, seconds, True, device, T_START, _log)
    run = taps.run
    w = run.profile
    kept = next(i for i, (recs, _) in enumerate(taps.windows) if recs is w.records)
    raw = taps.windows[kept][1]
    st = stages.Stages(w)
    per = 1e3 * w.batches
    valid = sum(c["slots"] for c in run.counts())
    launched = taps.slots[2 * kept + 1]["fused_rerank"] - taps.slots[2 * kept]["fused_rerank"]
    prof_mod = sys.modules.get("torch.autograd.profiler")
    line = {
        "workload": cell.name, "seed": seed, "torch": torch.__version__,
        "card": torch.cuda.get_device_name(0) if device == "cuda" else device,
        "kept_window": kept, "batches": w.batches,
        "profiler_flag": hasattr(prof_mod, "_is_profiler_enabled"),
        "fast_ranges": hasattr(torch._C._profiler, "_RecordFunctionFast"),
        "ranges": len(st.ranges), "launch_calls": st.launch_calls,
        "device_records": len(st.device), "linked_by_order": st.linked,
        "agree": _by_link(st, raw),
        "calls_by_name": _count(e[0] for e in raw if not e[1] and e[0].startswith("cu")),
        "device_by_kind": _count(r.kind for r in st.device),
        "streams": sorted({e[7] for e in raw if e[1]}),
        "repro_device_records": sum(1 for e in raw if e[1] and e[0].startswith(stages.PREFIX)),
        "repro_user_annotations": sum(1 for e in raw if e[6] and e[0].startswith(stages.PREFIX)),
        "device_ms": {k: v / per for k, v in sorted(st.device_by_stage().items(),
                                                    key=lambda kv: -kv[1])},
        "idle_ms": {k: v / per for k, v in sorted(st.idle_by_stage().items(),
                                                  key=lambda kv: -kv[1])},
        "ops": [[op, stage, us / per] for op, stage, us in _owner_of_ops(st)],
        "slots_launched": launched, "slots_valid": valid,
        "slot_fill": 100.0 * valid / launched if launched else None,
        "window_s": w.window_s, "busy_s": w.busy_s,
    }
    return line, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    line, result = inspect(spec.load_cell(ROOT, args.workload), args.seed, args.seconds)
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    result.pop("checks", None)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
