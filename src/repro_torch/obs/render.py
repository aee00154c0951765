"""Span JSONL → Chrome trace-event JSON, plus the CI validation checks.

``load_spans`` reads every ``spans-*.jsonl`` a traced run left in a
directory; ``to_chrome`` turns them into the Chrome trace-event format
(``chrome://tracing`` / Perfetto): each process label becomes a numbered
``pid`` with a ``process_name`` metadata event, spans become ``ph: "X"``
complete events and instants become ``ph: "i"``, all stamped with their
trace/span/parent ids in ``args`` so a hedged 2-worker query reads as one
connected tree across the router and both workers.

``check_spans`` is the CI gate (DESIGN.md §12): schema per record, at
least one **cross-process parent/child pair** sharing a trace id
(router-side parent span, worker-side child), and — for the hedge drill —
a primary/reissue ``replica_query`` pair on one trace plus the
``hedge_win`` instant marking the winner.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = ["load_spans", "to_chrome", "check_spans"]

_REQUIRED = ("ph", "name", "tid", "sid", "ts", "dur", "proc", "thread",
             "args")


def load_spans(trace_dir: str) -> List[dict]:
    """Every record from every ``spans-*.jsonl`` under ``trace_dir``."""
    recs: List[dict] = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "spans-*.jsonl"))):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    recs.append(json.loads(line))
    return recs


def to_chrome(spans: List[dict]) -> dict:
    """Chrome trace-event JSON ({"traceEvents": […]}) from span records."""
    procs = sorted({r.get("proc", "?") for r in spans})
    pid_of = {p: i + 1 for i, p in enumerate(procs)}
    events: List[dict] = []
    for p in procs:
        events.append({"ph": "M", "name": "process_name", "pid": pid_of[p],
                       "tid": 0, "args": {"name": p}})
    for r in sorted(spans, key=lambda r: r.get("ts", 0)):
        ev = {"name": r["name"], "ph": r["ph"], "pid": pid_of[r["proc"]],
              "tid": r["thread"], "ts": r["ts"],
              "args": {"trace_id": r["tid"], "span_id": r["sid"],
                       "parent_span_id": r["psid"], **r.get("args", {})}}
        if r["ph"] == "X":
            ev["dur"] = r["dur"]
        else:
            ev["s"] = "t"           # instant events: thread-scoped
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _schema_errors(spans: List[dict]) -> List[str]:
    errors = []
    for n, r in enumerate(spans):
        missing = [k for k in _REQUIRED if k not in r]
        if missing:
            errors.append(f"record {n}: missing keys {missing}")
            continue
        if r["ph"] not in ("X", "i"):
            errors.append(f"record {n}: bad ph {r['ph']!r}")
        if not isinstance(r["tid"], str) or not r["tid"]:
            errors.append(f"record {n}: trace id must be a non-empty str")
        if not isinstance(r["sid"], int):
            errors.append(f"record {n}: span id must be an int")
        if not isinstance(r["ts"], int) or not isinstance(r["dur"], int):
            errors.append(f"record {n}: ts/dur must be int microseconds")
        if not isinstance(r["args"], dict):
            errors.append(f"record {n}: args must be a dict")
        if len(errors) >= 10:
            errors.append("…")
            break
    return errors


def _cross_process_pairs(spans: List[dict]) -> List[Tuple[dict, dict]]:
    """(parent, child) span pairs that share a trace id but not a process."""
    by_sid: Dict[Tuple[str, int], dict] = {
        (r["tid"], r["sid"]): r for r in spans}
    pairs = []
    for r in spans:
        psid = r.get("psid")
        if psid is None:
            continue
        parent = by_sid.get((r["tid"], psid))
        if parent is not None and parent["proc"] != r["proc"]:
            pairs.append((parent, r))
    return pairs


def _hedge_evidence(spans: List[dict]) -> Optional[dict]:
    """One trace showing both hedge racers and the winner mark, or None."""
    by_trace: Dict[str, Dict[str, List[dict]]] = {}
    for r in spans:
        if r["name"] == "replica_query":
            role = r.get("args", {}).get("hedge")
            by_trace.setdefault(r["tid"], {}).setdefault(role, []).append(r)
    wins = {r["tid"] for r in spans if r["name"] == "hedge_win"}
    for tid, roles in by_trace.items():
        if "primary" in roles and "reissue" in roles and tid in wins:
            return {"trace_id": tid,
                    "primary": roles["primary"][0]["args"],
                    "reissue": roles["reissue"][0]["args"]}
    return None


def check_spans(spans: List[dict], require_cross_process: bool = False,
                require_hedge: bool = False) -> dict:
    """Validation report; ``ok`` is False with reasons on any failure."""
    report: dict = {"records": len(spans), "ok": True, "errors": []}
    if not spans:
        report["ok"] = False
        report["errors"].append("no span records found")
        return report
    schema = _schema_errors(spans)
    if schema:
        report["ok"] = False
        report["errors"].extend(schema)
    # structural checks run over the well-formed records only: a single
    # torn JSONL line must degrade to a schema error, not a crash
    spans = [r for r in spans if all(k in r for k in _REQUIRED)]
    report["processes"] = sorted({r.get("proc", "?") for r in spans})
    report["traces"] = len({r.get("tid") for r in spans})
    pairs = _cross_process_pairs(spans)
    report["cross_process_pairs"] = len(pairs)
    if pairs:
        parent, child = pairs[0]
        report["cross_process_example"] = {
            "trace_id": parent["tid"],
            "parent": {"proc": parent["proc"], "name": parent["name"]},
            "child": {"proc": child["proc"], "name": child["name"]}}
    if require_cross_process and not pairs:
        report["ok"] = False
        report["errors"].append(
            "no cross-process parent/child span pair shares a trace id")
    hedge = _hedge_evidence(spans)
    report["hedge"] = hedge
    if require_hedge and hedge is None:
        report["ok"] = False
        report["errors"].append(
            "no trace shows a primary+reissue replica_query pair with a "
            "hedge_win mark")
    return report
