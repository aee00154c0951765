"""One run of one cell.

Set-up: the port's kernels are built or loaded, the inputs are made on the
device from the seed, the engine is built over them (warming the traffic's
batch shape at every rung of its candidate ladder), and ``warm_requests``
requests are served.  ``setup_s`` runs from the process's start to here.

The window: the traffic's loop sends requests for ``seconds``.  Untraced,
nothing else runs.  Traced, the window opens with the program's spans on
(``REPRO_TRACE=1``, which ends each phase with the card synchronised) and
closes with three profiled windows (``PROFILE_WINDOWS`` of up to
``PROFILE_WINDOW_S`` each; the complete one with the most device records
is kept, ``profiling.keep_fullest``).

After the window the peak memory is read, the engine is freed, and the
plain reference builds its own tables to judge a drawn sample of the
answers (``check``) and, traced, to count the work of the kept window's
batches (``workcount``).  Each metric of the cell is then read by its own
reader (``portbench/metrics/<name>.py``).
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from portbench.harness import check, datagen, profiling, program, spec
from portbench.reference import lsh as ref

__all__ = ["RunRecord", "run", "PROFILE_WINDOWS", "PROFILE_WINDOW_S", "MARK"]

PROFILE_WINDOWS = 3
PROFILE_WINDOW_S = 1.0
MARK = profiling.ANNOTATION_PREFIX + "request"


@dataclass
class RunRecord:
    """What a run measured; metric readers take their numbers from it.

    Besides the measurements it holds what a reader needs to count its own
    work: the run's inputs (points, queries, hash parameters), the plain
    reference's parameters and tables, built from those inputs after the
    engine is freed, and the queries of each batch of the kept profiled
    window."""

    cell: spec.Cell
    setup_s: float = 0.0
    requests: List = field(default_factory=list)     # every request of the window
    window_s: float = 0.0                             # first sent .. last answered
    peak_bytes: int = 0
    profile: Optional[profiling.Window] = None       # the kept profiled window
    spans: List[Dict] = field(default_factory=list)  # the program's spans
    inputs: Dict = field(default_factory=dict)       # datagen.make_inputs' tensors
    params: Optional[ref.HashParams] = None          # the reference's view of them
    tables: Optional[ref.Tables] = None              # the reference's own tables
    kept_batches: List[torch.Tensor] = field(default_factory=list)  # queries, kept window
    _counts: Optional[List[Dict]] = None

    @property
    def queries_done(self) -> int:
        return sum(r.dists.shape[0] for r in self.requests if r.error is None)

    @property
    def latencies_ms(self) -> List[float]:
        return [r.ms for r in self.requests if r.error is None]

    def counts(self) -> List[Dict]:
        """``reference.lsh.work`` of each batch of the kept window."""
        if self._counts is None:
            cap = int(self.cell.config["index"]["candidate_cap"])
            self._counts = [ref.work(self.params, self.tables, b, cap)
                            for b in self.kept_batches]
        return self._counts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read_spans(directory: str) -> List[Dict]:
    out = []
    for path in sorted(Path(directory).glob("*.jsonl")):
        with open(path, encoding="utf-8") as f:
            out.extend(json.loads(line) for line in f if line.strip())
    return out


def _profiled(lp, serve, stream, first: int, seconds: float,
              device: torch.device) -> tuple:
    """One profiled window of whole requests -> (requests, Window)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def marked(batch):
        with record_function(MARK):
            return serve(batch)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    before = program.launches()
    with profile(activities=acts) as prof:
        reqs = lp.serve_until(marked, stream, first, time.perf_counter() + seconds)
        _sync(device)
    after = program.launches()
    records = profiling.records_from_profiler(prof)
    del prof
    t0, t1 = profiling.window_bounds(records, MARK)
    return reqs, profiling.Window(
        first_request=first, requests=len(reqs), batches=len(reqs),
        t0_us=t0, t1_us=t1, records=records,
        launched={k: after[k] - before.get(k, 0) for k in after})


def _spans(lp, serve, stream, first: int, deadline: float) -> tuple:
    """Requests served with the program's spans on -> (requests, spans)."""
    from repro_torch.obs import trace as obs_trace
    directory = tempfile.mkdtemp(prefix="portbench-spans-")
    saved = {k: os.environ.get(k) for k in ("REPRO_TRACE", "REPRO_TRACE_DIR")}
    os.environ.update(REPRO_TRACE="1", REPRO_TRACE_DIR=directory)
    try:
        reqs = lp.serve_until(serve, stream, first, deadline)
        obs_trace.flush()
        return reqs, _read_spans(directory)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(directory, ignore_errors=True)


def _traced_window(rec: RunRecord, lp, serve, stream, seconds: float,
                   device: torch.device, log) -> List:
    """The window with the program's spans on, then its last
    ``PROFILE_WINDOWS`` profiled windows (spans first: a process that has
    run the profiler serves slower afterwards)."""
    start = time.perf_counter()
    window_s = min(PROFILE_WINDOW_S, seconds / (2 * PROFILE_WINDOWS))
    reqs, rec.spans = _spans(lp, serve, stream, 0, start + seconds - PROFILE_WINDOWS * window_s)
    log(f"spans: {len(reqs)} requests in {reqs[-1].t1 - reqs[0].t0:.3f} s, "
        f"{len(rec.spans)} spans")
    windows, first = [], len(reqs)
    for _ in range(PROFILE_WINDOWS):
        got, w = _profiled(lp, serve, stream, first, window_s, device)
        reqs += got
        windows.append(w)
        first += len(got)
    try:
        rec.profile = profiling.keep_fullest(windows, program.KERNELS)
    finally:
        for i, w in enumerate(windows):
            kinds = {}
            for r in w.records:
                kinds[r.kind] = kinds.get(r.kind, 0) + 1
            log(f"profiled window {i}: {w.requests} requests, {w.window_s:.3f} s, records "
                f"{json.dumps(kinds)}, launched {sum(w.launched.values())}, missing "
                f"{w.missing or 'none'}" + (" (kept)" if w is rec.profile else ""))
    return reqs


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        log: Callable[[str], None]) -> Dict:
    """One run; returns the result line's object (``checks`` last)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    rec = RunRecord(cell=cell)
    ix, traffic = cell.config["index"], cell.traffic
    t = time.perf_counter()
    if cuda:
        from repro_torch.kernels import _build
        for name in _build.build_all():
            _build.library(name)
    log(f"kernels built or loaded: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    inputs = datagen.make_inputs(cell.config, seed, device)
    _sync(device)
    log(f"inputs made: {time.perf_counter() - t:.3f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    engine = program.build_engine(cell.config, traffic, inputs, device)
    _sync(device)
    log(f"engine built and warmed: {time.perf_counter() - t:.3f} s")

    lp = spec.loop(cell.root, traffic["kind"])
    stream = lp.Requests(inputs["queries"].cpu().numpy(), traffic)
    serve = engine.query_batch
    warm = int(traffic.get("warm_requests", 0))
    if warm:
        bad = [r.error for r in lp.serve_until(serve, stream, -warm, 0.0, warm) if r.error]
        if bad:
            raise RuntimeError(f"a warm-up request failed: {bad[0]}")
    rec.setup_s = time.perf_counter() - t_start

    if trace:
        reqs = _traced_window(rec, lp, serve, stream, seconds, device, log)
    else:
        reqs = lp.serve_until(serve, stream, 0, time.perf_counter() + seconds)
    rec.requests = reqs
    rec.window_s = reqs[-1].t1 - reqs[0].t0
    _sync(device)
    rec.peak_bytes = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    summary = engine.summary()
    log("engine: " + json.dumps({k: summary[k] for k in
                                 ("batches", "cand_buckets", "bucket_cold_hits")}))
    log(f"launches: {json.dumps(program.launches())}")
    del engine, serve
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    rec.inputs = inputs
    rec.params = params = ref.as_params(ix["width"], inputs["params"])
    points, queries = inputs["points"], inputs["queries"]
    rec.tables = tables = ref.build(params, points, int(ix["num_probes"]))

    def rows(req) -> torch.Tensor:
        return queries[torch.from_numpy(stream.rows(req.index)).to(device)]

    def answer(req):
        d, i = ref.answer(params, tables, points, rows(req), int(ix["candidate_cap"]),
                          int(ix["k"]))
        return d.cpu().numpy(), i.cpu().numpy()

    drawn = check.draw(reqs, stream.size, seed)
    checks = check.judge(drawn, answer)
    _sync(device)
    log(f"reference: {time.perf_counter() - t:.3f} s for {len(drawn)} requests")

    if rec.profile is not None:
        first = rec.profile.first_request
        rec.kept_batches = [rows(r) for r in reqs
                            if first <= r.index < first + rec.profile.requests]

    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        value = spec.reader(cell.root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": check.correct(checks),
        "attempted": len(reqs),
        "failed": sum(1 for r in reqs if r.error is not None),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": 1, "memory_peak_bytes": rec.peak_bytes},
    }
    if rec.profile is not None:
        result["device"]["busy_s"] = rec.profile.busy_s
        result["device"]["window_s"] = rec.profile.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in rec.profile.top_ops()],
                               "idle_gaps": [list(x) for x in rec.profile.idle_gaps()]}
    errors = sorted({r.error for r in reqs if r.error is not None})
    if errors:
        log(f"failed requests: {len(errors)} kinds, first: {errors[0]}")
    for line in check.lines(checks, sum(r.dists.shape[0] if r.dists is not None
                                        else stream.size for r in drawn)):
        log(line)
    result["checks"] = checks
    return result
