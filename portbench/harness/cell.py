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

**On several cards** (``run_sharded``; a configuration that declares
``"row_shards": R`` on a cell of R cards) the run is one process a card
(``ranks.launch``), each building the distributed index over its own rows
(``datagen.make_shard_inputs``, ``program.build_sharded``) and answering
every request's whole batch, in lockstep: every rank sends the same
requests in the same order, so every phase is a request count that the
ranks agree on before it starts.  Rank 0 times its last ``CALIBRATE`` set-up
requests, and each phase's count is its length over their median time,
which rank 0 sends over the host group (``Lockstep``); nothing is sent
between requests.  Rank 0 times, traces and reports; the request's answer
is its global top-k.  The peak is the fullest card's.  Each rank's
reference answers the drawn queries over its shard and rank 0 merges them
(``reference.lsh.merge``); a query another rank answered otherwise than
rank 0 counts as mismatched.  In a sharded run the ``RunRecord``'s inputs
and tables are rank 0's shard, the rows whose work rank 0's kernels did.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.harness import check, datagen, profiling, program, ranks as ranks_mod, spec
from portbench.reference import lsh as ref

__all__ = ["RunRecord", "Clock", "Lockstep", "run", "run_sharded", "PROFILE_WINDOWS",
           "PROFILE_WINDOW_S", "MARK", "CALIBRATE", "RANK_LIMIT_S"]

PROFILE_WINDOWS = 3
PROFILE_WINDOW_S = 1.0
MARK = profiling.ANNOTATION_PREFIX + "request"
CALIBRATE = 3            # set-up requests whose time sets a sharded run's phase counts
RANK_LIMIT_S = 270.0     # a sharded run's ranks: set-up, reference and readers, past the window


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


class Clock:
    """The phases of one process: each runs until its host-clock deadline."""

    lead = True

    def until(self, deadline: float) -> Tuple[float, int]:
        """``serve_until``'s (deadline, min_requests) for a phase."""
        return deadline, 1


class Lockstep(Clock):
    """The phases of ranks in lockstep: each runs the request count that
    rank 0 works out from its deadline and its set-up requests' median time,
    and sends to every rank over the host group before the phase starts."""

    def __init__(self, ranks, request_s: float):
        self.ranks, self.request_s = ranks, request_s
        self.lead = ranks.lead

    def until(self, deadline: float) -> Tuple[float, int]:
        count = max(1, round((deadline - time.perf_counter()) / self.request_s))
        return 0.0, int(self.ranks.broadcast(count if self.lead else None))


def _read_spans(directory: str) -> List[Dict]:
    out = []
    for path in sorted(Path(directory).glob("*.jsonl")):
        with open(path, encoding="utf-8") as f:
            out.extend(json.loads(line) for line in f if line.strip())
    return out


def _profiled(lp, serve, stream, first: int, seconds: float,
              device: torch.device, clock: Clock) -> tuple:
    """One profiled window of whole requests -> (requests, Window); a rank
    that does not lead serves its share of the window unprofiled (None)."""
    if not clock.lead:
        phase = clock.until(time.perf_counter() + seconds)
        return lp.serve_until(serve, stream, first, *phase), None
    from torch.profiler import ProfilerActivity, profile, record_function

    def marked(batch):
        with record_function(MARK):
            return serve(batch)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    before = program.launches()
    with profile(activities=acts) as prof:
        reqs = lp.serve_until(marked, stream, first, *clock.until(time.perf_counter() + seconds))
        _sync(device)
    after = program.launches()
    records = profiling.records_from_profiler(prof)
    del prof
    t0, t1 = profiling.window_bounds(records, MARK)
    return reqs, profiling.Window(
        first_request=first, requests=len(reqs), batches=len(reqs),
        t0_us=t0, t1_us=t1, records=records,
        launched={k: after[k] - before.get(k, 0) for k in after})


def _spans(lp, serve, stream, first: int, phase: Tuple[float, int], lead: bool) -> tuple:
    """Requests served with the program's spans on (on the leading process
    only) -> (requests, spans)."""
    if not lead:
        return lp.serve_until(serve, stream, first, *phase), []
    from repro_torch.obs import trace as obs_trace
    directory = tempfile.mkdtemp(prefix="portbench-spans-")
    saved = {k: os.environ.get(k) for k in ("REPRO_TRACE", "REPRO_TRACE_DIR")}
    os.environ.update(REPRO_TRACE="1", REPRO_TRACE_DIR=directory)
    try:
        reqs = lp.serve_until(serve, stream, first, *phase)
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
                   device: torch.device, log, clock: Clock) -> List:
    """The window with the program's spans on, then its last
    ``PROFILE_WINDOWS`` profiled windows (spans first: a process that has
    run the profiler serves slower afterwards)."""
    start = time.perf_counter()
    window_s = min(PROFILE_WINDOW_S, seconds / (2 * PROFILE_WINDOWS))
    reqs, rec.spans = _spans(lp, serve, stream, 0,
                             clock.until(start + seconds - PROFILE_WINDOWS * window_s),
                             clock.lead)
    log(f"spans: {len(reqs)} requests in {reqs[-1].t1 - reqs[0].t0:.3f} s, "
        f"{len(rec.spans)} spans")
    windows, first = [], len(reqs)
    for _ in range(PROFILE_WINDOWS):
        got, w = _profiled(lp, serve, stream, first, window_s, device, clock)
        reqs += got
        windows.append(w)
        first += len(got)
    if not clock.lead:
        return reqs
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


def _build_kernels(device: torch.device, log) -> None:
    t = time.perf_counter()
    if device.type == "cuda":
        from repro_torch.kernels import _build
        for name in _build.build_all():
            _build.library(name)
    log(f"kernels built or loaded: {time.perf_counter() - t:.3f} s")


def _window(rec: RunRecord, lp, serve, stream, seconds: float, trace: bool,
            device: torch.device, log, clock: Clock) -> List:
    """The measured window's requests (traced or not), its time on ``rec``."""
    if trace:
        reqs = _traced_window(rec, lp, serve, stream, seconds, device, log, clock)
    else:
        reqs = lp.serve_until(serve, stream, 0, *clock.until(time.perf_counter() + seconds))
    rec.requests = reqs
    rec.window_s = reqs[-1].t1 - reqs[0].t0
    _sync(device)
    return reqs


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(rec: RunRecord, inputs: Dict, stream, device: torch.device) -> Callable:
    """The plain reference's parameters and tables over the inputs' points,
    on ``rec`` (built once the program is freed) -> ``rows(request)``, the
    request's queries on the device."""
    ix = rec.cell.config["index"]
    rec.inputs = inputs
    rec.params = ref.as_params(ix["width"], inputs["params"])
    rec.tables = ref.build(rec.params, inputs["points"], int(ix["num_probes"]))
    queries = inputs["queries"]

    def rows(req) -> torch.Tensor:
        return queries[torch.from_numpy(stream.rows(req.index)).to(device)]

    return rows


def _report(rec: RunRecord, trace: bool, reqs: List, drawn: List, checks: Dict, stream,
            rows, device: torch.device, count: int, log) -> Dict:
    """The result line's object (``checks`` last), from the judged run."""
    cuda = device.type == "cuda"
    if rec.profile is not None:
        first = rec.profile.first_request
        rec.kept_batches = [rows(r) for r in reqs
                            if first <= r.index < first + rec.profile.requests]

    names = rec.cell.per_layer if trace else rec.cell.end_to_end
    metrics = {}
    for m in names:
        value = spec.reader(rec.cell.root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": check.correct(checks),
        "attempted": len(reqs),
        "failed": sum(1 for r in reqs if r.error is not None),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": count, "memory_peak_bytes": rec.peak_bytes},
    }
    if rec.profile is not None:
        result["device"]["busy_s"] = rec.profile.busy_s
        result["device"]["window_s"] = rec.profile.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in rec.profile.top_ops()],
                               "idle_gaps": [list(x) for x in rec.profile.idle_gaps()]}
    errors = sorted({r.error for r in reqs if r.error is not None})
    if errors:
        log(f"failed requests: {len(errors)} kinds, first: {errors[0]}")
    for line in _check_lines(checks, drawn, stream):
        log(line)
    result["checks"] = checks
    return result


def _check_lines(checks: Dict, drawn: List, stream) -> List[str]:
    return check.lines(checks, sum(r.dists.shape[0] if r.dists is not None else stream.size
                                   for r in drawn))


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        log: Callable[[str], None]) -> Dict:
    """One run on one card; returns the result line's object (``checks`` last)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    rec = RunRecord(cell=cell)
    ix, traffic = cell.config["index"], cell.traffic
    _build_kernels(device, log)

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

    reqs = _window(rec, lp, serve, stream, seconds, trace, device, log, Clock())
    rec.peak_bytes = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    summary = engine.summary()
    log("engine: " + json.dumps({k: summary[k] for k in
                                 ("batches", "cand_buckets", "bucket_cold_hits")}))
    log(f"launches: {json.dumps(program.launches())}")
    del engine, serve
    _free(device)

    t = time.perf_counter()
    rows = _reference(rec, inputs, stream, device)

    def answer(req):
        d, i = ref.answer(rec.params, rec.tables, inputs["points"], rows(req),
                          int(ix["candidate_cap"]), int(ix["k"]))
        return d.cpu().numpy(), i.cpu().numpy()

    drawn = check.draw(reqs, stream.size, seed)
    checks = check.judge(drawn, answer)
    _sync(device)
    log(f"reference: {time.perf_counter() - t:.3f} s for {len(drawn)} requests")
    return _report(rec, trace, reqs, drawn, checks, stream, rows, device, 1, log)


class RankFault(BaseException):
    """A request that raised on a rank in lockstep: the run fails, since its
    peers would wait in the request's collective for the rank's share."""


def _fatal(serve):
    def served(batch):
        try:
            return serve(batch)
        except Exception as err:
            raise RankFault(f"{type(err).__name__}: {err}") from err
    return served


def run_sharded(cell: spec.Cell, seed: int, seconds: float, trace: bool, backend: str,
                device: str, t_start: float, log: Callable[[str], None], forbidden,
                limit_s: Optional[float] = None, fault: Optional[Callable] = None) -> Dict:
    """One run of a cell on ``cell.chips`` cards, one rank a card under
    ``backend`` (``'nccl'`` on cards; ``'gloo'`` on the CPU, where ``device``
    is ``'cpu'``); returns rank 0's result line's object and writes the
    numbers compared as the log's last lines.  Every rank fails when, once
    its window has closed, it holds a module whose top-level name is in
    ``forbidden`` (JAX and the JAX package).  ``fault(rank)``, if given,
    runs in every rank before the program is built: the tests plant their
    faults with it.  Raises ``ranks.RankFailure`` when a rank fails or the
    ranks outlive ``limit_s`` (``seconds + RANK_LIMIT_S``)."""
    if device != "cpu":
        from repro_torch.kernels import _build
        t = time.perf_counter()
        _build.build_all()          # once, before the ranks load the libraries
        log(f"kernels built or found: {time.perf_counter() - t:.3f} s")
    limit = seconds + RANK_LIMIT_S if limit_s is None else limit_s
    out = ranks_mod.launch(cell.chips, _rank_job,
                           (cell, seed, seconds, trace, device, t_start, frozenset(forbidden),
                            fault),
                           backend, limit, log)
    for line in out["lines"]:
        log(line)
    return out["result"]


def _rank_job(ranks, cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
              t_start: float, forbidden: frozenset, fault) -> Optional[Dict]:
    """One rank of ``run_sharded``; rank 0 returns the result and its check
    lines, the others None."""
    def log(msg: str) -> None:
        sys.stderr.write(f"rank {ranks.rank}: {msg}\n")      # one write: ranks share stderr
        sys.stderr.flush()

    device = torch.device(device, ranks.rank) if device != "cpu" else torch.device("cpu")
    cuda = device.type == "cuda"
    rec = RunRecord(cell=cell)
    ix, traffic = cell.config["index"], cell.traffic
    log(f"group formed: {time.perf_counter() - t_start:.3f} s after the run's start")
    _build_kernels(device, log)

    t = time.perf_counter()
    inputs = datagen.make_shard_inputs(cell.config, seed, device, ranks.rank, ranks.world)
    _sync(device)
    log(f"inputs made: {time.perf_counter() - t:.3f} s, rows {inputs['first_row']} + "
        f"{inputs['points'].shape[0]}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if fault is not None:
        fault(ranks.rank)
    t = time.perf_counter()
    serve = _fatal(program.build_sharded(cell.config, inputs, device))
    _sync(device)
    log(f"index built: {time.perf_counter() - t:.3f} s")

    lp = spec.loop(cell.root, traffic["kind"])
    stream = lp.Requests(inputs["queries"].cpu().numpy(), traffic)
    warm = int(traffic.get("warm_requests", 0)) + CALIBRATE
    got = lp.serve_until(serve, stream, -warm, 0.0, warm)
    request_s = float(np.median([r.t1 - r.t0 for r in got[-CALIBRATE:]]))
    clock = Lockstep(ranks, request_s)
    rec.setup_s = time.perf_counter() - t_start
    if ranks.lead:
        log(f"set-up requests: {request_s * 1e3:.3f} ms each (median of {CALIBRATE})")

    reqs = _window(rec, lp, serve, stream, seconds, trace, device, log, clock)
    peaks = ranks.gather(int(torch.cuda.max_memory_allocated(device)) if cuda else 0)
    if ranks.lead:
        rec.peak_bytes = max(peaks)
        log("peak bytes by rank: " + json.dumps(peaks))
    log(f"{len(reqs)} requests; launches: {json.dumps(program.launches())}")
    del serve
    _free(device)

    t = time.perf_counter()
    rows = _reference(rec, inputs, stream, device)
    drawn = check.draw(reqs, stream.size, seed)
    mine = []
    for req in drawn:
        d, i = ref.answer_shard(rec.params, rec.tables, inputs["points"], rows(req),
                                int(ix["candidate_cap"]), int(ix["k"]), inputs["first_row"])
        mine.append((d.cpu(), i.cpu()))
    shards = ranks.gather(mine)
    answers = ranks.gather([(r.dists, r.ids) for r in drawn])
    _sync(device)
    log(f"reference: {time.perf_counter() - t:.3f} s for {len(drawn)} requests")
    if not ranks.lead:
        return _guard(forbidden, None)
    merged = {req.index: tuple(x.numpy() for x in
                               ref.merge([shard[n] for shard in shards], int(ix["k"])))
              for n, req in enumerate(drawn)}
    checks = check.judge(drawn, lambda req: merged[req.index], peers=answers[1:])
    result = _report(rec, trace, reqs, drawn, checks, stream, rows, device, ranks.world, log)
    return _guard(forbidden, {"result": result, "lines": _check_lines(checks, drawn, stream)})


def _guard(forbidden: frozenset, out):
    """``out``, once this rank is found to hold no module of ``forbidden``
    (compared by whole top-level names); raises otherwise."""
    found = sorted({m.split(".")[0] for m in sys.modules} & forbidden)
    if found:
        raise RuntimeError(f"JAX or the JAX package was loaded: {', '.join(found)}")
    return out
