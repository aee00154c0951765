"""Port parity of observability and the race sanitizer: ``repro_torch.obs``
against the JAX package's ``repro.obs`` on the same samples (histogram
quantiles, snapshot JSON, merges, roll-ups), a trace that the port's engine
writes rendering and checking with both packages, the phase spans of a
served batch, the flight recorder, and the sanitizer cases of
``tests/test_racecheck.py`` on ``repro_torch.analysis.racecheck`` and the
port's engine."""
import dataclasses
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import racecheck as jrace
from repro.obs import metrics as jmetrics
from repro.obs import render as jrender
from repro_torch.analysis import racecheck
from repro_torch.analysis.racecheck import RaceViolation, StateToken
from repro_torch.core.index import IndexConfig
from repro_torch.core.segments import SegmentedIndex
from repro_torch.data import ann_synthetic as ds
from repro_torch.obs import FlightRecorder, MetricsRegistry, merge_snapshots
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import render as trender
from repro_torch.obs import summarize_snapshot
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import AnnServingEngine, ServeConfig

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"


# ------------------------------------------------------------- metrics

def _samples(name):
    rng = np.random.default_rng(len(name))
    return {
        "bimodal": np.concatenate([rng.uniform(0.5, 5.0, 900),
                                   rng.uniform(50.0, 80.0, 100)]),
        "tiny": rng.uniform(0.0, 0.02, 200),
        "wide": rng.uniform(0.001, 10_000.0, 3000),
        "one": np.array([7.25]),
        "huge": np.array([1.0, 1e15, 3.0]),
    }[name]


def _registries(samples):
    regs = []
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry("engine")
        reg["batches"] = 0
        for ms in samples:
            reg["batches"] += 1
            reg.histogram("batch_ms").record_ms(float(ms))
        reg.family("cand_buckets")[128] += 2
        reg.gauge_set("depth", 3)
        regs.append(reg)
    return regs


@pytest.mark.parametrize("name", ["bimodal", "tiny", "wide", "one", "huge"])
def test_histogram_and_snapshot_match_jax(name):
    """The same quantile bounds, mean and snapshot JSON on the same samples."""
    jreg, treg = _registries(_samples(name))
    jh, th = jreg.histogram("batch_ms"), treg.histogram("batch_ms")
    for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert th.quantile_bounds(q) == jh.quantile_bounds(q)
        assert th.quantile_ms(q) == jh.quantile_ms(q)
    assert (th.count, th.mean_ms, th.max_us) == (jh.count, jh.mean_ms, jh.max_us)
    assert json.dumps(treg.snapshot(), sort_keys=True) == \
        json.dumps(jreg.snapshot(), sort_keys=True)
    assert treg.as_dict() == jreg.as_dict()
    assert summarize_snapshot(treg.snapshot()) == \
        jmetrics.summarize_snapshot(jreg.snapshot())


def test_merge_snapshots_match_jax():
    """Merges (a JSON round trip on one side, None as identity) and their
    roll-ups agree with the JAX package's, in either order."""
    snaps = [r.snapshot() for r in _registries(_samples("bimodal"))]
    other = [r.snapshot() for r in _registries(_samples("wide"))]
    wire = json.loads(json.dumps(other[1]))
    for a, b in ((snaps[1], wire), (wire, snaps[1]), (snaps[1], None)):
        got = merge_snapshots(a, b)
        assert got == jmetrics.merge_snapshots(a, b)
        assert summarize_snapshot(got) == jmetrics.summarize_snapshot(got)
    three = merge_snapshots(merge_snapshots(snaps[1], other[1]), snaps[1])
    assert three == merge_snapshots(snaps[1], merge_snapshots(other[1], snaps[1]))


def test_registry_facade():
    reg = MetricsRegistry("t")
    reg["batches"] = 0
    reg["batches"] += 3
    assert reg["batches"] == 3 and reg["never_set"] == 0
    assert reg.get("nope", None) is None and "batches" in reg
    reg.family("cand_buckets")[128] += 2
    assert reg["cand_buckets"][128] == 2
    assert reg.as_dict() == {"batches": 3, "cand_buckets": {128: 2}}


def test_flight_recorder_bounds_and_exemplars():
    fr = FlightRecorder(capacity=4, slow_ms=10.0, exemplar_capacity=2)
    for n in range(8):
        fr.record(1.0, {"n": n})
    assert [e[2]["n"] for e in fr.entries()] == [4, 5, 6, 7]
    ex = fr.record(25.0, {"n": 8}, spans=[{"name": "s"}])
    assert ex["ms"] == 25.0 and ex["spans"] == [{"name": "s"}]
    fr.record(30.0, {"n": 9})
    fr.record(40.0, {"n": 10})
    assert [e["n"] for e in fr.exemplars()] == [9, 10]
    assert fr.summary() == {"capacity": 4, "recorded": 11, "slow_ms": 10.0,
                            "slow_batches": 3, "exemplar_count": 2}


# ------------------------------------------------------------- tracing

CFG = IndexConfig(num_tables=2, num_hashes=6, width=16, num_probes=10,
                  candidate_cap=16, universe=32, k=4, rerank_chunk=64)


@pytest.fixture(scope="module")
def small():
    spec = ds.DatasetSpec("obs-t", n=600, dim=8, universe=32, num_clusters=4)
    data = ds.make_dataset(spec)
    return data, ds.make_queries(spec, data, 12)


def test_span_is_shared_null_when_disabled(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    s1, s2 = obs_trace.span("a", x=1), obs_trace.span("b")
    assert s1 is s2
    with s1:
        assert obs_trace.current() is None
    obs_trace.capture_begin()
    assert obs_trace.capture_end() == []


def _engine(data, **kw):
    serve = dict(batch_size=8, bucket_min=4, delta_cap=32)
    serve.update(kw)
    return AnnServingEngine(CFG, ServeConfig(**serve), data, device="cpu")


def test_tracing_off_adds_no_sync(small, monkeypatch, tmp_path):
    """The phase spans synchronize the card only while tracing is on."""
    data, queries = small
    calls = []
    monkeypatch.setattr(SegmentedIndex, "_sync", lambda self: calls.append(1))
    eng = _engine(data)
    eng.insert(data[:3] + 2)                        # a delta: all four phases
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    eng.query_batch(queries)
    assert calls == []
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    eng.query_batch(queries[:4])
    assert len(calls) == 3                          # phase B, delta scan, merge


def test_traced_engine_renders_with_both_packages(small, monkeypatch, tmp_path):
    """One traced drain: an ``engine_batch`` span per batch, each the parent
    of ``phase_a``, ``phase_b_rerank``, ``delta_scan`` and ``merge``; the
    file renders and checks with the port's and the JAX package's
    ``render``, and through ``python -m repro_torch.obs render --check``."""
    data, queries = small
    eng = _engine(data, hedge_ms=0.0)               # every batch an exemplar
    eng.insert(data[:3] + 2)
    eng.warmup()                                    # warm-up runs untraced
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    obs_trace.set_process_label("port-engine")
    try:
        eng.submit(queries)
        eng.drain()
    finally:
        obs_trace.set_process_label("")
    obs_trace.flush()
    spans = trender.load_spans(str(tmp_path))
    assert spans == jrender.load_spans(str(tmp_path))
    batches = [r for r in spans if r["name"] == "engine_batch"]
    assert len(batches) == eng.summary()["batches"] == 2
    parents = {r["sid"] for r in batches}
    for name in ("phase_a", "phase_b_rerank", "delta_scan", "merge"):
        mine = [r for r in spans if r["name"] == name]
        assert len(mine) == 2 and {r["psid"] for r in mine} == parents, name
    report = trender.check_spans(spans)
    assert report["ok"] and report == jrender.check_spans(spans)
    assert trender.to_chrome(spans) == jrender.to_chrome(spans)
    ex = eng.flight.exemplars()
    assert len(ex) == 2 and ex[-1]["preview_d"] and \
        {s["name"] for s in ex[-1]["spans"]} >= {"engine_batch", "merge"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "render", str(tmp_path),
         "-o", str(tmp_path / "trace.json"), "--check"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    chrome = json.loads((tmp_path / "trace.json").read_text())
    assert {e["name"] for e in chrome["traceEvents"]} >= {"engine_batch", "phase_a"}


# ------------------------------------------------------------- sanitizer

def test_token_same_thread_nesting_is_legal():
    tok = StateToken("t")
    e = tok.enter_query()
    tok.enter_mutation()
    tok.exit_mutation()
    tok.exit_query(e)


def _in_other_thread(enter, leave):
    """Run ``enter`` in a thread that holds until released; returns
    (release, join)."""
    inside, release = threading.Event(), threading.Event()

    def body():
        token = enter()
        inside.set()
        release.wait(5)
        leave(token)

    t = threading.Thread(target=body)
    t.start()
    assert inside.wait(5)

    def join():
        release.set()
        t.join(5)
        assert not t.is_alive()
    return join


def test_token_cross_thread_mutation_during_query_raises():
    tok = StateToken("t")
    join = _in_other_thread(tok.enter_query, tok.exit_query)
    try:
        with pytest.raises(RaceViolation):
            tok.enter_mutation()
    finally:
        join()


def test_token_query_detects_epoch_advanced_by_unwrapped_mutator():
    tok = StateToken("t")
    e = tok.enter_query()
    tok.epoch += 1
    tok.last_mutator = -2
    with pytest.raises(RaceViolation):
        tok.exit_query(e)


def test_token_concurrent_cross_thread_mutations_raise():
    tok = StateToken("t")
    join = _in_other_thread(tok.enter_mutation, lambda _: tok.exit_mutation())
    try:
        with pytest.raises(RaceViolation):
            tok.enter_mutation()
        with pytest.raises(RaceViolation):
            tok.enter_query()
    finally:
        join()


def test_instrument_is_noop_when_disabled(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)

    class Obj:
        def q(self):
            return 1

    o = Obj()
    racecheck.maybe_instrument(o, "x", queries=("q",))
    assert not hasattr(o, "__repro_race_token__") and o.q() == 1


def test_instrument_wraps_and_is_idempotent(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")

    class Obj:
        def q(self):
            return 41

        def m(self):
            return 42

    o = Obj()
    racecheck.maybe_instrument(o, "x", queries=("q",), mutations=("m",))
    assert o.q.__repro_sanitized__ == "query"
    assert o.m.__repro_sanitized__ == "mutation"
    first = o.q
    racecheck.maybe_instrument(o, "x", queries=("q",))
    assert o.q is first
    assert (o.q(), o.m()) == (41, 42)
    assert o.__repro_race_token__.epoch == 1
    assert racecheck.enabled() == jrace.enabled()


def test_same_thread_engine_reentrancy_is_clean_under_sanitizer(small, monkeypatch):
    """insert -> watermark compaction is same-thread nesting: clean."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    data, queries = small
    eng = _engine(data[:200], delta_cap=64, compact_watermark=0.01, batch_size=16)
    assert hasattr(eng, "__repro_race_token__")
    eng.insert(data[200:220])
    d, i = eng.run_padded(queries, queries.shape[0])
    assert i.shape == (queries.shape[0], CFG.k)
    assert eng.__repro_race_token__.epoch >= 1


def test_engine_mutation_during_another_threads_query_raises(small, monkeypatch):
    """A mutation entering while another thread's query is in flight trips
    the sanitizer before it touches the index; without the sanitizer the
    engine carries no token."""
    data, queries = small
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not hasattr(_engine(data, warm_buckets=False), "__repro_race_token__")
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    eng = _engine(data)
    inside, release = threading.Event(), threading.Event()
    real = eng.index.query_compact

    def held(*args, **kw):
        inside.set()
        release.wait(5)
        return real(*args, **kw)

    eng.index.query_compact = held
    t = threading.Thread(target=eng.query_batch, args=(queries[:4],))
    t.start()
    try:
        assert inside.wait(5)
        live = eng.index.num_live
        with pytest.raises(RaceViolation):
            eng.insert(data[:2])
        assert eng.index.num_live == live
    finally:
        release.set()
        t.join(5)
    assert not t.is_alive()


# ------------------------------------------------------------- stage spans

# Each stage span of a served request and the span it runs under.
STAGE_PARENT = {
    "engine_validate": "engine_request", "engine_batch": "engine_request",
    "engine_answers": "engine_request",
    "engine_h2d": "engine_batch", "phase_a": "engine_batch",
    "phase_b_rerank": "engine_batch", "delta_scan": "engine_batch",
    "merge": "engine_batch", "engine_sync": "engine_batch",
    "stage_hash": "phase_a", "stage_probe_keys": "phase_a",
    "stage_probe_extents": "phase_a", "rung_read": "phase_a",
    "stage_fused_probe": "phase_b_rerank", "stage_dedup": "phase_b_rerank",
    "stage_tombstone": "phase_b_rerank", "stage_rerank": "phase_b_rerank",
    "gid_map": "phase_b_rerank",
}


def _profiled_request(eng, queries):
    """One ``query_batch`` under a CPU profiler -> its ``repro.*`` events
    (the engine warmed first: a warm-up runs inside ``engine_validate``)."""
    from torch.profiler import ProfilerActivity, profile
    eng.warmup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.query_batch(queries)
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(obs_trace.RANGE_PREFIX)]


def _range_parents(events):
    """Range name -> names of the innermost ranges around it."""
    spans = [(e.name()[len(obs_trace.RANGE_PREFIX):], e.start_ns(),
              e.start_ns() + e.duration_ns()) for e in events]
    parents = {}
    for name, a, b in spans:
        around = [(b2 - a2, n2) for n2, a2, b2 in spans
                  if a2 <= a and b <= b2 and (a2, b2) != (a, b)]
        parents.setdefault(name, set()).add(min(around)[1] if around else None)
    return parents


@pytest.mark.parametrize("rerank_impl", ["fused", "scan"])
def test_profiler_records_every_stage_range_nested(small, monkeypatch, rerank_impl):
    """Under a torch profiler, with tracing off, one request records every
    stage as a ``repro.*`` host range inside the range of its parent span;
    ``stage_dedup`` runs (and is recorded) only before the 'scan' rerank."""
    data, queries = small
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    cfg = dataclasses.replace(CFG, rerank_impl=rerank_impl)
    eng = AnnServingEngine(cfg, ServeConfig(batch_size=8, bucket_min=4, delta_cap=32),
                           data, device="cpu")
    eng.insert(data[:3] + 2)                        # a delta: all four phases
    parents = _range_parents(_profiled_request(eng, queries[:8]))
    want = set(STAGE_PARENT) | {"engine_request"}
    if rerank_impl == "fused":
        want.discard("stage_dedup")
    assert set(parents) == want
    assert parents.pop("engine_request") == {None}
    assert parents == {name: {STAGE_PARENT[name]} for name in parents}


def test_skipped_tombstone_mask_keeps_its_range(small, monkeypatch):
    """With no delete and no delta the mask launches nothing, yet a profiled
    request still records ``repro.stage_tombstone`` under
    ``repro.phase_b_rerank``, so its device time reads 0 and not nothing."""
    data, queries = small
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    eng = _engine(data)
    assert eng.index.num_tombstones == 0 and eng.index.delta_fill == 0
    parents = _range_parents(_profiled_request(eng, queries[:8]))
    assert parents["stage_tombstone"] == {"phase_b_rerank"}
    passes = eng.index.tombstone_passes
    assert passes["masked"] == 0 and passes["skipped"] > 0


def test_traced_tombstone_span_says_whether_it_masked(small, monkeypatch, tmp_path):
    """The JSONL ``stage_tombstone`` span carries ``masked``: false on every
    pass before the first delete, true on every pass after it."""
    data, queries = small
    eng = _engine(data)
    eng.warmup()
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    eng.query_batch(queries[:8])
    assert eng.delete([0, 1]) == 2
    eng.query_batch(queries[:8])
    obs_trace.flush()
    spans = sorted((r for r in trender.load_spans(str(tmp_path))
                    if r["name"] == "stage_tombstone"), key=lambda r: r["ts"])
    masked = [r["args"]["masked"] for r in spans]
    assert masked[0] is False and masked[-1] is True
    assert masked == sorted(masked)


def test_stage_ranges_are_host_ranges_not_user_annotations(small, monkeypatch):
    """The ranges are plain host ranges: a user annotation would be copied
    onto the device's timeline, where it would read as a kernel."""
    data, queries = small
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    events = _profiled_request(_engine(data), queries[:8])
    assert len(events) >= len(STAGE_PARENT) - 2
    assert not any(e.is_user_annotation() for e in events)
    assert {str(e.device_type()) for e in events} == {"DeviceType.CPU"}


def test_new_stage_span_is_shared_null_without_tracing_or_profiler(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    for name in ("engine_request", "stage_tombstone", "rung_read", "gid_map"):
        assert obs_trace.span(name, slots=4) is obs_trace.span("phase_a")


def test_profiler_ranges_without_fast_ranges_record_nothing(small, monkeypatch):
    """A torch without ``_RecordFunctionFast`` gets no ranges (and never a
    ``record_function`` in their place)."""
    data, queries = small
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(data)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs_trace.span("engine_request") is obs_trace._NULL
        eng.query_batch(queries[:8])
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not any(n.startswith(obs_trace.RANGE_PREFIX) for n in names)


def test_spans_and_profiler_ranges_share_one_clock(small, monkeypatch, tmp_path):
    """With ``REPRO_TRACE=1`` and a profiler both on, a JSONL
    ``engine_batch`` span and its ``repro.engine_batch`` range start within
    1 ms of each other."""
    data, queries = small
    eng = _engine(data)
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    events = _profiled_request(eng, queries[:8])
    obs_trace.flush()
    spans = [r for r in trender.load_spans(str(tmp_path)) if r["name"] == "engine_batch"]
    ranges = [e for e in events if e.name() == "repro.engine_batch"]
    assert len(spans) == len(ranges) == 1
    assert abs(spans[0]["ts"] - ranges[0].start_ns() / 1e3) < 1000


def test_traced_jsonl_holds_the_stage_spans_and_syncs_only_the_phases(
        small, monkeypatch, tmp_path):
    """With ``REPRO_TRACE=1`` each stage span is in the JSONL tree under its
    phase, and a traced batch with a delta still synchronises three times
    (phase B, the delta scan, the merge): the stage spans add none."""
    data, queries = small
    calls = []
    monkeypatch.setattr(SegmentedIndex, "_sync", lambda self: calls.append(1))
    eng = _engine(data)
    eng.insert(data[:3] + 2)
    eng.warmup()
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    eng.query_batch(queries[:8])
    obs_trace.flush()
    assert len(calls) == 3
    spans = trender.load_spans(str(tmp_path))
    by_sid = {r["sid"]: r["name"] for r in spans}
    got = {}
    for r in spans:
        got.setdefault(r["name"], set()).add(by_sid.get(r["psid"]))
    assert got.pop("engine_request") == {None}
    assert set(got) == set(STAGE_PARENT) - {"stage_dedup"}
    assert got == {name: {STAGE_PARENT[name]} for name in got}
    assert trender.check_spans(spans)["ok"]
