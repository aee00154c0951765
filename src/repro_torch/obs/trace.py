"""Distributed per-query tracing (DESIGN.md §12), the port's copy.

Inert unless ``REPRO_TRACE=1`` — the ``REPRO_SANITIZE`` pattern: every
``span()`` call with tracing off (and no torch profiler collecting, see
below) returns one shared no-op context manager (no span object, no id, no
clock read), so the serving hot path pays two dict lookups and a flag read
and nothing else.  With tracing on:

  * a **trace id** is born at the root span (the router's per-batch
    ``cluster_batch``) and every child span carries it, across threads via
    an explicit ``parent=`` handoff (thread-local context does not follow
    ``ThreadPoolExecutor.submit``) and across processes via a tiny
    ``{"tid": ..., "sid": ...}`` dict in the RPC JSON meta
    (``wire_context()`` / the worker's ``parent=`` — scalars only, no
    wire-protocol dtype changes, see ``transport.TRACE_META_KEY``);
  * completed spans are buffered per process and appended as JSONL to
    ``$REPRO_TRACE_DIR`` (default ``./repro_trace``), one file per
    process.  The buffer flushes whenever a thread's span stack unwinds to
    empty (so a worker that is later SIGKILL'd has already persisted every
    finished request) and again at interpreter exit;
  * ``python -m repro_torch.obs render <dir>`` merges the JSONL files into
    Chrome trace-event JSON (Perfetto/chrome://tracing-ready).

``capture_begin()``/``capture_end()`` additionally tee the emitting
thread's spans into a thread-local list — the flight recorder uses this
to attach the full span tree to slow-query exemplars without re-reading
the files.

A second sink, independent of ``REPRO_TRACE``: while a torch profiler is
collecting, ``span(name)`` also opens a host range ``repro.<name>`` in the
profile (``torch._C._profiler._RecordFunctionFast``, a plain host range:
never a user annotation, which the profiler would copy onto the device's
timeline), on the same wall clock as the JSONL spans.  The device records
launched inside a range can then be put down to the span, and the card's
idle gaps to the host work around them.  The profiler is found through
``sys.modules``, so this module never imports torch; a torch without
``_RecordFunctionFast`` gets no ranges.
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import sys
import threading
import time

__all__ = ["enabled", "trace_dir", "set_process_label", "span", "event",
           "record_span", "current", "wire_context", "flush",
           "capture_begin", "capture_end"]


# Read the env per call (the racecheck pattern): tests and launchers flip
# ``REPRO_TRACE`` at runtime and workers inherit it via the env.  But
# ``os.environ.get`` on an UNSET key — the tracing-off common case — goes
# through ``MutableMapping.get``'s raise-and-catch KeyError path (~1µs per
# call), which alone would blow the §12.4 off-path budget.  CPython backs
# ``os.environ`` with a plain dict (``_data``); reading it directly with
# the mapping's own key codec is the same live view (``__setitem__`` /
# ``monkeypatch.setenv`` mutate it in place) at plain-dict-get cost.
try:
    _ENV = os.environ._data
    _KEY = os.environ.encodekey("REPRO_TRACE")
    _ON = os.environ.encodevalue("1")
except Exception:                     # non-CPython: correct, just slower
    _ENV, _KEY, _ON = os.environ, "REPRO_TRACE", "1"


def enabled() -> bool:
    return _ENV.get(_KEY) == _ON


def trace_dir() -> str:
    return (os.environ.get("REPRO_TRACE_DIR")
            or os.path.join(os.getcwd(), "repro_trace"))


_tls = threading.local()
_lock = threading.Lock()
_buffer: list = []
_label = ""                      # process label; pid-suffixed in filenames
_registered = False
_span_seq = itertools.count(1)


def set_process_label(label: str) -> None:
    global _label
    _label = label


# The pid, read once a process: ``os.getpid()`` is a system call, which on a
# virtualised host costs microseconds, and a traced span read it twice.
_pid = os.getpid()


def _reset_pid() -> None:
    global _pid
    _pid = os.getpid()


os.register_at_fork(after_in_child=_reset_pid)


def _proc_label() -> str:
    return _label or f"pid{_pid}"


def _now_us() -> int:
    # wall clock: the one timestamp comparable across processes on a host
    return time.time_ns() // 1000


def _new_trace_id() -> str:
    return os.urandom(8).hex()


def _new_span_id() -> int:
    # pid in the high bits: ids stay unique across the router + W workers
    return (_pid << 24) | (next(_span_seq) & 0xFFFFFF)


def _emit(rec: dict) -> None:
    cap = getattr(_tls, "capture", None)
    if cap is not None:
        cap.append(rec)
    global _registered
    with _lock:
        _buffer.append(rec)
        if not _registered:
            _registered = True
            atexit.register(flush)
    if not getattr(_tls, "stack", None):
        flush()                  # root unwound: persist the finished tree


def flush() -> None:
    """Append every buffered span to this process's JSONL file."""
    with _lock:
        if not _buffer:
            return
        recs, _buffer[:] = list(_buffer), []
    d = trace_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"spans-{_proc_label()}-{_pid}.jsonl")
    with open(path, "a", encoding="utf-8") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


class _NullSpan:
    """Shared tracing-off stand-in: no state, no clock, no allocation."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()

RANGE_PREFIX = "repro."          # the profiler sink's range names


def _profiler_range(name: str):
    """A ``repro.<name>`` host range while a torch profiler collects, else
    None: one ``sys.modules`` lookup and a flag read when none does."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    fast = getattr(sys.modules["torch"]._C._profiler, "_RecordFunctionFast", None)
    return None if fast is None else fast(RANGE_PREFIX + name)


class _Range:
    """The profiler sink alone (tracing off): the host range and nothing
    else, with ``Span``'s ``set`` as a no-op."""
    __slots__ = ("_range",)

    def __init__(self, rng):
        self._range = rng

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False

    def set(self, **attrs):
        return self


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_ts", "_t0", "_range")

    def __init__(self, name: str, trace_id: str, parent_id, attrs: dict,
                 rng=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self._range = rng

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        if self._range is not None:
            self._range.__enter__()
        self._ts = _now_us()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = (time.perf_counter_ns() - self._t0) // 1000
        if self._range is not None:
            self._range.__exit__(*exc)
        _tls.stack.pop()
        _emit({"ph": "X", "name": self.name, "tid": self.trace_id,
               "sid": self.span_id, "psid": self.parent_id,
               "ts": self._ts, "dur": int(dur), "proc": _proc_label(),
               "thread": threading.get_ident() % 1_000_000,
               "args": self.attrs})
        return False


def current():
    """(trace_id, span_id) of this thread's innermost open span, or None.

    Capture it before handing work to a pool thread and pass it back as
    ``span(..., parent=ctx)`` — context does not cross threads on its own.
    """
    stack = getattr(_tls, "stack", None)
    if stack:
        top = stack[-1]
        return (top.trace_id, top.span_id)
    return None


def span(name: str, parent=None, **attrs):
    """Context manager for one span; a no-op singleton when tracing is off.

    ``parent`` is an explicit ``(trace_id, span_id)`` (cross-thread /
    cross-process); otherwise the thread's current span is the parent and
    a parentless span starts a fresh trace.  While a torch profiler
    collects, the span is also a ``repro.<name>`` range of the profile.
    """
    rng = _profiler_range(name)
    if _ENV.get(_KEY) != _ON:         # enabled(), inlined: §12.4 hot path
        return _NULL if rng is None else _Range(rng)
    if parent is None:
        parent = current()
    if parent is None:
        return Span(name, _new_trace_id(), None, attrs, rng)
    return Span(name, parent[0], parent[1], attrs, rng)


def record_span(name: str, dur_ms: float, parent=None, **attrs) -> None:
    """Emit a completed span ending now (e.g. queue-wait measured from an
    enqueue timestamp: the interval was over before tracing saw it)."""
    if _ENV.get(_KEY) != _ON:         # enabled(), inlined: §12.4 hot path
        return
    if parent is None:
        parent = current()
    tid, psid = parent if parent is not None else (_new_trace_id(), None)
    dur_us = max(0, int(dur_ms * 1000.0))
    _emit({"ph": "X", "name": name, "tid": tid, "sid": _new_span_id(),
           "psid": psid, "ts": _now_us() - dur_us, "dur": dur_us,
           "proc": _proc_label(),
           "thread": threading.get_ident() % 1_000_000, "args": attrs})


def event(name: str, parent=None, **attrs) -> None:
    """Zero-duration instant event (hedge winner marks, failovers, …)."""
    if _ENV.get(_KEY) != _ON:         # enabled(), inlined: §12.4 hot path
        return
    if parent is None:
        parent = current()
    tid, psid = parent if parent is not None else (_new_trace_id(), None)
    _emit({"ph": "i", "name": name, "tid": tid, "sid": _new_span_id(),
           "psid": psid, "ts": _now_us(), "dur": 0, "proc": _proc_label(),
           "thread": threading.get_ident() % 1_000_000, "args": attrs})


def wire_context():
    """Trace context for the RPC JSON meta, or None (key omitted) when
    tracing is off / no span is open — scalars only, never a dtype."""
    ctx = current()
    if ctx is None:
        return None
    return {"tid": ctx[0], "sid": ctx[1]}


def capture_begin() -> None:
    """Start teeing this thread's spans (flight-recorder exemplars)."""
    if _ENV.get(_KEY) == _ON:         # enabled(), inlined: §12.4 hot path
        _tls.capture = []


def capture_end() -> list:
    """Stop teeing; returns the spans captured since ``capture_begin``."""
    cap = getattr(_tls, "capture", None)
    _tls.capture = None
    return cap or []
