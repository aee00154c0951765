"""Device records of a traced window, from ``torch.profiler``.

A window is a run of whole requests under ``torch.profiler.profile``.  Its
device records (kernels, copies, sets) give the busy time (the union of
their intervals), the device time by kernel, and the idle gaps; its host
records name what the host was doing in each gap.

The profiler on the H100 machine has been seen to lose device records (one
device event in ten calls of a two-launch call).  A window short of records
reads short of busy time and of kernel time, so every window is checked
against the port's own launch counters: each entry point's device kernels
must appear exactly as often as the entry point was launched.  Of several
windows the complete one with the most device records is kept; when none
is complete the traced run fails (``LossyTrace``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Record", "Window", "LossyTrace", "records_from_profiler", "keep_fullest",
           "union_us", "short_name"]

ANNOTATION_PREFIX = "portbench."    # the harness's own record_function names


@dataclass
class Record:
    name: str
    kind: str           # 'kernel', 'gpu_memcpy', 'gpu_memset' or 'cpu'
    start_us: float
    end_us: float
    correlation: int = 0    # the profiler's correlation id: a device record's and its launch call's


@dataclass
class Window:
    """One profiled run of whole requests."""

    first_request: int
    requests: int
    batches: int
    t0_us: float                     # host clock at its first request (profiler time)
    t1_us: float                     # host clock at its last answer
    records: List[Record]
    launched: Dict[str, int]         # the port's launch counters, this window
    missing: Dict[str, int] = field(default_factory=dict)

    @property
    def device(self) -> List[Record]:
        return [r for r in self.records if r.kind != "cpu"]

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us([(r.start_us, r.end_us) for r in self.device],
                        self.t0_us, self.t1_us) / 1e6

    def _kernels(self) -> Dict[str, Tuple[int, float]]:
        """Kernel name -> (records, device us)."""
        by = {}
        for r in self.records:
            if r.kind == "kernel":
                n, us = by.get(r.name, (0, 0.0))
                by[r.name] = (n + 1, us + r.end_us - r.start_us)
        return by

    def kernel_s(self, names: Sequence[str]) -> float:
        """Device seconds of the kernels whose identifier is one of ``names``."""
        pat = _identifier(names)
        return sum(us for name, (_, us) in self._kernels().items() if pat.search(name)) / 1e6

    def kernel_count(self, names: Sequence[str] = ()) -> int:
        """Kernel records, of the identifiers ``names`` if given."""
        pat = _identifier(names) if names else None
        return sum(n for name, (n, _) in self._kernels().items()
                   if pat is None or pat.search(name))

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        total: Dict[str, float] = {}
        for r in self.device:
            key = short_name(r.name)
            total[key] = total.get(key, 0.0) + (r.end_us - r.start_us) / 1e6
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` longest device-idle intervals inside the window, each
        named by the innermost host operation around its middle."""
        spans = sorted((r.start_us, r.end_us) for r in self.device)
        gaps, t = [], self.t0_us
        for a, b in spans:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1_us > t:
            gaps.append((t, self.t1_us))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [r for r in self.records if r.kind == "cpu"]
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            around = [r for r in host if r.start_us <= mid <= r.end_us]
            name = (min(around, key=lambda r: r.end_us - r.start_us).name
                    if around else "host outside any traced operation")
            out.append((name, (b - a) / 1e6))
        return out


class LossyTrace(RuntimeError):
    pass


def _identifier(names: Sequence[str]):
    """A kernel identifier as a whole word, demangled (``ns::name<...>(...)``)
    or mangled (``13gather_kernelEPKi...``), and never one of torch's own
    (``at::native::...``, ``vectorized_gather_kernel``)."""
    alts = "|".join(re.escape(n) for n in names)
    return re.compile(rf"^(?!.*\bat::)(?:.*?)(?<![A-Za-z_])(?:{alts})(?![a-z0-9_])")


def short_name(name: str) -> str:
    """A kernel's identifier without its return type, namespace and
    arguments; other names as they are, cut to 96 characters."""
    base = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    base = base.split("(")[0].split("<")[0].split("::")[-1]
    return (base or name)[:96]


def union_us(spans: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of intervals, clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(spans):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def _device_kind(name: str) -> str:
    """A device record's kind by its name: a copy, a set or a kernel."""
    low = name.lower()
    if "memcpy" in low:
        return "gpu_memcpy"
    if "memset" in low:
        return "gpu_memset"
    return "kernel"


def records_from_profiler(prof) -> List[Record]:
    """The records of a finished profile, in microseconds on the profiler's
    clock, each with its correlation id: each host event (operations,
    runtime calls, the harness's annotations, the program's ``repro.*``
    ranges) as a ``cpu`` record, and each device event by its kind, but for
    the device-side copies of host ranges: the harness's annotations
    (``portbench.*``) and torch.distributed's (``nccl:all_gather`` spans the
    collective's kernel on the card), which bear their host range's name and
    are no work of their own.  The kind is read from the name alone: torch
    2.11's events have no ``activity_type()``; the program's ranges are
    never user annotations, so they have no device-side copy."""
    events = list(prof.profiler.kineto_results.events())
    on_card = [str(e.device_type()).endswith("CUDA") for e in events]
    host_names = {e.name() for e, card in zip(events, on_card) if not card}
    out = []
    for e, card in zip(events, on_card):
        name = e.name()
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        corr = int(e.correlation_id())
        if not card:
            out.append(Record(name, "cpu", start, end, corr))
        elif not name.startswith(ANNOTATION_PREFIX) and name not in host_names:
            out.append(Record(name, _device_kind(name), start, end, corr))
    return out


def keep_fullest(windows: List[Window], kernels: Dict[str, Sequence[str]]) -> Window:
    """Check each window's device kernels against the launch counters and
    return the complete window with the most device records; raise
    ``LossyTrace`` when every window lost records."""
    complete: List[Window] = []
    for w in windows:
        w.missing = {}
        for entry, names in kernels.items():
            want = w.launched.get(entry, 0)
            got = w.kernel_count(names)
            if got != want:
                w.missing[entry] = want - got
        if not w.missing:
            complete.append(w)
    if not complete:
        raise LossyTrace(
            "every profiled window lost device records: "
            + "; ".join(f"window {i}: {w.missing} (launched minus recorded)"
                        for i, w in enumerate(windows)))
    return max(complete, key=lambda w: len(w.device))


def window_bounds(records: List[Record], marker: str) -> Optional[Tuple[float, float]]:
    """First start and last end of the host annotations named ``marker``."""
    marks = [r for r in records if r.kind == "cpu" and r.name == marker]
    if not marks:
        return None
    return min(r.start_us for r in marks), max(r.end_us for r in marks)
