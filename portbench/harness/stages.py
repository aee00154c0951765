"""The program's stages in a traced window.

While a profiler collects, the program opens a host range ``repro.<span>``
around each of its spans (``repro_torch.obs.trace``), nested as the spans
are: ``repro.engine_request`` > ``repro.engine_batch`` > ``repro.phase_a``
> ``repro.stage_hash``, and so on.  This module puts the kept window's
device time and idle gaps down to those ranges.

**Device records, by their launch.**  A device record belongs to the host
call that launched it, never to the host work at its own time: at bulk the
host runs a batch ahead of the card.  The profiler links the two: a device
record and the launch call (``LAUNCH_CALLS``) that put it on the card share
a correlation id, and a record is put down to the call with its id; one
whose id names no launch call in the window is unattributed.  This holds on
any number of streams, as on a rank under NCCL, whose collectives run on a
stream of their own.  Records without ids (made by hand) are linked by
order instead, which holds on one stream only: the card's n-th device
record (kernel, copy or set, by start) is the work of the host's n-th
launch call, by start; where the two counts differ, order proves nothing
and every record is unattributed.  Where both links exist, the share of
device time on which they agree is kept as a cross-check (``order_agrees``,
in the log's table).  A window with no device record (a run on the CPU) is
unattributed.  A record's stack is the ``repro.*`` ranges around its launch
call, outermost first; its stage is the innermost, and a record launched
outside every range is ``UNATTRIBUTED``.

**Idle gaps, by the host around them.**  A gap with no device record is
named by the stack of ranges around its middle: the program's host work
that the card waited on; a gap outside every range is the client's
(``OUTSIDE``).

The ranges of one thread nest, so each query is a sweep over a stack of
open ranges.  A window without ranges (a program that opens none) gives
``None`` to every reader here.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.harness.profiling import Record, Window

__all__ = ["PREFIX", "LAUNCH_CALLS", "UNATTRIBUTED", "OUTSIDE", "Stages", "of",
           "device_ms_per_batch", "program_idle_ms_per_batch"]

PREFIX = "repro."      # obs.trace.RANGE_PREFIX, not imported: a program without it reads None
# Host calls that put one record on the card, by the name's start: the CUDA
# runtime's launches, copies and sets, and ``cuLaunchKernel`` (Triton's path).
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
UNATTRIBUTED = "unattributed"
OUTSIDE = "outside the program"

Stack = Tuple[str, ...]


def _stacks(ranges: Sequence[Record], times: Sequence[float]) -> List[Stack]:
    """The stack of range names (prefix cut) open at each time, outermost
    first.  ``ranges`` sorted by start (the outer first on a tie)."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out: List[Stack] = [()] * len(times)
    open_: List[Record] = []
    names: List[str] = []
    nxt = 0
    for k in order:
        t = times[k]
        while nxt < len(ranges) and ranges[nxt].start_us <= t:
            r = ranges[nxt]
            while open_ and open_[-1].end_us <= r.start_us:
                open_.pop()
                names.pop()
            open_.append(r)
            names.append(r.name[len(PREFIX):])
            nxt += 1
        while open_ and open_[-1].end_us < t:
            open_.pop()
            names.pop()
        out[k] = tuple(names)
    return out


class Stages:
    """A window's device records and idle gaps, each with its stack."""

    def __init__(self, window: Window):
        self.window = window
        recs = window.records
        self.ranges = sorted((r for r in recs if r.kind == "cpu" and r.name.startswith(PREFIX)),
                             key=lambda r: (r.start_us, -r.end_us))
        calls = sorted((r for r in recs if r.kind == "cpu" and r.name.startswith(LAUNCH_CALLS)),
                       key=lambda r: r.start_us)
        self.device = sorted(window.device, key=lambda r: r.start_us)
        self.launch_calls = len(calls)
        by_order = None
        if self.device and len(calls) == len(self.device):
            by_order = _stacks(self.ranges, [c.start_us for c in calls])
        self.by_id = bool(self.device) and all(r.correlation for r in self.device)
        self.unmatched = 0
        self.order_agrees: Optional[float] = None
        if self.by_id:
            call_of = {c.correlation: c for c in calls}
            found = [call_of.get(r.correlation) for r in self.device]
            self.unmatched = sum(c is None for c in found)
            linked = _stacks(self.ranges, [c.start_us if c else -1.0 for c in found])
            self.stacks = [s if c else () for s, c in zip(linked, found)]
            if by_order is not None:
                us = [r.end_us - r.start_us for r in self.device]
                same = sum(u for u, a, b in zip(us, self.stacks, by_order) if a == b)
                self.order_agrees = 100.0 * same / max(sum(us), 1e-9)
        else:
            self.stacks = by_order or [()] * len(self.device)
        self.linked = self.by_id or by_order is not None
        self.gaps = _gaps(self.device, window.t0_us, window.t1_us)
        self.gap_stacks = _stacks(self.ranges, [(a + b) / 2 for a, b in self.gaps])

    def device_us(self, stage: str) -> Optional[float]:
        """Device us of the records launched under ``repro.<stage>`` (at any
        depth); None when the window has no such range."""
        if not any(r.name == PREFIX + stage for r in self.ranges):
            return None
        return sum(r.end_us - r.start_us for r, s in zip(self.device, self.stacks)
                   if stage in s)

    def device_by_stage(self) -> Dict[str, float]:
        """Device us by innermost stage, with ``UNATTRIBUTED``."""
        out: Dict[str, float] = {}
        for r, s in zip(self.device, self.stacks):
            key = s[-1] if s else UNATTRIBUTED
            out[key] = out.get(key, 0.0) + r.end_us - r.start_us
        return out

    def idle_by_stage(self) -> Dict[str, float]:
        """Idle us of the window by the innermost stage around each gap's
        middle, with ``OUTSIDE``."""
        out: Dict[str, float] = {}
        for (a, b), s in zip(self.gaps, self.gap_stacks):
            key = s[-1] if s else OUTSIDE
            out[key] = out.get(key, 0.0) + b - a
        return out

    def program_idle_us(self) -> Optional[float]:
        """Idle us whose gap's middle lies inside a ``repro.*`` range; None
        without ranges or without device records."""
        if not self.ranges or not self.device:
            return None
        return sum(b - a for (a, b), s in zip(self.gaps, self.gap_stacks) if s)

    def table(self) -> List[str]:
        """The log's per-stage lines: ms a batch of device and idle time."""
        per = 1e3 * max(self.window.batches, 1)
        dev, idle = self.device_by_stage(), self.idle_by_stage()
        dev.setdefault(UNATTRIBUTED, 0.0)
        total = sum(dev.values())
        if self.by_id:
            how = (f", linked by correlation id ({self.unmatched} unmatched); launch order "
                   + ("unchecked (counts differ)" if self.order_agrees is None else
                      f"agrees on {self.order_agrees:.2f}% of device time"))
        else:
            how = "" if self.linked else " (counts differ: unattributed)"
        lines = [f"stages: {len(self.ranges)} ranges, {len(self.device)} device records, "
                 f"{self.launch_calls} launch calls" + how]
        for name, us in sorted(dev.items(), key=lambda kv: -kv[1]):
            lines.append(f"stage device {name}: {us / per:.4f} ms a batch "
                         f"({100 * us / max(total, 1e-9):.2f}%)")
        for name, us in sorted(idle.items(), key=lambda kv: -kv[1]):
            lines.append(f"stage idle {name}: {us / per:.4f} ms a batch")
        return lines


def _gaps(device: Sequence[Record], t0: float, t1: float) -> List[Tuple[float, float]]:
    """Intervals of [t0, t1] with no device record (as ``Window.idle_gaps``)."""
    gaps, t = [], t0
    for r in device:
        if r.start_us > t:
            gaps.append((t, min(r.start_us, t1)))
        t = max(t, r.end_us)
        if t >= t1:
            break
    if t1 > t:
        gaps.append((t, t1))
    return [(a, b) for a, b in gaps if b > a]


_LAST: list = [None, None]          # the last window read, and its Stages


def of(run) -> Optional[Stages]:
    """The kept window's ``Stages`` (built once a window, its table then
    written to standard error, the run's log), or None untraced."""
    w = run.profile
    if w is None:
        return None
    if _LAST[0] is not w:
        _LAST[:] = [w, Stages(w)]
        if _LAST[1].ranges and _LAST[1].device:
            for line in _LAST[1].table():
                print(line, file=sys.stderr, flush=True)
    return _LAST[1]


def device_ms_per_batch(run, stage: str) -> Optional[float]:
    """Device ms a batch of the records launched under ``repro.<stage>``;
    None when no record could be put down to a launch or the window has no
    such range."""
    st = of(run)
    if st is None or not st.linked or not st.window.batches:
        return None
    us = st.device_us(stage)
    return None if us is None else us / 1e3 / st.window.batches


def program_idle_ms_per_batch(run) -> Optional[float]:
    """Idle ms a batch whose gap lies inside the program's own ranges."""
    st = of(run)
    if st is None or not st.window.batches:
        return None
    us = st.program_idle_us()
    return None if us is None else us / 1e3 / st.window.batches
