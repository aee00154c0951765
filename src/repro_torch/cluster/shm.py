"""Shared-memory slab rings: the same-host zero-copy fast path of the
process transport, the port's own copy of ``repro.cluster.shm`` (DESIGN.md
§13).

Array payloads above a size threshold skip the socket: the sender claims a
slot in a ``multiprocessing.shared_memory`` ring slab, writes the array
bytes there once (or builds them in place), and the RPC frame carries only
a JSON descriptor (segment name, offset, dtype, shape).  The receiver maps
the segment and hands back an ``np.frombuffer`` view.  The ``WIRE_METRICS``
counters below attribute every payload byte to the socket or the slab.

Slot lifecycle: each status byte has exactly one writer at a time, so no
cross-process atomics are needed.

  * request direction (``rel='s'``, sender-released): the client claims
    the slot, the worker borrows a read view while serving, and the client
    frees the slot when the response frame arrives, so the worker must not
    keep request views past its response;
  * response direction (``rel='r'``, receiver-released): the worker claims
    a slot in its own ring and the client frees it through a
    ``weakref.finalize`` on the borrowed array, when the last result view
    dies.  A client that vanishes instead is handled by
    ``SlabRing.reset()`` on connection teardown.

Torn slabs (a SIGKILL'd owner leaks its ``/dev/shm`` file) are reaped by
:func:`reap_orphan_slabs`: the owner pid is in the segment name, so any
surviving process can unlink segments whose owner is gone.  The grid
spawner runs it at connect time, the router at every recovery and the
launcher's supervisor on every sweep.

The port names its segments ``rwtshm-<pid>-...`` (``SHM_PREFIX``), not the
JAX package's ``rwshm-``: the two packages' slabs never mix, so neither
package's reaper collects the other's segments and each package's tests
can hold the ``/dev/shm`` population under its own prefix to a baseline
while the other's run beside them.

Stdlib only (the port's ``obs`` is stdlib-only too): this layer moves
bytes; the typed descriptor codec (dtype whitelist included) is in
``transport.py``.
"""
from __future__ import annotations

import os
import threading
import uuid
from multiprocessing import resource_tracker, shared_memory
from typing import List, Optional, Tuple

from repro_torch.obs import MetricsRegistry

__all__ = ["SHM_PREFIX", "WIRE_METRICS", "SlabRing", "SlabReader",
           "StagedPayload", "attach_segment", "count", "wire_counters",
           "reap_orphan_slabs", "list_slabs"]

SHM_PREFIX = "rwtshm-"
SHM_DIR = "/dev/shm"

# Process-local wire accounting (DESIGN.md §12): payload bytes that hit
# the socket vs. the slab, staging fallbacks (ring full / payload too
# big), and reaped orphans.  Transport send/recv sites on pool threads
# race these counters, so every bump goes through :func:`count`'s lock.
WIRE_METRICS = MetricsRegistry("wire")
_COUNT_LOCK = threading.Lock()


def count(key: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        WIRE_METRICS[key] += n


def wire_counters() -> dict:
    with _COUNT_LOCK:
        return dict(WIRE_METRICS.as_dict())


_ATTACH_LOCK = threading.Lock()


def _no_register(*args, **kwargs) -> None:
    return None


def attach_segment(name: str) -> shared_memory.SharedMemory:
    """Map an existing segment WITHOUT adopting ownership.

    CPython 3.10's ``SharedMemory`` registers every mapping — attaches
    included — with the resource tracker, which would unlink the owner's
    live segment when *this* process exits (3.13 grew ``track=False``
    for exactly this).  Registration is suppressed for the attach rather
    than undone after it: the tracker's per-name cache is a set, so an
    unregister from an attacher that shares the creator's process
    (tests, in-proc loopbacks) would strand the creator's entry and spew
    KeyErrors at exit.  Cleanup stays with the owner — and with
    :func:`reap_orphan_slabs` when the owner is SIGKILL'd.
    """
    with _ATTACH_LOCK:
        orig = resource_tracker.register
        resource_tracker.register = _no_register
        try:
            return shared_memory.SharedMemory(name=name, create=False)
        finally:
            resource_tracker.register = orig


def _quiet_close(seg: shared_memory.SharedMemory) -> None:
    """Close a segment whose buffer may still have borrowed views.

    A late hedge loser (or a caller-held result view) keeps the mmap
    exported; in that case leak the mapping — it dies with the views or
    the process — but drop the fd now and disarm ``__del__``'s retry so
    interpreter exit stays silent.
    """
    try:
        seg.close()
    except BufferError:
        seg._mmap = None
        if seg._fd >= 0:
            os.close(seg._fd)
            seg._fd = -1


class SlabRing:
    """Owner side of one ring slab: N fixed-size slots + status bytes.

    Layout: ``slots`` status bytes (0=free, 1=in-flight) followed by
    ``slots`` payload regions of ``slot_bytes`` each.  ``stage()`` hands
    out a writable view over a claimed slot; whoever the ``rel``
    protocol designates writes the status byte back to 0.  A full ring
    is not an error — callers fall back to the socket path (counted).
    """

    def __init__(self, slots: int = 8, slot_bytes: int = 1 << 20,
                 tag: str = "tx"):
        if not 1 <= slots <= 255:
            raise ValueError(f"slots must be in [1, 255]; got {slots}")
        self.slots = int(slots)
        self.slot_bytes = int(slot_bytes)
        self.name = f"{SHM_PREFIX}{os.getpid()}-{tag}-{uuid.uuid4().hex[:8]}"
        self._shm = shared_memory.SharedMemory(
            name=self.name, create=True,
            size=self.slots + self.slots * self.slot_bytes)
        self._shm.buf[: self.slots] = bytes(self.slots)
        self._lock = threading.Lock()
        self._next = 0
        self._closed = False

    def stage(self, nbytes: int) -> Optional[Tuple[int, int, memoryview]]:
        """Claim a free slot; returns (slot, absolute offset, writable
        view of exactly ``nbytes``), or None (ring full / too big)."""
        if self._closed or nbytes > self.slot_bytes:
            return None
        with self._lock:
            for k in range(self.slots):
                slot = (self._next + k) % self.slots
                if self._shm.buf[slot] == 0:
                    self._shm.buf[slot] = 1
                    self._next = slot + 1
                    off = self.slots + slot * self.slot_bytes
                    return slot, off, self._shm.buf[off: off + nbytes]
        return None

    def release(self, slot: int) -> None:
        if not self._closed:
            self._shm.buf[slot] = 0

    def free_slots(self) -> int:
        if self._closed:
            return 0
        return sum(1 for s in range(self.slots) if self._shm.buf[s] == 0)

    def reset(self) -> None:
        """Free every slot — the peer holding the borrows is gone
        (connection teardown); its views can never release them."""
        if not self._closed:
            self._shm.buf[: self.slots] = bytes(self.slots)

    def close(self) -> None:
        """Unlink + unmap.  Borrowed views may outlive us (late hedge
        losers); the unlink still reclaims the name now and the mapping
        itself dies with the last view / the process."""
        if self._closed:
            return
        self._closed = True
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass                # already reaped (we were presumed dead)
        _quiet_close(self._shm)


class SlabReader:
    """Receiver-side cache of attached slab segments, keyed by name.

    Attach is lazy (the descriptor itself names the segment, so no
    handshake precedes the first shm frame) and sticky — one mmap per
    peer segment for the connection's lifetime.
    """

    def __init__(self):
        self._segs: dict = {}
        self._lock = threading.Lock()

    def segment(self, name: str) -> shared_memory.SharedMemory:
        with self._lock:
            seg = self._segs.get(name)
            if seg is None:
                seg = self._segs[name] = attach_segment(name)
            return seg

    def view(self, name: str, off: int, nbytes: int) -> memoryview:
        return self.segment(name).buf[off: off + nbytes]

    def release_slot(self, name: str, slot: int) -> None:
        """Receiver-released slots (``rel='r'``): write the status byte
        free through our mapping.  The owner may already be dead and
        reaped — then there is nothing left to release."""
        try:
            self.segment(name).buf[slot] = 0
        except (FileNotFoundError, OSError, ValueError):
            pass

    def close(self) -> None:
        with self._lock:
            for seg in self._segs.values():
                _quiet_close(seg)
            self._segs.clear()


class StagedPayload:
    """One slab-staged array shared by several sends (router fan-out).

    The stager holds the first reference; every ``send_frame`` acquires
    one more and drops it when its response (or failure) retires the
    frame.  The slot returns to the ring only when the LAST reference
    drops — a hedge loser still writing its frame cannot see the slot
    recycled under it.  ``acquire()`` after retirement raises instead of
    resurrecting the slot (the late sender's RPC fails like any dead
    connection; nobody reads a recycled buffer).
    """

    def __init__(self, ring: SlabRing, slot: int, desc: dict):
        self.ring = ring
        self.slot = slot
        self.desc = desc
        self._refs = 1
        self._lock = threading.Lock()

    def acquire(self) -> dict:
        with self._lock:
            if self._refs <= 0:
                raise RuntimeError("staged payload already retired")
            self._refs += 1
        return self.desc

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            done = self._refs == 0
        if done:
            self.ring.release(self.slot)


# -- orphan reaping ----------------------------------------------------------

def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def list_slabs() -> List[str]:
    """Every live slab segment name (tests assert the /dev/shm delta)."""
    try:
        return sorted(fn for fn in os.listdir(SHM_DIR)
                      if fn.startswith(SHM_PREFIX))
    except OSError:
        return []


def reap_orphan_slabs() -> List[str]:
    """Unlink slab segments whose owner pid is gone (SIGKILL leftovers).

    The owner pid is the first field of the segment name, so liveness is
    one ``kill(pid, 0)`` — no registry, no lock file.  Runs at grid
    connect, replica recovery, and every supervisor sweep; safe to race
    (unlink losers just skip).
    """
    reaped: List[str] = []
    for fn in list_slabs():
        parts = fn[len(SHM_PREFIX):].split("-")
        try:
            pid = int(parts[0])
        except (ValueError, IndexError):
            continue
        if _pid_alive(pid):
            continue
        try:
            os.unlink(os.path.join(SHM_DIR, fn))
        except OSError:
            continue
        reaped.append(fn)
    if reaped:
        count("shm_slabs_reaped", len(reaped))
    return reaped
