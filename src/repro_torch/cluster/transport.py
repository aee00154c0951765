"""Length-prefixed binary RPC transport for shard workers, the port's own
copy of ``repro.cluster.transport`` (DESIGN.md §10, §13).

The port's multi-process cluster (``repro_torch.cluster.worker`` /
``RemoteReplica``) speaks this wire protocol over stream sockets:
``AF_UNIX`` for same-host workers, ``AF_INET`` (``listen_tcp`` /
``connect_tcp``) for workers placed by ``host:port``, and, same-host only,
a shared-memory fast path: arrays past a size threshold travel in
``repro_torch.cluster.shm`` ring slabs while the socket frame carries a
JSON descriptor (segment, offset, dtype, shape).  One ``Connection``
fronts all three.  The frames are the JAX package's, byte for byte (magic,
layout, dtype codes, the ``trace`` and ``shmv`` meta keys), so a frame one
package sends the other reads.  Design constraints, in order:

  * **no pickle** — a query batch is a numpy array and crosses the wire as
    its raw buffer plus a descriptor; small scalar metadata (method name,
    seq numbers, counts) rides in a compact JSON header, arrays never do;
  * **zero-copy where it counts** — the sender hands array buffers
    (``memoryview``) straight to the socket (large frames go as separate
    ``sendall`` calls; small frames are coalesced, where one copy is
    cheaper than extra syscalls).  The receiver reads the whole frame into
    one buffer and returns ``np.frombuffer`` views into it;
  * **self-delimiting frames** — a ``u64`` length prefix, then a magic,
    kind, request id and typed array descriptors.  A torn or corrupt frame
    (dead peer mid-write) surfaces as ``ConnectionError``, which the
    replica proxy maps to ``ReplicaKilled``, so the router's failover
    handles a SIGKILL'd worker like any dead replica.

Frame layout (little-endian)::

    u64 frame_len                    bytes after this field
    u32 magic      0x52504331 'RPC1'
    u8  kind       1=request  2=response  3=error
    u32 req_id     echoes the request on its response/error
    u32 meta_len   JSON header length
    u8  n_arrays   INLINE arrays only (slab-staged arrays ride the meta)
    meta           UTF-8 JSON (method + scalars; errors: etype/emsg)
    per array:     u8 dtype_code  u8 ndim  u32 shape[ndim]
    array bytes    raw buffers, back to back, in descriptor order

Slab-staged arrays are NOT in the binary array section: each one is a
JSON descriptor under the ``shmv`` meta key — ``{"i": original position,
"seg": segment, "slot": n, "off": bytes, "dt": wire dtype code, "sh":
shape, "rel": 's'|'r'}`` — and the receiver re-interleaves them with the
inline arrays by position, so callers never see which tier a given array
took.  Descriptors are scalars-only JSON plus the same closed dtype-code
table as the binary section: no pickle enters the protocol through the
fast path.

Exceptions raised by a worker's handler are shipped back as an ERROR frame
carrying the exception class name; :func:`raise_remote_error` re-raises the
port's matching class (``ReplicaKilled``, ``ReplicaDiverged``,
``RaceViolation``, ``ValueError``, …), so cross-process errors behave as
in-process ones.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import shm

__all__ = ["Connection", "RemoteError", "WIRE_DTYPES", "TRACE_META_KEY",
           "KIND_REQUEST", "KIND_RESPONSE", "KIND_ERROR", "SHM_META_KEY",
           "send_frame", "recv_frame", "listen_unix", "connect_unix",
           "listen_tcp", "connect_tcp", "tune_tcp", "parse_address",
           "listen_address", "connect_address", "bound_endpoint",
           "stage_buffer", "raise_remote_error"]

# Distributed tracing (DESIGN.md §12) rides the JSON meta under this key as
# {"tid": <hex trace id>, "sid": <int span id>} — scalars in the existing
# header, so trace propagation changes NOTHING about the wire protocol: no
# new frame kind, no new dtype code, no array payload.  Absent when tracing
# is off (the common case costs zero header bytes).
TRACE_META_KEY = "trace"

# Slab-staged array descriptors ride the JSON meta under this key (see the
# frame-layout notes above); ``rel`` says which side frees the slot —
# 's' = the sender, when the response to this request arrives; 'r' = the
# receiver, when its last borrowed view of the array dies.
SHM_META_KEY = "shmv"
REL_SENDER = "s"
REL_RECEIVER = "r"

_MAGIC = 0x52504331                       # 'RPC1'
_PREAMBLE = struct.Struct("<Q")           # frame_len
_FIXED = struct.Struct("<IBIIB")          # magic, kind, req_id, meta_len, n_arrays
_DESC = struct.Struct("<BB")              # dtype_code, ndim
_DIM = struct.Struct("<I")

KIND_REQUEST = 1
KIND_RESPONSE = 2
KIND_ERROR = 3

# The closed set of dtypes the cluster moves; a wire protocol enumerates its
# types explicitly instead of trusting dtype strings from the peer.  The
# codec derives its code table from this tuple.  Codes are tuple positions,
# so the order is part of the protocol (the JAX package's, the same): append
# only.
WIRE_DTYPES: Tuple[np.dtype, ...] = tuple(np.dtype(t) for t in (
    np.int32, np.int64, np.uint32, np.uint64, np.float32, np.float64,
    np.uint8, np.int8, np.int16, np.uint16, np.bool_))
_DTYPES: List[np.dtype] = list(WIRE_DTYPES)
_DTYPE_CODE: Dict[np.dtype, int] = {dt: i for i, dt in enumerate(WIRE_DTYPES)}

# one frame bounded well above any legitimate payload (a full shard state
# transfer); a corrupt length prefix must not trigger a huge allocation
_MAX_FRAME = 1 << 34

# below this, coalescing into one send beats per-buffer syscalls
_COALESCE_BYTES = 64 * 1024


class RemoteError(RuntimeError):
    """A worker-side exception of a class this process cannot map."""


def _encode_header(kind: int, req_id: int, meta: Optional[dict],
                   arrays: Sequence[np.ndarray]) -> Tuple[bytes, list]:
    meta_b = json.dumps(meta or {}, separators=(",", ":")).encode()
    descs = []
    bufs = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        code = _DTYPE_CODE.get(a.dtype)
        if code is None:
            raise TypeError(f"dtype {a.dtype} is not on the wire-protocol "
                            f"whitelist {[str(d) for d in _DTYPES]}")
        if a.ndim > 255:
            raise ValueError(f"ndim {a.ndim} exceeds protocol limit")
        descs.append(_DESC.pack(code, a.ndim)
                     + b"".join(_DIM.pack(d) for d in a.shape))
        # cast("B") rejects shapes containing 0; an empty array has no
        # payload bytes anyway (its descriptor alone reconstructs it)
        bufs.append(memoryview(a).cast("B") if a.size else memoryview(b""))
    head = (_FIXED.pack(_MAGIC, kind, req_id, len(meta_b), len(arrays))
            + meta_b + b"".join(descs))
    return head, bufs


def _stage_one(shm_tx: "shm.SlabRing", idx: int, a: np.ndarray,
               code: int, rel: str) -> Optional[dict]:
    """Copy one array into a claimed slab slot; None = fall back to the
    socket (ring full or payload exceeds the slot size)."""
    got = shm_tx.stage(a.nbytes)
    if got is None:
        shm.count("shm_stage_fallbacks")
        return None
    slot, off, view = got
    view[:] = memoryview(a).cast("B")
    view.release()
    shm.count("shm_payload_tx_bytes", a.nbytes)
    return {"i": idx, "seg": shm_tx.name, "slot": slot, "off": off,
            "dt": code, "sh": list(a.shape), "rel": rel}


def send_frame(sock: socket.socket, kind: int, req_id: int,
               meta: Optional[dict] = None,
               arrays: Sequence[np.ndarray] = (),
               shm_tx: Optional["shm.SlabRing"] = None,
               shm_threshold: Optional[int] = None,
               ) -> List[Callable[[], None]]:
    """Send one frame; arrays may route through the slab fast path.

    With ``shm_tx`` set, any array of at least ``shm_threshold`` bytes is
    staged in the ring (or pre-staged: a ``shm.StagedPayload`` element is
    sent descriptor-only, acquiring one reference for this frame).
    Returns the release callbacks for sender-released slots — a client
    MUST run them once the response for ``req_id`` arrives (or the RPC
    fails); responses return an empty list, their slots being freed by
    the receiver's views.
    """
    inline: List[np.ndarray] = []
    shm_descs: List[dict] = []
    releases: List[Callable[[], None]] = []
    rel = REL_SENDER if kind == KIND_REQUEST else REL_RECEIVER
    for idx, a in enumerate(arrays):
        if isinstance(a, shm.StagedPayload):
            if kind != KIND_REQUEST:
                raise TypeError(
                    "pre-staged payloads are request-direction only")
            desc = dict(a.acquire())
            desc["i"] = idx
            desc["rel"] = REL_SENDER
            shm_descs.append(desc)
            releases.append(a.release)
            shm.count("shm_payload_tx_bytes", _desc_nbytes(desc))
            continue
        a = np.ascontiguousarray(a)
        code = _DTYPE_CODE.get(a.dtype)
        if code is None:
            raise TypeError(f"dtype {a.dtype} is not on the wire-protocol "
                            f"whitelist {[str(d) for d in _DTYPES]}")
        if (shm_tx is not None and shm_threshold is not None
                and a.nbytes >= shm_threshold):
            desc = _stage_one(shm_tx, idx, a, code, rel)
            if desc is not None:
                shm_descs.append(desc)
                if rel == REL_SENDER:
                    releases.append(
                        lambda ring=shm_tx, s=desc["slot"]: ring.release(s))
                continue
        inline.append(a)
    if shm_descs:
        meta = dict(meta or {})
        meta[SHM_META_KEY] = shm_descs
    head, bufs = _encode_header(kind, req_id, meta, inline)
    payload = sum(b.nbytes for b in bufs)
    if payload:
        shm.count("socket_payload_tx_bytes", payload)
    total = len(head) + payload
    pieces = [_PREAMBLE.pack(total), head] + bufs
    try:
        if total < _COALESCE_BYTES:
            sock.sendall(b"".join(pieces))
        else:
            # vectored send: big array buffers go to the kernel as-is
            for p in pieces:
                sock.sendall(p)
    except BaseException:
        # the frame never (fully) left: retire sender-released slots now,
        # nobody will deliver the response that normally frees them
        for cb in releases:
            cb()
        raise
    return releases


def _recv_exact(sock: socket.socket, n: int) -> memoryview:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError(
                f"peer closed mid-frame ({got}/{n} bytes)")
        got += r
    return view


def _desc_nbytes(desc: dict) -> int:
    code = int(desc["dt"])
    if not 0 <= code < len(_DTYPES):
        raise ConnectionError(f"unknown wire dtype code {code}")
    shape = tuple(int(x) for x in desc["sh"])
    return int(np.prod(shape, dtype=np.int64)) * _DTYPES[code].itemsize


def _resolve_shm(reader: "shm.SlabReader", desc: dict) -> np.ndarray:
    """Map one slab descriptor to a zero-copy array view."""
    nbytes = _desc_nbytes(desc)
    dt = _DTYPES[int(desc["dt"])]
    shape = tuple(int(x) for x in desc["sh"])
    try:
        view = reader.view(str(desc["seg"]), int(desc["off"]), nbytes)
        arr = np.frombuffer(view, dtype=dt).reshape(shape)
    except (FileNotFoundError, OSError, ValueError) as err:
        raise ConnectionError(
            f"shared-memory slab {desc.get('seg')!r} unavailable: "
            f"{err}") from err
    if desc.get("rel") == REL_RECEIVER:
        # receiver-released slot: freed when the last borrowed view dies
        weakref.finalize(arr, reader.release_slot,
                         str(desc["seg"]), int(desc["slot"]))
    shm.count("shm_payload_rx_bytes", nbytes)
    return arr


def recv_frame(sock: socket.socket,
               shm_reader: Optional["shm.SlabReader"] = None,
               ) -> Tuple[int, int, dict, List[np.ndarray]]:
    """Read one frame; returns (kind, req_id, meta, arrays).

    The arrays are zero-copy ``np.frombuffer`` views — over the single
    receive buffer, or (descriptor-routed arrays, ``shm_reader`` given)
    over the peer's slab segment; either way they keep their backing
    storage alive and callers may hold them freely.
    """
    (frame_len,) = _PREAMBLE.unpack(bytes(_recv_exact(sock, _PREAMBLE.size)))
    if not 0 < frame_len <= _MAX_FRAME:
        raise ConnectionError(f"implausible frame length {frame_len}")
    buf = _recv_exact(sock, frame_len)
    if frame_len < _FIXED.size:
        raise ConnectionError(f"short frame ({frame_len} bytes)")
    magic, kind, req_id, meta_len, n_arrays = _FIXED.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise ConnectionError(f"bad frame magic 0x{magic:08x}")
    pos = _FIXED.size
    if pos + meta_len > frame_len:
        raise ConnectionError("frame meta overruns frame")
    meta = json.loads(bytes(buf[pos: pos + meta_len]) or b"{}")
    pos += meta_len
    shapes = []
    for _ in range(n_arrays):
        if pos + _DESC.size > frame_len:
            raise ConnectionError("frame descriptor overruns frame")
        code, ndim = _DESC.unpack_from(buf, pos)
        pos += _DESC.size
        if code >= len(_DTYPES):
            raise ConnectionError(f"unknown wire dtype code {code}")
        shape = []
        for _ in range(ndim):
            (d,) = _DIM.unpack_from(buf, pos)
            pos += _DIM.size
            shape.append(d)
        shapes.append((_DTYPES[code], tuple(shape)))
    arrays = []
    payload = 0
    for dt, shape in shapes:
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if pos + nbytes > frame_len:
            raise ConnectionError("array payload overruns frame")
        arrays.append(np.frombuffer(buf[pos: pos + nbytes],
                                    dtype=dt).reshape(shape))
        pos += nbytes
        payload += nbytes
    if payload:
        shm.count("socket_payload_rx_bytes", payload)
    descs = meta.pop(SHM_META_KEY, None)
    if descs:
        if shm_reader is None:
            raise ConnectionError(
                "peer sent slab descriptors on a connection with no "
                "shared-memory reader")
        total = len(arrays) + len(descs)
        out: List[Optional[np.ndarray]] = [None] * total
        for desc in descs:
            i = int(desc.get("i", -1))
            if not 0 <= i < total or out[i] is not None:
                raise ConnectionError(f"bad slab descriptor index {i}")
            out[i] = _resolve_shm(shm_reader, desc)
        it = iter(arrays)
        arrays = [a if a is not None else next(it) for a in out]
    return kind, req_id, meta, arrays


# -- exception mapping -------------------------------------------------------

def _error_classes() -> Dict[str, type]:
    # imported lazily: transport is the bottom layer and must not create an
    # import cycle with replica/router
    from repro_torch.analysis.racecheck import RaceViolation
    from .replica import ReplicaDiverged, ReplicaKilled
    return {
        "ReplicaKilled": ReplicaKilled,
        "ReplicaDiverged": ReplicaDiverged,
        "RaceViolation": RaceViolation,
        "ValueError": ValueError,
        "TypeError": TypeError,
        "KeyError": KeyError,
        "OSError": OSError,
        "RuntimeError": RuntimeError,
    }


def error_meta(exc: BaseException) -> dict:
    return {"etype": type(exc).__name__, "emsg": str(exc)}


def raise_remote_error(meta: dict) -> None:
    cls = _error_classes().get(meta.get("etype", ""), RemoteError)
    msg = f"[worker] {meta.get('etype', '?')}: {meta.get('emsg', '')}"
    raise cls(msg)


# -- sockets -----------------------------------------------------------------

def listen_unix(path: str) -> socket.socket:
    """Bind + listen on a fresh unix socket (stale path unlinked first)."""
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(4)
    return srv


def connect_unix(path: str, timeout_s: float = 30.0,
                 poll_s: float = 0.05,
                 giveup=None) -> socket.socket:
    """Connect, retrying until the server binds (worker boot is async).

    ``giveup()`` (e.g. "the worker process already exited") short-circuits
    the wait with a clear error instead of burning the whole timeout.
    """
    import time
    deadline = time.monotonic() + timeout_s
    while True:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(path)
            return sock
        except (FileNotFoundError, ConnectionRefusedError) as err:
            sock.close()
            if giveup is not None and giveup():
                raise ConnectionError(
                    f"worker died before binding {path}") from err
            if time.monotonic() > deadline:
                raise ConnectionError(
                    f"timed out connecting to {path}") from err
            time.sleep(poll_s)


def tune_tcp(sock: socket.socket) -> None:
    """RPC-appropriate TCP settings, applied on both accept and connect.

    NODELAY because frames are latency-bound request/response pairs (a
    Nagle-delayed 40ms per small descriptor frame would dwarf the query
    itself); keepalive so a silently vanished peer (host down, not
    process down — TCP's failure mode that AF_UNIX cannot have) surfaces
    as ConnectionError within minutes instead of hanging a blocking recv
    forever.  The probe knobs are Linux-only, hence the hasattr guards.
    """
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", 60), ("TCP_KEEPINTVL", 10),
                     ("TCP_KEEPCNT", 6)):
        if hasattr(socket, opt):
            sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)


def listen_tcp(host: str = "127.0.0.1", port: int = 0) -> socket.socket:
    """Bind + listen on TCP; ``port=0`` lets the kernel pick (the bound
    endpoint is then published via :func:`bound_endpoint`)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(16)
    return srv


def connect_tcp(host: str, port: int, timeout_s: float = 30.0,
                poll_s: float = 0.05, giveup=None) -> socket.socket:
    """Connect with retry + exponential backoff.

    Connection-refused during boot means "not bound yet" — retry until
    the deadline (§10 failure semantics: refusal is a *connect-time*
    state, unlike a reset, which is a dead peer mid-conversation and
    always surfaces as ConnectionError from the codec).
    """
    import time
    deadline = time.monotonic() + timeout_s
    delay = poll_s
    while True:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.settimeout(min(max(1.0, poll_s), timeout_s))
            sock.connect((host, port))
            sock.settimeout(None)
            tune_tcp(sock)
            return sock
        except OSError as err:
            sock.close()
            if giveup is not None and giveup():
                raise ConnectionError(
                    f"worker died before binding {host}:{port}") from err
            if time.monotonic() > deadline:
                raise ConnectionError(
                    f"timed out connecting to {host}:{port}") from err
            time.sleep(delay)
            delay = min(delay * 2, 1.0)


def parse_address(spec: str) -> Tuple[str, object]:
    """``'unix:/path'`` | ``'tcp:host:port'`` | bare path (legacy unix).

    Returns ('unix', path) or ('tcp', (host, port)).
    """
    if spec.startswith("tcp:"):
        host, _, port = spec[4:].rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad tcp address {spec!r} "
                             "(expected tcp:host:port)")
        return "tcp", (host, int(port))
    if spec.startswith("unix:"):
        return "unix", spec[5:]
    return "unix", spec


def listen_address(spec: str) -> Tuple[str, socket.socket]:
    """Bind + listen per an address spec; returns (family, server sock)."""
    family, addr = parse_address(spec)
    if family == "tcp":
        return family, listen_tcp(*addr)
    return family, listen_unix(addr)


def connect_address(spec: str, timeout_s: float = 30.0,
                    poll_s: float = 0.05, giveup=None) -> socket.socket:
    family, addr = parse_address(spec)
    if family == "tcp":
        return connect_tcp(addr[0], addr[1], timeout_s=timeout_s,
                           poll_s=poll_s, giveup=giveup)
    return connect_unix(addr, timeout_s=timeout_s, poll_s=poll_s,
                        giveup=giveup)


def bound_endpoint(srv: socket.socket) -> str:
    """The connectable spec of a bound listener (resolves ``port=0``)."""
    if srv.family == socket.AF_INET:
        host, port = srv.getsockname()[:2]
        return f"tcp:{host}:{port}"
    return f"unix:{srv.getsockname()}"


# -- shared-memory staging ---------------------------------------------------

def stage_buffer(ring: "shm.SlabRing", shape: Tuple[int, ...], dtype,
                 ) -> Optional[Tuple["shm.StagedPayload", np.ndarray]]:
    """Claim a slab slot and hand back a writable array view over it.

    The router pads its fan-out batch straight into the slab through the
    returned view, then sends the SAME :class:`shm.StagedPayload` to
    every shard — one gather, zero per-send payload copies.  None means
    the ring is full (fall back to the plain array path, counted).
    """
    dt = np.dtype(dtype)
    code = _DTYPE_CODE.get(dt)
    if code is None:
        raise TypeError(f"dtype {dt} is not on the wire-protocol "
                        f"whitelist {[str(d) for d in _DTYPES]}")
    nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    got = ring.stage(nbytes)
    if got is None:
        shm.count("shm_stage_fallbacks")
        return None
    slot, off, view = got
    arr = np.frombuffer(view, dtype=dt).reshape(shape)
    desc = {"seg": ring.name, "slot": slot, "off": off,
            "dt": code, "sh": list(shape), "rel": REL_SENDER}
    return shm.StagedPayload(ring, slot, desc), arr


class Connection:
    """One framed RPC connection (client side or server side).

    Client usage: ``meta, arrays = conn.request("query", meta, arrays)``.
    The per-connection lock pairs each request with its response, so any
    number of router threads can share one proxy; requests to ONE worker
    serialize (the worker's replica is single-threaded anyway — engines
    are not thread-safe vs mutation), while different workers proceed in
    parallel.  All socket-level failures surface as ``ConnectionError``.

    With ``shm_tx`` (a ring this side owns) outbound arrays of at least
    ``shm_threshold`` bytes take the slab fast path; inbound slab
    descriptors resolve through a per-connection :class:`shm.SlabReader`
    regardless (attach is by segment name — no handshake).  Same-host
    connections only; the TCP transport leaves both unset.
    """

    def __init__(self, sock: socket.socket,
                 timeout_s: Optional[float] = None,
                 shm_tx: Optional["shm.SlabRing"] = None,
                 shm_threshold: Optional[int] = None):
        self.sock = sock
        if timeout_s is not None:
            sock.settimeout(timeout_s)
        self._lock = threading.Lock()
        self._next_id = 0
        self.shm_tx = shm_tx
        self.shm_threshold = shm_threshold
        self._shm_reader = shm.SlabReader()

    def request(self, method: str, meta: Optional[dict] = None,
                arrays: Sequence[np.ndarray] = (),
                ) -> Tuple[dict, List[np.ndarray]]:
        m = dict(meta or {})
        m["method"] = method
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            releases: List = []
            try:
                releases = send_frame(
                    self.sock, KIND_REQUEST, rid, m, arrays,
                    shm_tx=self.shm_tx, shm_threshold=self.shm_threshold)
                kind, got_id, rmeta, rarrays = recv_frame(
                    self.sock, self._shm_reader)
            except (OSError, socket.timeout) as err:
                raise ConnectionError(f"rpc {method!r} failed: {err}") from err
            finally:
                # the peer is done with request-direction slots once its
                # response arrived — and can never answer a failed RPC
                for cb in releases:
                    cb()
        if got_id != rid:
            raise ConnectionError(
                f"rpc {method!r}: response id {got_id} != request id {rid}")
        if kind == KIND_ERROR:
            raise_remote_error(rmeta)
        if kind != KIND_RESPONSE:
            raise ConnectionError(f"rpc {method!r}: unexpected kind {kind}")
        return rmeta, rarrays

    # -- server side -------------------------------------------------------

    def recv_request(self) -> Tuple[int, str, dict, List[np.ndarray]]:
        kind, rid, meta, arrays = recv_frame(self.sock, self._shm_reader)
        if kind != KIND_REQUEST:
            raise ConnectionError(f"expected request frame, got kind {kind}")
        return rid, meta.pop("method", ""), meta, arrays

    def respond(self, req_id: int, meta: Optional[dict] = None,
                arrays: Sequence[np.ndarray] = ()) -> None:
        # response-direction slots are receiver-released (the client's
        # borrowed views free them), so there is nothing to run here
        send_frame(self.sock, KIND_RESPONSE, req_id, meta, arrays,
                   shm_tx=self.shm_tx, shm_threshold=self.shm_threshold)

    def respond_error(self, req_id: int, exc: BaseException) -> None:
        send_frame(self.sock, KIND_ERROR, req_id, error_meta(exc))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
        self._shm_reader.close()
