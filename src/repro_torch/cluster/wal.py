"""Write-ahead log for index mutations, torch counterpart of
``repro.cluster.wal`` (DESIGN.md §7): the same records, byte for byte, so a
log written by either package replays in the other.  It holds host arrays
only and imports no torch.

Durability contract: a mutation is acknowledged only after its record is
appended **and fsync'd** to the replica's log, so an acknowledged
insert/delete survives a process kill.  Recovery = latest
``CheckpointManager`` snapshot + replay of the log tail (records with
``seq`` greater than the snapshot's ``wal_seq``); because the segmented
index applies mutations deterministically, replay reconstructs the
replica's logical state bit-identically.

Record layout (little-endian), one per mutation batch:

    magic   u32  0x57414C31 ('WAL1')
    seq     u64  per-shard mutation sequence number (1-based)
    op      u8   1 = insert, 2 = delete
    n       u32  row count (insert) / gid count (delete)
    dim     u32  point dimensionality (insert) or 0 (delete)
    payload      gids int32[n]  [+ points int32[n*dim] for insert]
    crc     u32  crc32 over header-after-magic + payload

A crash mid-append leaves a torn record at the tail; ``crc``/short-read
checks make the scanner stop at the last complete record, and opening the
log for append truncates the torn bytes so they can never corrupt later
appends.  Truncation at snapshot time (``truncate_upto``) rewrites the
surviving tail to a temp file and ``os.replace``s it — the same
atomic-rename discipline ``CheckpointManager`` uses.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["WalRecord", "WriteAheadLog", "OP_INSERT", "OP_DELETE"]

_MAGIC = 0x57414C31
_HEADER = struct.Struct("<IQBII")      # magic, seq, op, n, dim
_CRC = struct.Struct("<I")

OP_INSERT = 1
OP_DELETE = 2


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One durable mutation batch (gids are shard-local ids)."""

    seq: int
    op: int                            # OP_INSERT | OP_DELETE
    gids: np.ndarray                   # int32 (n,)
    points: Optional[np.ndarray] = None  # int32 (n, dim) for inserts

    def encode(self) -> bytes:
        gids = np.ascontiguousarray(self.gids, np.int32)
        if self.op == OP_INSERT:
            pts = np.ascontiguousarray(self.points, np.int32)
            if pts.ndim != 2 or pts.shape[0] != gids.shape[0]:
                raise ValueError(
                    f"insert record needs (n, dim) points aligned with gids; "
                    f"got {pts.shape} vs {gids.shape}")
            dim, payload = pts.shape[1], gids.tobytes() + pts.tobytes()
        elif self.op == OP_DELETE:
            dim, payload = 0, gids.tobytes()
        else:
            raise ValueError(f"unknown WAL op {self.op}")
        header = _HEADER.pack(_MAGIC, self.seq, self.op, gids.shape[0], dim)
        crc = zlib.crc32(header[4:] + payload)
        return header + payload + _CRC.pack(crc)


def _scan(path: str) -> Iterator[Tuple[WalRecord, int]]:
    """Yield (record, end_offset) for every complete record.

    Stops silently at the first torn/corrupt record (crash mid-append) —
    everything before it is intact by construction (fsync-before-ack).
    """
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    while pos + _HEADER.size + _CRC.size <= len(buf):
        magic, seq, op, n, dim = _HEADER.unpack_from(buf, pos)
        if magic != _MAGIC or op not in (OP_INSERT, OP_DELETE):
            return
        body = 4 * n + 4 * n * dim
        end = pos + _HEADER.size + body + _CRC.size
        if end > len(buf):
            return                      # torn tail: record only partly on disk
        payload = buf[pos + _HEADER.size: end - _CRC.size]
        (crc,) = _CRC.unpack_from(buf, end - _CRC.size)
        if crc != zlib.crc32(buf[pos + 4: pos + _HEADER.size] + payload):
            return                      # torn tail: payload bytes corrupt
        gids = np.frombuffer(payload[: 4 * n], np.int32).copy()
        points = None
        if op == OP_INSERT:
            points = np.frombuffer(payload[4 * n:], np.int32).copy()
            points = points.reshape(n, dim)
        yield WalRecord(seq=seq, op=op, gids=gids, points=points), end
        pos = end


class WriteAheadLog:
    """Append-only fsync'd mutation log for one shard replica."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.last_seq = 0
        self.torn_bytes_dropped = 0
        good_end = 0
        for rec, end in _scan(path):
            self.last_seq, good_end = rec.seq, end
        if os.path.exists(path) and os.path.getsize(path) > good_end:
            # drop the torn tail so later appends start on a record boundary
            self.torn_bytes_dropped = os.path.getsize(path) - good_end
            with open(path, "r+b") as f:
                f.truncate(good_end)
        self._f = open(path, "ab")

    # -- append ------------------------------------------------------------

    def append(self, op: int, gids, points=None,
               seq: Optional[int] = None) -> int:
        """Durably append one mutation batch; returns its seq.

        ``seq`` defaults to ``last_seq + 1``; the catch-up path passes the
        originating shard seq through so replicas stay aligned.
        """
        seq = self.last_seq + 1 if seq is None else int(seq)
        if seq <= self.last_seq:
            raise ValueError(
                f"non-monotone WAL seq {seq} (last is {self.last_seq})")
        rec = WalRecord(seq=seq, op=op,
                        gids=np.asarray(gids, np.int32),
                        points=None if points is None
                        else np.asarray(points, np.int32))
        self._f.write(rec.encode())
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.last_seq = seq
        return seq

    def append_record(self, rec: WalRecord) -> int:
        return self.append(rec.op, rec.gids, rec.points, seq=rec.seq)

    # -- read / maintenance ------------------------------------------------

    def records(self, after_seq: int = 0) -> List[WalRecord]:
        """All complete records with seq > after_seq, in append order."""
        self._f.flush()
        return [rec for rec, _ in _scan(self.path) if rec.seq > after_seq]

    def truncate_upto(self, seq: int) -> int:
        """Drop records with seq <= ``seq`` (they are covered by a snapshot).

        Atomic: survivors are rewritten to a temp file and ``os.replace``d
        over the log.  Returns how many records survived.
        """
        self._f.flush()
        keep = [rec for rec, _ in _scan(self.path) if rec.seq > seq]
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for rec in keep:
                f.write(rec.encode())
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        return len(keep)

    @property
    def closed(self) -> bool:
        return self._f.closed

    @property
    def size_bytes(self) -> int:
        self._f.flush()
        return os.path.getsize(self.path)

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._f.close()
