"""Shard-worker subprocess: one ``ShardReplica`` behind the RPC transport,
torch counterpart of ``repro.cluster.worker`` (DESIGN.md §10).

``python -m repro_torch.cluster.worker --socket /path/sock`` owns exactly one
replica (its own CUDA context, engine, WAL and checkpoint directory) and
serves the replica interface over a socket: ``init``, ``query``,
``log_and_apply``, ``apply_records`` / ``wal_records`` / ``export_payload``
/ ``adopt_payload`` (the catch-up quartet), ``snapshot`` / ``compact`` /
``recover``, ``telemetry`` / ``health``, and the chaos seams
(``set_chaos``).  The parent talks to it through
:class:`repro_torch.cluster.remote.RemoteReplica`.

The worker is single-threaded: engines are not thread-safe against
mutation, and the router already serializes one worker's requests on the
proxy's connection lock.  Cross-shard parallelism comes from running S x R
of these processes, each with its own interpreter lock.

Boot: bind and listen on ``--listen`` (``unix:/path`` or
``tcp:host:port``; ``--socket PATH`` is the unix spelling), then accept.  A
TCP worker bound to port 0 publishes its real endpoint through
``--endpoint-file`` (tmp + rename).  The ``init`` request creates the
replica; its meta carries the configs, the replica's ``device`` (``"cuda"``,
``"cuda:0"`` or ``"cpu"``, resolved here by ``repro_torch.resolve_device``,
which raises when no card is there) and the hash parameters' shape; its
arrays carry the parameter leaves (drawn once by the parent, so every
replica and every respawn hashes alike: a callable cannot cross a process)
and the seed rows.  On AF_UNIX connections the same meta may carry a
``shm`` block, after which the worker answers big arrays through its own
slab ring.  A worker restarted over an existing root recovers from its own
snapshot and WAL inside ``init`` and reports how many records it replayed.
Acknowledged mutations are fsync'd in the WAL before the ack leaves the
process, so a SIGKILL at any point is survivable.

Arrays off the wire are views of the receive buffer or of a slab
slot that the peer recycles once the response is sent.  Every handler
copies what it keeps into memory of its own before it returns (``_own``:
the WAL records, the query batch and the payload rows are host arrays the
engine moves to its device; the parameter leaves go straight to device
tensors), and answers with contiguous int32 arrays from one ``.cpu()``
copy.

Kernel launches are counted in the process that makes them
(``kernels._build.LAUNCHES``): the ``telemetry`` answer adds this worker's
``launches`` and ``device``, which is how a caller shows that the kernels
ran on the card in another process.

WalRecord batches and hash parameters cross the wire without pickle: scalars
ride in the JSON meta, arrays as raw arrays; ``pack_records`` /
``unpack_records`` and ``pack_params`` / ``unpack_params`` are shared with the
client proxy so the two sides cannot drift.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import time
import traceback
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.analysis.racecheck import RaceViolation
from repro_torch.obs import trace as obs_trace

from . import shm
from .transport import (TRACE_META_KEY, Connection, bound_endpoint,
                        listen_address, parse_address, tune_tcp)
from .wal import WalRecord

__all__ = ["main", "pack_records", "unpack_records", "pack_params",
           "unpack_params"]


def _own(a) -> np.ndarray:
    """An int32 copy of a wire array: it no longer borrows the receive
    buffer or a slab slot."""
    return np.array(a, np.int32)


def pack_records(records) -> Tuple[dict, List[np.ndarray]]:
    """(meta, arrays) wire form of a WalRecord batch (no pickle)."""
    meta, arrays = [], []
    for rec in records:
        meta.append({"seq": int(rec.seq), "op": int(rec.op),
                     "pts": rec.points is not None})
        arrays.append(np.asarray(rec.gids, np.int32))
        if rec.points is not None:
            arrays.append(np.asarray(rec.points, np.int32))
    return {"records": meta}, arrays


def unpack_records(meta: dict, arrays: List[np.ndarray]) -> List[WalRecord]:
    out, pos = [], 0
    for m in meta.get("records", ()):
        gids = _own(arrays[pos])
        pos += 1
        points = None
        if m["pts"]:
            points = _own(arrays[pos])
            pos += 1
        out.append(WalRecord(seq=int(m["seq"]), op=int(m["op"]),
                             gids=gids, points=points))
    return out


def pack_params(params) -> Tuple[dict, List[np.ndarray]]:
    """(meta, arrays) wire form of ``LshParams``: family, width and the
    names of the leaves in the meta, the leaves as host arrays."""
    leaves = {"offsets": params.offsets, "mix_a": params.mix_a,
              "mix_c": params.mix_c}
    if params.walks is not None:
        leaves["pairs"] = params.walks.pairs
        leaves["prefix"] = params.walks.prefix
    if params.proj is not None:
        leaves["proj"] = params.proj
    return ({"family": params.family, "width": float(params.width),
             "leaves": list(leaves)},
            [t.cpu().numpy() for t in leaves.values()])


def unpack_params(meta: dict, arrays: List[np.ndarray], device):
    """``LshParams`` on ``device`` from :func:`pack_params`' wire form."""
    from repro_torch.bridge import params_from_numpy
    leaves = dict(zip(meta["leaves"], arrays))
    return params_from_numpy(meta["width"], leaves["offsets"], leaves["mix_a"],
                             leaves["mix_c"], pairs=leaves.get("pairs"),
                             prefix=leaves.get("prefix"), device=device,
                             family=meta["family"], proj=leaves.get("proj"))


class _Shutdown(Exception):
    """Raised by the shutdown handler to leave the serve loop cleanly."""


class WorkerServer:
    """Request dispatcher around one (lazily ``init``-ed) ShardReplica."""

    def __init__(self):
        self.replica = None
        self.shm_ring: Optional[shm.SlabRing] = None
        self._shm_cfg: Optional[dict] = None

    # every handler: (meta, arrays) -> (meta, arrays)

    def _handle_init(self, meta, arrays):
        # imported here, not at module top: argparse/--help and the boot
        # handshake do not pay for the engine's imports
        from repro_torch import resolve_device
        from repro_torch.core.index import IndexConfig
        from repro_torch.serve.engine import ServeConfig
        from .replica import ShardReplica

        t0 = time.perf_counter()
        tag = f"s{int(meta['shard_id'])}r{int(meta['replica_id'])}"
        # label first: the engine's warm-up batches trace into this file
        obs_trace.set_process_label(f"worker-{tag}")
        device = resolve_device(meta["device"])
        params = unpack_params(meta["params"], arrays[:-1], device)
        self.replica = ShardReplica(
            int(meta["shard_id"]), int(meta["replica_id"]),
            IndexConfig(**meta["cfg"]), ServeConfig(**meta["serve_cfg"]),
            0, meta["root"], _own(arrays[-1]),
            keep_snapshots=int(meta.get("keep_snapshots", 2)),
            wal_fsync=bool(meta.get("wal_fsync", True)),
            snapshot_every_bytes=meta.get("snapshot_every_bytes"),
            snapshot_every_s=meta.get("snapshot_every_s"),
            params_fn=lambda cfg, dim: params, device=device)
        self._shm_cfg = meta.get("shm") or None
        print(f"worker {tag}: pid {os.getpid()}, device {device}, "
              f"{self.replica.num_live} live rows, replayed "
              f"{self.replica.recovered_records}, init "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        return {"last_seq": self.replica.last_seq,
                "next_gid": self.replica.next_gid,
                "dim": self.replica.engine.index.dim,
                "replayed": self.replica.recovered_records,
                "pid": os.getpid(), "device": str(device)}, ()

    def _handle_query(self, meta, arrays):
        import torch
        # re-parent under the router's span: the (tid, sid) pair from the
        # JSON meta joins this process's spans to the cross-process trace
        ctx = meta.get(TRACE_META_KEY)
        parent = (ctx["tid"], int(ctx["sid"])) if ctx else None
        with obs_trace.span("worker_query", parent=parent,
                            n_real=int(meta["n_real"])):
            d, i = self.replica.query(_own(arrays[0]), int(meta["n_real"]))
            both = torch.stack([d, i]).cpu().numpy()
        return {}, (both[0], both[1])

    def _handle_log_and_apply(self, meta, arrays):
        (rec,) = unpack_records(meta, arrays)
        removed = self.replica.log_and_apply(rec)
        return {"removed": int(removed), "last_seq": self.replica.last_seq,
                "next_gid": self.replica.next_gid}, ()

    def _handle_wal_records(self, meta, arrays):
        return pack_records(
            self.replica.wal_records(after_seq=int(meta["after_seq"])))

    def _handle_apply_records(self, meta, arrays):
        applied = self.replica.apply_records(unpack_records(meta, arrays))
        return {"applied": applied, "last_seq": self.replica.last_seq,
                "next_gid": self.replica.next_gid}, ()

    def _handle_export_payload(self, meta, arrays):
        dataset, gids, next_gid = self.replica.export_payload()
        return {"next_gid": int(next_gid)}, (dataset, gids)

    def _handle_adopt_payload(self, meta, arrays):
        self.replica.adopt_payload(_own(arrays[0]), _own(arrays[1]),
                                   int(meta["next_gid"]), int(meta["seq"]))
        return {"last_seq": self.replica.last_seq}, ()

    def _handle_snapshot(self, meta, arrays):
        return {"step": self.replica.snapshot()}, ()

    def _handle_compact(self, meta, arrays):
        self.replica.compact()
        return {"last_seq": self.replica.last_seq}, ()

    def _handle_recover(self, meta, arrays):
        replayed = self.replica.recover()
        return {"replayed": replayed, "last_seq": self.replica.last_seq,
                "next_gid": self.replica.next_gid}, ()

    def _handle_telemetry(self, meta, arrays):
        """The replica's telemetry, plus this process's kernel ``launches``,
        its ``device`` and the engine's flight-recorder batch times
        (``engine_batch_ms``, oldest first)."""
        from repro_torch.kernels import _build
        t = self.replica.telemetry()
        t["engine_batch_ms"] = [ms for _, ms, _ in
                                self.replica.engine.flight.entries()]
        t["launches"] = dict(_build.LAUNCHES)
        t["device"] = str(self.replica.device)
        return t, ()

    def _handle_health(self, meta, arrays):
        return {"ok": self.replica is not None, "pid": os.getpid(),
                "last_seq": (self.replica.last_seq
                             if self.replica is not None else None)}, ()

    def _handle_set_chaos(self, meta, arrays):
        if "fail_next_queries" in meta:
            self.replica.fail_next_queries = int(meta["fail_next_queries"])
        if "slow_ms" in meta:
            self.replica.slow_ms = float(meta["slow_ms"])
        return {}, ()

    def _handle_get_chaos(self, meta, arrays):
        return {"fail_next_queries": self.replica.fail_next_queries,
                "slow_ms": self.replica.slow_ms}, ()

    def _handle_shutdown(self, meta, arrays):
        raise _Shutdown()

    def dispatch(self, method: str, meta, arrays):
        handler = getattr(self, f"_handle_{method}", None)
        if handler is None:
            raise ValueError(f"unknown rpc method {method!r}")
        if self.replica is None and method not in ("init", "health",
                                                   "shutdown"):
            raise RuntimeError(f"rpc {method!r} before init")
        return handler(meta, arrays)

    def _enable_shm(self, conn: Connection) -> None:
        """Arm the connection's slab fast path (after ``init``, AF_UNIX
        only).  The ring is created on the ``shm`` block the init meta
        carried; the client's reader attaches it by the name each
        descriptor carries."""
        if self._shm_cfg is None or conn.sock.family != socket.AF_UNIX:
            return
        if self.shm_ring is None:
            self.shm_ring = shm.SlabRing(
                slots=int(self._shm_cfg.get("slots", 8)),
                slot_bytes=int(self._shm_cfg.get("slot_bytes", 1 << 20)),
                tag="wtx")
        conn.shm_tx = self.shm_ring
        conn.shm_threshold = int(self._shm_cfg["threshold"])

    def serve_connection(self, conn: Connection) -> None:
        # handlers do not keep request-array views past their response: the
        # client recycles request-direction slots once the response arrives
        while True:
            try:
                rid, method, meta, arrays = conn.recv_request()
            except ConnectionError:
                return                  # router went away; await reconnect
            try:
                rmeta, rarrays = self.dispatch(method, meta, arrays)
                if method == "init":
                    self._enable_shm(conn)
            except _Shutdown:
                conn.respond(rid, {"ok": True})
                raise
            except RaceViolation as exc:
                # the sanitizer's report is a BaseException, so that the
                # router's fault tolerance cannot absorb it; here the serve
                # loop survives to ship it (it re-raises router-side)
                conn.respond_error(rid, exc)
                continue
            except Exception as exc:    # ship the failure, keep serving:
                traceback.print_exc()   # the router decides health; the
                sys.stderr.flush()      # traceback goes to worker.log
                conn.respond_error(rid, exc)
                continue
            conn.respond(rid, rmeta, rarrays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--socket", help="unix socket path to bind (the unix "
                    "spelling of --listen unix:PATH)")
    ap.add_argument("--listen", help="address spec to bind: unix:/path "
                    "or tcp:host:port (port 0 = kernel-assigned)")
    ap.add_argument("--endpoint-file", help="publish the bound endpoint "
                    "spec here (atomic write; how a tcp:...:0 parent "
                    "learns the real port)")
    args = ap.parse_args(argv)
    spec = args.listen or (f"unix:{args.socket}" if args.socket else None)
    if spec is None:
        ap.error("one of --listen / --socket is required")
    family, srv = listen_address(spec)
    if args.endpoint_file:
        tmp = args.endpoint_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(bound_endpoint(srv) if family == "tcp" else spec)
        os.replace(tmp, args.endpoint_file)
    server = WorkerServer()
    try:
        while True:
            sock, _ = srv.accept()
            if family == "tcp":
                tune_tcp(sock)
            conn = Connection(sock)
            try:
                server.serve_connection(conn)
            except _Shutdown:
                return 0
            finally:
                conn.close()
                if server.shm_ring is not None:
                    # the departed client's borrowed views can never
                    # release their slots; a reconnecting client starts
                    # from an empty ring
                    server.shm_ring.reset()
    finally:
        if server.replica is not None:
            try:
                server.replica.close()
            except Exception:
                pass
        if server.shm_ring is not None:
            server.shm_ring.close()
        srv.close()
        if family == "unix":
            try:
                os.unlink(parse_address(spec)[1])
            except OSError:
                pass


if __name__ == "__main__":
    sys.exit(main())
