"""Client side of multi-process shard serving, torch counterpart of
``repro.cluster.remote`` (DESIGN.md §10).

:class:`RemoteReplica` is a drop-in, duck-typed stand-in for
``ShardReplica``: it owns a worker process (``repro_torch.cluster.worker``)
and ships every replica-interface call over the RPC transport.  The
``ClusterRouter``'s fan-out, hedging, failover, mutation-failure discipline
and catch-up run unchanged: a worker SIGKILL'd mid-request surfaces as
``ReplicaKilled``, exactly like an in-process replica whose chaos seam
fired.

Each worker runs its engine on the replica's ``device`` (None = the card;
``"cpu"`` when the caller asks), in a CUDA context of its own: the worker is
started with ``subprocess.Popen([sys.executable, "-m", ...])``, a fork
followed by an exec, never a bare fork of a parent that may have opened
CUDA.  ``_worker_env`` puts the port's ``src`` on ``PYTHONPATH`` and passes
the environment on (``REPRO_TRACE``, ``REPRO_SANITIZE``) without hiding any
card.  A worker asked for the card where there is none fails its ``init``,
and the proxy raises with the tail of its ``worker.log``.

Hash parameters cannot cross a process as a callable: the proxy draws them
once (``params_fn(cfg, dim)``, else ``make_params(cfg, dim, seed)``), as
``ShardReplica`` does, and ships the leaves in every ``init``, so a
respawned worker hashes as its first incarnation and its peers do.

Process supervision lives in :class:`WorkerHandle`: spawn (stdout/stderr to
``worker.log`` in the replica root), liveness, SIGKILL (chaos drills) and
restart.  ``RemoteReplica.recover()`` recovers in place by RPC when the
process survived (the router marked it dead on an application failure) and
respawns it for a disk recovery when it did not; either way the worker
replays its own WAL and reports how many records that took.

Cold start: every worker loads the CUDA kernels from
``build/repro_torch_kernels/<hash>/`` at its first launch and builds them
with ``nvcc`` if they are not there (concurrent builds are safe, but
redundant).  :func:`spawn_replica_grid` therefore boots worker (0, 0) to
completion first, so the build runs once, and only then the other W-1
together.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import List, Optional

import numpy as np

from repro_torch.analysis import racecheck
from repro_torch.core.index import ParamsFn, make_params
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import engine as serve_engine

from . import shm
from .concurrency import under_quiesce
from .replica import ReplicaKilled, ShardReplica
from .transport import TRACE_META_KEY, Connection, connect_address
from .worker import pack_params, pack_records, unpack_records

__all__ = ["RemoteReplica", "WorkerHandle", "spawn_replica_grid"]


def _worker_env() -> dict:
    """Subprocess env: the worker imports ``repro_torch`` from this
    checkout; everything else (``REPRO_TRACE``, ``REPRO_SANITIZE``, the
    visible cards) is this process's environment as it stands."""
    env = dict(os.environ)
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    parts = [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p and p != src]
    env["PYTHONPATH"] = os.pathsep.join(parts)
    return env


class WorkerHandle:
    """One supervised worker process + how to reach it.

    ``family`` picks the transport: ``'unix'`` spawns the worker on a
    fresh unix socket path; ``'tcp'`` spawns it on ``tcp:127.0.0.1:0``
    and resolves the kernel-assigned port through the worker's endpoint
    file.  An explicit ``address`` (``tcp:host:port``) means the worker
    is EXTERNAL — already running, possibly on another host — so spawn /
    sigkill / shutdown-wait become no-ops and only the RPC side applies.
    """

    def __init__(self, root: str, tag: str, family: str = "unix",
                 address: Optional[str] = None):
        self.root = root
        self.tag = tag
        self.family = family
        self.address = address
        self.external = address is not None
        os.makedirs(root, exist_ok=True)
        # AF_UNIX paths are capped at ~108 bytes; deep pytest/temp roots
        # overflow that, so the socket lives under the system temp dir
        self.socket_path = os.path.join(
            tempfile.gettempdir(), f"rwt-{tag}-{uuid.uuid4().hex[:8]}.sock")
        self.endpoint_path = os.path.join(root, "endpoint")
        self.log_path = os.path.join(root, "worker.log")
        self.proc: Optional[subprocess.Popen] = None

    def spawn(self) -> None:
        if self.external:
            return
        if self.family == "tcp":
            try:
                os.unlink(self.endpoint_path)   # stale port from a
            except FileNotFoundError:           # previous incarnation
                pass
            argv = ["--listen", "tcp:127.0.0.1:0",
                    "--endpoint-file", self.endpoint_path]
        else:
            argv = ["--socket", self.socket_path]
        log = open(self.log_path, "ab")
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.cluster.worker"] + argv,
                stdout=log, stderr=subprocess.STDOUT, env=_worker_env())
        finally:
            log.close()               # the child holds its own fd now

    def endpoint(self, timeout_s: float = 30.0, giveup=None) -> str:
        """The connectable address spec; for a spawned TCP worker this
        waits (bounded) for the endpoint file to materialize."""
        if self.external:
            return self.address
        if self.family != "tcp":
            return f"unix:{self.socket_path}"
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                with open(self.endpoint_path) as f:
                    spec = f.read().strip()
                if spec:
                    return spec
            except FileNotFoundError:
                pass
            if giveup is not None and giveup():
                raise ConnectionError(
                    f"worker died before publishing {self.endpoint_path}")
            if time.monotonic() > deadline:
                raise ConnectionError(
                    f"timed out waiting for endpoint {self.endpoint_path}")
            time.sleep(0.05)

    def connect(self, timeout_s: float = 30.0, giveup=None):
        return connect_address(self.endpoint(timeout_s, giveup),
                               timeout_s=timeout_s, giveup=giveup)

    def running(self) -> bool:
        if self.external:
            return True               # liveness shows up as RPC failures
        return self.proc is not None and self.proc.poll() is None

    def sigkill(self) -> None:
        """The chaos drill: an unannounced, uncatchable process death.  The
        dead worker's socket file, which only a clean exit removes, goes
        with it."""
        if not self.external and self.running():
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait()
            if self.family != "tcp":
                try:
                    os.unlink(self.socket_path)
                except FileNotFoundError:
                    pass

    def shutdown(self, conn: Optional[Connection], timeout_s: float = 10.0,
                 ) -> None:
        """Graceful stop; escalates to SIGKILL if the worker lingers."""
        if conn is not None and self.running():
            try:
                conn.request("shutdown")
            except Exception:
                pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.sigkill()

    def tail_log(self, n: int = 40) -> str:
        try:
            with open(self.log_path, "rb") as f:
                return b"\n".join(
                    f.read().splitlines()[-n:]).decode(errors="replace")
        except OSError:
            return "<no worker log>"


class RemoteReplica:
    """``ShardReplica`` interface over a worker process (DESIGN.md §10).

    Takes ``ShardReplica``'s arguments; ``device`` (None = the card) is the
    worker's, and ``query`` returns host int32 arrays where the in-process
    replica returns tensors on its device.

    ``alive`` is router-side routing state, exactly as for the in-process
    replica: the router flips it on health markdown and chaos drills; the
    worker process itself may outlive a markdown (app-level failures) or
    predecease it (SIGKILL), and ``recover()`` reconciles either case.
    """

    def __init__(self, shard_id: int, replica_id: int, cfg, serve_cfg,
                 seed: int, root: str, seed_dataset: np.ndarray,
                 keep_snapshots: int = 2, wal_fsync: bool = True,
                 snapshot_every_bytes: Optional[int] = None,
                 snapshot_every_s: Optional[float] = None,
                 params_fn: Optional[ParamsFn] = None, device=None,
                 rpc_timeout_s: float = 120.0,
                 spawn_timeout_s: float = 300.0,
                 family: str = "unix",
                 address: Optional[str] = None,
                 shm_pool: Optional[shm.SlabRing] = None,
                 shm_threshold: Optional[int] = None,
                 shm_slots: int = 8,
                 shm_slot_bytes: int = 1 << 20):
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.root = root
        self.family = family
        # the slab fast path is same-host by construction: never on tcp
        self._shm_pool = shm_pool if family == "unix" else None
        self._shm_threshold = shm_threshold if family == "unix" else None
        self._shm_cfg = (
            {"threshold": int(shm_threshold), "slots": int(shm_slots),
             "slot_bytes": int(shm_slot_bytes)}
            if self._shm_threshold is not None else None)
        # kept ONLY for a fresh worker boot; a respawn over an existing
        # root recovers from its own snapshot + WAL and ignores the seed
        self._seed = np.ascontiguousarray(seed_dataset, np.int32)
        dim = int(self._seed.shape[1])
        params_meta, self._params = pack_params(
            params_fn(cfg, dim) if params_fn is not None
            else make_params(cfg, dim, seed))
        self.device = "cuda" if device is None else str(device)
        self._init_meta = {
            "shard_id": shard_id, "replica_id": replica_id, "root": root,
            "cfg": dataclasses.asdict(cfg),
            "serve_cfg": dataclasses.asdict(serve_cfg),
            "keep_snapshots": keep_snapshots, "wal_fsync": wal_fsync,
            "snapshot_every_bytes": snapshot_every_bytes,
            "snapshot_every_s": snapshot_every_s,
            "device": self.device, "params": params_meta,
        }
        if self._shm_cfg is not None:
            self._init_meta["shm"] = self._shm_cfg
        self._rpc_timeout_s = rpc_timeout_s
        self._spawn_timeout_s = spawn_timeout_s
        self.handle = WorkerHandle(root, f"s{shard_id}r{replica_id}",
                                   family=family, address=address)
        self.conn: Optional[Connection] = None
        self.alive = True
        self.last_seq = 0
        self._next_gid = 0
        self.recovered_records = 0
        self.boot_s = 0.0                # spawn to init answered, last boot
        self._boot()
        # opt-in race sanitizer (REPRO_SANITIZE=1): the proxy carries its
        # own token so a straggler RPC overlapping a mutation is caught on
        # the router side even before the worker sees either frame
        racecheck.maybe_instrument(
            self, f"remote_s{shard_id}r{replica_id}",
            queries=("query",),
            mutations=("log_and_apply", "apply_records", "adopt_payload",
                       "recover", "catch_up_from", "compact", "kill"))

    # -- boot / supervision -------------------------------------------------

    def _boot(self) -> int:
        """Spawn (if needed) + connect + init; returns #records replayed.

        A worker that does not come up (it died before binding, or its
        ``init`` failed: no card for a ``cuda`` device, a failed kernel
        build, ...) is stopped, and this raises with its log's tail."""
        t0 = time.perf_counter()
        if not self.handle.running():
            self.handle.spawn()
        try:
            sock = self.handle.connect(
                timeout_s=self._spawn_timeout_s,
                giveup=lambda: not self.handle.running())
            # init covers engine build + warm-up: no timeout; steady-state
            # RPCs then run under the configured deadline
            self.conn = Connection(sock, timeout_s=None,
                                   shm_tx=self._shm_pool,
                                   shm_threshold=self._shm_threshold)
            meta, _ = self.conn.request(
                "init", self._init_meta, [*self._params, self._seed])
        except Exception as err:
            self.handle.sigkill()
            if self.conn is not None:
                self.conn.close()
                self.conn = None
            raise RuntimeError(
                f"worker s{self.shard_id}r{self.replica_id} failed to init: "
                f"{err}\n--- worker log ---\n{self.handle.tail_log()}"
            ) from err
        sock.settimeout(self._rpc_timeout_s)
        self.boot_s = time.perf_counter() - t0
        self.last_seq = int(meta["last_seq"])
        self._next_gid = int(meta["next_gid"])
        self.recovered_records = int(meta["replayed"])
        return self.recovered_records

    def _rpc(self, method: str, meta: Optional[dict] = None, arrays=()):
        """One replica RPC; a transport failure means the process is gone
        (or wedged past the deadline) — same contract as a dead replica."""
        if self.conn is None:
            raise ReplicaKilled(
                f"shard {self.shard_id} replica {self.replica_id}: "
                "no worker connection")
        try:
            return self.conn.request(method, meta, arrays)
        except ConnectionError as err:
            raise ReplicaKilled(
                f"shard {self.shard_id} replica {self.replica_id}: "
                f"worker unreachable ({err})") from err

    # -- replica interface --------------------------------------------------

    @property
    def supports_staged(self) -> bool:
        """True when the router may pass a pre-staged slab payload in
        place of the batch (same-host worker with the fast path armed)."""
        return self.conn is not None and self.conn.shm_tx is not None

    def query(self, batch: np.ndarray, n_real: int, staged=None):
        if not self.alive:
            raise ReplicaKilled(
                f"shard {self.shard_id} replica {self.replica_id} is down")
        meta: dict = {"n_real": int(n_real)}
        # trace context rides the JSON meta (scalars only — no wire-protocol
        # dtype changes); the worker re-parents its spans under it
        ctx = obs_trace.wire_context()
        if ctx is not None:
            meta[TRACE_META_KEY] = ctx
        # a pre-staged payload IS the batch, already in the shared slab:
        # the frame ships a descriptor, not the rows (fan-out sends the
        # same staged slot to every shard)
        payload = staged if staged is not None else \
            np.ascontiguousarray(batch, np.int32)
        _, (d, i) = self._rpc("query", meta, [payload])
        return d, i

    @under_quiesce
    def log_and_apply(self, record) -> int:
        if not self.alive:
            raise ReplicaKilled(
                f"shard {self.shard_id} replica {self.replica_id} is down")
        meta, arrays = pack_records([record])
        r, _ = self._rpc("log_and_apply", meta, arrays)
        self.last_seq = int(r["last_seq"])
        self._next_gid = int(r["next_gid"])
        return int(r["removed"])

    def wal_records(self, after_seq: int = 0):
        meta, arrays = self._rpc("wal_records", {"after_seq": int(after_seq)})
        return unpack_records(meta, arrays)

    @under_quiesce
    def apply_records(self, records) -> int:
        meta, arrays = pack_records(records)
        r, _ = self._rpc("apply_records", meta, arrays)
        self.last_seq = int(r["last_seq"])
        self._next_gid = int(r["next_gid"])
        return int(r["applied"])

    def export_payload(self):
        meta, (dataset, gids) = self._rpc("export_payload")
        return dataset, gids, int(meta["next_gid"])

    @under_quiesce
    def adopt_payload(self, dataset, gids, next_gid: int, seq: int) -> None:
        r, _ = self._rpc("adopt_payload",
                         {"next_gid": int(next_gid), "seq": int(seq)},
                         [np.ascontiguousarray(dataset, np.int32),
                          np.ascontiguousarray(gids, np.int32)])
        self.last_seq = int(r["last_seq"])
        self._next_gid = int(next_gid)

    # the catch-up orchestration is deliberately THE SAME code as the
    # in-process replica's — it only touches the five interface primitives
    # above, so sharing the function pins remote/in-process semantics
    catch_up_from = ShardReplica.catch_up_from

    def snapshot(self) -> int:
        r, _ = self._rpc("snapshot")
        return int(r["step"])

    @under_quiesce
    def compact(self) -> None:
        self._rpc("compact")

    @under_quiesce
    def kill(self) -> None:
        """SIGKILL the worker — the real process-death chaos drill (the
        in-process replica can only pretend)."""
        self.alive = False
        self.handle.sigkill()
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    @under_quiesce
    def recover(self) -> int:
        """In-place RPC recover if the process survived, respawn + disk
        recovery if it did not; either way = snapshot restore + WAL replay
        in the worker.  Returns #records replayed."""
        replayed = None
        if self.handle.running() and self.conn is not None:
            try:
                r, _ = self._rpc("recover")
                self.last_seq = int(r["last_seq"])
                self._next_gid = int(r["next_gid"])
                replayed = int(r["replayed"])
            except ReplicaKilled:
                pass                    # process died under us: respawn
        if replayed is None:
            if self.conn is not None:
                self.conn.close()
                self.conn = None
            replayed = self._boot()
        self.alive = True
        return replayed

    # -- router-facing introspection ---------------------------------------

    @property
    def next_gid(self) -> int:
        return self._next_gid

    @property
    def num_live(self) -> int:
        return int(self.telemetry()["num_live"])

    @property
    def snapshots_taken(self) -> int:
        return int(self.telemetry()["snapshots"])

    def validate_queries(self, queries) -> np.ndarray:
        # pure client-side check (engine's own formula): a malformed batch
        # must fail fast in the router, not one RPC later in the worker
        return serve_engine.validate_queries(queries, self._seed.shape[1])

    def bucket_for(self, q: int) -> int:
        return serve_engine.bucket_for(q, self.serve_cfg)

    def telemetry(self) -> dict:
        t, _ = self._rpc("telemetry")
        if t.get("cand_buckets"):
            # JSON stringified the int bucket keys on the wire
            t["cand_buckets"] = {int(k): v
                                 for k, v in t["cand_buckets"].items()}
        return t

    def health(self) -> dict:
        meta, _ = self._rpc("health")
        return meta

    # -- chaos seams (worker-side state, property-fronted) ------------------

    @property
    def fail_next_queries(self) -> int:
        return int(self._rpc("get_chaos")[0]["fail_next_queries"])

    @fail_next_queries.setter
    def fail_next_queries(self, n: int) -> None:
        self._rpc("set_chaos", {"fail_next_queries": int(n)})

    @property
    def slow_ms(self) -> float:
        return float(self._rpc("get_chaos")[0]["slow_ms"])

    @slow_ms.setter
    def slow_ms(self, ms: float) -> None:
        self._rpc("set_chaos", {"slow_ms": float(ms)})

    def close(self) -> None:
        self.handle.shutdown(self.conn)
        if self.conn is not None:
            self.conn.close()
            self.conn = None


def spawn_replica_grid(cfg, serve_cfg, ccfg, root: str,
                       shard_rows: List[np.ndarray], seed: int = 0,
                       params_fn: Optional[ParamsFn] = None, device=None,
                       shm_pool: Optional[shm.SlabRing] = None,
                       ) -> List[List[RemoteReplica]]:
    """Boot the S×R worker grid, worker (0, 0) first.

    The hash parameters are drawn once here (``params_fn(cfg, dim)``, else
    ``make_params(cfg, dim, seed)``) and every worker gets the same.  Worker
    (0, 0) boots alone first: its first launch builds the CUDA kernels into
    ``build/repro_torch_kernels/<hash>/`` (if they are not there yet), so
    the remaining W-1 workers, booted together, load them instead of each
    running ``nvcc``.

    ``ccfg.transport == 'tcp'`` places workers on loopback ``host:port``
    endpoints (kernel-assigned, resolved via endpoint files); entries in
    ``ccfg.worker_hosts`` — ``tcp:host:port`` specs in shard-major
    (s*R + r) order — attach to EXTERNAL, already-running workers
    instead of spawning (multi-host placement).  ``shm_pool`` is the
    router-owned request-staging ring shared by every same-host proxy
    (unix only; the slab fast path never crosses hosts).
    """
    S, R = ccfg.num_shards, ccfg.num_replicas
    dim = int(shard_rows[0].shape[1])
    params = (params_fn(cfg, dim) if params_fn is not None
              else make_params(cfg, dim, seed))
    family = "tcp" if ccfg.transport == "tcp" else "unix"
    hosts = list(getattr(ccfg, "worker_hosts", None) or ())
    # a previous cluster SIGKILL'd mid-flight may have leaked slabs; a
    # boot is the natural quiesce point to collect them
    shm.reap_orphan_slabs()

    def make(s: int, r: int) -> RemoteReplica:
        idx = s * R + r
        return RemoteReplica(
            s, r, cfg, serve_cfg, seed,
            os.path.join(root, f"shard{s:02d}", f"replica{r}"),
            shard_rows[s], keep_snapshots=ccfg.keep_snapshots,
            wal_fsync=ccfg.wal_fsync,
            snapshot_every_bytes=ccfg.snapshot_every_bytes,
            snapshot_every_s=ccfg.snapshot_every_s,
            params_fn=lambda c, d: params, device=device,
            rpc_timeout_s=ccfg.rpc_timeout_s,
            family=family,
            address=hosts[idx] if idx < len(hosts) else None,
            shm_pool=shm_pool,
            shm_threshold=ccfg.shm_threshold_bytes,
            shm_slots=ccfg.shm_slots,
            shm_slot_bytes=ccfg.shm_slot_bytes)

    grid: List[List[Optional[RemoteReplica]]] = [
        [None] * R for _ in range(S)]
    grid[0][0] = make(0, 0)            # builds the kernels if needed
    rest = [(s, r) for s in range(S) for r in range(R) if (s, r) != (0, 0)]
    if rest:
        with cf.ThreadPoolExecutor(max_workers=len(rest)) as pool:
            futs = {pool.submit(make, s, r): (s, r) for s, r in rest}
            errs = []
            for fut in cf.as_completed(futs):
                s, r = futs[fut]
                try:
                    grid[s][r] = fut.result()
                except Exception as err:
                    errs.append((s, r, err))
            if errs:
                for row in grid:       # don't leak the workers that DID boot
                    for rep in row:
                        if rep is not None:
                            rep.close()
                s, r, err = errs[0]
                raise RuntimeError(
                    f"worker s{s}r{r} failed to boot: {err}") from err
    return grid
