"""Sharded, replicated, admission-controlled cluster router, torch
counterpart of ``repro.cluster.router`` (DESIGN.md §7, §10).

``ClusterRouter`` turns S*R single-shard :class:`ShardReplica` engines into
one logical index with the flat ``query_index`` contract:

  * **partitioning** — point with global gid ``g`` lives on shard
    ``g % S`` as local row id ``g // S``.  The router allocates gids densely
    in arrival order, so shard ``s`` receives the gids ``s, s+S, s+2S, …``
    in order and its engine's sequential local ids land on ``g // S``; seed
    row ``i`` keeps gid ``i``, so results compare directly with a flat
    index over the same rows;
  * **query fan-out** — a batch is padded once to the engines' shared shape
    bucket, sent to every shard (one replica each) from a thread pool, and
    the per-shard top-k lists are folded on the router's ``device`` with
    the ``topk_merge`` kernel (``pipeline.stage_merge_pair``), then copied
    to the host once.  With a non-truncating ``candidate_cap`` the result
    equals the flat single-engine path bit for bit;
  * **replication + hedging** — R replicas per shard.  The preferred
    replica rotates per batch; a failure fails over to a peer, a miss of
    the hedge deadline re-issues the batch to a peer and the first result
    wins; repeated failures mark a replica dead;
  * **mutations** — insert/delete route to the owning shard and are
    WAL-appended on every live replica before being applied; a killed
    replica recovers from snapshot + WAL replay and closes any gap from a
    live peer;
  * **admission control** — a bounded queue (``rejected_queue_full``) and
    per-query deadlines shed at dispatch (``rejected_deadline``);
  * **result cache** — per-query LRU stamped with the per-shard WAL seqs,
    so any acknowledged mutation invalidates it.

Transports (``ClusterConfig.transport``):

  * ``'inproc'`` — every replica is a ``ShardReplica`` in this process, on
    ``device`` (None = the card), and kernels launch from the pool's
    threads, which share one interpreter lock;
  * ``'process'`` — one worker subprocess a replica
    (``repro_torch.cluster.worker``, a ``RemoteReplica`` here), each with
    its own interpreter and CUDA context on ``device``, over AF_UNIX
    sockets; a fan-out batch of at least ``shm_threshold_bytes`` is
    padded once into a shared-memory slab slot that every shard reads;
  * ``'tcp'`` — the same workers on loopback ``host:port`` endpoints, or
    attached at ``worker_hosts``; no slabs.

A remote replica answers with host arrays; the router moves each shard's
answer to ``device`` once and folds there.  Hash parameters come from
``params_fn(cfg, dim)`` or else from ``seed``, as ``AnnServingEngine`` takes
them, the same for every replica (for workers, drawn once here and shipped).
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import pipeline as pipe
from repro_torch.core.index import IndexConfig, ParamsFn
from repro_torch.obs import FlightRecorder, MetricsRegistry
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import ServeConfig

from .concurrency import under_quiesce
from .replica import ReplicaKilled, ShardReplica
from .wal import OP_DELETE, OP_INSERT, WalRecord

__all__ = ["ClusterConfig", "ClusterRouter", "ClusterUnavailable"]


class ClusterUnavailable(RuntimeError):
    """No live replica could serve the shard (queries) or ack (mutations)."""


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    num_shards: int = 2
    num_replicas: int = 2
    hedge_ms: float = 200.0        # straggler deadline before re-issue
    max_queue_depth: int = 4096    # admission: pending-query bound
    cache_capacity: int = 256      # result-cache entries; 0 disables
    health_failures: int = 3       # consecutive failures -> marked dead
    keep_snapshots: int = 2
    wal_fsync: bool = True         # tests may relax for speed
    transport: str = "inproc"      # 'inproc' = ShardReplica objects in this
                                   # process; 'process' = one worker
                                   # subprocess per replica over AF_UNIX +
                                   # the shm fast path (DESIGN.md §10, §13);
                                   # 'tcp' = workers on host:port endpoints
    shm_threshold_bytes: Optional[int] = 16384   # arrays at least this big
                                   # ride shared-memory slabs instead of the
                                   # socket ('process' transport only; None
                                   # disables the fast path entirely)
    shm_slots: int = 8             # ring geometry, both directions: slots
    shm_slot_bytes: int = 1 << 20  # per ring x payload bytes per slot
    worker_hosts: Optional[Tuple[str, ...]] = None   # 'tcp:host:port' specs,
                                   # shard-major (s*R + r): attach to these
                                   # external workers instead of spawning
    rpc_timeout_s: float = 120.0   # per-RPC deadline against a worker (init
                                   # is exempt: it covers engine warm-up)
    pipeline_depth: int = 1        # drain(): batches in flight at once; >1
                                   # overlaps batch i's fold/cache work with
                                   # batch i+1's replica queries
    snapshot_every_bytes: Optional[int] = None   # replica snapshot cadence:
    snapshot_every_s: Optional[float] = None     # WAL growth / age triggers


class ClusterRouter:
    """S shards x R replicas behind one flat-index-compatible interface."""

    def __init__(self, cfg: IndexConfig, serve_cfg: ServeConfig,
                 ccfg: ClusterConfig, dataset, root: str, seed: int = 0,
                 params_fn: Optional[ParamsFn] = None, device=None):
        if serve_cfg.target_recall is not None:
            raise ValueError(
                "per-shard autotuning would give shards divergent configs; "
                "tune once (eval.autotune) and pass the tuned IndexConfig")
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.ccfg = ccfg
        data = (dataset.cpu().numpy() if torch.is_tensor(dataset)
                else np.asarray(dataset)).astype(np.int32, copy=False)
        if data.ndim != 2:
            raise ValueError(f"dataset must be (n, dim); got {data.shape}")
        self.dim = int(data.shape[1])
        S, R = ccfg.num_shards, ccfg.num_replicas
        if ccfg.transport not in ("inproc", "process", "tcp"):
            raise ValueError(
                f"unknown transport {ccfg.transport!r} "
                "(expected 'inproc', 'process', or 'tcp')")
        # where the shards' answers are folded (and, inproc, the replicas)
        self.device = resolve_device(device)
        self._shm = None               # module ref, process transports only
        self._wire_pool = None         # router-owned request-staging ring
        # shard s owns gids {g : g % S == s}; seed rows keep gid == row
        if ccfg.transport in ("process", "tcp"):
            from . import shm as shm_mod
            from .remote import spawn_replica_grid
            self._shm = shm_mod
            if (ccfg.transport == "process"
                    and ccfg.shm_threshold_bytes is not None):
                try:
                    self._wire_pool = shm_mod.SlabRing(
                        slots=ccfg.shm_slots,
                        slot_bytes=ccfg.shm_slot_bytes, tag="router")
                except OSError:
                    self._wire_pool = None   # no /dev/shm: socket path only
            self.replicas = spawn_replica_grid(
                cfg, serve_cfg, ccfg, root,
                [np.ascontiguousarray(data[s::S]) for s in range(S)],
                seed=seed, params_fn=params_fn, device=str(self.device),
                shm_pool=self._wire_pool)
        else:
            self.replicas = [[
                ShardReplica(
                    s, r, cfg, serve_cfg, seed,
                    os.path.join(root, f"shard{s:02d}", f"replica{r}"),
                    data[s::S], keep_snapshots=ccfg.keep_snapshots,
                    wal_fsync=ccfg.wal_fsync,
                    snapshot_every_bytes=ccfg.snapshot_every_bytes,
                    snapshot_every_s=ccfg.snapshot_every_s,
                    params_fn=params_fn, device=self.device)
                for r in range(R)] for s in range(S)]
        self.next_gid = int(data.shape[0])
        self._shard_seq = [0] * S
        self._adopt_durable_state()
        self._rr = [0] * S             # per-shard preferred-replica rotation
        # (row, deadline, enqueue_perf_s): the third field feeds the
        # per-batch queue_wait span at dispatch time
        self._queue: List[Tuple[np.ndarray, Optional[float], float]] = []
        self._cache: "collections.OrderedDict[bytes, tuple]" = \
            collections.OrderedDict()
        self._fail_counts: Dict[Tuple[int, int], int] = {}
        self._parked: Dict[int, List[WalRecord]] = {}
        # sized for the nesting worst case PER IN-FLIGHT BATCH: one dispatch
        # task + S fan-out tasks each blocking on up to 2 replica futures
        # (primary + hedge) — 3S+1 keeps an inner future always schedulable,
        # so the outer wait cannot deadlock the pool; pipelining multiplies
        # the whole tier by the number of batches in flight
        depth = max(1, ccfg.pipeline_depth)
        self._pool = cf.ThreadPoolExecutor(
            max_workers=max(4, (S * 3 + 1) * depth),
            thread_name_prefix="cluster-query")
        self._inflight: set = set()
        self._inflight_lock = threading.Lock()
        # guards stats/_fail_counts/alive mutations from pool threads:
        # S shards fail over concurrently, and dict += is read-modify-write
        self._stats_lock = threading.Lock()
        # registry-backed stats (DESIGN.md §12): the registry's dict-style
        # facade keeps every _bump/"stats[...]" site unchanged while the
        # counters become part of the mergeable-snapshot API; the
        # dispatch-latency histogram rides in the same registry
        self.metrics = MetricsRegistry("router")
        self.stats = self.metrics
        for k in ("queries", "batches", "served",
                  "hedged_batches", "hedge_wins", "failovers",
                  "rejected_queue_full", "rejected_deadline",
                  "cache_hits", "cache_misses",
                  "replicas_marked_dead", "recoveries",
                  "dispatch_failures"):
            self.stats[k] = 0
        self._dispatch_lat = self.metrics.histogram("dispatch_ms")
        # dispatch-granularity flight recorder: fan-out/hedge timing; the
        # rung/cbucket decisions live in each engine's recorder (telemetry)
        self.flight = FlightRecorder(slow_ms=ccfg.hedge_ms)
        obs_trace.set_process_label("router")

    @under_quiesce
    def _adopt_durable_state(self) -> None:
        """Cluster restart: adopt what the replica WALs/snapshots survived.

        A ``root`` that already holds replica state means every replica
        just self-recovered in its constructor (snapshot + WAL replay).
        The router's in-memory counters are rebuilt from the durable state:
        per-shard seq = the furthest replica (stale peers catch up from
        it), and the global gid counter = the sum of per-shard local
        counters — gids are allocated densely, so the counts partition
        exactly.
        """
        if all(r.last_seq == 0 for g in self.replicas for r in g):
            return
        total_next = 0
        for s, group in enumerate(self.replicas):
            leader = max(group, key=lambda r: r.last_seq)
            for rep in group:
                if rep is not leader and rep.last_seq < leader.last_seq:
                    rep.catch_up_from(leader)
            self._shard_seq[s] = leader.last_seq
            total_next += leader.next_gid
        self.next_gid = total_next

    # -- topology helpers --------------------------------------------------

    @property
    def num_shards(self) -> int:
        return self.ccfg.num_shards

    def shard_of(self, gid) -> np.ndarray:
        return np.asarray(gid) % self.num_shards

    def _alive(self, s: int) -> List[ShardReplica]:
        return [r for r in self.replicas[s] if r.alive]

    def _any_alive_replica(self) -> ShardReplica:
        for group in self.replicas:
            for r in group:
                if r.alive:
                    return r
        raise ClusterUnavailable("no alive replica in the cluster")

    def _signature(self) -> tuple:
        """Mutation signature: changes iff any shard acknowledged a
        mutation — the result cache's staleness stamp."""
        return tuple(self._shard_seq)

    def _track(self, fut) -> None:
        with self._inflight_lock:
            self._inflight.add(fut)

    def _quiesce(self) -> None:
        """Wait out straggler query futures (late hedging losers) so
        mutations/recovery never race an in-flight engine query."""
        with self._inflight_lock:
            pending = {f for f in self._inflight if not f.done()}
            self._inflight = pending.copy()
        if pending:
            cf.wait(pending)
            with self._inflight_lock:
                self._inflight -= pending

    # -- health ------------------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    def _health_ok(self, rep: ShardReplica) -> None:
        with self._stats_lock:
            self._fail_counts[(rep.shard_id, rep.replica_id)] = 0

    def _health_fail(self, rep: ShardReplica) -> None:
        k = (rep.shard_id, rep.replica_id)
        with self._stats_lock:
            self._fail_counts[k] = self._fail_counts.get(k, 0) + 1
            if (rep.alive
                    and self._fail_counts[k] >= self.ccfg.health_failures):
                rep.alive = False
                self.stats["replicas_marked_dead"] += 1

    # -- mutations ---------------------------------------------------------

    def insert(self, points) -> np.ndarray:
        """Insert points; returns their global gids (dense, arrival order).

        Acknowledged only after every live replica of each owning shard has
        fsync'd the WAL record and applied it.
        """
        pts = np.atleast_2d(np.asarray(points))
        if pts.ndim != 2 or pts.shape[1] != self.dim:
            raise ValueError(
                f"points must be (n, {self.dim}); got {pts.shape}")
        pts = pts.astype(np.int32, copy=False)
        gids = np.arange(self.next_gid, self.next_gid + pts.shape[0],
                         dtype=np.int32)
        shard = self.shard_of(gids)
        targets = sorted(set(shard.tolist()))
        self._require_alive(targets)
        self._quiesce()
        # burn the gids BEFORE applying: a partially-failed batch must never
        # reallocate ids a surviving shard already assigned (the engines'
        # local counters cannot roll back, so reuse = ReplicaDiverged)
        self.next_gid += pts.shape[0]
        recs = {}
        for s in targets:
            sel = shard == s
            recs[s] = WalRecord(seq=self._shard_seq[s] + 1, op=OP_INSERT,
                                gids=(gids[sel] // self.num_shards),
                                points=pts[sel])
        self._apply_all(recs)
        return gids

    @under_quiesce
    def _apply_all(self, recs: Dict[int, "WalRecord"]) -> int:
        """Apply one mutation batch's per-shard records, ALL shards, even
        past a failure.  A shard whose every replica failed gets its record
        parked (``_apply_to_shard``); skipping the remaining shards instead
        would strand THEIR slices of the already-burned gid range and break
        their local-counter arithmetic too.  Raises after the sweep if any
        shard could not acknowledge — the mutation is then applied on the
        healthy shards, parked for the failed ones, and converges to fully
        applied once ``recover_replica`` replays the parked records.
        """
        result, failed = 0, []
        for s, rec in recs.items():
            try:
                result += self._apply_to_shard(s, rec)
            except ClusterUnavailable:
                failed.append(s)
        if failed:
            raise ClusterUnavailable(
                f"shards {failed}: no replica acknowledged; records parked "
                "for replay at recovery (healthy shards already applied)")
        return result

    @under_quiesce
    def _apply_to_shard(self, s: int, rec: WalRecord) -> int:
        """Apply one mutation record to every live replica of shard ``s``.

        A replica that fails mid-mutation is marked dead on the spot (its
        WAL/engine may be ahead of or behind the record — recovery resyncs
        it from a peer), and the shard seq advances iff at least one
        replica acknowledged.  Without the markdown+advance discipline, one
        failing replica would leave the healthy peer's WAL ahead of
        ``_shard_seq`` and every later mutation would be rejected as
        non-monotone — poisoning the shard forever.

        If EVERY replica fails, the record is **parked**: the shard's gid
        stream must still receive it eventually (the dense g//S arithmetic
        leaves no way to skip a slice), so ``recover_replica`` replays
        parked records once a replica is back, and until then every
        mutation touching the shard fails upfront in ``_require_alive``.
        (Parked records live in router memory: a death of the whole
        process with a parked record loses that slice.)  Returns the first
        acknowledging replica's result (delete count).
        """
        acked, result = 0, 0
        for rep in self._alive(s):
            try:
                r = rep.log_and_apply(rec)
            except Exception:
                rep.alive = False
                self._bump("replicas_marked_dead")
                continue
            if acked == 0:
                result = r
            acked += 1
        if acked == 0:
            self._parked.setdefault(s, []).append(rec)
            raise ClusterUnavailable(
                f"shard {s}: no replica acknowledged mutation seq {rec.seq} "
                "(record parked for replay at recovery)")
        self._shard_seq[s] = rec.seq
        return result

    def delete(self, gids) -> int:
        """Tombstone global gids on their owning shards; returns how many
        were newly deleted (idempotent, unknown ids ignored)."""
        g = np.atleast_1d(np.asarray(gids, np.int64))
        g = g[(g >= 0) & (g < self.next_gid)].astype(np.int32)
        if g.size == 0:
            return 0
        shard = self.shard_of(g)
        targets = sorted(set(shard.tolist()))
        self._require_alive(targets)
        self._quiesce()
        recs = {s: WalRecord(seq=self._shard_seq[s] + 1, op=OP_DELETE,
                             gids=(g[shard == s] // self.num_shards))
                for s in targets}
        return self._apply_all(recs)

    def compact(self) -> None:
        """Force a major compaction + snapshot on every live replica."""
        self._quiesce()
        for group in self.replicas:
            for rep in group:
                if rep.alive:
                    rep.compact()

    def _require_alive(self, shards) -> None:
        for s in shards:
            if not self._alive(s):
                raise ClusterUnavailable(
                    f"shard {s}: no alive replica to acknowledge mutation")

    # -- failure / recovery orchestration ----------------------------------

    def kill_replica(self, s: int, r: int) -> None:
        self._quiesce()
        self.replicas[s][r].kill()

    def recover_replica(self, s: int, r: int) -> dict:
        """Snapshot-restore + WAL-replay the replica, then close any gap
        from a live peer, then replay any parked records (mutations that
        found zero live replicas — see ``_apply_to_shard``).  Returns
        {'replayed': …, 'caught_up': …, 'parked_applied': …}."""
        self._quiesce()
        rep = self.replicas[s][r]
        replayed = rep.recover()
        caught_up = 0
        for peer in self._alive(s):
            if peer is not rep and peer.last_seq > rep.last_seq:
                caught_up = rep.catch_up_from(peer)
                break
        if self._shm is not None:
            # a SIGKILL'd worker leaks its response ring; its replacement
            # made a fresh one, so the orphan is collectable right here
            self._shm.reap_orphan_slabs()
        parked_applied = 0
        parked = self._parked.get(s, [])
        while parked:  # pop AFTER a successful replay: a failure mid-replay
            rec = parked[0]   # must keep the record parked, or the shard's
            if rec.seq > rep.last_seq:   # gid stream is down a slice forever
                rep.log_and_apply(rec)
                parked_applied += 1
            self._shard_seq[s] = max(self._shard_seq[s], rec.seq)
            parked.pop(0)
        self._parked.pop(s, None)
        self._fail_counts[(s, r)] = 0
        self.stats["recoveries"] += 1
        return {"replayed": replayed, "caught_up": caught_up,
                "parked_applied": parked_applied}

    # -- query path --------------------------------------------------------

    def submit(self, queries, deadline_ms: Optional[float] = None) -> int:
        """Enqueue queries; returns how many were admitted.

        Overflow beyond ``max_queue_depth`` is rejected *now* (bounded
        memory, explicit ``rejected_queue_full``); an admitted query may
        still be shed at dispatch if its deadline expired in the queue.
        """
        q = self._any_alive_replica().validate_queries(queries)
        room = self.ccfg.max_queue_depth - len(self._queue)
        admit = max(0, min(q.shape[0], room))
        self.stats["rejected_queue_full"] += q.shape[0] - admit
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        t_enq = time.perf_counter()
        for row in q[:admit]:
            self._queue.append((row, deadline, t_enq))
        obs_trace.event("admission", admitted=int(admit),
                        rejected=int(q.shape[0] - admit),
                        queue_depth=len(self._queue))
        return admit

    def drain(self) -> Tuple[np.ndarray, np.ndarray]:
        """Serve everything admitted; returns (dists, gids) (N, k) int32 in
        submit order.  Shed rows (deadline expired in queue) are filled
        with -1 and counted in ``rejected_deadline``.

        With ``pipeline_depth > 1`` up to that many batches are dispatched
        before the oldest one's results are folded, so that batch i+1's
        replica queries overlap batch i's cache bookkeeping.  Results are
        still resolved strictly in submit order (depth 1 is the sequential
        drain).
        """
        k = self.cfg.k
        depth = max(1, self.ccfg.pipeline_depth)
        out_d: List[np.ndarray] = []
        out_i: List[np.ndarray] = []
        inflight: "collections.deque" = collections.deque()

        def resolve(entry) -> None:
            # runs on the drain caller's thread: cache writes and stats
            # that aren't _bump'd stay single-threaded
            d, i, todo_pos, todo_rows, sig, fut = entry
            if fut is not None:
                try:
                    bd, bi = fut.result()
                except ClusterUnavailable:
                    # a shard lost its last replica mid-drain: these rows
                    # stay -1 (explicit failure), and the drain CONTINUES —
                    # raising here would orphan the still-queued rows, and
                    # a later caller's drain would return them interleaved
                    # with its own (row misalignment)
                    self.stats["dispatch_failures"] += 1
                    out_d.append(d)
                    out_i.append(i)
                    return
                self.stats["cache_misses"] += len(todo_rows)
                self.stats["served"] += len(todo_rows)
                for j, pos in enumerate(todo_pos):
                    d[pos], i[pos] = bd[j], bi[j]
                    self._cache_put(todo_rows[j].tobytes(), sig, bd[j], bi[j])
            out_d.append(d)
            out_i.append(i)

        while self._queue:
            take = self._queue[: self.serve_cfg.batch_size]
            self._queue = self._queue[len(take):]
            d = np.full((len(take), k), -1, np.int32)
            i = np.full((len(take), k), -1, np.int32)
            now = time.monotonic()
            todo_pos: List[int] = []
            todo_rows: List[np.ndarray] = []
            sig = self._signature()
            # the trace root for the whole batch is born HERE — spans opened
            # on pool threads / workers chain off it via explicit (tid, sid)
            # hand-off (thread-locals do not follow _pool.submit)
            with obs_trace.span("cluster_batch", rows=len(take)):
                oldest = min(t for _, _, t in take)
                obs_trace.record_span(
                    "queue_wait",
                    dur_ms=(time.perf_counter() - oldest) * 1e3,
                    rows=len(take))
                hits = 0
                for pos, (row, deadline, _t_enq) in enumerate(take):
                    if deadline is not None and now > deadline:
                        self.stats["rejected_deadline"] += 1
                        continue
                    hit = self._cache_get(row.tobytes(), sig)
                    if hit is not None:
                        d[pos], i[pos] = hit
                        self.stats["cache_hits"] += 1
                        self.stats["served"] += 1
                        hits += 1
                    else:
                        todo_pos.append(pos)
                        todo_rows.append(row)
                obs_trace.event("cache", hits=hits, misses=len(todo_rows))
                ctx = obs_trace.current()
                fut = (self._pool.submit(self._dispatch,
                                         np.stack(todo_rows), ctx)
                       if todo_rows else None)
            inflight.append((d, i, todo_pos, todo_rows, sig, fut))
            if len(inflight) >= depth:
                resolve(inflight.popleft())
        while inflight:
            resolve(inflight.popleft())
        if not out_d:
            return (np.zeros((0, k), np.int32), np.zeros((0, k), np.int32))
        return np.concatenate(out_d), np.concatenate(out_i)

    def query(self, queries) -> Tuple[np.ndarray, np.ndarray]:
        """submit + drain in one call (no deadline, no shedding).

        All-or-nothing admission: raising AFTER a partial submit would
        orphan the admitted rows in the queue (wedging later submits and
        misaligning the next drain's rows with its caller's requests).
        """
        q = np.atleast_2d(np.asarray(queries))
        if len(self._queue) + q.shape[0] > self.ccfg.max_queue_depth:
            raise ClusterUnavailable(
                f"queue full: {q.shape[0]} rows need "
                f"{len(self._queue) + q.shape[0]}/"
                f"{self.ccfg.max_queue_depth} slots")
        self.submit(q)
        failures_before = self.stats["dispatch_failures"]
        out = self.drain()
        if self.stats["dispatch_failures"] != failures_before:
            # drain() degraded some rows to -1 to keep the queue aligned;
            # the one-shot helper's contract is all-or-error
            raise ClusterUnavailable(
                "one or more batches found no serving replica "
                "(rows marked -1; see stats['dispatch_failures'])")
        return out

    def _stage_fanout(self, rows: np.ndarray, n: int, bucket: int):
        """One gather for the whole fan-out: pad the batch straight into a
        shared slab slot, so the S shards get descriptor-only frames over
        one staged copy.  Returns (staged, padded); staged None = no slab
        (ring off or full, batch under the threshold, tcp), and then the
        plain pad and a socket copy a send apply."""
        nbytes = bucket * self.dim * 4
        staged = None
        if (self._wire_pool is not None
                and nbytes >= (self.ccfg.shm_threshold_bytes or 0)):
            from .transport import stage_buffer
            staged = stage_buffer(self._wire_pool, (bucket, self.dim),
                                  np.int32)
        if staged is not None:
            staged, buf = staged
            buf[:n] = rows
            buf[n:] = 0
            return staged, buf
        if n < bucket:
            rows = np.concatenate(
                [rows, np.zeros((bucket - n, self.dim), np.int32)])
        return None, rows

    def _dispatch(self, rows: np.ndarray, ctx=None,
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Fan one batch out to every shard and fold the top-k lists."""
        n = rows.shape[0]
        bucket = self._any_alive_replica().bucket_for(n)
        staged, padded = self._stage_fanout(rows, n, bucket)
        # _dispatch runs on a pool thread once drain() pipelines, so the
        # counters must go through the lock
        self._bump("batches")
        self._bump("queries", n)
        t0 = time.perf_counter()
        try:
            with obs_trace.span("fanout", parent=ctx,
                                shards=self.num_shards, n_real=n):
                fan_ctx = obs_trace.current() or ctx
                # all shards in flight at once: batch latency is
                # ~max(per-shard) and one shard's hedge wait does not stall
                # the others
                shard_futs = [
                    self._pool.submit(self._query_shard, s, padded, n,
                                      fan_ctx, staged)
                    for s in range(self.num_shards)]
                try:
                    with obs_trace.span("merge", shards=self.num_shards):
                        out = self._fold_shards(shard_futs, n)
                except BaseException:
                    # one shard failed: wait out its siblings (not in
                    # _inflight) so a follow-up mutation cannot race an
                    # in-flight query
                    cf.wait(shard_futs)
                    raise
        finally:
            if staged is not None:
                # drop the stager's reference; the slot itself frees when
                # the last in-flight send (a late hedge loser) retires
                staged.release()
        ms = (time.perf_counter() - t0) * 1e3
        with self._stats_lock:
            self._dispatch_lat.record_ms(ms)
        self.flight.record(ms, {"n_real": n, "shards": self.num_shards})
        return out

    def _on_device(self, x) -> torch.Tensor:
        """A shard's answer on the router's device.  A remote replica's is
        a view of a receive buffer or a slab slot, copied here
        (the slot frees when the view dies)."""
        if torch.is_tensor(x):
            return x.to(self.device)
        return torch.from_numpy(np.array(x, np.int32)).to(self.device)

    def _fold_shards(self, shard_futs, n: int,
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Map each shard's local ids to gids (``i * S + s``) and fold the
        lists pairwise with ``topk_merge``, on the router's device; one copy
        to the host at the end."""
        merged_d: Optional[torch.Tensor] = None
        merged_i: Optional[torch.Tensor] = None
        for s, fut in enumerate(shard_futs):
            d, i = map(self._on_device, fut.result())
            gi = torch.where(i >= 0, i * self.num_shards + s, -1).to(torch.int32)
            if merged_d is None:
                merged_d, merged_i = d, gi
            else:
                merged_d, merged_i = pipe.stage_merge_pair(merged_d, merged_i, d, gi)
        return merged_d[:n].cpu().numpy(), merged_i[:n].cpu().numpy()

    def _traced_query(self, rep: ShardReplica, padded: np.ndarray,
                      n_real: int, ctx, role: str, staged=None):
        """One replica query in a ``replica_query`` span, on the pool thread
        that serves the future; ``role`` tells the hedge primary, the
        re-issue and a failover apart.  A replica that ``supports_staged``
        gets the slab-staged batch instead of the rows."""
        with obs_trace.span("replica_query", parent=ctx,
                            shard=rep.shard_id, replica=rep.replica_id,
                            hedge=role):
            if staged is not None and getattr(rep, "supports_staged", False):
                return rep.query(padded, n_real, staged=staged)
            return rep.query(padded, n_real)

    def _query_shard(self, s: int, padded: np.ndarray, n_real: int, ctx=None,
                     staged=None):
        """One shard's answer, with failover and hedged re-issue.

        The preferred replica rotates per batch.  A fast failure fails over
        synchronously; a straggler (miss of ``hedge_ms``) gets the batch
        re-issued to a peer and the FIRST complete result wins — the dead
        and the slow replica are both survivable, which is the point of
        running R > 1.
        """
        order = self._alive(s)
        if not order:
            raise ClusterUnavailable(f"shard {s}: no alive replicas")
        start = self._rr[s] % len(order)
        self._rr[s] += 1
        order = order[start:] + order[:start]
        primary = order[0]
        with obs_trace.span("shard_query", parent=ctx, shard=s) as sp:
            ctx = obs_trace.current() or ctx
            fut = self._pool.submit(self._traced_query, primary, padded,
                                    n_real, ctx, "primary", staged)
            self._track(fut)
            try:
                res = fut.result(timeout=self.ccfg.hedge_ms / 1e3)
                self._health_ok(primary)
                return res
            except cf.TimeoutError:
                if len(order) == 1:
                    # nobody to hedge to: wait it out (NOT counted as a
                    # hedged re-issue — none happened); a failure here must
                    # surface as ClusterUnavailable so drain()'s
                    # degrade-in-place handler keeps the queue aligned
                    try:
                        res = fut.result()
                        self._health_ok(primary)
                        return res
                    except Exception as err:
                        self._health_fail(primary)
                        raise ClusterUnavailable(
                            f"shard {s}: sole replica failed after deadline"
                        ) from err
                self._bump("hedged_batches")
                sp.set(hedged=True)
                peer = order[1]
                fut2 = self._pool.submit(self._traced_query, peer, padded,
                                         n_real, ctx, "reissue", staged)
                self._track(fut2)
                return self._first_complete(
                    s, [(fut, primary), (fut2, peer)], primary)
            except Exception as err:  # fast failure (ReplicaKilled, …):
                self._health_fail(primary)       # fail over synchronously
                self._bump("failovers")
                obs_trace.event("failover", shard=s,
                                from_replica=primary.replica_id)
                for peer in order[1:]:
                    try:
                        res = self._traced_query(peer, padded, n_real,
                                                 ctx, "failover", staged)
                        self._health_ok(peer)
                        return res
                    except Exception as e2:
                        self._health_fail(peer)
                        err = e2
                raise ClusterUnavailable(
                    f"shard {s}: all replicas failed") from err

    def _first_complete(self, s: int, racers, primary):
        """Wait for the first *successful* racer; losers keep running and
        are reaped at the next quiesce point."""
        pending = {f for f, _ in racers}
        by_fut = dict(racers)
        last_err: Optional[BaseException] = None
        while pending:
            done, pending = cf.wait(pending, return_when=cf.FIRST_COMPLETED)
            for f in done:
                rep = by_fut[f]
                try:
                    res = f.result()
                except Exception as e:
                    self._health_fail(rep)
                    last_err = e
                    continue
                self._health_ok(rep)
                if rep is not primary:
                    self._bump("hedge_wins")
                obs_trace.event("hedge_win", shard=s,
                                replica=rep.replica_id,
                                hedged=rep is not primary)
                return res
        raise ClusterUnavailable(
            f"shard {s}: all hedged replicas failed") from last_err

    # -- caching -----------------------------------------------------------

    def clear_cache(self) -> None:
        """Drop every cached result (chaos drills / benchmarks force real
        dispatches with this; correctness never needs it — stale entries
        are already unreachable once the mutation signature moves)."""
        self._cache.clear()

    def _cache_get(self, key: bytes, sig: tuple):
        if self.ccfg.cache_capacity <= 0:
            return None
        ent = self._cache.get(key)
        if ent is None or ent[0] != sig:
            return None                 # miss or invalidated by a mutation
        self._cache.move_to_end(key)
        return ent[1], ent[2]

    def _cache_put(self, key: bytes, sig: tuple,
                   d: np.ndarray, i: np.ndarray) -> None:
        if self.ccfg.cache_capacity <= 0:
            return
        self._cache[key] = (sig, d.copy(), i.copy())
        self._cache.move_to_end(key)
        while len(self._cache) > self.ccfg.cache_capacity:
            self._cache.popitem(last=False)

    # -- introspection -----------------------------------------------------

    def summary(self) -> dict:
        shards = []
        # one mergeable roll-up across every live engine: merge is
        # commutative+associative (tests pin it), so shard/replica order
        # cannot change the cluster-wide counters or histogram buckets
        cluster_snap: Optional[dict] = None
        for s, group in enumerate(self.replicas):
            reps = []
            for rep in group:
                # one telemetry() per replica instead of attribute reaches
                # into its engine; a replica may be dead without being
                # marked yet, and stats must never be what surfaces that
                try:
                    t = rep.telemetry() if rep.alive else {}
                except ReplicaKilled:
                    t = {}
                snap = t.get("metrics")
                if snap:
                    cluster_snap = (snap if cluster_snap is None
                                    else obs_metrics.merge_snapshots(
                                        cluster_snap, snap))
                reps.append({
                    "replica": rep.replica_id,
                    "alive": rep.alive,
                    "last_seq": rep.last_seq,
                    "snapshots": t.get("snapshots"),
                    "wal_bytes": t.get("wal_bytes"),
                    "num_live": t.get("num_live"),
                    "bucket_cold_hits": t.get("bucket_cold_hits"),
                    "cand_buckets": t.get("cand_buckets"),
                    "overflow_hits": t.get("overflow_hits"),
                    "truncated_candidates": t.get("truncated_candidates"),
                    "skew_segments": t.get("skew_segments"),
                    "flight": t.get("flight"),
                })
            shards.append({
                "shard": s,
                "seq": self._shard_seq[s],
                "replicas": reps,
            })
        return {
            **self.metrics.as_dict(),
            "dispatch_ms": obs_metrics.summarize_snapshot(
                self.metrics.snapshot())["histograms"].get("dispatch_ms"),
            "cluster_metrics": (obs_metrics.summarize_snapshot(cluster_snap)
                                if cluster_snap else None),
            "flight": self.flight.summary(),
            # router-side wire accounting (§13): socket and slab payload
            # bytes, staging fallbacks, reaped orphans; None inproc
            "wire": (self._shm.wire_counters()
                     if self._shm is not None else None),
            "num_shards": self.ccfg.num_shards,
            "num_replicas": self.ccfg.num_replicas,
            "next_gid": self.next_gid,
            "queue_depth": len(self._queue),
            "cache_entries": len(self._cache),
            "shards": shards,
        }

    def close(self) -> None:
        self._quiesce()
        self._pool.shutdown(wait=True)
        for group in self.replicas:
            for rep in group:
                rep.close()
        if self._wire_pool is not None:
            self._wire_pool.close()
            self._wire_pool = None
