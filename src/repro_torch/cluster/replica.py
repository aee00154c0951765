"""One shard replica: engine + WAL + snapshots, torch counterpart of
``repro.cluster.replica`` (DESIGN.md §7).

A replica owns a full copy of its shard, an ``AnnServingEngine`` over the
shard's points on its device, plus what makes it durable and replaceable:

  * a :class:`~repro_torch.cluster.wal.WriteAheadLog`: every mutation batch
    is fsync'd to the log *before* it is applied to the engine, so an
    acknowledged insert/delete survives a kill;
  * a ``CheckpointManager`` snapshot, taken whenever applying a mutation
    compacted the index, on WAL growth or age (``snapshot_every_bytes``,
    ``snapshot_every_s``) and at explicit ``snapshot()`` calls.  It stores
    the raw shard rows, local gids, ``next_gid`` and the WAL seq it covers;
    the hash tables are not stored but rebuilt from the replica's hash
    parameters.

Every replica of a cluster holds the same parameters: ``params_fn(cfg,
dim)`` where the caller gives one, else the port's draw from ``seed``
(``core.index.make_params``).  The replica draws them once and hands the
same ones to its first engine, to ``recover()`` and to ``adopt_payload()``,
so a recovered or re-adopted replica hashes exactly as its peers do.

Recovery (:meth:`ShardReplica.recover`) = restore the latest snapshot,
rebuild the index, replay the WAL tail, each replayed insert's gids checked
against the log.  :meth:`catch_up_from` closes a WAL gap from a live peer,
record by record or by a full state transfer.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import racecheck
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.index import IndexConfig, ParamsFn, build_index, make_params
from repro_torch.core.segments import SegmentedIndex
from repro_torch.serve.engine import AnnServingEngine, ServeConfig, validate_queries

from .concurrency import under_quiesce
from .wal import OP_DELETE, OP_INSERT, WalRecord, WriteAheadLog

__all__ = ["ShardReplica", "ReplicaKilled", "ReplicaDiverged"]


class ReplicaKilled(RuntimeError):
    """Raised when a query/mutation reaches a dead replica."""


class ReplicaDiverged(RuntimeError):
    """Replay/apply produced different gids than the WAL recorded."""


class ShardReplica:
    """One replica of one shard; all replicas of a shard are bit-identical.

    ``device`` (None = the card) holds the engine's tensors."""

    def __init__(self, shard_id: int, replica_id: int, cfg: IndexConfig,
                 serve_cfg: ServeConfig, seed: int, root: str,
                 seed_dataset, keep_snapshots: int = 2,
                 wal_fsync: bool = True,
                 snapshot_every_bytes: Optional[int] = None,
                 snapshot_every_s: Optional[float] = None,
                 params_fn: Optional[ParamsFn] = None, device=None):
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.device = resolve_device(device)
        self.root = root
        seed_dataset = (seed_dataset.cpu().numpy() if torch.is_tensor(seed_dataset)
                        else np.asarray(seed_dataset))
        dim = int(seed_dataset.shape[1])
        self.params = (params_fn(cfg, dim) if params_fn is not None
                       else make_params(cfg, dim, seed)).to(self.device)
        self._wal_fsync = wal_fsync
        self.snapshot_every_bytes = snapshot_every_bytes
        self.snapshot_every_s = snapshot_every_s
        self._last_snap_t = time.monotonic()
        os.makedirs(root, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(root, "ckpt"),
                                      keep=keep_snapshots)
        self.wal = WriteAheadLog(os.path.join(root, "wal.log"),
                                 fsync=wal_fsync)
        self.alive = True
        self.last_seq = self.wal.last_seq
        self.snapshots_taken = 0
        # test/chaos seams driven by the router's failure-injection hooks
        self.fail_next_queries = 0     # raise ReplicaKilled on next N queries
        self.slow_ms = 0.0             # added latency per query batch
        self.recovered_records = 0     # WAL records replayed by a ctor recover
        if self.ckpt.latest_step() is None and self.last_seq == 0:
            # fresh replica: build from the seed slice and take the base
            # snapshot at once (the seed rows are not in the WAL)
            self.engine = AnnServingEngine(
                cfg, serve_cfg, dataset=seed_dataset, device=self.device,
                params_fn=self._params_fn)
            self._last_snap_compactions = self.engine.index.compactions
            self.snapshot()
        else:
            # the directory holds state (restart): recover from it
            self.engine = None
            self.recovered_records = self.recover()
        # opt-in race sanitizer (REPRO_SANITIZE=1), at the END of the ctor
        # so that boot-time recover()/snapshot() stay unwrapped
        racecheck.maybe_instrument(
            self, f"shard{shard_id}r{replica_id}",
            queries=("query",),
            mutations=("log_and_apply", "apply_records", "adopt_payload",
                       "recover", "catch_up_from", "compact", "kill"))

    def _params_fn(self, cfg: IndexConfig, dim: int):
        return self.params

    # -- mutation log + apply ---------------------------------------------

    @under_quiesce
    def log_and_apply(self, record: WalRecord) -> int:
        """WRITE-ahead: fsync the record, then apply it.  Returns removed
        count for deletes (insert returns 0)."""
        if not self.alive:
            raise ReplicaKilled(
                f"shard {self.shard_id} replica {self.replica_id} is down")
        self.wal.append_record(record)
        return self._apply(record)

    @under_quiesce
    def _apply(self, record: WalRecord) -> int:
        removed = 0
        if record.op == OP_INSERT:
            got = self.engine.insert(record.points)
            if not np.array_equal(np.asarray(got, np.int32), record.gids):
                raise ReplicaDiverged(
                    f"shard {self.shard_id} replica {self.replica_id}: "
                    f"insert assigned gids {got[:4]}… but the WAL recorded "
                    f"{record.gids[:4]}… (seq {record.seq})")
        elif record.op == OP_DELETE:
            removed = self.engine.delete(record.gids)
        else:
            raise ValueError(f"unknown WAL op {record.op}")
        self.last_seq = record.seq
        self._maybe_snapshot()
        return removed

    def _maybe_snapshot(self) -> None:
        """Snapshot and truncate the WAL when applying the mutation compacted
        the index, the WAL grew past ``snapshot_every_bytes``, or the last
        snapshot is older than ``snapshot_every_s``."""
        if self.engine.index.compactions != self._last_snap_compactions:
            self.snapshot()
            return
        if (self.snapshot_every_bytes is not None
                and self.wal.size_bytes >= self.snapshot_every_bytes):
            self.snapshot()
            return
        if (self.snapshot_every_s is not None
                and time.monotonic() - self._last_snap_t
                >= self.snapshot_every_s):
            self.snapshot()

    # -- query -------------------------------------------------------------

    def query(self, batch: np.ndarray, n_real: int):
        """Serve one pre-padded batch: padded (d, i) int32 tensors on the
        replica's device (the router folds shards there and slices).

        A killed replica raises; an injected-slow replica sleeps past the
        router's hedge deadline first.
        """
        if not self.alive:
            raise ReplicaKilled(
                f"shard {self.shard_id} replica {self.replica_id} is down")
        if self.fail_next_queries > 0:
            self.fail_next_queries -= 1
            raise ReplicaKilled(
                f"shard {self.shard_id} replica {self.replica_id}: "
                "injected query failure")
        if self.slow_ms > 0:
            time.sleep(self.slow_ms / 1e3)
        return self.engine.run_padded(batch, n_real)

    # -- durability --------------------------------------------------------

    def export_payload(self):
        """(dataset rows, local gids, next_gid) as host arrays, covering
        every acknowledged mutation: the snapshot payload and the unit of a
        peer's state transfer.  An emptied shard exports an empty payload
        whose ``next_gid`` still counts every id assigned."""
        try:
            state, gids, next_gid = self.engine.checkpoint_payload()
            return (state.dataset.cpu().numpy().astype(np.int32),
                    gids.cpu().numpy().astype(np.int32), int(next_gid))
        except RuntimeError:
            return (np.zeros((0, self.engine.index.dim), np.int32),
                    np.zeros((0,), np.int32), self.engine.index.next_gid)

    def snapshot(self) -> int:
        """Checkpoint the engine state + WAL position; truncate the log.

        Returns the snapshot step (== the WAL seq it covers).  A repeat at
        the current seq is a no-op: the snapshot on disk already covers the
        same logical state.
        """
        if self.ckpt.latest_step() == self.last_seq:
            return self.last_seq
        dataset, gids, next_gid = self.export_payload()
        self.ckpt.save(self.last_seq, {
            "dataset": dataset,
            "gids": gids,
            "next_gid": np.int32(next_gid),
            "wal_seq": np.int64(self.last_seq),
        })
        self.wal.truncate_upto(self.last_seq)
        self._last_snap_compactions = self.engine.index.compactions
        self._last_snap_t = time.monotonic()
        self.snapshots_taken += 1
        return self.last_seq

    @under_quiesce
    def compact(self) -> None:
        """Force a major compaction and snapshot the flat result."""
        self.engine.compact()
        self.snapshot()

    def kill(self) -> None:
        """Simulate a process death: drop in-memory state, keep disk."""
        self.alive = False
        self.engine = None
        self.wal.close()

    def _engine_from_payload(self, dataset, gids, next_gid: int) -> AnnServingEngine:
        """An engine over a payload, its tables rebuilt on the replica's
        device from the replica's hash parameters."""
        data = torch.from_numpy(np.ascontiguousarray(dataset, np.int32)).to(self.device)
        state = build_index(self.cfg, data, params=self.params)
        index = SegmentedIndex.from_checkpoint(
            self.cfg, state, np.asarray(gids, np.int32), int(next_gid),
            delta_cap=self.serve_cfg.delta_cap,
            cap_quantile=self.serve_cfg.cand_cap_quantile,
            cap_sample=self.serve_cfg.cand_cap_sample)
        return AnnServingEngine(self.cfg, self.serve_cfg, index=index)

    @under_quiesce
    def recover(self) -> int:
        """Snapshot restore + WAL replay; returns #records replayed.

        The snapshot rows are exact, the tables are rebuilt from the same
        parameters, and the WAL tail replays the later mutations in their
        order (gid assignment re-checked per record), so the rebuilt index
        equals the killed replica's acknowledged state.
        """
        if getattr(self, "wal", None) is not None and not self.wal.closed:
            # died without kill() (markdown / failed mutation): close the
            # old append handle, or every markdown->recover leaks an fd
            self.wal.close()
        self.wal = WriteAheadLog(os.path.join(self.root, "wal.log"),
                                 fsync=self._wal_fsync)
        step = self.ckpt.latest_step()
        if step is None:
            raise RuntimeError(
                f"shard {self.shard_id} replica {self.replica_id}: no "
                "snapshot to recover from (base snapshot missing)")
        snap = self.ckpt.restore_flat_step(step)
        self.engine = self._engine_from_payload(snap["dataset"], snap["gids"],
                                                int(snap["next_gid"]))
        self._last_snap_compactions = self.engine.index.compactions
        self.last_seq = int(snap["wal_seq"])
        replayed = 0
        for rec in self.wal.records(after_seq=self.last_seq):
            self._apply(rec)
            replayed += 1
        self.alive = True
        # a restarted process does not inherit injected chaos
        self.fail_next_queries = 0
        self.slow_ms = 0.0
        return replayed

    # -- catch-up primitives ------------------------------------------------

    def wal_records(self, after_seq: int = 0):
        """Complete WAL records with seq > ``after_seq`` (the peer side of
        record-level catch-up)."""
        return self.wal.records(after_seq=after_seq)

    @under_quiesce
    def apply_records(self, records) -> int:
        """Append + apply already-sequenced records from a peer (seq
        preserved); returns how many were applied."""
        for rec in records:
            self.wal.append_record(rec)
            self._apply(rec)
        return len(records)

    @under_quiesce
    def adopt_payload(self, dataset, gids, next_gid: int, seq: int) -> None:
        """Full state transfer: replace the engine with a peer's exported
        payload at ``seq`` and snapshot it as our own durable base."""
        self.engine = self._engine_from_payload(dataset, gids, next_gid)
        self.last_seq = int(seq)
        self._last_snap_compactions = self.engine.index.compactions
        self.snapshot()                # own durable base at the new seq

    @under_quiesce
    def catch_up_from(self, peer) -> int:
        """Close the WAL gap against a live peer; returns #records applied.

        Record by record when the peer still has every missing record,
        else a full state transfer of the peer's payload.
        """
        if peer.last_seq <= self.last_seq:
            return 0
        missing = peer.wal_records(after_seq=self.last_seq)
        have = {r.seq for r in missing}
        if all(s in have for s in range(self.last_seq + 1,
                                        peer.last_seq + 1)):
            return self.apply_records(missing)
        gap = peer.last_seq - self.last_seq
        dataset, gids, next_gid = peer.export_payload()
        self.adopt_payload(dataset, gids, next_gid, peer.last_seq)
        return gap

    # -- router-facing introspection ---------------------------------------

    @property
    def next_gid(self) -> int:
        """The shard-local gid counter (a restarted router sums these)."""
        return self.engine.index.next_gid

    @property
    def num_live(self) -> int:
        return self.engine.index.num_live

    def validate_queries(self, queries) -> np.ndarray:
        return validate_queries(queries, self.engine.index.dim)

    def bucket_for(self, q: int) -> int:
        return self.engine.bucket_for(q)

    def telemetry(self) -> dict:
        """Per-replica stats the router's ``summary()`` aggregates."""
        eng = self.engine
        return {
            "last_seq": self.last_seq,
            "snapshots": self.snapshots_taken,
            "wal_bytes": self.wal.size_bytes if not self.wal.closed else None,
            "num_live": eng.index.num_live,
            "bucket_cold_hits": eng.stats["bucket_cold_hits"],
            "cand_buckets": dict(sorted(eng.stats["cand_buckets"].items())),
            "overflow_hits": eng.stats["overflow_hits"],
            "truncated_candidates": eng.stats["truncated_candidates"],
            "skew_segments": eng.index.skew_summary(),
            "metrics": eng.metrics.snapshot(),
            "flight": {**eng.flight.summary(),
                       "exemplars": eng.flight.exemplars()},
        }

    def close(self) -> None:
        self.wal.close()
