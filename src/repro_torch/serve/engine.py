"""Batched ANN serving engine, torch counterpart of ``repro.serve.engine``.

Requests queue up and leave in batches padded to power-of-two shape
buckets; the mutable segmented index takes inserts and deletes between
batches and compacts on its watermarks; every batch runs the compacted
two-phase query (``SegmentedIndex.query_compact``).  Batch latency is taken
after ``torch.cuda.synchronize()`` on the card.

Given ``ServeConfig(target_recall=...)`` the engine tunes (L, T, cap) at
start-up through the success model (``eval.autotune.tune_for_recall``) and
seeds its index from the tuner's validated state.  Metrics live in a typed
registry (``obs.MetricsRegistry``, which doubles as ``stats``), batch
latency in its log2 histogram, recent batches in a flight recorder; with
``REPRO_TRACE=1`` each batch is an ``engine_batch`` span over the index's
phase spans (``query_batch`` an ``engine_request`` span over its
validation, batches and answers' copies), and with ``REPRO_SANITIZE=1`` the entry points carry race
tokens (``analysis.racecheck``).  The JAX package's persistent compile cache
(``persistent_cache``, ``cache_dir``) has no counterpart: the port builds
its kernels once per build directory.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import racecheck
from repro_torch.core.index import IndexConfig, IndexState, ParamsFn
from repro_torch.core.segments import SegmentedIndex
from repro_torch.obs import FlightRecorder, MetricsRegistry
from repro_torch.obs import trace as obs_trace

__all__ = ["ServeConfig", "AnnServingEngine", "shape_buckets", "bucket_for",
           "validate_queries"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 64           # max queries per dispatch (largest bucket)
    bucket_min: int = 8            # smallest padded batch shape
    shape_buckets: bool = True     # pow2 buckets; False = always pad to batch_size
    warm_buckets: bool = True      # run every (bucket x rung) at startup
    compact_probe: bool = True     # compacted two-phase query; False = the
                                   # worst-case L*P*C slab every batch
    cand_bucket_min: int = 128     # smallest candidate-count bucket
    cand_cap_quantile: float = 0.999  # occupancy quantile of the per-bucket
                                   # cap; >= 1.0 disables the second level
    cand_overflow: str = "escalate"  # 'escalate' (exact) | 'truncate'
    cand_cap_sample: int = 32      # surrogate queries per segment for ctot_norm
    hedge_ms: float = 50.0
    max_wait_ms: float = 2.0
    delta_cap: int = 1024          # delta-buffer capacity (points)
    compact_watermark: float = 0.5  # delta fill fraction that triggers compaction
    max_segments: int = 4           # segment count that triggers compaction
    tombstone_watermark: float = 0.25  # dead/live fraction that triggers compaction
    target_recall: Optional[float] = None  # quality target: autotune (L, T,
                                   # candidate_cap) at start-up
    autotune_calib: int = 32       # calibration queries for the autotuner


def shape_buckets(serve_cfg: ServeConfig) -> List[int]:
    """Padded batch shapes a ``serve_cfg`` dispatches: pow2 up to batch_size."""
    if not serve_cfg.shape_buckets:
        return [serve_cfg.batch_size]
    out, b = [], max(1, serve_cfg.bucket_min)
    while b < serve_cfg.batch_size:
        out.append(b)
        b *= 2
    out.append(serve_cfg.batch_size)
    return out


def bucket_for(q: int, serve_cfg: ServeConfig) -> int:
    """Padded shape a q-row batch dispatches at under ``serve_cfg``."""
    for b in shape_buckets(serve_cfg):
        if q <= b:
            return b
    return serve_cfg.batch_size


def validate_queries(queries, dim: int) -> np.ndarray:
    """Normalize to (Q, dim) int32, failing now with a clear message."""
    arr = np.atleast_2d(np.asarray(queries))
    if arr.ndim != 2:
        raise ValueError(f"queries must be (dim,) or (Q, dim); got shape {arr.shape}")
    if arr.shape[1] != dim:
        raise ValueError(f"query dim {arr.shape[1]} != index dim {dim} "
                         f"(shape {arr.shape})")
    if not np.can_cast(arr.dtype, np.int32, casting="same_kind"):
        raise TypeError(f"queries must be integer-typed (castable to int32); "
                        f"got dtype {arr.dtype}")
    return arr.astype(np.int32, copy=False)


class AnnServingEngine:
    """Single-shard engine over a ``SegmentedIndex`` on ``device`` (``None``
    means the card; without one the constructor raises)."""

    def __init__(self, cfg: IndexConfig, serve_cfg: ServeConfig,
                 dataset=None, seed: int = 0,
                 index: Optional[SegmentedIndex] = None, device=None,
                 params_fn: Optional[ParamsFn] = None):
        """``dataset`` seeds a fresh index, with hash parameters from
        ``params_fn(cfg, dim)`` or else drawn from ``seed``; ``index`` adopts
        an existing one, which keeps its device (and clears any
        ``target_recall``: an adopted index is served as it is)."""
        if (dataset is None) == (index is None):
            raise ValueError("pass exactly one of dataset= or index=")
        if index is not None:
            serve_cfg = dataclasses.replace(serve_cfg, target_recall=None)
        self.serve_cfg = serve_cfg
        self.autotune = None
        if serve_cfg.target_recall is not None and dataset.shape[0] > 0:
            # derive (L, T, cap) from the success model and a calibration
            # split; an empty dataset has nothing to calibrate against and
            # is served as configured
            from repro_torch.eval.autotune import tune_for_recall
            self.autotune = tune_for_recall(
                cfg, dataset, serve_cfg.target_recall, seed=seed,
                num_calib=serve_cfg.autotune_calib, params_fn=params_fn,
                device=resolve_device(device))
            cfg = self.autotune.cfg
        self.cfg = cfg
        caps = dict(cap_quantile=serve_cfg.cand_cap_quantile,
                    cap_sample=serve_cfg.cand_cap_sample)
        if index is not None:
            self.index = index
            index.cap_quantile = serve_cfg.cand_cap_quantile
            index.cap_sample = serve_cfg.cand_cap_sample
        elif self.autotune is not None:
            # the tuner built and validated exactly this index: seed the
            # segment from it instead of hashing and sorting again
            n = int(dataset.shape[0])
            self.index = SegmentedIndex.from_checkpoint(
                cfg, self.autotune.state, np.arange(n, dtype=np.int32), n,
                delta_cap=serve_cfg.delta_cap, **caps)
        else:
            params = None if params_fn is None else params_fn(
                cfg, int(dataset.shape[1]))
            self.index = SegmentedIndex.from_dataset(
                cfg, dataset, delta_cap=serve_cfg.delta_cap, params=params,
                device=device, seed=seed, **caps)
        self.device = self.index.device
        self._dim = self.index.dim
        self._pending: List[np.ndarray] = []
        # the typed registry doubles as the dict-style ``stats``; batch
        # latency goes to its log2 histogram (bounded memory)
        self.metrics = MetricsRegistry("engine")
        self.stats = self.metrics
        for k in ("batches", "queries", "hedges", "inserts", "deletes",
                  "bucket_cold_hits", "overflow_hits", "truncated_candidates"):
            self.stats[k] = 0
        for k in ("compact_ms", "warmup_ms", "total_ms"):
            self.stats[k] = 0.0
        self.metrics.family("cand_buckets")
        self._lat = self.metrics.histogram("batch_ms")
        # bounded ring of recent batches, slow ones kept as exemplars
        self.flight = FlightRecorder(slow_ms=serve_cfg.hedge_ms)
        # (bucket, index-structure signature[, rung]) keys already run
        self._warm: set = set()
        if serve_cfg.warm_buckets:
            self.warmup()
        # opt-in race sanitizer, after warm-up so boot-time calls stay bare
        racecheck.maybe_instrument(
            self, f"engine@{id(self):x}",
            queries=("run_padded", "query_batch", "drain"),
            mutations=("insert", "delete", "compact"))

    # -- shape buckets -----------------------------------------------------

    def buckets(self) -> List[int]:
        return shape_buckets(self.serve_cfg)

    def bucket_for(self, q: int) -> int:
        return bucket_for(q, self.serve_cfg)

    def _index_signature(self) -> tuple:
        return self.index.structure_signature()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Run every batch bucket against the current index structure — with
        ``compact_probe``, at every rung of every segment's candidate ladder
        — so the first live batch of any shape meets built kernels and warm
        allocator pools; ``stats['bucket_cold_hits']`` counts live shapes
        that were not warmed."""
        t0 = time.perf_counter()
        sig = self._index_signature()
        for b in self.buckets():
            if (b, sig) in self._warm:
                continue
            warm = torch.zeros((b, self._dim), dtype=torch.int32, device=self.device)
            if self.serve_cfg.compact_probe:
                for key in self.index.warm_compact(
                        warm, floor=self.serve_cfg.cand_bucket_min,
                        overflow=self.serve_cfg.cand_overflow):
                    self._warm.add((b, sig) + key)
            else:
                self.index.query(warm)
            self._warm.add((b, sig))
        self._sync()
        self.stats["warmup_ms"] += (time.perf_counter() - t0) * 1e3

    @property
    def state(self) -> IndexState:
        """The compacted index's ``IndexState``; refuses a partial view while
        delta inserts, tombstones or extra segments are pending (use
        ``checkpoint_payload`` or ``compact()`` first)."""
        idx = self.index
        if not idx.segments:
            raise RuntimeError("index is empty; nothing to checkpoint")
        if idx.num_segments != 1 or idx.delta_fill > 0 or idx.num_tombstones:
            raise RuntimeError(
                "index has uncompacted mutations; call compact() first or "
                "checkpoint via checkpoint_payload()")
        return idx.segments[0].state

    def checkpoint_payload(self):
        """(IndexState, gids, next_gid) capturing every acknowledged
        mutation; compacts as needed.  Restore with
        ``SegmentedIndex.from_checkpoint``."""
        return self.index.checkpoint_payload()

    # -- mutation endpoints ------------------------------------------------

    def insert(self, points) -> np.ndarray:
        """Add points to the live index; returns their global ids."""
        gids = self.index.insert(points)
        self.stats["inserts"] += len(gids)
        self._maybe_compact()
        return gids

    def delete(self, gids) -> int:
        """Tombstone global ids; returns how many were newly deleted."""
        removed = self.index.delete(gids)
        self.stats["deletes"] += removed
        self._maybe_compact()
        return removed

    def compact(self) -> None:
        """Force a major compaction, then re-warm the new structure."""
        t0 = time.perf_counter()
        self.index.compact()
        self._sync()
        self.stats["compact_ms"] += (time.perf_counter() - t0) * 1e3
        if self.serve_cfg.warm_buckets:
            self.warmup()

    def _maybe_compact(self) -> None:
        idx = self.index
        if (idx.delta_fill >= self.serve_cfg.compact_watermark
                or idx.num_segments > self.serve_cfg.max_segments
                or (idx.num_tombstones
                    >= self.serve_cfg.tombstone_watermark * max(idx.num_live, 1))):
            self.compact()

    # -- query path --------------------------------------------------------

    def submit(self, queries) -> None:
        for q in validate_queries(queries, self._dim):
            self._pending.append(q)

    def _pad(self, batch: np.ndarray) -> np.ndarray:
        bucket = self.bucket_for(batch.shape[0])
        if batch.shape[0] < bucket:
            pad = np.zeros((bucket - batch.shape[0], self._dim), np.int32)
            batch = np.concatenate([batch, pad])
        return batch

    def _run_batch(self, batch: np.ndarray, n_real: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run one padded batch; returns PADDED (B, k) results on the
        engine's device."""
        with obs_trace.span("engine_validate"):
            self.index.admit_queries(batch[:n_real])
            sig = self._index_signature()
            key = (batch.shape[0], sig)
            if key not in self._warm:
                self.stats["bucket_cold_hits"] += 1
                self._warm.add(key)
        used = ()
        obs_trace.capture_begin()
        t0 = time.perf_counter()
        with obs_trace.span("engine_batch", bucket=int(batch.shape[0]),
                            n_real=int(n_real)):
            with obs_trace.span("engine_h2d"):
                queries = torch.from_numpy(batch).to(self.device)
            if self.serve_cfg.compact_probe:
                d, i, used = self.index.query_compact(
                    queries, floor=self.serve_cfg.cand_bucket_min,
                    overflow=self.serve_cfg.cand_overflow, stats=self.stats)
                for seg_key in used:
                    self.stats["cand_buckets"][seg_key[1]] += 1
                    ck = key + seg_key
                    if ck not in self._warm:
                        self.stats["bucket_cold_hits"] += 1
                        self._warm.add(ck)
            else:
                d, i = self.index.query(queries)
            with obs_trace.span("engine_sync"):
                self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        if ms > self.serve_cfg.hedge_ms:
            self.stats["hedges"] += 1
        self.stats["batches"] += 1
        self.stats["queries"] += n_real
        self.stats["total_ms"] += ms
        self._lat.record_ms(ms)
        entry = {"bucket": int(batch.shape[0]), "n_real": int(n_real),
                 "rungs": [list(u) for u in used]}
        if ms > self.flight.slow_ms:
            # slow path only: stamp the exemplar with a result preview
            entry["preview_d"] = d[:1].cpu().tolist()  # repro: allow[r1-host-sync] flight-recorder slow-exemplar capture — batch-boundary read after torch.cuda.synchronize, slow path only (DESIGN.md §12)
        self.flight.record(ms, entry, spans=obs_trace.capture_end())
        return d, i

    def run_padded(self, batch: np.ndarray, n_real: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Serve one pre-padded batch; returns padded results on the
        engine's device (the cluster router folds shards there)."""
        if self.serve_cfg.warm_buckets:
            self.warmup()
        return self._run_batch(np.asarray(batch, np.int32), n_real)

    def query_batch(self, queries) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous query: chunk to ``batch_size``, pad each chunk to its
        bucket, return unpadded (Q, k) dists/gids.  The whole call is the
        ``engine_request`` span."""
        with obs_trace.span("engine_request"):
            with obs_trace.span("engine_validate"):
                q = validate_queries(queries, self._dim)
                if q.shape[0] == 0:
                    return (np.zeros((0, self.cfg.k), np.int32),
                            np.zeros((0, self.cfg.k), np.int32))
                if self.serve_cfg.warm_buckets:
                    self.warmup()
            out_d, out_i = [], []
            for lo in range(0, q.shape[0], self.serve_cfg.batch_size):
                chunk = q[lo: lo + self.serve_cfg.batch_size]
                with obs_trace.span("engine_validate"):
                    padded = self._pad(chunk)
                d, i = self._run_batch(padded, chunk.shape[0])
                with obs_trace.span("engine_answers"):
                    out_d.append(d[:chunk.shape[0]].cpu().numpy())  # repro: allow[r1-host-sync] batch-boundary result conversion after torch.cuda.synchronize
                    out_i.append(i[:chunk.shape[0]].cpu().numpy())  # repro: allow[r1-host-sync] batch-boundary result conversion after torch.cuda.synchronize
            return np.concatenate(out_d), np.concatenate(out_i)

    def drain(self) -> Tuple[np.ndarray, np.ndarray]:
        """Process all pending requests; returns (dists (B,k) int32 asc,
        gids (B,k) int32, -1 pad) stacked over requests."""
        if self.serve_cfg.warm_buckets and self._pending:
            self.warmup()
        out_d, out_i = [], []
        while self._pending:
            take = self._pending[:self.serve_cfg.batch_size]
            self._pending = self._pending[len(take):]
            d, i = self._run_batch(self._pad(np.stack(take)), len(take))
            out_d.append(d[:len(take)].cpu().numpy())  # repro: allow[r1-host-sync] batch-boundary result conversion after torch.cuda.synchronize
            out_i.append(i[:len(take)].cpu().numpy())  # repro: allow[r1-host-sync] batch-boundary result conversion after torch.cuda.synchronize
        self._maybe_compact()
        if not out_d:
            return (np.zeros((0, self.cfg.k), np.int32),
                    np.zeros((0, self.cfg.k), np.int32))
        return np.concatenate(out_d), np.concatenate(out_i)

    def summary(self) -> dict:
        """The JAX engine's summary keys, except that the port adds
        ``device`` and has no ``compile_cache`` (no JAX compile cache).  The
        batch-latency quantiles are the histogram's upper bounds (each
        bucket at most 12.5% wide), not exact per-batch times."""
        total_s = self.stats["total_ms"] / 1e3
        quality = None
        if self.autotune is not None:
            quality = {
                "target_recall": self.autotune.target_recall,
                "validated_recall": round(self.autotune.validated_recall, 4),
                "met_target": self.autotune.met_target,
                "num_tables": self.cfg.num_tables,
                "num_probes": self.cfg.num_probes,
                "candidate_cap": self.cfg.candidate_cap,
            }
        return {
            "device": str(self.device),
            "quality": quality,
            "queries": self.stats["queries"],
            "batches": self.stats["batches"],
            "hedges": self.stats["hedges"],
            "inserts": self.stats["inserts"],
            "deletes": self.stats["deletes"],
            "compactions": self.index.compactions,
            "segments": self.index.num_segments,
            "delta_fill": round(self.index.delta_fill, 4),
            "buckets": self.buckets(),
            "bucket_cold_hits": self.stats["bucket_cold_hits"],
            "cand_buckets": dict(sorted(self.stats["cand_buckets"].items())),
            "skew": {
                "cand_overflow": self.serve_cfg.cand_overflow,
                "cand_cap_quantile": self.serve_cfg.cand_cap_quantile,
                "overflow_hits": self.stats["overflow_hits"],
                "overflow_rate": (self.stats["overflow_hits"]
                                  / max(1, self.stats["batches"])),
                "truncated_candidates": self.stats["truncated_candidates"],
                "segments": self.index.skew_summary(),
            },
            "warmup_ms": self.stats["warmup_ms"],
            "mean_batch_ms": self._lat.mean_ms,
            "p50_batch_ms": self._lat.quantile_ms(0.50),
            "p99_batch_ms": self._lat.quantile_ms(0.99),
            "p999_batch_ms": self._lat.quantile_ms(0.999),
            "flight": self.flight.summary(),
            "queries_per_s": (self.stats["queries"] / total_s
                              if total_s > 0 else 0.0),
        }
