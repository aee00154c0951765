"""Batched ANN serving engine, torch counterpart of ``repro.serve.engine``.

Requests queue up and leave in batches padded to power-of-two shape
buckets; the mutable segmented index takes inserts and deletes between
batches and compacts on its watermarks; every batch runs the compacted
two-phase query (``SegmentedIndex.query_compact``).  Batch latency is taken
after ``torch.cuda.synchronize()`` on the card.

Not ported yet: the JAX compile cache (``persistent_cache``, ``cache_dir``;
the port compiles its kernels once per build directory instead), the
recall autotuner (``target_recall``, ``autotune_calib``), the race sanitizer
and the flight recorder.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import IndexConfig
from repro_torch.core.segments import SegmentedIndex

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
                 index: Optional[SegmentedIndex] = None, device=None):
        """``dataset`` seeds a fresh index (params from ``seed``); ``index``
        adopts an existing one, which keeps its device."""
        if (dataset is None) == (index is None):
            raise ValueError("pass exactly one of dataset= or index=")
        self.serve_cfg = serve_cfg
        self.cfg = cfg
        if index is not None:
            self.index = index
            index.cap_quantile = serve_cfg.cand_cap_quantile
            index.cap_sample = serve_cfg.cand_cap_sample
        else:
            self.index = SegmentedIndex.from_dataset(
                cfg, dataset, delta_cap=serve_cfg.delta_cap,
                cap_quantile=serve_cfg.cand_cap_quantile,
                cap_sample=serve_cfg.cand_cap_sample, device=device, seed=seed)
        self.device = self.index.device
        self._dim = self.index.dim
        self._pending: List[np.ndarray] = []
        self.stats = {k: 0 for k in ("batches", "queries", "hedges", "inserts",
                                     "deletes", "bucket_cold_hits",
                                     "overflow_hits", "truncated_candidates")}
        self.stats.update(compact_ms=0.0, warmup_ms=0.0, total_ms=0.0,
                          cand_buckets=Counter())
        self._lat_ms: List[float] = []
        # (bucket, index-structure signature[, rung]) keys already run
        self._warm: set = set()
        if serve_cfg.warm_buckets:
            self.warmup()

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
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Run one padded batch; returns PADDED (B, k) host results."""
        sig = self._index_signature()
        key = (batch.shape[0], sig)
        if key not in self._warm:
            self.stats["bucket_cold_hits"] += 1
            self._warm.add(key)
        t0 = time.perf_counter()
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
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        if ms > self.serve_cfg.hedge_ms:
            self.stats["hedges"] += 1
        self.stats["batches"] += 1
        self.stats["queries"] += n_real
        self.stats["total_ms"] += ms
        self._lat_ms.append(ms)
        return d.cpu().numpy(), i.cpu().numpy()

    def run_padded(self, batch: np.ndarray, n_real: int):
        """Serve one pre-padded batch; returns padded results."""
        if self.serve_cfg.warm_buckets:
            self.warmup()
        return self._run_batch(np.asarray(batch, np.int32), n_real)

    def query_batch(self, queries) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous query: chunk to ``batch_size``, pad each chunk to its
        bucket, return unpadded (Q, k) dists/gids."""
        q = validate_queries(queries, self._dim)
        if q.shape[0] == 0:
            return (np.zeros((0, self.cfg.k), np.int32),
                    np.zeros((0, self.cfg.k), np.int32))
        if self.serve_cfg.warm_buckets:
            self.warmup()
        out_d, out_i = [], []
        for lo in range(0, q.shape[0], self.serve_cfg.batch_size):
            chunk = q[lo: lo + self.serve_cfg.batch_size]
            d, i = self._run_batch(self._pad(chunk), chunk.shape[0])
            out_d.append(d[:chunk.shape[0]])
            out_i.append(i[:chunk.shape[0]])
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
            out_d.append(d[:len(take)])
            out_i.append(i[:len(take)])
        self._maybe_compact()
        if not out_d:
            return (np.zeros((0, self.cfg.k), np.int32),
                    np.zeros((0, self.cfg.k), np.int32))
        return np.concatenate(out_d), np.concatenate(out_i)

    def summary(self) -> dict:
        total_s = self.stats["total_ms"] / 1e3
        lat = np.asarray(self._lat_ms, np.float64)

        def pct(p):
            return float(np.percentile(lat, p)) if lat.size else 0.0

        return {
            "device": str(self.device),
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
            "mean_batch_ms": float(lat.mean()) if lat.size else 0.0,
            "p50_batch_ms": pct(50),
            "p99_batch_ms": pct(99),
            "p999_batch_ms": pct(99.9),
            "queries_per_s": (self.stats["queries"] / total_s
                              if total_s > 0 else 0.0),
        }
