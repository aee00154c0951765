"""Segmented mutable MP-RW-LSH index, torch counterpart of
``repro.core.segments``.

LSM-style: immutable sorted segments (each an ``IndexState`` plus a gid
vector), a fixed-capacity delta buffer of fresh inserts scanned exactly by
the rerank stage, a tombstone set applied at the candidate stage (skipped,
with nothing launched, while the set is empty), and
``compact()`` folding everything back into one segment.  Per-source top-k
lists are folded with the bitonic ``topk_merge`` kernel (or, with
``use_merge_kernel=False``, the concat sort).  Every segment shares one
``LshParams`` (guarded by ``hashes.params_fingerprint``).

With ``REPRO_TRACE=1`` the compacted query records the spans ``phase_a``,
``phase_b_rerank``, ``delta_scan`` and ``merge`` and synchronizes the card
at the end of each, so that a span's time is the device's time for that
phase; with tracing off no span object exists and nothing synchronizes.
Inside the phases the stage spans (``stage_hash``, ``stage_probe_keys``,
``stage_probe_extents``, ``rung_read``; ``stage_fused_probe``,
``stage_dedup``, ``stage_tombstone``, ``stage_rerank``, ``gid_map``) never
synchronize, but for ``stage_rerank`` after a windowed launch, which reads
the launch's counters and phase times into its attributes: under a torch
profiler (spans off) their ``repro.*`` ranges name the host work that
launched each device record.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build as kbuild
from repro_torch.kernels import ops as kops
from repro_torch.obs import trace as obs_trace

from . import hashes as hashes_lib
from . import pipeline as pipe
from .index import (IndexConfig, IndexState, build_index, make_params,
                    make_template, probe_index)

__all__ = ["Segment", "SegmentedIndex"]

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class Segment:
    """One immutable sorted segment: an IndexState plus stable global ids."""

    state: IndexState                 # built with row_offset = 0
    gids: torch.Tensor                # (n,) int32 global row ids, ascending
    fingerprint: int
    ctot_cap: int = 0                 # worst-case valid candidates per query
    ctot_norm: int = 0                # normal-rung ladder top (0 = not derived)
    c_norm: int = 0                   # truncate-rung per-bucket cap
    occ_stats: Optional[dict] = None  # cached skew_summary quantiles

    @property
    def size(self) -> int:
        return int(self.gids.shape[0])


def _seg_ctot_cap(cfg: IndexConfig, state: IndexState) -> int:
    """Ladder top: L*P*min(cap, max bucket occupancy)."""
    occ = pipe.max_bucket_occupancy(state.sorted_keys, state.occ_from)  # repro: allow[r1-host-sync] seal-time cap derivation, once per segment seal
    return cfg.num_tables * cfg.probes_per_table * min(cfg.candidate_cap, occ)


def _gid_map(i: torch.Tensor, gids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(i >= 0, gids[i.clamp(0, n - 1).to(torch.int64)], -1)


def _query_segment(cfg, state: IndexState, gids, tombstones, queries):
    """Worst-case-slab pipeline over one segment: probe -> tombstone ->
    rerank -> gid."""
    n = state.dataset.shape[0]
    ids = pipe.probe_candidates(cfg, state.params, state.template,
                                state.sorted_keys, state.sorted_ids, n,
                                queries, occ_from=state.occ_from)
    ids = pipe.stage_tombstone(ids, gids, tombstones, n)
    d, i = pipe.stage_rerank(cfg, state.dataset, queries, ids)
    if n == 0:
        return d, i
    return d, _gid_map(i, gids, n)


def _truncated_total(occ, counts, c_cap: int, cbucket: int) -> int:
    """Candidates the truncate rung drops against the full-cap gather."""
    got = occ.clamp(max=c_cap).sum(dim=-1).clamp(max=cbucket)
    return int((counts - got).sum())


def _finish_segment(cfg, cbucket: int, c_cap: Optional[int], state: IndexState,
                    gids, tombstones, probe_keys, lo, occ, queries):
    """Phase B over one segment: compacted gather at the rung -> [dedup ->]
    tombstone -> rerank -> gid map."""
    n = state.dataset.shape[0]
    with obs_trace.span("stage_fused_probe"):
        ids, _ = pipe.stage_fused_probe(
            cfg, state.sorted_keys, state.sorted_ids, probe_keys, n, cbucket,
            extents=(lo, occ), c_cap=c_cap, occ_from=state.occ_from)
    if not pipe.rerank_handles_duplicates(cfg):
        with obs_trace.span("stage_dedup"):
            ids = pipe.stage_dedup(ids, n)
    with obs_trace.span("stage_tombstone", masked=tombstones is not None):
        ids = pipe.stage_tombstone(ids, gids, tombstones, n)
    with obs_trace.span("stage_rerank", slots=queries.shape[0] * cbucket) as span:
        traced = obs_trace.enabled()
        if traced:       # forget a path no traced span took
            kbuild.take_path("fused_rerank")
        d, i = pipe.stage_rerank(cfg, state.dataset, queries, ids)
        if traced:       # the kernel's path and counters, "none" off it
            path, detail = kbuild.take_path("fused_rerank") or ("none", 0)
            span.set(path=path, **kops.rerank_attrs(path, detail))
    if n == 0:
        return d, i
    with obs_trace.span("gid_map"):
        return d, _gid_map(i, gids, n)


def _query_delta(cfg, buffer, gids, count: int, tombstones, queries):
    """Exact scan of the delta buffer through the rerank stage."""
    cap = buffer.shape[0]
    slots = torch.arange(cap, dtype=torch.int32, device=buffer.device)
    ids = torch.where(slots < count, slots, cap)
    ids = ids.expand(queries.shape[0], cap).contiguous()
    ids = pipe.stage_tombstone(ids, gids, tombstones, cap)
    d, i = pipe.stage_rerank(cfg, buffer, queries, ids)
    return d, _gid_map(i, gids, cap)


class SegmentedIndex:
    """Mutable index = immutable segments + delta buffer + tombstones.

    Host-side orchestrator; not thread-safe (the serving engine serializes
    mutations against queries).  Tensors live on ``device`` (``None`` means
    the card).  ``tombstone_passes`` counts the segment and delta passes
    that ran the tombstone mask (``masked``) and those that skipped it with
    no tombstone held (``skipped``).
    """

    def __init__(self, cfg: IndexConfig, dim: int, delta_cap: int = 1024,
                 params: Optional[hashes_lib.LshParams] = None,
                 cap_quantile: float = 0.999, cap_sample: int = 32,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        if params is None:
            params = make_params(cfg, dim, seed)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.dim = dim
        self.delta_cap = int(delta_cap)
        self.cap_quantile = float(cap_quantile)
        self.cap_sample = int(cap_sample)
        self.fingerprint = hashes_lib.params_fingerprint(self.params)
        self._template = torch.from_numpy(make_template(cfg)).to(self.device)  # repro: allow[r1-host-sync] index construction: the template's one copy to the device
        self.segments: List[Segment] = []
        self._delta_points = np.zeros((self.delta_cap, dim), np.int32)
        self._delta_gids = np.full((self.delta_cap,), -1, np.int32)
        self._delta_count = 0
        self._tombstones: set = set()
        self._next_gid = 0
        self.compactions = 0
        self._delta_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._tomb_cache: Optional[torch.Tensor] = None
        self.tombstone_passes = {"masked": 0, "skipped": 0}
        self._coord_range: Optional[Tuple[int, int]] = None  # of every point held

    def _within_reach(self, lo: int, hi: int, what: str) -> Tuple[int, int]:
        """The union of ``(lo, hi)`` and the held points' range; raises when
        an L1 distance inside it could reach ``BIG_DIST``."""
        if self._coord_range is not None:
            lo, hi = min(lo, self._coord_range[0]), max(hi, self._coord_range[1])
        if self.dim * (hi - lo) >= pipe.BIG_DIST:
            raise ValueError(
                f"{what}: coordinates in [{lo}, {hi}] over {self.dim} dims could "
                f"reach an L1 distance of BIG_DIST ({pipe.BIG_DIST}), which the "
                f"rerank kernel does not rank as the reference does")
        return lo, hi

    def admit_points(self, points) -> None:
        """Record points about to enter the index (build, insert, restore),
        refusing them if a distance between held points and queries in
        their range could reach ``BIG_DIST``."""
        if points.shape[0] == 0:
            return
        self._coord_range = self._within_reach(int(points.min()), int(points.max()),
                                               "points")

    def admit_queries(self, queries: np.ndarray) -> None:
        """Refuse a host batch whose distances to held points could reach
        ``BIG_DIST``; reads nothing from the device."""
        if queries.shape[0]:
            self._within_reach(int(queries.min()), int(queries.max()), "queries")

    def _segment(self, state: IndexState, gids) -> Segment:
        return Segment(state=state, gids=gids, fingerprint=self.fingerprint,
                       ctot_cap=_seg_ctot_cap(self.cfg, state))

    def _build(self, data) -> IndexState:
        data = data if torch.is_tensor(data) else torch.from_numpy(data)
        return build_index(self.cfg, data.to(self.device, torch.int32),  # repro: allow[r1-host-sync] build-time: the points' one copy to the device, once per build (seed, seal, compaction)
                           params=self.params, template=self._template)

    @classmethod
    def from_dataset(cls, cfg: IndexConfig, dataset, delta_cap: int = 1024,
                     params: Optional[hashes_lib.LshParams] = None,
                     cap_quantile: float = 0.999, cap_sample: int = 32,
                     device=None, seed: int = 0) -> "SegmentedIndex":
        """Seed with one segment holding ``dataset`` (gids 0..n-1)."""
        if not torch.is_tensor(dataset):
            dataset = torch.from_numpy(np.ascontiguousarray(dataset, np.int32))
        n, dim = dataset.shape
        idx = cls(cfg, int(dim), delta_cap, params, cap_quantile=cap_quantile,
                  cap_sample=cap_sample, device=device, seed=seed)
        idx.admit_points(dataset)
        state = idx._build(dataset)
        idx.segments = [idx._segment(
            state, torch.arange(n, dtype=torch.int32, device=idx.device))]
        idx._next_gid = int(n)
        return idx

    @classmethod
    def from_checkpoint(cls, cfg: IndexConfig, state: IndexState, gids,
                        next_gid, delta_cap: int = 1024,
                        cap_quantile: float = 0.999,
                        cap_sample: int = 32) -> "SegmentedIndex":
        """Rebuild a serving index from a ``checkpoint_payload()`` triple, on
        the device the state lives on."""
        device = state.sorted_keys.device
        idx = cls(cfg, int(state.dataset.shape[1]), delta_cap,
                  params=state.params, cap_quantile=cap_quantile,
                  cap_sample=cap_sample, device=device)
        idx.admit_points(state.dataset)
        gids = torch.as_tensor(np.asarray(gids, np.int32)
                               if not torch.is_tensor(gids) else gids)
        idx.segments = [idx._segment(state, gids.to(torch.int32).to(device))]
        idx._next_gid = int(next_gid)
        return idx

    def checkpoint_payload(self) -> Tuple[IndexState, torch.Tensor, int]:
        """Durable payload ``(IndexState, gids, next_gid)``; compacts first
        when mutations are pending."""
        if self.num_segments != 1 or self._delta_count or self._tombstones:
            self.compact()
        if not self.segments:
            raise RuntimeError("empty index; nothing to checkpoint")
        seg = self.segments[0]
        return seg.state, seg.gids, self._next_gid

    # -- introspection ----------------------------------------------------

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    @property
    def delta_fill(self) -> float:
        return self._delta_count / self.delta_cap

    @property
    def num_live(self) -> int:
        total = sum(s.size for s in self.segments) + self._delta_count
        return total - len(self._tombstones)

    @property
    def num_tombstones(self) -> int:
        return len(self._tombstones)

    @property
    def next_gid(self) -> int:
        return self._next_gid

    # -- mutations --------------------------------------------------------

    def insert(self, points) -> np.ndarray:
        """Append points to the delta buffer; returns their global ids.  A
        full buffer is sealed into a segment."""
        pts = np.atleast_2d(np.asarray(points, np.int32))
        if pts.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {pts.shape[1]}")
        self.admit_points(pts)
        gids = np.arange(self._next_gid, self._next_gid + pts.shape[0],
                         dtype=np.int32)
        self._next_gid += pts.shape[0]
        pos = 0
        while pos < pts.shape[0]:
            if self._delta_count == self.delta_cap:
                self._seal_delta()
            take = min(self.delta_cap - self._delta_count, pts.shape[0] - pos)
            lo = self._delta_count
            self._delta_points[lo:lo + take] = pts[pos:pos + take]
            self._delta_gids[lo:lo + take] = gids[pos:pos + take]
            self._delta_count += take
            pos += take
        self._delta_cache = None
        return gids

    def delete(self, gids) -> int:
        """Tombstone global ids; returns how many were newly tombstoned."""
        before = len(self._tombstones)
        for g in np.atleast_1d(np.asarray(gids, np.int64)):
            if 0 <= g < self._next_gid:
                self._tombstones.add(int(g))
        if len(self._tombstones) != before:
            self._tomb_cache = None
        return len(self._tombstones) - before

    def _seal_delta(self) -> None:
        """Delta buffer -> immutable segment."""
        n = self._delta_count
        if n == 0:
            return
        state = self._build(self._delta_points[:n].copy())
        self.segments.append(self._segment(
            state, torch.from_numpy(self._delta_gids[:n].copy()).to(self.device)))  # repro: allow[r1-host-sync] seal-time: the sealed gids' one copy, once per seal
        self._delta_count = 0
        self._delta_gids[:] = -1
        self._delta_cache = None

    def compact(self) -> None:
        """Major compaction: segments + delta - tombstones -> one segment,
        in insertion order."""
        parts, gid_parts = [], []
        for seg in self.segments:
            if seg.fingerprint != self.fingerprint:
                raise ValueError("segment params diverged; cannot compact")
            parts.append(seg.state.dataset.to(torch.int32).cpu().numpy())  # repro: allow[r1-host-sync] compaction materializes on host by design
            gid_parts.append(seg.gids.cpu().numpy())  # repro: allow[r1-host-sync] compaction materializes on host by design
        if self._delta_count:
            parts.append(self._delta_points[:self._delta_count].copy())
            gid_parts.append(self._delta_gids[:self._delta_count].copy())
        if not parts:
            return
        data = np.concatenate(parts)
        gids = np.concatenate(gid_parts)
        order = np.argsort(gids, kind="stable")
        data, gids = data[order], gids[order]
        if self._tombstones:
            dead = np.asarray(sorted(self._tombstones), np.int32)
            live = ~np.isin(gids, dead)
            data, gids = data[live], gids[live]
        self.segments = []
        self._delta_count = 0
        self._delta_gids[:] = -1
        self._tombstones = set()
        self._delta_cache = None
        self._tomb_cache = None
        self.compactions += 1
        if data.shape[0] == 0:
            return
        state = self._build(data)
        self.segments = [self._segment(
            state, torch.from_numpy(np.ascontiguousarray(gids)).to(self.device))]  # repro: allow[r1-host-sync] compaction: the new segment's gids, once per compaction

    # -- query ------------------------------------------------------------

    def structure_signature(self) -> tuple:
        """(per-segment sizes, delta-scan active, tombstone-array capacity):
        the shapes the query path specializes on besides the batch."""
        tomb = len(self._tombstones)
        tomb_cap = 1 << (tomb - 1).bit_length() if tomb else 1
        return (tuple(s.size for s in self.segments),
                self._delta_count > 0 or not self.segments, tomb_cap)

    def _tombstone_array(self) -> Optional[torch.Tensor]:
        """Ascending int32 tensor padded to a power of two with INT32_MAX,
        cached between mutations; ``None`` while nothing is deleted, which
        ``stage_tombstone`` skips (the host's own count: no device read)."""
        if not self._tombstones:
            return None
        if self._tomb_cache is None:
            dead = sorted(self._tombstones)
            cap = 1 << (len(dead) - 1).bit_length()
            out = np.full((cap,), _INT32_MAX, np.int32)
            out[:len(dead)] = dead
            self._tomb_cache = torch.from_numpy(out).to(self.device)  # repro: allow[r1-host-sync] cached between mutations: one copy on the first batch after a delete
        return self._tomb_cache

    def _delta_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device snapshot of the delta buffer, cached between mutations."""
        if self._delta_cache is None:
            self._delta_cache = (
                torch.from_numpy(self._delta_points.copy()).to(self.device),  # repro: allow[r1-host-sync] cached between mutations: one copy on the first batch after an insert
                torch.from_numpy(self._delta_gids.copy()).to(self.device))  # repro: allow[r1-host-sync] cached between mutations: one copy on the first batch after an insert
        return self._delta_cache

    def _tombstone_pass(self, tomb: Optional[torch.Tensor]):
        """``tomb`` for one segment or delta pass, counted in
        ``tombstone_passes``."""
        self.tombstone_passes["skipped" if tomb is None else "masked"] += 1
        return tomb

    def _as_queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries).to(device=self.device, dtype=torch.int32)

    def _query_delta_if_any(self, results, tomb, queries) -> None:
        if self._delta_count or not results:
            delta_pts, delta_gids = self._delta_arrays()
            results.append(_query_delta(self.cfg, delta_pts, delta_gids,
                                        self._delta_count,
                                        self._tombstone_pass(tomb), queries))

    @staticmethod
    def _fold(results, use_kernel: bool = True):
        d, i = results[0]
        for dn, in_ in results[1:]:
            d, i = pipe.stage_merge_pair(d, i, dn, in_, use_kernel=use_kernel)
        return d, i

    def _sync(self) -> None:
        """Wait for the card (a traced span's end); nothing on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def query(self, queries, use_merge_kernel: bool = True,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Probe every segment at the worst-case slab + scan the delta; fold
        (``topk_merge``, or the concat sort with ``use_merge_kernel=False``).
        Returns (dists (Q, k) int32 ascending, gids (Q, k) int32, -1 pad)."""
        queries = self._as_queries(queries)
        tomb = self._tombstone_array()
        results = [_query_segment(self.cfg, seg.state, seg.gids,
                                  self._tombstone_pass(tomb), queries)
                   for seg in self.segments]
        self._query_delta_if_any(results, tomb, queries)
        return self._fold(results, use_merge_kernel)

    def _ensure_caps(self, seg: Segment) -> None:
        """Derive the segment's two-level caps (lazy; once per seal):
        ``c_norm`` from the occupancy-histogram quantile, ``ctot_norm`` from
        the p90 of ``cap_sample`` surrogate rows' candidate totals under
        ``c_norm``, with 2x pow-2 headroom."""
        if seg.ctot_norm or seg.size == 0:
            return
        cfg = self.cfg
        state = seg.state
        if not seg.ctot_cap:
            seg.ctot_cap = _seg_ctot_cap(cfg, state)
        lp = cfg.num_tables * cfg.probes_per_table
        c_full = max(1, seg.ctot_cap // lp)
        if state.occ_hist is None or self.cap_quantile >= 1.0:
            seg.ctot_norm, seg.c_norm = seg.ctot_cap, c_full
            return
        c_norm = max(1, min(c_full, pipe.occupancy_quantile(  # repro: allow[r1-host-sync] seal-time cap derivation, once per segment
            state.occ_hist, self.cap_quantile)))
        ctot_norm = lp * c_norm
        s = min(self.cap_sample, seg.size)
        if s > 0:
            stride = max(1, seg.size // s)
            sample = state.dataset[::stride][:s].to(torch.int32)
            _, _, occ, _ = probe_index(cfg, state, sample)
            totals = np.minimum(occ.cpu().numpy(), c_norm).sum(axis=-1)  # repro: allow[r1-host-sync] seal-time occupancy sampling, once per segment
            realized = int(np.percentile(totals, 90))
            ctot_norm = min(ctot_norm, 1 << max(0, 2 * realized - 1).bit_length())
        seg.ctot_norm = max(1, min(ctot_norm, seg.ctot_cap))
        seg.c_norm = c_norm

    def skew_summary(self):
        """Per-segment size, derived caps and bucket-occupancy quantiles."""
        out = []
        for seg in self.segments:
            entry = {"size": seg.size, "ctot_cap": seg.ctot_cap or None,
                     "ctot_norm": seg.ctot_norm or None,
                     "c_norm": seg.c_norm or None}
            hist = seg.state.occ_hist
            if hist is not None and seg.size:
                if seg.occ_stats is None:
                    seg.occ_stats = {
                        "p50": pipe.occupancy_quantile(hist, 0.5),  # repro: allow[r1-host-sync] cache fill, once per sealed segment
                        "p99": pipe.occupancy_quantile(hist, 0.99),  # repro: allow[r1-host-sync] cache fill, once per sealed segment
                        "p999": pipe.occupancy_quantile(hist, 0.999),  # repro: allow[r1-host-sync] cache fill, once per sealed segment
                        "max": pipe.max_bucket_occupancy(  # repro: allow[r1-host-sync] cache fill, once per sealed segment
                            seg.state.sorted_keys, seg.state.occ_from),
                    }
                entry["occ_quantiles"] = dict(seg.occ_stats)
            out.append(entry)
        return out

    def candidate_ladders(self, floor: int = 64, overflow: str = "escalate"):
        """Per-segment ``(cbucket, c_cap or None)`` rung ladders."""
        ladders = []
        for seg in self.segments:
            if not seg.size:
                ladders.append(())
                continue
            self._ensure_caps(seg)
            ladders.append(pipe.rung_ladder(
                seg.ctot_cap, floor, seg.ctot_norm, seg.c_norm, overflow))
        return tuple(ladders)

    def query_compact(self, queries, floor: int = 64,
                      use_merge_kernel: bool = True,
                      overflow: str = "escalate", stats=None):
        """``query`` with the compacted probe front-end: per segment, phase
        A, one host read of ``counts.max()`` to pick the rung, phase B at
        that rung.  Returns (dists, gids, used) with ``used`` the
        (segment_size, cbucket, c_cap or None) triples of this call.
        ``stats``, when a dict, accumulates ``overflow_hits`` and
        ``truncated_candidates``.  Traced (``REPRO_TRACE=1``), each phase
        is a span that ends with the card synchronized."""
        queries = self._as_queries(queries)
        tomb = self._tombstone_array()
        results, used = [], []
        traced = obs_trace.enabled()
        for seg in self.segments:
            if seg.size == 0:
                results.append(_query_segment(
                    self.cfg, seg.state, seg.gids, self._tombstone_pass(tomb),
                    queries))
                continue
            self._ensure_caps(seg)
            with obs_trace.span("phase_a", segment=int(seg.size)):
                probe_keys, lo, occ, counts = probe_index(self.cfg, seg.state,
                                                          queries)
                # the host read of the count synchronizes the card
                with obs_trace.span("rung_read"):
                    top = int(counts.max())  # repro: allow[r1-host-sync] THE sanctioned phase-A rung-pick read (DESIGN.md §8)
                cb, c_cap, over = pipe.pick_rung(top, seg.ctot_cap, floor,
                                                 seg.ctot_norm, seg.c_norm,
                                                 overflow)
            with obs_trace.span("phase_b_rerank", segment=int(seg.size),
                                cbucket=int(cb),
                                c_cap=None if c_cap is None else int(c_cap)):
                results.append(_finish_segment(
                    self.cfg, cb, c_cap, seg.state, seg.gids,
                    self._tombstone_pass(tomb), probe_keys, lo, occ, queries))
                if traced:
                    self._sync()
            used.append((seg.size, cb, c_cap))
            if stats is not None and over:
                stats["overflow_hits"] = stats.get("overflow_hits", 0) + 1
                if c_cap is not None:
                    stats["truncated_candidates"] = (
                        stats.get("truncated_candidates", 0)
                        + _truncated_total(occ, counts, c_cap, cb))  # repro: allow[r1-host-sync] overflow-rung stats, rare by construction
        if self._delta_count or not results:
            with obs_trace.span("delta_scan", fill=int(self._delta_count)):
                self._query_delta_if_any(results, tomb, queries)
                if traced:
                    self._sync()
        with obs_trace.span("merge", parts=len(results)):
            d, i = self._fold(results, use_merge_kernel)
            if traced:
                self._sync()
        return d, i, tuple(used)

    def warm_compact(self, queries, floor: int = 64, overflow: str = "escalate"):
        """Run the compacted path at every ladder rung of every segment for
        this batch shape, plus one full ``query_compact``.  Returns every
        (segment_size, cbucket, c_cap) triple run."""
        queries = self._as_queries(queries)
        tomb = self._tombstone_array()
        warmed = []
        for seg, ladder in zip(self.segments,
                               self.candidate_ladders(floor, overflow)):
            if not ladder:
                continue
            probe_keys, lo, occ, _ = probe_index(self.cfg, seg.state, queries)
            for cb, c_cap in ladder:
                _finish_segment(self.cfg, cb, c_cap, seg.state, seg.gids,
                                self._tombstone_pass(tomb), probe_keys, lo, occ,
                                queries)
                warmed.append((seg.size, cb, c_cap))
        _, _, used = self.query_compact(queries, floor, overflow=overflow)
        return tuple(warmed) + used
