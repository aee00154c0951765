"""Shared-ground-truth quality protocol (paper Sect. 5), torch counterpart of
``repro.eval.quality``.

One :class:`QualityRun` holds a dataset, a query set and one exact L1 ground
truth (``brute_force_l1``); every scheme is scored against it:

  * schemes: MP-RW-LSH, RW-LSH (single-probe), CP-LSH, MP-CP-LSH and SRS;
  * ``sweep`` runs ``num_tables`` x ``num_probes`` per scheme and records
    recall@k and overall ratio; ``table_claim`` derives the paper's headline,
    the tables each scheme needs to reach recall R;
  * the cross-layer oracles push one configuration through ``query_index``
    (flat), ``SegmentedIndex.query`` (fresh, mutated, compacted), the
    compacted two-phase query and the distributed query, and check that they
    agree.

Parameters come from a parameter source, ``params_fn(cfg, dim)``, by default
the port's own seeded draw (``core.index.make_params``), so that a caller can
hand in parameters made elsewhere (the JAX package's, for parity).  The
cluster oracle runs ``cluster.ClusterRouter`` in-process or over worker
processes, the distributed one ``launch.dist_index`` over one rank a card.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import baselines as bl
from repro_torch.core import hashes as hashes_lib
from repro_torch.core import pipeline as pipe
from repro_torch.core.index import (IndexConfig, ParamsFn, build_index,
                                    make_params, probe_index, query_index,
                                    query_index_compact)
from repro_torch.core.segments import SegmentedIndex

__all__ = ["SCHEMES", "QualitySpec", "QualityRun", "tables_needed"]

# single-probe schemes pin T = 0; 'srs' has no hash tables at all
SCHEMES = ("mp-rw-lsh", "rw-lsh", "cp-lsh", "mp-cp-lsh", "srs")
_MULTIPROBE = {"mp-rw-lsh": True, "rw-lsh": False,
               "cp-lsh": False, "mp-cp-lsh": True}


@dataclasses.dataclass(frozen=True)
class QualitySpec:
    """Static sweep parameters (widths are tuned per dataset)."""

    k: int = 10
    table_sweep: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    # single-probe schemes burn tables much faster (the paper's claim);
    # None = the same as table_sweep
    table_sweep_single: Optional[Tuple[int, ...]] = None
    probe_sweep: Tuple[int, ...] = (100,)     # T values for multiprobe schemes
    candidate_cap: int = 64
    num_hashes_rw: int = 12
    num_hashes_cp: int = 8
    rerank_chunk: int = 1024
    srs_proj: int = 10
    srs_t: int = 1024                          # projected t-NN candidates
    target_recall: float = 0.9
    seed: int = 0


def tables_needed(records: Sequence[dict], scheme: str,
                  target: float) -> Optional[int]:
    """Smallest num_tables at which ``scheme`` reaches ``target`` recall
    (any probe count); None when the sweep never gets there."""
    hits = [r["num_tables"] for r in records
            if r["scheme"] == scheme and r["recall"] >= target]
    return min(hits) if hits else None


class QualityRun:
    """One dataset + one exact ground truth; every scheme scored against it.

    ``device`` (None = the card) holds the data and runs every query.
    ``params_fn(cfg, dim)`` gives each configuration's hash parameters (by
    default ``make_params(cfg, dim, spec.seed)``), and ``srs_proj`` the SRS
    projection (M, m) (by default a Cauchy draw seeded ``spec.seed + 1``).
    """

    def __init__(self, data, queries, universe: int,
                 spec: QualitySpec = QualitySpec(), device=None,
                 params_fn: Optional[ParamsFn] = None,
                 srs_proj: Optional[torch.Tensor] = None):
        self.spec = spec
        self.universe = int(universe)
        self.device = resolve_device(device)
        self.data = _int32_on(data, self.device)
        self.queries = _int32_on(queries, self.device)
        self._params_fn = params_fn or (
            lambda cfg, dim: make_params(cfg, dim, seed=spec.seed))
        self._srs_proj = srs_proj
        td, ti = bl.brute_force_l1(self.data, self.queries, spec.k)
        self.true_d = td.cpu().numpy()
        self.true_i = ti.cpu().numpy()
        # per-dataset widths from the shared ground truth: the RW raw-hash
        # spread at the near radius is sqrt(d1), the Cauchy scale is d1
        dbar = float(self.true_d.mean())
        self.dbar = dbar
        self.w_rw = max(8, int(3.0 * np.sqrt(dbar)) & ~1)
        self.w_cp = max(8, int(4.0 * dbar))

    # -- configs -----------------------------------------------------------

    def scheme_config(self, scheme: str, num_tables: int,
                      num_probes: Optional[int] = None) -> IndexConfig:
        s = self.spec
        if scheme not in _MULTIPROBE:
            raise ValueError(f"no IndexConfig for scheme {scheme!r}")
        if not _MULTIPROBE[scheme]:
            num_probes = 0
        elif num_probes is None:
            num_probes = s.probe_sweep[-1]
        rw = scheme in ("mp-rw-lsh", "rw-lsh")
        return IndexConfig(
            num_tables=num_tables,
            num_hashes=s.num_hashes_rw if rw else s.num_hashes_cp,
            width=self.w_rw if rw else self.w_cp,
            num_probes=num_probes,
            candidate_cap=s.candidate_cap,
            universe=self.universe,
            family="rw" if rw else "cauchy",
            k=s.k,
            rerank_chunk=s.rerank_chunk)

    def params(self, cfg: IndexConfig) -> hashes_lib.LshParams:
        return self._params_fn(cfg, int(self.data.shape[1])).to(self.device)

    def _build(self, cfg: IndexConfig):
        return build_index(cfg, self.data, params=self.params(cfg))

    def _segmented(self, cfg: IndexConfig, data, **kw) -> SegmentedIndex:
        return SegmentedIndex.from_dataset(cfg, data, params=self.params(cfg),
                                           device=self.device, **kw)

    # -- query layers (the cross-layer oracle's subjects) ------------------

    def query_flat(self, cfg: IndexConfig):
        return query_index(cfg, self._build(cfg), self.queries)

    def query_segmented(self, cfg: IndexConfig):
        return self._segmented(cfg, self.data).query(self.queries)

    def dist_devices(self) -> int:
        """The ranks of ``query_dist``: one a card (one on the CPU), and one
        in all when the queries do not divide over the cards."""
        n_dev = torch.cuda.device_count() if self.device.type == "cuda" else 1
        return 1 if self.queries.shape[0] % n_dev else n_dev

    def query_dist(self, cfg: IndexConfig, merge: str = "allgather"):
        """The distributed query on a (1, n_devices) mesh: one row shard,
        the queries over 'model' (``launch.dist_index``; nccl on the card,
        gloo on the CPU).

        One row shard keeps the candidate set identical to the flat path
        (per-shard candidate_cap never truncates differently), so the
        result must be bit-for-bit equal to ``query_index``, which makes this
        a consistency oracle rather than an approximate comparison.  One
        rank runs in this process (a default group of one, which must not
        exist yet); more run as ``spawn_ranks`` processes.
        """
        from repro_torch.launch import dist_index as di

        n_dev = self.dist_devices()
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        run = {"shape": (1, n_dev), "cfg": cfg, "params": self.params(cfg).to("cpu"),
               "merge": merge}
        if n_dev == 1:
            with di.single_process_group(backend):
                recs = [di.run_meshes(self.device, self.data, self.queries, [run])]
        else:
            queries = self.queries.cpu().numpy()
            with tempfile.TemporaryDirectory(prefix="rwt-quality-") as tmp:
                path = os.path.join(tmp, "data.npy")
                np.save(path, self.data.cpu().numpy())
                recs = [rep["result"] for rep in di.spawn_ranks(
                    n_dev, di.run_meshes, path, queries, [run], backend=backend,
                    device=self.device)]
        d, i = di.assemble(recs, 0)
        return (torch.from_numpy(d).to(self.device), torch.from_numpy(i).to(self.device))

    # -- scoring -----------------------------------------------------------

    def _score(self, d, i, ms_per_query: Optional[float] = None) -> dict:
        rec = {"recall": float(bl.recall(_np(i), self.true_i)),
               "ratio": float(bl.overall_ratio(_np(d), self.true_d))}
        if ms_per_query is not None:
            rec["ms_per_query"] = ms_per_query
        return rec

    def _timed(self, fn):
        """fn's result, and with it its wall time per query (the device's
        work included) when a second call is timed."""
        out = fn()                                      # warm-up + result
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        return out, (time.perf_counter() - t0) * 1e3 / self.queries.shape[0]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def eval_config(self, cfg: IndexConfig, timed: bool = False) -> dict:
        state = self._build(cfg)
        run = lambda: query_index(cfg, state, self.queries)
        if not timed:
            return self._score(*run())
        (d, i), ms = self._timed(run)
        return self._score(d, i, ms)

    def _srs_state(self) -> bl.SrsState:
        s = self.spec
        if self._srs_proj is not None:
            return bl.build_srs(self.data, s.srs_proj, proj=self._srs_proj)
        gen = torch.Generator().manual_seed(s.seed + 1)
        return bl.build_srs(self.data, s.srs_proj, generator=gen)

    def eval_srs(self, timed: bool = False) -> dict:
        s = self.spec
        t = min(s.srs_t, int(self.data.shape[0]))
        srs = self._srs_state()
        run = lambda: bl.query_srs(srs, self.queries, t, s.k)
        if not timed:
            return self._score(*run())
        (d, i), ms = self._timed(run)
        return self._score(d, i, ms)

    # -- sweeps + derived statistics ---------------------------------------

    def sweep(self, schemes: Sequence[str] = SCHEMES,
              timed: bool = False) -> List[dict]:
        """recall@k and ratio over num_tables x num_probes for every scheme,
        all against the one shared ground truth."""
        records: List[dict] = []
        for scheme in schemes:
            if scheme == "srs":
                rec = self.eval_srs(timed)
                rec.update(scheme="srs", num_tables=0, num_probes=0)
                records.append(rec)
                continue
            multi = _MULTIPROBE[scheme]
            probes = self.spec.probe_sweep if multi else (0,)
            tables = (self.spec.table_sweep if multi else
                      self.spec.table_sweep_single or self.spec.table_sweep)
            for t_probes in probes:
                for l_tables in tables:
                    cfg = self.scheme_config(scheme, l_tables, t_probes)
                    rec = self.eval_config(cfg, timed)
                    rec.update(scheme=scheme, num_tables=l_tables,
                               num_probes=t_probes)
                    records.append(rec)
        return records

    def table_claim(self, records: Sequence[dict],
                    target: Optional[float] = None) -> dict:
        """The paper's headline: tables needed at recall R, per scheme, and
        the baselines' ratios to MP-RW-LSH (paper Sect. 5: 15-53x for
        CP-LSH)."""
        target = self.spec.target_recall if target is None else target
        needed = {s: tables_needed(records, s, target)
                  for s in ("mp-rw-lsh", "rw-lsh", "cp-lsh", "mp-cp-lsh")
                  if any(r["scheme"] == s for r in records)}
        l_mp = needed.get("mp-rw-lsh")
        ratios = {}
        for s, l in needed.items():
            if s == "mp-rw-lsh" or l_mp is None:
                continue
            # None = more than the sweep maximum: a lower bound on the ratio
            ratios[s] = (None if l is None else round(l / l_mp, 2))
        max_l = max(self.spec.table_sweep
                    + (self.spec.table_sweep_single or ()))
        return {"target_recall": target, "tables_needed": needed,
                "ratio_vs_mp_rw": ratios, "sweep_max_tables": max_l}

    # -- cross-layer consistency oracle ------------------------------------

    def fragmented(self, cfg: IndexConfig, split: float = 0.5,
                   delta_cap: Optional[int] = None) -> SegmentedIndex:
        """``check_segmented``'s mutated index: the first ``split`` of the
        rows built, the rest inserted (sealed segments plus a delta)."""
        data_np = self.data.cpu().numpy()
        n = data_np.shape[0]
        n0 = max(1, int(n * split))
        frag = self._segmented(cfg, data_np[:n0],
                               delta_cap=delta_cap or max(64, (n - n0) // 3))
        frag.insert(data_np[n0:])                  # seals segments + delta
        return frag

    def check_segmented(self, cfg: IndexConfig, split: float = 0.5,
                        delta_cap: Optional[int] = None, flat=None) -> dict:
        """Mutation-path oracle: build half, insert the rest, query while
        fragmented, compact, query again.

          * fresh single-segment == flat ``query_index``, bit for bit;
          * fragmented recall never below the compacted recall (each source
            gathers its own candidate_cap, a superset);
          * after ``compact()`` the result equals the fresh build's, bit for
            bit (insertion order and gids are kept).
        """
        fd, fi = self.query_flat(cfg) if flat is None else flat
        fd, fi = _np(fd), _np(fi)
        fresh = self._score(fd, fi)

        frag = self.fragmented(cfg, split, delta_cap)
        md, mi = frag.query(self.queries)
        mutated = self._score(md, mi)
        segments_while_fragmented = frag.num_segments
        frag.compact()
        cd, ci = map(_np, frag.query(self.queries))
        compacted = self._score(cd, ci)
        del frag

        sd, si = map(_np, self.query_segmented(cfg))
        return {
            "fresh_recall": fresh["recall"],
            "mutated_recall": mutated["recall"],
            "compacted_recall": compacted["recall"],
            "segments_while_fragmented": segments_while_fragmented,
            "segmented_matches_flat": bool(
                np.array_equal(sd, fd) and np.array_equal(si, fi)),
            "compacted_matches_fresh": bool(
                np.array_equal(cd, fd) and np.array_equal(ci, fi)),
            "mutated_no_regression":
                mutated["recall"] >= compacted["recall"],
        }

    def check_compact(self, cfg: IndexConfig, flat=None) -> dict:
        """Compacted-front-end oracle: the flat two-phase
        ``query_index_compact`` and the segmented ``query_compact`` equal
        the worst-case-slab result bit for bit, at smaller slabs."""
        fd, fi = self.query_flat(cfg) if flat is None else flat
        fd, fi = _np(fd), _np(fi)
        cd, ci = map(_np, query_index_compact(cfg, self._build(cfg), self.queries))
        sd, si, used = self._segmented(cfg, self.data).query_compact(self.queries)
        sd, si = _np(sd), _np(si)
        return {
            "compact_flat_matches_flat": bool(
                np.array_equal(cd, fd) and np.array_equal(ci, fi)),
            "compact_segmented_matches_flat": bool(
                np.array_equal(sd, fd) and np.array_equal(si, fi)),
            "compact_cand_buckets": [cb for _, cb, _ in used],
            "compact_full_slab": (cfg.num_tables * cfg.probes_per_table
                                  * cfg.candidate_cap),
        }

    def check_skew_cap(self, cfg: IndexConfig, quantile: float = 0.999,
                       floor: int = 64, flat=None) -> dict:
        """Two-level compaction oracle: with the caps the serving policy
        derives (per-bucket ``c_norm`` from the occupancy-histogram
        quantile, ``ctot_norm`` from realized capped totals), 'escalate'
        equals the uncapped flat query bit for bit and 'truncate' costs
        less than 0.5% recall."""
        fd, fi = self.query_flat(cfg) if flat is None else flat
        fd, fi = _np(fd), _np(fi)
        state = self._build(cfg)
        lp = cfg.num_tables * cfg.probes_per_table
        occ_max = pipe.max_bucket_occupancy(state.sorted_keys, state.occ_from)
        c_full = min(cfg.candidate_cap, occ_max)
        ctot_cap = lp * c_full
        c_norm = max(1, min(c_full, pipe.occupancy_quantile(
            state.occ_hist, quantile)))
        # p90 of realized capped totals over the dataset's own rows, as
        # SegmentedIndex._ensure_caps derives it
        sample = self.data[::max(1, self.data.shape[0] // 64)][:64]
        _, _, occ, _ = probe_index(cfg, state, sample)
        totals = np.minimum(occ.cpu().numpy(), c_norm).sum(axis=-1)
        realized = int(np.percentile(totals, 90))
        ctot_norm = min(lp * c_norm,
                        1 << max(0, 2 * realized - 1).bit_length())
        ctot_norm = max(1, min(ctot_norm, ctot_cap))
        ed, ei = map(_np, query_index_compact(
            cfg, state, self.queries, floor=floor, ctot_cap=ctot_cap,
            ctot_norm=ctot_norm, c_cap=c_norm, overflow="escalate"))
        td, ti = query_index_compact(
            cfg, state, self.queries, floor=floor, ctot_cap=ctot_cap,
            ctot_norm=ctot_norm, c_cap=c_norm, overflow="truncate")
        uncapped = self._score(fd, fi)
        capped = self._score(td, ti)
        drop = uncapped["recall"] - capped["recall"]
        return {
            "skew_c_norm": c_norm,
            "skew_c_full": c_full,
            "skew_ctot_norm": ctot_norm,
            "skew_ctot_cap": ctot_cap,
            "skew_escalate_matches_flat": bool(
                np.array_equal(ed, fd) and np.array_equal(ei, fi)),
            "skew_uncapped_recall": uncapped["recall"],
            "skew_capped_recall": capped["recall"],
            "skew_recall_drop": drop,
            "skew_recall_within_half_pct": bool(drop < 0.005),
        }

    def check_distributed(self, cfg: IndexConfig, flat=None) -> dict:
        """Distributed-path oracle: the all-gather ``query_dist`` == flat, bit
        for bit (one row shard; the queries over 'model').  ``flat`` may pass
        a precomputed ``query_flat(cfg)`` result to skip the rebuild."""
        fd, fi = self.query_flat(cfg) if flat is None else flat
        dd, di_ = self.query_dist(cfg)
        return {
            "devices": self.dist_devices(),
            "dist_matches_flat": bool(
                np.array_equal(_np(dd), _np(fd)) and np.array_equal(_np(di_), _np(fi))),
        }

    def check_cluster(self, cfg: IndexConfig, num_shards: int = 2,
                      num_replicas: int = 2, root_dir: Optional[str] = None,
                      transport: str = "inproc") -> dict:
        """Cluster-path oracle: the sharded, replicated ``ClusterRouter``
        equals the flat ``query_index`` bit for bit, before and after a
        replica kill and its recovery by WAL replay (the recovered replica
        then serves: its peer is killed).

        Bit-identity needs a non-truncating candidate gather (each shard
        takes its own ``candidate_cap`` a probed bucket), so the cap is
        raised to the built index's largest bucket
        (``pipeline.oracle_candidate_cap``).  The replicas live on this
        run's device.  ``transport='process'`` (or ``'tcp'``) runs the same
        oracle against worker subprocesses behind the RPC transport, each
        engine on this run's device: the claims must survive the wire, and
        the kill is a real SIGKILL.
        """
        from repro_torch.cluster import ClusterConfig, ClusterRouter
        from repro_torch.serve.engine import ServeConfig

        state = self._build(cfg)
        cfg = dataclasses.replace(cfg, candidate_cap=pipe.oracle_candidate_cap(
            cfg, state.sorted_keys, state.occ_from))
        fd, fi = map(_np, query_index(cfg, state, self.queries))
        del state
        queries = self.queries.cpu().numpy()
        with tempfile.TemporaryDirectory(dir=root_dir) as root:
            router = ClusterRouter(
                cfg, ServeConfig(batch_size=32),
                ClusterConfig(num_shards=num_shards, num_replicas=num_replicas,
                              hedge_ms=60000.0,  # oracle: never hedge
                              wal_fsync=False, transport=transport),
                self.data, root, params_fn=self._params_fn, device=self.device)
            try:  # the workers stop even when a check raises
                cd, ci = router.query(queries)
                matches = bool(np.array_equal(cd, fd) and np.array_equal(ci, fi))
                # WAL some mutations through, kill a replica, recover it, then
                # make it serve (peer killed): still equal to flat on the
                # original points (the inserted probes are deleted again)
                gids = router.insert(queries[:4])
                router.kill_replica(0, 0)
                router.delete(gids)
                router.recover_replica(0, 0)
                router.kill_replica(0, min(1, num_replicas - 1))
                rd, ri = router.query(queries)
                recovered = bool(np.array_equal(rd, fd) and np.array_equal(ri, fi))
                summary = router.summary()
            finally:
                router.close()
        return {
            "cluster_matches_flat": matches,
            "cluster_recovery_matches_flat": recovered,
            "cluster_shards": num_shards,
            "cluster_replicas": num_replicas,
            "cluster_recoveries": summary["recoveries"],
            "cluster_oracle_cap": cfg.candidate_cap,
            "cluster_transport": transport,
        }

    def check_cross_layer(self, cfg: IndexConfig, cluster: bool = True) -> dict:
        """All oracle layers for one config; every flag must hold.  The
        segmented, compacted and distributed oracles share one flat query;
        ``cluster`` adds the cluster oracle."""
        flat = self.query_flat(cfg)
        out = self.check_segmented(cfg, flat=flat)
        out.update(self.check_compact(cfg, flat=flat))
        out.update(self.check_distributed(cfg, flat=flat))
        if cluster:
            out.update(self.check_cluster(cfg))
        return out


def _int32_on(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x, np.int32))
    return x.to(device=device, dtype=torch.int32)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
