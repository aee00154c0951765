"""Staged MP-RW-LSH query pipeline, torch counterpart of
``repro.core.pipeline`` (same stage names and contracts).

Q queries, L tables, M hashes, P probes per table, C candidate cap:

  stage_hash          : queries (Q, m)              -> bucket, x_neg (Q, L, M)
  stage_probe_keys    : bucket, x_neg               -> probe_keys (Q, L, P) int64
  stage_bucket_lookup : sorted_keys, probe_keys     -> lo, hi (Q, L, P)
  stage_candidate_gather : sorted_ids, lo, hi       -> ids (Q, L*P*C), sentinel n
  stage_probe_extents : sorted_keys, probe_keys     -> lo, occ (Q, L*P), counts (Q,)
  stage_probe_counts  : sorted_keys, probe_keys     -> counts (Q,)
  stage_fused_probe   : sorted keys/ids, probe_keys -> ids (Q, Cb), counts (Q,)
  stage_dedup         : ids                         -> ids, duplicates -> sentinel
  stage_tombstone     : ids, gids, tombstones       -> ids, deleted -> sentinel
  stage_rerank        : dataset, queries, ids       -> (dists, ids) (Q, k) asc
  stage_merge_pair    : two (Q, k) lists            -> one (Q, k) list
  stage_merge_concat  : (Q, R*k) stacked lists      -> (Q, k)

plus the host-side rung helpers of the two-phase compacted query.  The
probe is 'fused' (the extents and gather kernels, a compactable slab) or
'staged' (``stage_bucket_lookup`` + ``stage_candidate_gather`` in plain
torch, at the fixed L*P*C width).  The rerank is 'fused' (the kernel, which
drops duplicate ids itself) or 'scan' (``l1_distance_chunked``, which takes
``stage_dedup``'s output).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops

from . import hashes as hashes_lib
from . import multiprobe as mp_lib

__all__ = [
    "BIG_DIST", "stage_hash", "stage_probe_keys", "stage_bucket_lookup",
    "stage_candidate_gather", "stage_probe_extents", "stage_probe_counts",
    "stage_fused_probe", "stage_dedup", "stage_tombstone", "probe_candidates",
    "rerank_handles_duplicates", "stage_rerank", "l1_distance_chunked",
    "stage_merge_pair", "stage_merge_concat", "max_bucket_occupancy", "oracle_candidate_cap",
    "occupancy_quantile", "candidate_ladder", "candidate_bucket", "rung_ladder",
    "pick_rung",
]

# Sentinel distance for invalid/padded slots; iinfo//2 so two of them still
# fit in int32 when summed.
BIG_DIST = np.iinfo(np.int32).max // 2


def stage_hash(cfg, params: hashes_lib.LshParams, queries: torch.Tensor):
    """Raw-hash + quantize.  Returns (bucket (Q,L,M) int32, x_neg (Q,L,M))."""
    f = hashes_lib.raw_hash(params, queries, impl=cfg.hash_impl)
    return hashes_lib.bucket_and_offsets(params, f)


def stage_probe_keys(cfg, params: hashes_lib.LshParams, template: torch.Tensor,
                     bucket: torch.Tensor, x_neg: torch.Tensor) -> torch.Tensor:
    """Instantiate the template and mix probe buckets into (Q, L, P) keys."""
    deltas = mp_lib.instantiate_template(template, x_neg, float(cfg.width))
    probe_buckets = bucket[:, :, None, :] + deltas.to(torch.int32)  # (Q,L,P,M)
    probe_keys = hashes_lib.mix_keys(
        params, probe_buckets.permute(0, 2, 1, 3))                  # (Q, P, L)
    return probe_keys.permute(0, 2, 1).contiguous()                 # (Q, L, P)


def stage_bucket_lookup(sorted_keys, probe_keys):
    """Two searches per table: (lo, hi) (Q, L, P) int32 bucket extents.

    ``torch.searchsorted`` batches over matching leading dims, so the table
    axis moves to the front: (L, n) keys against (L, Q*P) probe keys.
    """
    q, l, p = probe_keys.shape
    pk = probe_keys.permute(1, 0, 2).reshape(l, q * p).contiguous()

    def per_query(x):                                           # -> (Q, L, P)
        return x.reshape(l, q, p).permute(1, 0, 2).to(torch.int32)

    return (per_query(torch.searchsorted(sorted_keys, pk)),
            per_query(torch.searchsorted(sorted_keys, pk, right=True)))


def stage_candidate_gather(cfg, sorted_ids, lo, hi, n: int):
    """Up to ``candidate_cap`` row ids per probed bucket: (Q, L*P*C) int32,
    sentinel n in empty slots, in (table, probe, offset) order."""
    q = lo.shape[0]
    l, p, c = cfg.num_tables, cfg.probes_per_table, cfg.candidate_cap
    if n == 0:
        # every slot is invalid, and the sentinel for n = 0 is 0 itself
        return torch.zeros((q, l * p * c), dtype=torch.int32, device=lo.device)
    slots = lo[..., None] + torch.arange(c, dtype=torch.int32, device=lo.device)
    valid = slots < torch.minimum(hi, lo + c)[..., None]        # (Q, L, P, C)
    table = torch.arange(l, device=lo.device)[None, :, None, None]
    ids = sorted_ids[table, slots.clamp(0, n - 1).to(torch.int64)]
    return torch.where(valid, ids, n).to(torch.int32).reshape(q, l * p * c)


def stage_probe_extents(cfg, sorted_keys, probe_keys, occ_from=None):
    """Phase A: raw extents (lo, occ) and per-query counts under
    ``cfg.candidate_cap`` — the extents kernel on the card."""
    return kops.probe_extents(sorted_keys, probe_keys, cfg.candidate_cap,
                              occ_from=occ_from)


def stage_probe_counts(cfg, sorted_keys, probe_keys, occ_from=None):
    """Per-query valid-candidate count: ``sum_{l,p} min(hi - lo, cap)``."""
    return stage_probe_extents(cfg, sorted_keys, probe_keys, occ_from)[2]


def stage_fused_probe(cfg, sorted_keys, sorted_ids, probe_keys, n: int,
                      cbucket: Optional[int] = None, extents=None,
                      c_cap: Optional[int] = None, occ_from=None):
    """Fused bucket lookup + compacted gather: (ids (Q, cbucket) sentinel n,
    counts (Q,)).  ``cbucket`` defaults to the worst case L*P*cap; ``c_cap``
    tightens the per-bucket cap (the two-level truncate rung)."""
    cap = cfg.candidate_cap
    if c_cap is not None:
        cap = min(cap, max(1, int(c_cap)))
    if cbucket is None:
        cbucket = cfg.num_tables * cfg.probes_per_table * cap
    return kops.fused_probe(sorted_keys, sorted_ids, probe_keys, cap, cbucket,
                            extents=extents, occ_from=occ_from)


# --------------------------------------------------------------------------
# Candidate-count shape buckets (host-side policy helpers)
# --------------------------------------------------------------------------

def max_bucket_occupancy(sorted_keys, occ_from=None) -> int:
    """Largest run of equal bucket keys over all tables (host-side)."""
    if occ_from is not None and occ_from.numel():
        return max(1, int(occ_from.max()))
    keys = sorted_keys.cpu().numpy() if torch.is_tensor(sorted_keys) else np.asarray(sorted_keys)
    if keys.size == 0:
        return 1
    runs = keys[..., 1:] == keys[..., :-1]
    if not runs.any():
        return 1
    best = 1
    for t in range(keys.shape[0]):
        idx = np.flatnonzero(np.diff(np.concatenate(([False], runs[t], [False]))))
        if idx.size:
            best = max(best, int((idx[1::2] - idx[::2]).max()) + 1)
    return best


def oracle_candidate_cap(cfg, sorted_keys, occ_from=None) -> int:
    """A candidate cap at which no probed bucket is truncated, so that the
    candidate sets of segments or shards union to the flat index's set."""
    return max(cfg.candidate_cap, max_bucket_occupancy(sorted_keys, occ_from))


def occupancy_quantile(occ_hist, q: float = 0.999) -> int:
    """Bucket-weighted pow-2 occupancy quantile from an (L, B) ceil-log2
    occupancy histogram (host-side; called at segment seal)."""
    h = occ_hist.cpu().numpy() if torch.is_tensor(occ_hist) else np.asarray(occ_hist)
    h = h.reshape(-1, h.shape[-1]).sum(axis=0).astype(np.int64)
    total = int(h.sum())
    if total == 0:
        return 1
    target = int(np.ceil(min(max(q, 0.0), 1.0) * total))
    b = int(np.searchsorted(np.cumsum(h), max(target, 1)))
    return 1 << min(b, 31)


def candidate_ladder(ctot_cap: int, floor: int = 64) -> Tuple[int, ...]:
    """Pow-2 candidate-count rungs [floor, 2*floor, ...] topped by ctot_cap."""
    ctot_cap = max(1, int(ctot_cap))
    floor = max(1, int(floor))
    out = []
    b = 1 << (floor - 1).bit_length()
    while b < ctot_cap:
        out.append(b)
        b *= 2
    out.append(ctot_cap)
    return tuple(out)


def candidate_bucket(count: int, ctot_cap: int, floor: int = 64) -> int:
    """Smallest ladder rung covering ``count`` valid candidates."""
    ctot_cap = max(1, int(ctot_cap))
    need = max(1, int(count), int(floor))
    b = 1 << (need - 1).bit_length()
    return b if b < ctot_cap else ctot_cap


def rung_ladder(ctot_cap: int, floor: int = 64,
                ctot_norm: Optional[int] = None, c_cap: Optional[int] = None,
                overflow: str = "escalate",
                ) -> Tuple[Tuple[int, Optional[int]], ...]:
    """Two-level rung ladder ``((cbucket, c_cap or None), ...)``: pow-2 rungs
    up to ``ctot_norm`` plus one overflow rung ('escalate': exact
    ``(ctot_cap, None)``; 'truncate': ``(ctot_norm, c_cap)``)."""
    ctot_cap = max(1, int(ctot_cap))
    if not ctot_norm or int(ctot_norm) >= ctot_cap:
        return tuple((b, None) for b in candidate_ladder(ctot_cap, floor))
    ctot_norm = max(1, int(ctot_norm))
    rungs = [(b, None) for b in candidate_ladder(ctot_norm, floor)]
    if overflow == "escalate":
        rungs.append((ctot_cap, None))
    elif overflow == "truncate":
        rungs.append((ctot_norm, max(1, int(c_cap)) if c_cap else None))
    else:
        raise ValueError(f"unknown overflow policy: {overflow!r}")
    return tuple(rungs)


def pick_rung(count: int, ctot_cap: int, floor: int = 64,
              ctot_norm: Optional[int] = None, c_cap: Optional[int] = None,
              overflow: str = "escalate",
              ) -> Tuple[int, Optional[int], bool]:
    """The ``rung_ladder`` rung for a batch's max candidate count:
    ``(cbucket, c_cap or None, overflowed)``."""
    ctot_cap = max(1, int(ctot_cap))
    if not ctot_norm or int(ctot_norm) >= ctot_cap:
        return candidate_bucket(count, ctot_cap, floor), None, False
    ctot_norm = max(1, int(ctot_norm))
    if count <= ctot_norm:
        return candidate_bucket(count, ctot_norm, floor), None, False
    if overflow == "escalate":
        return ctot_cap, None, True
    if overflow == "truncate":
        return ctot_norm, max(1, int(c_cap)) if c_cap else None, True
    raise ValueError(f"unknown overflow policy: {overflow!r}")


# --------------------------------------------------------------------------
# Tombstone, rerank, merge
# --------------------------------------------------------------------------

def rerank_handles_duplicates(cfg) -> bool:
    """True when ``stage_rerank`` drops duplicate ids itself ('fused'); the
    'scan' rerank needs ``stage_dedup`` first."""
    return getattr(cfg, "rerank_impl", "fused") != "scan"


def stage_dedup(ids, n: int):
    """Sort each row ascending and turn every repeat into the sentinel n."""
    ids = torch.sort(ids, dim=-1).values
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    return torch.where(dup, n, ids)


def stage_tombstone(ids, gids, tombstones, n: int):
    """Mask deleted points out of a (Q, Ctot) candidate list (sentinel n).

    ``tombstones`` is ascending int32, padded with INT32_MAX, or ``None``
    when nothing is deleted: then ``ids`` itself comes back and nothing is
    launched (the padded single ``INT32_MAX`` matches no gid either).
    """
    if n == 0 or tombstones is None:
        return ids
    gid = gids[ids.clamp(0, n - 1).to(torch.int64)]
    pos = torch.searchsorted(tombstones, gid)
    hit = tombstones[pos.clamp(0, tombstones.shape[0] - 1)] == gid
    return torch.where((ids < n) & hit, n, ids)


def probe_candidates(cfg, params, template, sorted_keys, sorted_ids, n: int,
                     queries, cbucket: Optional[int] = None,
                     c_cap: Optional[int] = None, occ_from=None,
                     dedup: Optional[bool] = None):
    """hash -> probe keys -> lookup+gather [-> dedup]; candidate ids,
    sentinel n.  The lookup+gather runs per ``cfg.probe_impl``: 'fused' at
    slab width ``cbucket`` (default the worst case L*P*C) and per-bucket cap
    ``c_cap``, 'staged' at the fixed L*P*C width (neither option allowed).
    ``dedup`` defaults to what the configured rerank needs."""
    bucket, x_neg = stage_hash(cfg, params, queries)
    probe_keys = stage_probe_keys(cfg, params, template, bucket, x_neg)
    impl = getattr(cfg, "probe_impl", "fused")
    if impl == "fused":
        ids, _ = stage_fused_probe(cfg, sorted_keys, sorted_ids, probe_keys, n,
                                   cbucket, c_cap=c_cap, occ_from=occ_from)
    elif impl == "staged":
        if cbucket is not None or c_cap is not None:
            raise ValueError("slab compaction requires probe_impl='fused'")
        lo, hi = stage_bucket_lookup(sorted_keys, probe_keys)
        ids = stage_candidate_gather(cfg, sorted_ids, lo, hi, n)
    else:
        raise ValueError(f"unknown probe_impl: {impl!r}")
    if dedup is None:
        dedup = not rerank_handles_duplicates(cfg)
    return stage_dedup(ids, n) if dedup else ids


def _rows_operands(dataset, queries):
    """The queries and a row transform for ``l1_distance_rows``, which takes
    one integer type for both: the dataset's, when every query coordinate
    fits in it (one host read), else int32 for both."""
    queries = queries.contiguous()
    if queries.dtype == dataset.dtype:
        return queries, lambda rows: rows
    narrow = queries.to(dataset.dtype)
    if torch.equal(narrow.to(queries.dtype), queries):  # repro: allow[r1-host-sync] once per l1_distance_chunked call: whether the queries fit the dataset's type
        return narrow, lambda rows: rows
    return queries.to(torch.int32), lambda rows: rows.to(torch.int32)


def l1_distance_chunked(dataset, queries, ids, k: int, chunk: int):
    """Exact L1 rerank as a scan over ``chunk`` candidates at a time with a
    running top-k (the 'scan' rerank, SRS and the JAX package's brute force).

    ids (Q, Ctot) int32, sentinel >= n marks invalid, **deduplicated** (a
    repeated id takes a slot each time).  Each step gathers its rows and
    takes their distances through ``l1_distance_rows`` (the kernel on the
    card), then keeps the k smallest of the running list followed by the
    step's, ties going to the earlier slot, as ``lax.top_k`` of the negated
    distances does.  Returns (dists (Q, k) int32, ids (Q, k) int32)
    ascending; entries at ``BIG_DIST`` or beyond come back as (dist, -1).
    """
    n = dataset.shape[0]
    q, ctot = ids.shape
    big = torch.full((), BIG_DIST, dtype=torch.int32, device=ids.device)
    pad = (-ctot) % chunk
    if pad:
        ids = torch.cat([ids, torch.full((q, pad), n, dtype=ids.dtype,
                                         device=ids.device)], dim=1)
    qs, widen = _rows_operands(dataset, queries)
    best_d = big.expand(q, k)
    best_i = torch.full((q, k), n, dtype=torch.int32, device=ids.device)
    for lo in range(0, ids.shape[1], chunk):
        step_ids = ids[:, lo:lo + chunk].to(torch.int32)
        rows = widen(dataset[step_ids.clamp(0, n - 1).long()])     # (Q, c, m)
        d = kops.l1_distance_rows(qs, rows.contiguous()).to(torch.int32)
        d = torch.where(step_ids >= n, big, d)
        cd = torch.cat([best_d, d], dim=1)
        ci = torch.cat([best_i, step_ids], dim=1)
        # lax.top_k(-cd, k): the k largest negated distances (int32 wrap
        # included), equal ones in slot order
        sel = torch.sort(-cd, dim=1, descending=True, stable=True).indices[:, :k]
        best_d = torch.gather(cd, 1, sel)
        best_i = torch.gather(ci, 1, sel)
    best_i = torch.where(best_d >= big, -1, best_i)
    return best_d, best_i


def stage_rerank(cfg, dataset, queries, ids, impl: Optional[str] = None):
    """Exact rerank: the k lex-(dist, id)-smallest unique candidates,
    ascending; invalid -> (BIG_DIST, -1).  'fused' (``cfg.rerank_impl``'s
    default) takes the raw gather, 'scan' deduplicated ids.  The fused
    kernel may reorder ``ids`` in place (``kops.fused_rerank``): every
    caller hands it ids it does not read again."""
    impl = impl or getattr(cfg, "rerank_impl", "fused")
    if dataset.shape[0] == 0:
        q = ids.shape[0]
        return (torch.full((q, cfg.k), BIG_DIST, dtype=torch.int32, device=ids.device),
                torch.full((q, cfg.k), -1, dtype=torch.int32, device=ids.device))
    if impl == "scan":
        return l1_distance_chunked(dataset, queries, ids, cfg.k, cfg.rerank_chunk)
    if impl != "fused":
        raise ValueError(f"unknown rerank_impl: {impl!r}")
    return kops.fused_rerank(dataset, queries, ids, cfg.k, chunk=cfg.rerank_chunk)


def stage_merge_pair(da, ia, db, ib, use_kernel: bool = True):
    """Merge two ascending (Q, k) top-k lists into one: the bitonic
    ``topk_merge`` kernel, or with ``use_kernel=False`` the concat sort.
    Both order by (dist, id).  Invalid entries must carry dist >= BIG_DIST."""
    if use_kernel:
        return kops.topk_merge(da, ia, db, ib)
    return stage_merge_concat(torch.cat([da, db], dim=-1),
                              torch.cat([ia, ib], dim=-1), da.shape[-1])


def stage_merge_concat(ds, is_, k: int):
    """Merge R stacked top-k lists at once: (Q, R*k) -> (Q, k) ascending,
    lexicographic on signed (dist, id), as ``lax.sort(num_keys=2)``.

    One int64 key per entry, ``dist * 2^32 + (id + 2^31)``, orders exactly
    as the pair does for every int32 dist and id (-1 pads included).
    """
    key = ds.to(torch.int64) * (1 << 32) + (is_.to(torch.int64) + (1 << 31))
    key = torch.sort(key, dim=-1).values[:, :k]
    return ((key >> 32).to(torch.int32),
            ((key & 0xFFFFFFFF) - (1 << 31)).to(torch.int32))
