"""Staged MP-RW-LSH query pipeline, torch counterpart of
``repro.core.pipeline`` (same stage names and contracts).

Q queries, L tables, M hashes, P probes per table, C candidate cap:

  stage_hash          : queries (Q, m)              -> bucket, x_neg (Q, L, M)
  stage_probe_keys    : bucket, x_neg               -> probe_keys (Q, L, P) int64
  stage_probe_extents : sorted_keys, probe_keys     -> lo, occ (Q, L*P), counts (Q,)
  stage_fused_probe   : sorted keys/ids, probe_keys -> ids (Q, Cb), counts (Q,)
  stage_tombstone     : ids, gids, tombstones       -> ids, deleted -> sentinel
  stage_rerank        : dataset, queries, ids       -> (dists, ids) (Q, k) asc
  stage_merge_pair    : two (Q, k) lists            -> one (Q, k) list

plus the host-side rung helpers of the two-phase compacted query.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops

from . import hashes as hashes_lib
from . import multiprobe as mp_lib

__all__ = [
    "BIG_DIST", "stage_hash", "stage_probe_keys", "stage_probe_extents",
    "stage_fused_probe", "stage_tombstone", "probe_candidates", "stage_rerank",
    "stage_merge_pair", "max_bucket_occupancy", "occupancy_quantile",
    "candidate_ladder", "candidate_bucket", "rung_ladder", "pick_rung",
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


def stage_probe_extents(cfg, sorted_keys, probe_keys, occ_from=None):
    """Phase A: raw extents (lo, occ) and per-query counts under
    ``cfg.candidate_cap`` — plain torch on every device."""
    return kops.probe_extents(sorted_keys, probe_keys, cfg.candidate_cap,
                              occ_from=occ_from)


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

def stage_tombstone(ids, gids, tombstones, n: int):
    """Mask deleted points out of a (Q, Ctot) candidate list (sentinel n).

    ``tombstones`` is ascending int32, padded with INT32_MAX.
    """
    if n == 0:
        return ids
    gid = gids[ids.clamp(0, n - 1).to(torch.int64)]
    pos = torch.searchsorted(tombstones, gid)
    hit = tombstones[pos.clamp(0, tombstones.shape[0] - 1)] == gid
    return torch.where((ids < n) & hit, n, ids)


def probe_candidates(cfg, params, template, sorted_keys, sorted_ids, n: int,
                     queries, cbucket: Optional[int] = None,
                     c_cap: Optional[int] = None, occ_from=None):
    """hash -> probe keys -> fused lookup+gather; candidate ids, sentinel n.
    Not deduplicated: the fused rerank drops duplicates itself."""
    if cfg.probe_impl != "fused":
        raise NotImplementedError(
            f"probe_impl {cfg.probe_impl!r} is not ported yet (only 'fused')")
    bucket, x_neg = stage_hash(cfg, params, queries)
    probe_keys = stage_probe_keys(cfg, params, template, bucket, x_neg)
    ids, _ = stage_fused_probe(cfg, sorted_keys, sorted_ids, probe_keys, n,
                               cbucket, c_cap=c_cap, occ_from=occ_from)
    return ids


def stage_rerank(cfg, dataset, queries, ids):
    """Exact rerank: the k lex-(dist, id)-smallest unique candidates,
    ascending; invalid -> (BIG_DIST, -1)."""
    if cfg.rerank_impl != "fused":
        raise NotImplementedError(
            f"rerank_impl {cfg.rerank_impl!r} is not ported yet (only 'fused')")
    if dataset.shape[0] == 0:
        q = ids.shape[0]
        return (torch.full((q, cfg.k), BIG_DIST, dtype=torch.int32, device=ids.device),
                torch.full((q, cfg.k), -1, dtype=torch.int32, device=ids.device))
    return kops.fused_rerank(dataset, queries, ids, cfg.k, chunk=cfg.rerank_chunk)


def stage_merge_pair(da, ia, db, ib):
    """Merge two ascending (Q, k) top-k lists into one (bitonic topk_merge).
    Invalid entries must carry dist >= BIG_DIST."""
    return kops.topk_merge(da, ia, db, ib)
