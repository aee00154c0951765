"""Public wrappers for the port's kernels.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor runs the kernel's plain-torch version, a CUDA tensor launches the
CUDA kernel — and raises if the kernel cannot be built or launched.  A fake
tensor (the dry-run's: a device but no memory) takes the plain version,
which gives the result's shapes.  There is no switch and no fallback from a
kernel to its plain version.

``LAUNCHES`` counts kernel launches per kernel (``reset_launches`` zeroes
it), so a run can show that it went through the kernels; ``_build.SLOTS``
counts the candidate slots handed to ``fused_rerank``'s launches.
"""
from __future__ import annotations

from torch._subclasses.fake_tensor import FakeTensor

from ._build import LAUNCHES, count_slots, reset_launches
from .fused_probe import (compact_gather, compact_gather_cuda, fused_probe_cuda,
                          fused_probe_plain, probe_extents_cuda)
from .fused_probe import probe_extents as probe_extents_plain
from .fused_rerank import fused_rerank_cuda, fused_rerank_plain, rerank_attrs
from .l1_distance import (l1_distance_cuda, l1_distance_plain,
                          l1_distance_rows_cuda, l1_distance_rows_plain)
from .rw_hash import rw_hash_cuda, rw_hash_plain
from .topk_merge import topk_merge_cuda, topk_merge_plain

__all__ = ["LAUNCHES", "reset_launches", "topk_merge", "fused_rerank", "rerank_attrs",
           "fused_probe", "probe_extents", "rw_hash", "l1_distance",
           "l1_distance_rows"]


def _on_cuda(t) -> bool:
    """A card's tensor with memory behind it.  A fake tensor (the dry-run
    traces on them) takes the plain version, which gives its shapes."""
    return t.is_cuda and not isinstance(t, FakeTensor)


def topk_merge(da, ia, db, ib):
    """Merge two lex-ascending (Q, k) (dist, id) lists into the k smallest."""
    if _on_cuda(da):
        return topk_merge_cuda(da, ia, db, ib)
    return topk_merge_plain(da, ia, db, ib)


def fused_rerank(dataset, queries, ids, k: int, chunk: int = 512):
    """Gather + exact L1 + top-k over unique valid candidates (``chunk`` sizes
    the plain version's candidate steps; the kernel needs none).  The
    kernel's windowed path reorders ``ids`` in place, each row keeping its
    multiset of valid ids."""
    if _on_cuda(ids):
        out = fused_rerank_cuda(dataset, queries, ids, k)
        count_slots("fused_rerank", ids.numel())
        return out
    return fused_rerank_plain(dataset, queries, ids, k, chunk=chunk)


def probe_extents(sorted_keys, probe_keys, cap: int, occ_from=None):
    """Phase A: raw bucket extents (lo, occ (Q, L*P) int32, unclamped) and
    counts (Q,) = sum min(occ, cap).  ``occ_from``, the build-time run-length
    table, turns the right-side search into a hit test."""
    if _on_cuda(probe_keys):
        return probe_extents_cuda(sorted_keys, probe_keys, cap, occ_from=occ_from)
    return probe_extents_plain(sorted_keys, probe_keys, cap, occ_from=occ_from)


def fused_probe(sorted_keys, sorted_ids, probe_keys, cap: int, cbucket: int,
                extents=None, occ_from=None):
    """Bucket lookup + compacted gather.

    Given ``extents`` — phase A's (lo, occ) — it gathers from them and
    searches nothing (the served path, which runs phase A first); without
    them it computes the extents first (the one-pass path).  On the card
    these are the gather kernel alone, or the extents kernel and then the
    gather kernel.  ``cap`` may be tighter than the cap of the extents'
    counts (the truncate rung).
    """
    if extents is None:
        if _on_cuda(probe_keys):
            return fused_probe_cuda(sorted_keys, sorted_ids, probe_keys, cap,
                                    cbucket, occ_from=occ_from)
        return fused_probe_plain(sorted_keys, sorted_ids, probe_keys, cap,
                                 cbucket, occ_from=occ_from)
    gather = compact_gather_cuda if _on_cuda(extents[0]) else compact_gather
    return gather(sorted_ids, extents[0], extents[1], probe_keys.shape[2],
                  cbucket, cap)


def rw_hash(pairs, points):
    """Random-walk raw hash: pairs (F, m, U2) int8, points (n, m) int32 ->
    (n, F) int32, the thermometer product of ``points >> 1`` with the steps."""
    if _on_cuda(points):
        return rw_hash_cuda(pairs, points)
    return rw_hash_plain(pairs, points)


def l1_distance(queries, points):
    """(Q, m), (N, m) -> (Q, N) pairwise L1; int32 sums for integer inputs,
    float32 for float32 and bfloat16."""
    if _on_cuda(queries):
        return l1_distance_cuda(queries, points)
    return l1_distance_plain(queries, points)


def l1_distance_rows(queries, rows):
    """(Q, m), (Q, C, m) -> (Q, C) per-query candidate L1 distances."""
    if _on_cuda(queries):
        return l1_distance_rows_cuda(queries, rows)
    return l1_distance_rows_plain(queries, rows)
