"""Fused probe front-end: CUDA kernel (``csrc/fused_probe.cu``) and its
plain-torch version, plus the two-phase pair the serving path runs.

Replaces ``fused_probe_pallas`` (``src/repro/kernels/fused_probe.py:158``).
``probe_extents`` and ``compact_gather`` are the plain-torch counterparts of
``probe_extents_xla`` and ``compact_gather_xla``: phase A (raw extents and
counts, ahead of the host rung pick) runs as plain torch on every device,
as the JAX package runs it outside Pallas on every backend.

Output contract (all versions):

    ids    : (Q, cbucket) int32 — the valid candidates in (table, probe,
             bucket-offset) order, packed to the front; tail slots hold the
             sentinel n; a query whose count exceeds cbucket is truncated.
    counts : (Q,) int32 — sum over (table, probe) of min(occupancy, cap),
             not clipped to cbucket.

A bucket with occupancy > cap contributes its first ``cap`` rows in sorted
order (a deterministic prefix), so any tighter cap is reproducible.
Keys are uint32 values carried as int64 (see ``core.hashes``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["probe_extents", "compact_gather", "fused_probe_plain",
           "fused_probe_cuda"]


def _empty(q: int, cbucket: int, device):
    # n == 0: every slot invalid, and the sentinel for n = 0 is 0 itself
    return (torch.zeros((q, cbucket), dtype=torch.int32, device=device),
            torch.zeros((q,), dtype=torch.int32, device=device))


def probe_extents(sorted_keys, probe_keys, cap: int, occ_from=None):
    """Raw bucket extents: (lo (Q, L*P) int32, occ (Q, L*P) int32 unclamped
    occupancies, counts (Q,) int32 = sum min(occ, cap)).

    With ``occ_from`` (the build-time run-length table) the right-side
    search becomes a hit test at ``lo`` and one gather.
    """
    l, n = sorted_keys.shape
    q, _, p = probe_keys.shape
    if n == 0:
        z = torch.zeros((q, l * p), dtype=torch.int32, device=probe_keys.device)
        return z, z, torch.zeros((q,), dtype=torch.int32, device=probe_keys.device)
    pk = probe_keys.permute(1, 0, 2).reshape(l, q * p).contiguous()  # (L, Q*P)
    lo = torch.searchsorted(sorted_keys, pk)
    if occ_from is None:
        occ = torch.searchsorted(sorted_keys, pk, right=True) - lo
    else:
        safe = lo.clamp(max=n - 1)
        hit = (torch.gather(sorted_keys, 1, safe) == pk) & (lo < n)
        occ = torch.where(hit, torch.gather(occ_from, 1, safe).to(torch.int64), 0)

    def per_query(x):                                               # -> (Q, L*P)
        return x.reshape(l, q, p).permute(1, 0, 2).reshape(q, l * p).to(torch.int32)

    lo, occ = per_query(lo), per_query(occ)
    counts = occ.clamp(max=cap).sum(dim=-1, dtype=torch.int32)
    return lo, occ, counts


def compact_gather(sorted_ids, lo, occ, p: int, cbucket: int, cap: int):
    """Phase B from precomputed extents: each bucket's first min(occ, cap)
    ids packed to the front of a (Q, cbucket) slab.  ``cap`` may be tighter
    than the cap the extents' counts used (the two-level truncate rung).
    Returns (ids, counts under this cap)."""
    l, n = sorted_ids.shape
    q, lp = lo.shape
    if n == 0 or cbucket == 0 or q == 0:
        return _empty(q, cbucket, lo.device)
    cnt = occ.clamp(max=cap).to(torch.int64)
    csum = torch.cumsum(cnt, dim=-1)                                # inclusive
    total = csum[:, -1]
    start = csum - cnt                                              # exclusive
    slot = torch.arange(cbucket, dtype=torch.int64, device=lo.device)
    seg = torch.searchsorted(csum, slot.expand(q, cbucket).contiguous(),
                             right=True).clamp(max=lp - 1)
    valid = slot[None, :] < total[:, None]
    pos = torch.gather(lo.to(torch.int64), 1, seg) + slot[None, :] - torch.gather(start, 1, seg)
    flat = (seg // p) * n + pos.clamp(0, n - 1)
    ids = sorted_ids.reshape(-1)[flat]
    return torch.where(valid, ids, n).to(torch.int32), total.to(torch.int32)


def fused_probe_plain(sorted_keys, sorted_ids, probe_keys, cap: int,
                      cbucket: int, occ_from=None):
    """One-pass plain version: extents from the probe keys, then the gather."""
    q, _, p = probe_keys.shape
    if sorted_keys.shape[1] == 0 or cbucket == 0 or q == 0:
        return _empty(q, cbucket, probe_keys.device)
    lo, occ, _ = probe_extents(sorted_keys, probe_keys, cap, occ_from)
    return compact_gather(sorted_ids, lo, occ, p, cbucket, cap)


# sorted_keys, sorted_ids, occ_from, probe_keys, out, counts, q, n, l*p, p,
# cap, cbucket, stream
_build.declare("fused_probe", {
    "fused_probe_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]})


def fused_probe_cuda(sorted_keys, sorted_ids, probe_keys, cap: int,
                     cbucket: int, occ_from=None):
    """Launch the CUDA kernel on CUDA tensors; raises on what it cannot take."""
    if sorted_keys.dtype != torch.int64 or probe_keys.dtype != torch.int64:
        raise TypeError("fused_probe: keys must be int64 holding uint32 values")
    if sorted_ids.dtype != torch.int32:
        raise TypeError("fused_probe: sorted_ids must be int32")
    l, n = sorted_keys.shape
    q, l2, p = probe_keys.shape
    if l2 != l or sorted_ids.shape != (l, n):
        raise ValueError("fused_probe: keys, ids and probe keys disagree on L or n")
    if occ_from is not None and (occ_from.dtype != torch.int32
                                 or occ_from.shape != (l, n)):
        raise ValueError("fused_probe: occ_from must be (L, n) int32")
    if cap < 1:
        raise ValueError(f"fused_probe: cap must be >= 1, got {cap}")
    if n == 0 or cbucket == 0 or q == 0:
        return _empty(q, cbucket, probe_keys.device)
    sorted_keys, sorted_ids, probe_keys = (
        t.contiguous() for t in (sorted_keys, sorted_ids, probe_keys))
    occ = None if occ_from is None else occ_from.contiguous()
    out = torch.empty((q, cbucket), dtype=torch.int32, device=probe_keys.device)
    counts = torch.empty((q,), dtype=torch.int32, device=probe_keys.device)
    _build.launch("fused_probe", _build.entry("fused_probe", "fused_probe_launch"),
                  probe_keys.get_device(), sorted_keys.data_ptr(),
                  sorted_ids.data_ptr(), None if occ is None else occ.data_ptr(),
                  probe_keys.data_ptr(), out.data_ptr(), counts.data_ptr(), q, n,
                  l * p, p, int(cap), int(cbucket))
    return out, counts
