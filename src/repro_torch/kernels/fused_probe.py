"""Fused probe front-end: the two CUDA kernels of ``csrc/fused_probe.cu``
and their plain-torch versions.

Replaces ``fused_probe_pallas`` (``src/repro/kernels/fused_probe.py:158``).
``probe_extents`` and ``compact_gather`` are the plain-torch counterparts of
``probe_extents_xla`` (phase A: raw extents and counts, ahead of the host
rung pick) and ``compact_gather_xla`` (phase B: the gather from those
extents); ``probe_extents_cuda`` and ``compact_gather_cuda`` launch their
kernels, and ``fused_probe_cuda`` runs the two in turn (the one-pass route).

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
from .fused_rerank import plan_slices

__all__ = ["probe_extents", "compact_gather", "fused_probe_plain",
           "probe_extents_cuda", "compact_gather_cuda", "fused_probe_cuda",
           "gather_resident_blocks"]


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


# extents: sorted_keys, occ_from, probe_keys, lo, occ, counts, q, n, l*p, p,
# cap, stream; gather: sorted_ids, lo, occ, out, counts, q, n, l*p, p, cap,
# cbucket, slices, stream
_build.declare("fused_probe", {
    "fused_probe_extents_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "fused_probe_gather_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "fused_probe_gather_resident": [ctypes.c_int]})
_RESIDENT = {}  # (device, l*p) -> gather blocks resident at once


def _device(*tensors) -> int:
    device = tensors[0].get_device()
    if device < 0 or any(t.get_device() != device for t in tensors):
        raise ValueError("fused_probe: inputs must lie on one CUDA device")
    return device


def probe_extents_cuda(sorted_keys, probe_keys, cap: int, occ_from=None):
    """Launch the extents kernel on CUDA tensors: (lo, raw occ, counts) as
    ``probe_extents``; raises on what it cannot take."""
    if sorted_keys.dtype != torch.int64 or probe_keys.dtype != torch.int64:
        raise TypeError("fused_probe: keys must be int64 holding uint32 values")
    l, n = sorted_keys.shape
    q, l2, p = probe_keys.shape
    if l2 != l:
        raise ValueError("fused_probe: sorted keys and probe keys disagree on L")
    if occ_from is not None and (occ_from.dtype != torch.int32
                                 or occ_from.shape != (l, n)):
        raise ValueError("fused_probe: occ_from must be (L, n) int32")
    if cap < 1:
        raise ValueError(f"fused_probe: cap must be >= 1, got {cap}")
    device = _device(sorted_keys, probe_keys,
                     *(() if occ_from is None else (occ_from,)))
    if n == 0 or q == 0 or l * p == 0:
        z = torch.zeros((q, l * p), dtype=torch.int32, device=probe_keys.device)
        return z, z, torch.zeros((q,), dtype=torch.int32, device=probe_keys.device)
    lo = torch.empty((q, l * p), dtype=torch.int32, device=probe_keys.device)
    occ = torch.empty_like(lo)
    counts = torch.empty((q,), dtype=torch.int32, device=probe_keys.device)
    sorted_keys, probe_keys = sorted_keys.contiguous(), probe_keys.contiguous()
    occ_from = None if occ_from is None else occ_from.contiguous()
    _build.launch("fused_probe_extents",
                  _build.entry("fused_probe", "fused_probe_extents_launch"), device,
                  sorted_keys.data_ptr(), None if occ_from is None else occ_from.data_ptr(),
                  probe_keys.data_ptr(), lo.data_ptr(), occ.data_ptr(), counts.data_ptr(),
                  q, n, l * p, p, int(cap))
    return lo, occ, counts


def gather_resident_blocks(device: int, lp: int) -> int:
    """Blocks of the gather kernel for ``lp`` probes a query that CUDA device
    ``device`` keeps resident at once, read from the device once."""
    got = _RESIDENT.get((device, lp))
    if got is None:
        with torch.cuda.device(device):
            got = _build.entry("fused_probe", "fused_probe_gather_resident")(lp)
        if got <= 0:
            raise RuntimeError(f"fused_probe: occupancy query failed with error {-got}")
        _RESIDENT[(device, lp)] = got
    return got


def compact_gather_cuda(sorted_ids, lo, occ, p: int, cbucket: int, cap: int,
                        slices=None):
    """Launch the gather kernel on CUDA tensors: (ids, counts) as
    ``compact_gather``.  ``slices`` fixes the blocks a query's output row is
    split into (the tests use it); by default ``plan_slices`` fills one wave
    of resident blocks (its chunks of ``fused_rerank.CHUNK`` slots are the
    kernel's block width)."""
    if sorted_ids.dtype != torch.int32 or lo.dtype != torch.int32 or occ.dtype != torch.int32:
        raise TypeError("fused_probe: sorted_ids, lo and occ must be int32")
    l, n = sorted_ids.shape
    q, lp = lo.shape
    if occ.shape != lo.shape or p < 1 or lp != l * p:
        raise ValueError(f"fused_probe: extents {tuple(lo.shape)}, {tuple(occ.shape)} do "
                         f"not hold L*P = {l} * {p} buckets a query")
    if cap < 1:
        raise ValueError(f"fused_probe: cap must be >= 1, got {cap}")
    device = _device(sorted_ids, lo, occ)
    if n == 0 or cbucket == 0 or q == 0:
        return _empty(q, cbucket, lo.device)
    sorted_ids, lo, occ = sorted_ids.contiguous(), lo.contiguous(), occ.contiguous()
    n_slices = plan_slices(q, cbucket, gather_resident_blocks(device, lp)
                           if slices is None else 0, slices)
    out = torch.empty((q, cbucket), dtype=torch.int32, device=lo.device)
    counts = torch.empty((q,), dtype=torch.int32, device=lo.device)
    _build.launch("fused_probe_gather",
                  _build.entry("fused_probe", "fused_probe_gather_launch"), device,
                  sorted_ids.data_ptr(), lo.data_ptr(), occ.data_ptr(), out.data_ptr(),
                  counts.data_ptr(), q, n, lp, p, int(cap), int(cbucket), n_slices)
    return out, counts


def fused_probe_cuda(sorted_keys, sorted_ids, probe_keys, cap: int,
                     cbucket: int, occ_from=None):
    """The one-pass route on CUDA tensors: the extents kernel, then the
    gather kernel from its extents."""
    if sorted_ids.shape != sorted_keys.shape:
        raise ValueError("fused_probe: keys and ids disagree on L or n")
    lo, occ, _ = probe_extents_cuda(sorted_keys, probe_keys, cap, occ_from)
    return compact_gather_cuda(sorted_ids, lo, occ, probe_keys.shape[2], cbucket, cap)
