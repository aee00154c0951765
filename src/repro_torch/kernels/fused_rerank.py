"""Fused rerank: CUDA kernel (``csrc/fused_rerank.cu``) and its plain-torch
version.

Replaces ``fused_rerank_pallas`` (``src/repro/kernels/fused_rerank.py:140``).
Contract (both versions, and the JAX package's): the k lex-(dist,
id)-smallest pairs over the *unique* valid candidate ids, ascending; ids < 0
or >= n are invalid and ids need not be deduplicated; empty slots carry
``(BIG_DIST, -1)``, and so does every invalid or duplicate slot in the sort,
so a valid distance >= BIG_DIST ranks after them.  The kernel needs every
valid distance below BIG_DIST (the serving entry points refuse inputs that
could reach it, ``SegmentedIndex.admit_points`` and ``admit_queries``).

The kernel splits each query's candidate slots into ``S`` slices, one block
each, and merges the slices' top-k lists: slice s holds the ``CHUNK``-slot
chunks s, s + S, s + 2S, ... (``slice_slots``).  ``plan_slices`` picks S.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["BIG_DIST", "fused_rerank_plain", "fused_rerank_cuda", "empty_result",
           "plan_slices", "slice_slots", "resident_blocks"]

BIG_DIST = np.iinfo(np.int32).max // 2
_EMPTY_KEY = BIG_DIST << 32  # (BIG_DIST, -1) with the id stored as id + 1
SMEM_LIMIT = 48 * 1024  # bytes of shared memory the kernel may ask for
MAX_SLICES = 32         # the slice merge gives each slice's list one lane
CHUNK = 256             # slots a block takes a step (its 256 threads' ids)
MIN_CHUNKS = 2          # chunks a planned slice holds at least


def empty_result(q: int, k: int, device):
    return (torch.full((q, k), BIG_DIST, dtype=torch.int32, device=device),
            torch.full((q, k), -1, dtype=torch.int32, device=device))


def fused_rerank_plain(dataset, queries, ids, k: int, chunk: int = 512):
    """Plain-torch rerank: id-sort dedup, chunked distances, one key sort.

    Chunked over candidates like ``fused_rerank_xla``, so the gathered
    (Q, chunk, m) rows stay small at any candidate width.  As in the
    reference, every slot takes part in the sort: a unique valid id as
    ``(dist, id)``, an invalid or duplicate slot as ``(BIG_DIST, -1)``.  The
    packed int64 keys ``(dist << 32) | (id + 1)`` order exactly as lex-(dist,
    id) for any int32 dist, so a wrapped (negative) sum sorts first and a
    valid distance >= BIG_DIST sorts after every empty slot; an output whose
    distance is >= BIG_DIST carries the id -1.
    """
    n = dataset.shape[0]
    q, ctot = ids.shape
    if n == 0 or ctot == 0:
        return empty_result(q, k, ids.device)
    sid = torch.where((ids < 0) | (ids >= n), n, ids).to(torch.int64)
    sid = torch.sort(sid, dim=-1).values
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    sid = torch.where(dup, n, sid)
    qs = queries.to(torch.int32)
    keys = torch.empty((q, max(ctot, k)), dtype=torch.int64, device=ids.device)
    keys[:, ctot:] = _EMPTY_KEY
    for lo in range(0, ctot, chunk):
        step = sid[:, lo:lo + chunk]
        rows = dataset[step.clamp(0, n - 1)].to(torch.int32)        # (Q, c, m)
        d = (rows - qs[:, None, :]).abs().sum(dim=-1, dtype=torch.int32)
        keys[:, lo:lo + step.shape[1]] = torch.where(
            step < n, (d.to(torch.int64) << 32) | (step + 1), _EMPTY_KEY)
    keys = torch.sort(keys, dim=-1).values[:, :k]
    d = (keys >> 32).to(torch.int32)
    i = torch.where(d >= BIG_DIST, -1, (keys & 0xFFFFFFFF) - 1).to(torch.int32)
    return d, i


def plan_slices(q: int, ctot: int, resident: int, slices=None) -> int:
    """The number of slices S of each query's ``ctot`` slots.

    Unless ``slices`` is given, the grid's Q*S blocks fill one wave of the
    ``resident`` blocks the card holds at once, with at least ``MIN_CHUNKS``
    chunks a slice.  Always 1 <= S <= min(MAX_SLICES, chunks of the row).
    """
    chunks = -(-ctot // CHUNK)
    if slices is None:
        slices = min(resident // max(q, 1), chunks // MIN_CHUNKS)
    return max(1, min(int(slices), MAX_SLICES, chunks))


def slice_slots(ctot: int, slices: int, s: int) -> np.ndarray:
    """The slots of slice ``s`` of ``slices``, as the kernel takes them."""
    slots = np.arange(ctot)
    return slots[(slots // CHUNK) % slices == s]


_ENTRY = {torch.int32: "i32", torch.int16: "i16"}
# dataset, queries, ids, work, dout, iout, q, n, m, ctot, k, vec, slices,
# stream
_build.declare("fused_rerank", {
    **{f"fused_rerank_{s}": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
       for s in _ENTRY.values()},
    **{f"fused_rerank_resident_{s}": [ctypes.c_int] * 3 for s in _ENTRY.values()}})
_RESIDENT = {}  # (device, dtype, m, k, vec) -> blocks resident at once


def resident_blocks(device: int, dtype, m: int, k: int, vec: int) -> int:
    """Blocks of the kernel for (dtype, m, k, vec) that CUDA device ``device``
    keeps resident at once: SMs x blocks an SM, read from the device once."""
    key = (device, dtype, m, k, vec)
    got = _RESIDENT.get(key)
    if got is None:
        with torch.cuda.device(device):
            fn = _build.entry("fused_rerank", f"fused_rerank_resident_{_ENTRY[dtype]}")
            got = fn(m, k, vec)
        if got <= 0:
            raise RuntimeError(f"fused_rerank: occupancy query failed with error {-got}")
        _RESIDENT[key] = got
    return got


def fused_rerank_cuda(dataset, queries, ids, k: int, slices=None):
    """Launch the CUDA kernel on CUDA tensors; raises on what it cannot take.

    ``slices`` fixes the number of slices a query's candidates are split into
    (the tests use it); by default ``plan_slices`` picks it for the card.
    """
    if dataset.dtype not in _ENTRY:
        raise TypeError(f"fused_rerank: dataset must be int32 or int16, got {dataset.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"fused_rerank: ids must be int32, got {ids.dtype}")
    n, m = dataset.shape
    q, ctot = ids.shape
    if queries.shape != (q, m):
        raise ValueError(f"fused_rerank: queries {tuple(queries.shape)} != ({q}, {m})")
    device = ids.get_device()
    if device < 0 or dataset.get_device() != device or queries.get_device() != device:
        raise ValueError("fused_rerank: inputs must lie on one CUDA device")
    smem = 8 * 8 * k + 4 * m
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_rerank kernel: k={k}, m={m} need {smem} B of "
                         f"shared memory (> {SMEM_LIMIT})")
    if n == 0 or ctot == 0 or q == 0:
        return empty_result(q, k, ids.device)
    dataset = dataset.contiguous()
    queries = queries.to(torch.int32).contiguous()
    ids = ids.contiguous()
    per_vec = 16 // dataset.element_size()
    vec = int(m % per_vec == 0 and dataset.data_ptr() % 16 == 0)
    n_slices = plan_slices(
        q, ctot, resident_blocks(device, dataset.dtype, m, k, vec) if slices is None else 0, slices)
    dout = torch.empty((q, k), dtype=torch.int32, device=ids.device)
    iout = torch.empty((q, k), dtype=torch.int32, device=ids.device)
    work = (torch.empty((q, n_slices, k), dtype=torch.int64, device=ids.device)
            if n_slices > 1 else None)
    fn = _build.entry("fused_rerank", f"fused_rerank_{_ENTRY[dataset.dtype]}")
    _build.launch("fused_rerank", fn, device, dataset.data_ptr(), queries.data_ptr(),
                  ids.data_ptr(), None if work is None else work.data_ptr(),
                  dout.data_ptr(), iout.data_ptr(), q, n, m, ctot, k, vec, n_slices)
    return dout, iout
