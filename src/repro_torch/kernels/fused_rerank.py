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

The kernel has two paths, one contract.  The sliced path splits each
query's candidate slots into ``S`` slices, one block each, and merges the
slices' top-k lists: slice s holds the ``CHUNK``-slot chunks s, s + S, s +
2S, ... (``slice_slots``); ``plan_slices`` picks S.  The windowed path (one
cooperative launch) sorts each row's ids by window of ``2^shift`` rows in
place and reranks the batch window by window, so that every query reads a
window's rows while they sit in L2; ``plan_windows`` decides from the shapes
and the card's L2 size whether it runs, and with which windows.  It reorders
the ids it is given (each row keeps its multiset of valid ids, so a second
rerank of them gives the same answer): the served path hands the rerank ids
it never reads again.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import _build

__all__ = ["BIG_DIST", "fused_rerank_plain", "fused_rerank_cuda", "empty_result",
           "plan_slices", "slice_slots", "resident_blocks", "WindowPlan", "plan_windows",
           "window_budget", "window_smem_bytes", "window_workspace_bytes"]

BIG_DIST = np.iinfo(np.int32).max // 2
_EMPTY_KEY = BIG_DIST << 32  # (BIG_DIST, -1) with the id stored as id + 1
SMEM_LIMIT = 48 * 1024  # bytes of shared memory the kernel may ask for
MAX_SLICES = 32         # the slice merge gives each slice's list one lane
CHUNK = 256             # slots a block takes a step (its 256 threads' ids)
MIN_CHUNKS = 2          # chunks a planned slice holds at least
# The windowed path (csrc/fused_rerank.cu's kPart, kMaxWindows, kMaxChunks):
# slots a partition chunk, windows and chunks a row at most.
WINDOW_PART, MAX_WINDOWS, MAX_WINDOW_CHUNKS = 8192, 2048, 64
WARPS = 8
# The rule (from timings on an H100 80GB HBM3, PERF.md section 6): the path
# runs where the batch's slots name each row at least WINDOW_REUSE_MIN
# times on average (Q x ctot / n).  It won by 9-36% at 4.2-5.4 slots a row
# (32- to 1,024-query batches), by 5-25% at 0.67-2.7 (level at 2.1) and
# lost 4-17% at 0.17-0.34 (64 queries over 50 M rows of 512 bytes), so
# the two cross between 0.34 and 0.67.  The readings below 4 time the
# kernel alone on uniform ids with the first windows (65,536 and 4,096
# rows), no cell lies between 0.34 and 4, and the rule keeps that margin
# until the path is timed at such shapes.  The G resident blocks work
# on items of about G / Q windows at once, so a window's rows take the
# largest power of two of rows within Q / 2G of the card's L2, but no less
# than an eighth and no more than half of it (the best of 512 to 32,768
# rows at 32 to 1,024 queries over 1 M rows of 512 and 3,840 bytes),
# doubled while the windows pass MAX_WINDOWS or the workspace
# WINDOW_WORKSPACE_LIMIT; the rows must span two windows or more.
WINDOW_L2_SHARES = (1 / 8, 1 / 2)
WINDOW_REUSE_MIN = 4.0
WINDOW_WORKSPACE_LIMIT = 64 << 20


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


@dataclass(frozen=True)
class WindowPlan:
    """The windowed path's cut of one call: windows of ``2^shift`` rows,
    ``chunks`` partition chunks a row, the workspace's bytes."""
    shift: int
    windows: int
    chunks: int
    workspace_bytes: int

    @property
    def rows(self) -> int:
        return 1 << self.shift


def window_smem_bytes(m: int, k: int) -> int:
    """Dynamic shared memory of a windowed block (the kernel's
    ``window_smem_bytes``): the partition's chunk, bins and warp sums, or an
    item's 9 lists, query, gathered ids and segments, the larger."""
    part = 4 * (WINDOW_PART + MAX_WINDOWS + WARPS)
    item = 8 * (WARPS + 1) * k + 4 * (m + WINDOW_PART + 2 * MAX_WINDOW_CHUNKS + 1)
    return max(part, item)


def window_workspace_bytes(q: int, k: int, windows: int, chunks: int) -> int:
    """The windowed path's workspace: the running lists (q, k) int64, the
    locks (q,) int32, the ticket (16 bytes), the bin offsets (q, chunks,
    windows + 1) uint16, in that order."""
    return 8 * q * k + 4 * q + 16 + 2 * q * chunks * (windows + 1)


def window_budget(q: int, l2_bytes: int, resident: int) -> int:
    """Bytes of a window's rows: Q / 2G of the L2 for G resident blocks,
    within ``WINDOW_L2_SHARES``."""
    low, high = WINDOW_L2_SHARES
    return int(l2_bytes * min(high, max(low, q / (2 * max(resident, 1)))))


def plan_windows(q: int, n: int, m: int, itemsize: int, ctot: int, k: int,
                 l2_bytes: int, resident: int,
                 rows: Optional[int] = None) -> Optional[WindowPlan]:
    """The windowed path's plan, or None where the rule keeps the sliced path
    (``resident``: the windowed kernel's resident blocks).

    ``rows`` (a power of two) fixes the window and forces the path (the
    tests use it); it raises where the kernel cannot take the cut.
    """
    chunks = -(-ctot // WINDOW_PART)
    if rows is not None:
        if rows < 1 or rows & (rows - 1):
            raise ValueError(f"fused_rerank: window rows must be a power of two, got {rows}")
        windows = -(-n // rows)
        if windows > MAX_WINDOWS or chunks > MAX_WINDOW_CHUNKS:
            raise ValueError(f"fused_rerank: {windows} windows of {rows} rows and {chunks} "
                             f"chunks exceed {MAX_WINDOWS} and {MAX_WINDOW_CHUNKS}")
        if window_smem_bytes(m, k) > SMEM_LIMIT:
            raise ValueError(f"fused_rerank windowed kernel: k={k}, m={m} need "
                             f"{window_smem_bytes(m, k)} B of shared memory (> {SMEM_LIMIT})")
        return WindowPlan(rows.bit_length() - 1, windows, chunks,
                          window_workspace_bytes(q, k, windows, chunks))
    if (n == 0 or q * ctot < WINDOW_REUSE_MIN * n or chunks > MAX_WINDOW_CHUNKS
            or window_smem_bytes(m, k) > SMEM_LIMIT):
        return None
    shift = max(1, window_budget(q, l2_bytes, resident) // (m * itemsize)).bit_length() - 1
    while True:
        windows = -(-n // (1 << shift))
        nbytes = window_workspace_bytes(q, k, windows, chunks)
        if windows < 2:
            return None
        if windows <= MAX_WINDOWS and nbytes <= WINDOW_WORKSPACE_LIMIT:
            return WindowPlan(shift, windows, chunks, nbytes)
        shift += 1


_ENTRY = {torch.int32: "i32", torch.int16: "i16"}
# dataset, queries, ids, work, dout, iout, q, n, m, ctot, k, vec, slices,
# stream
# windowed: dataset, queries, ids, work, dout, iout, q, n, m, ctot, k, vec,
# shift, windows, grid, stream
_build.declare("fused_rerank", {
    **{f"fused_rerank_{s}": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
       for s in _ENTRY.values()},
    **{f"fused_rerank_window_{s}": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
       + [ctypes.c_void_p] for s in _ENTRY.values()},
    **{f"fused_rerank_{w}resident_{s}": [ctypes.c_int] * 3
       for s in _ENTRY.values() for w in ("", "window_")},
    "fused_rerank_l2_bytes": []})
_RESIDENT = {}  # (entry, device, ...) -> blocks resident at once, or L2 bytes


def _device_query(key, device: int, name: str, *args) -> int:
    got = _RESIDENT.get(key)
    if got is None:
        with torch.cuda.device(device):
            got = _build.entry("fused_rerank", name)(*args)
        if got <= 0:
            raise RuntimeError(f"fused_rerank: {name} failed with error {-got}")
        _RESIDENT[key] = got
    return got


def resident_blocks(device: int, dtype, m: int, k: int, vec: int, windowed: bool = False) -> int:
    """Blocks of the kernel for (dtype, m, k, vec) that CUDA device ``device``
    keeps resident at once (the sliced kernel's, or with ``windowed`` the
    windowed one's): SMs x blocks an SM, read from the device once."""
    entry = f"fused_rerank_{'window_' if windowed else ''}resident_{_ENTRY[dtype]}"
    return _device_query((entry, device, dtype, m, k, vec), device, entry, m, k, vec)


def l2_bytes(device: int) -> int:
    """The L2 cache of CUDA device ``device`` in bytes, read once."""
    return _device_query(("l2", device), device, "fused_rerank_l2_bytes")


def _vec(dataset) -> int:
    """1 where the kernel reads the rows as aligned 16-byte vectors."""
    return int(dataset.shape[1] % (16 // dataset.element_size()) == 0
               and dataset.data_ptr() % 16 == 0)


def _plan(dataset, q, ctot, k, device, window_rows=None):
    n, m = dataset.shape
    if window_rows is not None:
        return plan_windows(q, n, m, dataset.element_size(), ctot, k, 0, 0, window_rows)
    return plan_windows(q, n, m, dataset.element_size(), ctot, k, l2_bytes(device),
                        resident_blocks(device, dataset.dtype, m, k, _vec(dataset), windowed=True))


def fused_rerank_cuda(dataset, queries, ids, k: int, slices=None, window_rows=None):
    """Launch the CUDA kernel on CUDA tensors; raises on what it cannot take.

    ``plan_windows`` picks the path; the windowed one reorders ``ids`` in
    place (see the module's note).  ``slices`` forces the sliced path at that
    many slices, ``window_rows`` the windowed one at windows of that many
    rows (the tests use both); by default the plans pick for the card.
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
    vec = _vec(dataset)
    dout = torch.empty((q, k), dtype=torch.int32, device=ids.device)
    iout = torch.empty((q, k), dtype=torch.int32, device=ids.device)
    plan = None if slices is not None else _plan(dataset, q, ctot, k, device, window_rows)
    if plan is not None:
        work = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=ids.device)
        grid = min(resident_blocks(device, dataset.dtype, m, k, vec, windowed=True),
                   max(q * plan.chunks, q * plan.windows))
        fn = _build.entry("fused_rerank", f"fused_rerank_window_{_ENTRY[dataset.dtype]}")
        _build.launch("fused_rerank", fn, device, dataset.data_ptr(), queries.data_ptr(),
                      ids.data_ptr(), work.data_ptr(), dout.data_ptr(), iout.data_ptr(),
                      q, n, m, ctot, k, vec, plan.shift, plan.windows, grid)
        _build.count_path("fused_rerank", "windowed", plan.windows)
        return dout, iout
    n_slices = plan_slices(
        q, ctot, resident_blocks(device, dataset.dtype, m, k, vec) if slices is None else 0, slices)
    work = (torch.empty((q, n_slices, k), dtype=torch.int64, device=ids.device)
            if n_slices > 1 else None)
    fn = _build.entry("fused_rerank", f"fused_rerank_{_ENTRY[dataset.dtype]}")
    _build.launch("fused_rerank", fn, device, dataset.data_ptr(), queries.data_ptr(),
                  ids.data_ptr(), None if work is None else work.data_ptr(),
                  dout.data_ptr(), iout.data_ptr(), q, n, m, ctot, k, vec, n_slices)
    _build.count_path("fused_rerank", "sliced")
    return dout, iout
