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

A windowed item is (query, window), or, where ``plan_group`` picks G > 1,
(G consecutive queries, window): the block keeps the G queries in shared
memory, each distinct (row, query) pair of the window sets one bit of the
row's mask, and a warp loads each named row once into registers and sums it
against every query that names it.  Exactness rests on the same per-list
dedup and merges as the (query, window) item (the kernel's note); the item
is bound by its row loads, so the rule groups only int32 rows wide enough
that a load saves ``WINDOW_GROUP_BYTES`` on average (int16 rows are never
grouped).  A windowed launch's ``_build.take_path`` detail holds its
counters; ``rerank_attrs`` reads them for a traced run: the group, row
loads, pairs and phase times.
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
           "window_budget", "window_smem_bytes", "window_workspace_bytes", "plan_group",
           "group_reuse", "group_smem_bytes", "plan_call", "rerank_attrs"]

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
# The grouped item (csrc/fused_rerank.cu's kGroupMax, kGroupRowsMax,
# kGroupElems and kGroupWarps): queries an item, rows a window, values of a
# row at most, warps a block.  WINDOW_SMEM_LIMIT is an H100 block's opt-in
# shared memory (232,448 bytes) less 1 KB for the kernel's static shared
# memory; it holds the group's queries.  The rule (plan_group), from the
# kernel timed alone on an H100 80GB HBM3 at 1,024 queries of 50,600 valid
# ids in 131,072 slots (PERF.md section 6): a grouped item's time
# follows its row loads, a (query, window) item's its pairs' bytes, so
# grouping pays where a row load saves enough bytes: int32 rows of at least
# GROUP_ROW_BYTES_MIN bytes (1,920-byte rows won at 16.1 K bytes saved a
# load, 1,024-byte ones lost at 8.6 K; int16 rows lost at 1,920 bytes and
# 8.1 K) and an expected reuse x row bytes of at least WINDOW_GROUP_BYTES
# (3,840-byte rows won by 16% at 1.44 x 3,840 = 5,530; 2,048-byte rows lost
# by 23% at 2.38 x 2,048 = 4,870).  The rule's p = ctot / n counts slots,
# padding included, not valid ids: both readings were taken at a slot fill
# of about 39% (50,600 of 131,072), and the threshold holds at about that
# fill (gist1m's served batches; no cell lies near the line).
WINDOW_GROUP_MAX, GROUP_ROWS_MAX, GROUP_DIM_MAX = 64, 4096, 1024
GROUP_WARPS = 16
WINDOW_SMEM_LIMIT = 232_448 - 1024
GROUP_ROW_BYTES_MIN = 1536
WINDOW_GROUP_BYTES = 5200


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
    ``chunks`` partition chunks a row, the workspace's bytes, and ``group``
    queries an item (1: (query, window) items)."""
    shift: int
    windows: int
    chunks: int
    workspace_bytes: int
    group: int = 1

    @property
    def rows(self) -> int:
        return 1 << self.shift

    def items(self, q: int) -> int:
        """Phase 2's items for ``q`` queries: (group, window) pairs."""
        return -(-q // self.group) * self.windows


def window_smem_bytes(m: int, k: int) -> int:
    """Dynamic shared memory of a windowed block (the kernel's
    ``window_smem_bytes``): the partition's chunk, bins and warp sums, or an
    item's 9 lists, query, gathered ids and segments, the larger."""
    part = 4 * (WINDOW_PART + MAX_WINDOWS + WARPS)
    item = 8 * (WARPS + 1) * k + 4 * (m + WINDOW_PART + 2 * MAX_WINDOW_CHUNKS + 1)
    return max(part, item)


def group_smem_bytes(m: int, k: int, group: int, rows: int, chunks: int) -> int:
    """Dynamic shared memory of a grouped block (the kernel's
    ``group_smem_bytes``): the partition's, or a (group, window) item's lists
    and cuts, merge scratch, row masks, queries, locks, segments and warp
    sums, the larger."""
    segs = group * chunks
    b = 8 * (group * k + group + GROUP_WARPS * 2 * k + rows)
    b = -(-b // 16) * 16
    b += 4 * (group * m + group + segs + segs + 1 + GROUP_WARPS)
    return max(4 * (WINDOW_PART + MAX_WINDOWS + GROUP_WARPS), b)


def group_reuse(group: int, p: float) -> float:
    """Expected (query, row) pairs a row load serves in an item of ``group``
    queries that each name a window's row with probability ``p``."""
    if p <= 0:
        return 1.0
    p = min(p, 1.0)
    return group * p / (1 - (1 - p) ** group)


def plan_group(q: int, n: int, m: int, itemsize: int, ctot: int, k: int,
               smem_limit: int) -> int:
    """Queries an item of the windowed path: the largest G <= Q (at most
    ``WINDOW_GROUP_MAX``) whose block fits ``smem_limit`` bytes of shared
    memory at windows of ``GROUP_ROWS_MAX`` rows, where the rows are int32,
    at least ``GROUP_ROW_BYTES_MIN`` bytes, and a row load is expected to
    save ``WINDOW_GROUP_BYTES`` (``group_reuse(G, ctot / n)`` x row bytes);
    else 1, (query, window) items."""
    row_bytes = m * itemsize
    if (q < 2 or n == 0 or m > GROUP_DIM_MAX or itemsize != 4
            or row_bytes < GROUP_ROW_BYTES_MIN):
        return 1
    chunks = -(-ctot // WINDOW_PART)
    for group in range(min(q, WINDOW_GROUP_MAX), 1, -1):
        if group_smem_bytes(m, k, group, GROUP_ROWS_MAX, chunks) <= smem_limit:
            saved = group_reuse(group, ctot / n) * row_bytes
            return group if saved >= WINDOW_GROUP_BYTES else 1
    return 1


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
                 rows: Optional[int] = None, group: int = 1) -> Optional[WindowPlan]:
    """The windowed path's plan at ``group`` queries an item, or None where
    the rule keeps the sliced path (``group`` 1) or the group cannot be cut
    (``resident``: the windowed kernel's resident blocks, read at ``group``
    1 only).  A group (> 1) takes int32 rows only, and raises on others.

    ``rows`` (a power of two) fixes the window and forces the path (the
    tests use it); it raises where the kernel cannot take the cut.
    """
    chunks = -(-ctot // WINDOW_PART)
    if group > 1 and (group > WINDOW_GROUP_MAX or m > GROUP_DIM_MAX):
        raise ValueError(f"fused_rerank: a group of {group} queries of {m} values exceeds "
                         f"{WINDOW_GROUP_MAX} and {GROUP_DIM_MAX}")
    if group > 1 and itemsize != 4:
        raise ValueError(f"fused_rerank: grouped items take int32 rows, got {itemsize}-byte "
                         "values")
    if rows is not None:
        if rows < 1 or rows & (rows - 1):
            raise ValueError(f"fused_rerank: window rows must be a power of two, got {rows}")
        windows = -(-n // rows)
        if windows > MAX_WINDOWS or chunks > MAX_WINDOW_CHUNKS:
            raise ValueError(f"fused_rerank: {windows} windows of {rows} rows and {chunks} "
                             f"chunks exceed {MAX_WINDOWS} and {MAX_WINDOW_CHUNKS}")
        if group > 1:
            if rows > GROUP_ROWS_MAX:
                raise ValueError(f"fused_rerank: grouped windows of {rows} rows exceed "
                                 f"{GROUP_ROWS_MAX}")
            smem, limit = group_smem_bytes(m, k, group, rows, chunks), WINDOW_SMEM_LIMIT
        else:
            smem, limit = window_smem_bytes(m, k), SMEM_LIMIT
        if smem > limit:
            raise ValueError(f"fused_rerank windowed kernel: k={k}, m={m}, group={group} need "
                             f"{smem} B of shared memory (> {limit})")
        return WindowPlan(rows.bit_length() - 1, windows, chunks,
                          window_workspace_bytes(q, k, windows, chunks), group)
    if group > 1:
        # grouped windows hold GROUP_ROWS_MAX rows, the best of 512 to 4,096
        # at 1,024 x 960 over 1 M rows (PERF.md section 6); plan_group
        # decides whether the path pays
        windows = -(-n // GROUP_ROWS_MAX)
        nbytes = window_workspace_bytes(q, k, windows, chunks)
        if (windows < 2 or windows > MAX_WINDOWS or chunks > MAX_WINDOW_CHUNKS
                or nbytes > WINDOW_WORKSPACE_LIMIT
                or group_smem_bytes(m, k, group, GROUP_ROWS_MAX, chunks) > WINDOW_SMEM_LIMIT):
            return None
        return WindowPlan(GROUP_ROWS_MAX.bit_length() - 1, windows, chunks, nbytes, group)
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
# windowed: dataset, queries, ids, work, stats, dout, iout, q, n, m, ctot,
# k, vec, shift, windows, group, grid, stream
_build.declare("fused_rerank", {
    **{f"fused_rerank_{s}": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
       for s in _ENTRY.values()},
    **{f"fused_rerank_window_{s}": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
       + [ctypes.c_void_p] for s in _ENTRY.values()},
    **{f"fused_rerank_{w}resident_{s}": [ctypes.c_int] * 3
       for s in _ENTRY.values() for w in ("", "window_")},
    "fused_rerank_group_resident_i32": [ctypes.c_int] * 3,
    "fused_rerank_l2_bytes": [], "fused_rerank_smem_optin": []})
_RESIDENT = {}  # (entry, device, ...) -> blocks resident at once, or L2 bytes
STATS_WORDS = 6  # the windowed launch's stats words (csrc/fused_rerank.cu)


def _device_query(key, device: int, name: str, *args) -> int:
    got = _RESIDENT.get(key)
    if got is None:
        with torch.cuda.device(device):
            got = _build.entry("fused_rerank", name)(*args)
        if got <= 0:
            raise RuntimeError(f"fused_rerank: {name} failed with error {-got}")
        _RESIDENT[key] = got
    return got


def resident_blocks(device: int, dtype, m: int, k: int, vec: int, windowed: bool = False,
                    group_smem: int = 0) -> int:
    """Blocks of the kernel for (dtype, m, k, vec) that CUDA device ``device``
    keeps resident at once (the sliced kernel's, with ``windowed`` the
    windowed one's, with ``group_smem`` the grouped one's at that many bytes
    of shared memory, int32 rows only): SMs x blocks an SM, read from the
    device once."""
    if group_smem:
        entry = "fused_rerank_group_resident_i32"
        return _device_query((entry, device, dtype, m, vec, group_smem), device, entry, m, vec,
                             group_smem)
    entry = f"fused_rerank_{'window_' if windowed else ''}resident_{_ENTRY[dtype]}"
    return _device_query((entry, device, dtype, m, k, vec), device, entry, m, k, vec)


def l2_bytes(device: int) -> int:
    """The L2 cache of CUDA device ``device`` in bytes, read once."""
    return _device_query(("l2", device), device, "fused_rerank_l2_bytes")


def smem_optin(device: int) -> int:
    """Shared memory a grouped block of CUDA device ``device`` may take, in
    bytes: the device's opt-in less 1 KB, read once, at most
    ``WINDOW_SMEM_LIMIT``."""
    return min(WINDOW_SMEM_LIMIT,
               _device_query(("smem", device), device, "fused_rerank_smem_optin") - 1024)


def _vec(dataset) -> int:
    """1 where the kernel reads the rows as aligned 16-byte vectors."""
    return int(dataset.shape[1] % (16 // dataset.element_size()) == 0
               and dataset.data_ptr() % 16 == 0)


def plan_call(dataset, q: int, ctot: int, k: int, window_rows=None, group=None):
    """The windowed plan a call on CUDA ``dataset`` takes (None: the sliced
    path): ``plan_group``'s G and its windows, or at G = 1 where that cannot
    be cut; ``window_rows`` and ``group`` force them."""
    device = dataset.get_device()
    n, m = dataset.shape
    isz = dataset.element_size()
    if window_rows is not None:
        return plan_windows(q, n, m, isz, ctot, k, 0, 0, window_rows, group or 1)
    if group is not None and group > 1:   # grouped windows need no residency
        plan = plan_windows(q, n, m, isz, ctot, k, 0, 0, group=group)
        if plan is None:
            raise ValueError(f"fused_rerank: no windowed plan at a group of {group} for "
                             f"({q}, {ctot}) slots over {n} rows")
        return plan
    plan = plan_windows(q, n, m, isz, ctot, k, l2_bytes(device),
                        resident_blocks(device, dataset.dtype, m, k, _vec(dataset), windowed=True))
    if plan is None or group is not None:
        return plan
    g = plan_group(q, n, m, isz, ctot, k, smem_optin(device))
    return (plan_windows(q, n, m, isz, ctot, k, 0, 0, group=g) if g > 1 else None) or plan


def rerank_attrs(path: str, detail) -> dict:
    """``stage_rerank``'s attributes of the launch ``_build.take_path`` gave
    as ``(path, detail)``: the windows, and the windowed launch's ``group``,
    the rows it loaded (``row_loads``), the (query, row) pairs it computed
    (``pairs``) and the device time of its three phases (``partition_us``,
    ``items_us``, ``output_us``: block 0's clock); zeros off the windowed
    path.  A windowed launch's counters are read from the card, which waits
    for the launch: only a traced run asks."""
    if path != "windowed":
        return {"windows": 0, "group": 0, "row_loads": 0, "pairs": 0,
                "partition_us": 0.0, "items_us": 0.0, "output_us": 0.0}
    windows, group, stats = detail
    loads, pairs, t0, t1, t2, t3 = (int(v) for v in stats.tolist())
    return {"windows": windows, "group": group, "row_loads": loads, "pairs": pairs,
            "partition_us": (t1 - t0) / 1e3, "items_us": (t2 - t1) / 1e3,
            "output_us": (t3 - t2) / 1e3}


def fused_rerank_cuda(dataset, queries, ids, k: int, slices=None, window_rows=None, group=None):
    """Launch the CUDA kernel on CUDA tensors; raises on what it cannot take.

    ``plan_windows`` and ``plan_group`` pick the path; the windowed one
    reorders ``ids`` in place (see the module's note).  ``slices`` forces
    the sliced path at that many slices, ``window_rows`` the windowed one at
    windows of that many rows, ``group`` its items at that many queries
    (1: (query, window) items); the tests use them.  By default the plans
    pick for the card.
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
    plan = None if slices is not None else plan_call(dataset, q, ctot, k, window_rows, group)
    if plan is not None:
        work = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=ids.device)
        stats = torch.empty(STATS_WORDS, dtype=torch.int64, device=ids.device)
        if plan.group > 1:
            resident = resident_blocks(
                device, dataset.dtype, m, k, vec,
                group_smem=group_smem_bytes(m, k, plan.group, plan.rows, plan.chunks))
        else:
            resident = resident_blocks(device, dataset.dtype, m, k, vec, windowed=True)
        grid = min(resident, max(q * plan.chunks, plan.items(q)))
        fn = _build.entry("fused_rerank", f"fused_rerank_window_{_ENTRY[dataset.dtype]}")
        _build.launch("fused_rerank", fn, device, dataset.data_ptr(), queries.data_ptr(),
                      ids.data_ptr(), work.data_ptr(), stats.data_ptr(), dout.data_ptr(),
                      iout.data_ptr(), q, n, m, ctot, k, vec, plan.shift, plan.windows,
                      plan.group, grid)
        _build.count_path("fused_rerank", "windowed", (plan.windows, plan.group, stats))
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
