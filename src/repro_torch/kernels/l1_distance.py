"""Pairwise and per-query-row L1 distances: CUDA kernels
(``csrc/l1_distance.cu``) and their plain-torch versions.

Replace ``l1_distance_pallas`` and ``l1_distance_rows_pallas``
(``src/repro/kernels/l1_distance.py:59``, ``:103``).  Contract (both
versions, and the JAX package's ``ref.l1_distance``/``ref.l1_distance_rows``):
integer inputs (int32, int16) accumulate in int32, float32 and bfloat16
inputs in float32; the accumulation type of the queries decides.

The pairwise kernel runs each 32-coordinate stage of a block in one of two
loops, chosen from the values the block staged: a float32 loop, exact on
integers while every sum stays below 2^24, and an int32 loop for wider
values (see ``csrc/l1_distance.cu``).

The per-row kernel streams each query's rows as 16-byte vectors when a row
is a whole number of them and both pointers are 16-byte aligned, else with
scalar loads; ``plan_rows`` makes that choice and the grid.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

__all__ = ["l1_distance_plain", "l1_distance_rows_plain", "l1_distance_cuda",
           "l1_distance_rows_cuda", "plan_rows", "RowsPlan"]

PLAIN_CHUNK_ELEMS = 1 << 26  # bound on one chunk's (Q, chunk, m) difference
_MAX_GRID_Y = 65535          # the pairwise kernels' query tiles of 64
_ENTRY = {torch.int32: "i32", torch.int16: "i16", torch.float32: "f32",
          torch.bfloat16: "bf16"}
# the per-row kernels (csrc/l1_distance.cu: kRowWarps, kRowLoads,
# kRowMaxSlots, kRowQueryMax): warps a block, 16-byte loads a lane a pass,
# 32-vector slots a row a chunk, query bytes staged in shared memory; and the
# fewest rows and passes a block takes (the vector path loads a warp's next
# pass while it sums this one)
_ROW_WARPS, _ROW_LOADS, _ROW_MAX_SLOTS, _ROW_QUERY_MAX = 8, 4, 8, 32 * 1024
_ROW_MIN_TILE, _ROW_MIN_PASSES = 64, 2
_MAX_GRID_X = 2 ** 31 - 1


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else torch.int32


def _chunk(q: int, m: int) -> int:
    return max(1, PLAIN_CHUNK_ELEMS // max(1, q * m))


def l1_distance_plain(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(Q, m), (N, m) -> (Q, N), a chunk of points at a time."""
    acc = _acc_dtype(queries.dtype)
    q, m = queries.shape
    n = points.shape[0]
    qs = queries.to(acc)[:, None, :]
    out = torch.empty((q, n), dtype=acc, device=queries.device)
    step = _chunk(q, m)
    for lo in range(0, n, step):
        diff = qs - points[lo:lo + step].to(acc)[None, :, :]
        out[:, lo:lo + step] = diff.abs().sum(dim=-1, dtype=acc)
    return out


def l1_distance_rows_plain(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(Q, m), (Q, C, m) -> (Q, C), a chunk of candidates at a time."""
    acc = _acc_dtype(queries.dtype)
    q, c, m = rows.shape
    qs = queries.to(acc)[:, None, :]
    out = torch.empty((q, c), dtype=acc, device=queries.device)
    step = _chunk(q, m)
    for lo in range(0, c, step):
        diff = rows[:, lo:lo + step].to(acc) - qs
        out[:, lo:lo + step] = diff.abs().sum(dim=-1, dtype=acc)
    return out


# queries, points or rows, out, then (q, n, m) or (q, c, m) and the rows'
# plan (slots, seg, tile, stage), stream
_build.declare("l1_distance", {
    f"l1_{kind}_{suffix}": [ctypes.c_void_p] * 3 + [ctypes.c_int] * ints + [ctypes.c_void_p]
    for kind, ints in (("pairwise", 3), ("rows", 7)) for suffix in _ENTRY.values()})


class RowsPlan(NamedTuple):
    """How the per-row kernels take (Q, C, m): ``slots`` 0 is the scalar
    path; ``slots`` K > 0 the 16-byte vector path, K slots of 32 vectors a
    row a chunk, ``seg`` lanes a row when K is 1 (a power of two <= 32, so a
    warp-wide load covers 32 / seg whole rows), else 32.  A block takes
    ``tile`` rows of one query (block b: query b // tiles, rows from
    (b % tiles) * tile); ``stage`` 1 puts the query row in shared memory."""
    slots: int
    seg: int
    tile: int
    tiles: int
    blocks: int
    stage: int


def plan_rows(dtype: torch.dtype, m: int, c: int, q: int, rows_ptr: int,
              queries_ptr: int) -> RowsPlan:
    """The path and grid of ``l1_distance_rows_cuda`` for (Q, m), (Q, C, m)
    of ``dtype`` at the given addresses (m, C, Q > 0)."""
    row_bytes = m * dtype.itemsize
    if row_bytes % 16 == 0 and rows_ptr % 16 == 0 and queries_ptr % 16 == 0:
        nv = row_bytes // 16                        # vectors a row
        if nv <= 32:
            slots, seg = 1, 1 << (nv - 1).bit_length()
        else:
            slots, seg = min(_ROW_MAX_SLOTS, 1 << (-(-nv // 32) - 1).bit_length()), 32
        group = 32 // seg * max(1, _ROW_LOADS // slots)  # rows a warp takes a pass
    else:
        slots, seg, group = 0, 32, 1
    pass_rows = _ROW_WARPS * group
    tile = pass_rows * max(_ROW_MIN_PASSES, _ROW_MIN_TILE // pass_rows)
    tiles = -(-c // tile)
    # the vector path keeps a row of one chunk (<= 256 vectors) of the query
    # in registers; longer rows and the scalar path read it from shared memory
    staged = row_bytes <= _ROW_QUERY_MAX and (not slots or row_bytes > 16 * 32 * _ROW_MAX_SLOTS)
    return RowsPlan(slots, seg, tile, tiles, q * tiles, int(staged))


def _fn(kind: str, dtype: torch.dtype):
    return _build.entry("l1_distance", f"l1_{kind}_{_ENTRY[dtype]}")


def _check(queries: torch.Tensor, other: torch.Tensor, what: str) -> None:
    if queries.dtype not in _ENTRY or other.dtype != queries.dtype:
        raise TypeError(f"{what}: inputs must share one of int32, int16, float32, "
                        f"bfloat16, got {queries.dtype} and {other.dtype}")
    if queries.device.type != "cuda" or other.device != queries.device:
        raise ValueError(f"{what}: inputs must lie on one CUDA device")
    if not (queries.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")


def _pairwise_out(queries: torch.Tensor, points: torch.Tensor):
    """Check the pairwise inputs; return the output and whether a kernel must
    fill it (an empty output comes back as zeros)."""
    _check(queries, points, "l1_distance")
    if queries.dim() != 2 or points.dim() != 2 or points.shape[1] != queries.shape[1]:
        raise ValueError(f"l1_distance: (Q, m) and (N, m) expected, got "
                         f"{tuple(queries.shape)} and {tuple(points.shape)}")
    q, m = queries.shape
    n = points.shape[0]
    if -(-q // 64) > _MAX_GRID_Y:
        raise ValueError(f"l1_distance kernel takes Q <= {64 * _MAX_GRID_Y}, got {q}")
    acc = _acc_dtype(queries.dtype)
    if q == 0 or n == 0 or m == 0:
        return torch.zeros((q, n), dtype=acc, device=queries.device), False
    return torch.empty((q, n), dtype=acc, device=queries.device), True


def l1_distance_cuda(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Launch the pairwise kernel on CUDA tensors; raises on what it cannot take."""
    out, work = _pairwise_out(queries, points)
    if work:
        _build.launch("l1_distance", _fn("pairwise", queries.dtype), queries.get_device(),
                      queries.data_ptr(), points.data_ptr(), out.data_ptr(), *out.shape,
                      queries.shape[1])
    return out


def l1_distance_rows_cuda(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Launch the per-row kernel on CUDA tensors; raises on what it cannot take."""
    _check(queries, rows, "l1_distance_rows")
    if (queries.dim() != 2 or rows.dim() != 3 or rows.shape[0] != queries.shape[0]
            or rows.shape[2] != queries.shape[1]):
        raise ValueError(f"l1_distance_rows: (Q, m) and (Q, C, m) expected, got "
                         f"{tuple(queries.shape)} and {tuple(rows.shape)}")
    q, c, m = rows.shape
    acc = _acc_dtype(queries.dtype)
    if q == 0 or c == 0 or m == 0:
        return torch.zeros((q, c), dtype=acc, device=queries.device)
    plan = plan_rows(queries.dtype, m, c, q, rows.data_ptr(), queries.data_ptr())
    if plan.blocks > _MAX_GRID_X:
        raise ValueError(f"l1_distance_rows kernel: Q * C = {q * c} is too large")
    out = torch.empty((q, c), dtype=acc, device=queries.device)
    _build.launch("l1_distance_rows", _fn("rows", queries.dtype), queries.get_device(),
                  queries.data_ptr(), rows.data_ptr(), out.data_ptr(), q, c, m,
                  plan.slots, plan.seg, plan.tile, plan.stage)
    return out
