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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["l1_distance_plain", "l1_distance_rows_plain", "l1_distance_cuda",
           "l1_distance_rows_cuda"]

PLAIN_CHUNK_ELEMS = 1 << 26  # bound on one chunk's (Q, chunk, m) difference
_MAX_GRID_Y = 65535          # the pairwise kernels' query tiles of 64
_ENTRY = {torch.int32: "i32", torch.int16: "i16", torch.float32: "f32",
          torch.bfloat16: "bf16"}


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


# queries, points or rows, out, then (q, n, m) or (q, c, m), stream
_build.declare("l1_distance", {
    f"l1_{kind}_{suffix}": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for kind in ("pairwise", "rows") for suffix in _ENTRY.values()})


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
    if q * -(-c // 32) >= 2 ** 31:
        raise ValueError(f"l1_distance_rows kernel: Q * C = {q * c} is too large")
    acc = _acc_dtype(queries.dtype)
    if q == 0 or c == 0 or m == 0:
        return torch.zeros((q, c), dtype=acc, device=queries.device)
    out = torch.empty((q, c), dtype=acc, device=queries.device)
    _build.launch("l1_distance_rows", _fn("rows", queries.dtype), queries.get_device(),
                  queries.data_ptr(), rows.data_ptr(), out.data_ptr(), q, c, m)
    return out
