"""Random-walk raw hash: CUDA kernel (``csrc/rw_hash.cu``) and its
plain-torch version.

Replaces ``rw_hash_pallas`` (``src/repro/kernels/rw_hash.py:55``).
Contract (both versions, and the JAX package's ``ref.rw_hash``):

    f[n, k] = sum_{i, u} 1{u < points[n, i] >> 1} * pairs[k, i, u]

pairs (F, m, U2) int8, points (n, m) int32 -> (n, F) int32, for every int32
coordinate: ``>>`` is arithmetic, so the code is all zeros for a negative
coordinate and saturates at U2 above the universe.  The plain version is
the float32 thermometer product.  On the card one call launches two
kernels: the table kernel writes the prefix sums of the steps once, as an
(m, U2+1, Fp) int32 workspace (``rw_prefix_table_plain`` is its plain
version), and the hash kernel adds them up at ``clamp(points >> 1, 0, U2)``
in tiles of 512 rows x 32 functions, which is the same sum.  Any U2 is
taken: where a dimension's table slice outgrows shared memory, both kernels
pass over it in windows (``plan_rw_windows``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rw_hash_plain", "rw_hash_cuda", "rw_prefix_table_plain", "rw_prefix_table_cuda",
           "plan_rw_hash", "plan_rw_windows", "padded_fns", "max_u2", "resident_blocks"]

PLAIN_CHUNK_BYTES = 1 << 30  # bound on one row chunk's float32 code
ROW_TILE = 512  # rows a hash block takes
FN_TILE = 32    # hash functions a block takes, one a lane


def _check_shapes(pairs: torch.Tensor, points: torch.Tensor) -> None:
    if pairs.dim() != 3 or points.dim() != 2 or points.shape[1] != pairs.shape[1]:
        raise ValueError(f"rw_hash: pairs (F, m, U2) and points (n, m) expected, got "
                         f"{tuple(pairs.shape)} and {tuple(points.shape)}")


def rw_hash_plain(pairs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """One float32 product of the (rows, m*U2) 0/1 code with the (m*U2, F)
    steps, then round, a chunk of rows at a time.

    float32 is exact: with steps in {-2, 0, 2} every partial sum is an
    integer of magnitude at most 2*m*U2 (65,280 at m=128, U2=255), below
    2^24, and the operands (0/1 and {-2, 0, 2}) are exact even in TF32 or
    bf16.  The code is built per chunk of rows, so it stays under
    ``PLAIN_CHUNK_BYTES`` (the whole code at 1 M x 128 x 255 would be
    ~130 GB); rows are independent, so chunking changes no bit.
    """
    _check_shapes(pairs, points)
    f, m, u2 = pairs.shape
    n = points.shape[0]
    mat = pairs.to(torch.float32).reshape(f, m * u2).t()
    ramp = torch.arange(u2, dtype=torch.int32, device=points.device)
    t = points.to(torch.int32) >> 1
    rows = max(1, PLAIN_CHUNK_BYTES // max(1, 4 * m * u2))
    out = torch.empty((n, f), dtype=torch.int32, device=points.device)
    for lo in range(0, n, rows):
        code = (ramp < t[lo:lo + rows, :, None]).to(torch.float32)
        out[lo:lo + rows] = torch.round(code.reshape(code.shape[0], m * u2) @ mat).to(torch.int32)
    return out


def padded_fns(f: int) -> int:
    """F rounded up to the kernels' 32-function tile: the table's last axis."""
    return -(-f // FN_TILE) * FN_TILE


def rw_prefix_table_plain(pairs: torch.Tensor, fp: int) -> torch.Tensor:
    """The table kernel's plain version: pairs (F, m, U2) int8 -> (m, U2+1,
    fp) int32 with ``tab[i, u, f] = sum_{v < u} pairs[f, i, v]`` for f < F,
    and zero in row u = 0 and in columns F..fp-1.  int32 is exact: a prefix
    of U2 int8 steps is at most 128 * U2 in magnitude."""
    f, m, u2 = pairs.shape
    tab = torch.zeros((m, u2 + 1, fp), dtype=torch.int32, device=pairs.device)
    tab[:, 1:, :f] = torch.cumsum(pairs, dim=2, dtype=torch.int32).permute(1, 2, 0)
    return tab


def plan_rw_hash(n: int, f: int, m: int, resident: int, slices=None) -> int:
    """The number of slices S the m dimensions are split into (blockIdx.z).

    Unless ``slices`` is given, the grid's row tiles x function tiles x S
    blocks fill the ``resident`` blocks the card holds at once.  A slice
    takes ceil(m / S) dimensions, so S is cut to the count that leaves no
    slice empty.  Always 1 <= S <= m.
    """
    if slices is None:
        blocks = -(-n // ROW_TILE) * -(-f // FN_TILE)
        slices = -(-resident // blocks) if blocks < resident else 1
    slices = max(1, min(int(slices), m))
    return -(-m // -(-m // slices))


def plan_rw_windows(u2: int, limit: int):
    """``(span, n_win)``: the passes both kernels make over one dimension's
    table slice, given the ``limit`` one pass holds (``max_u2()`` on the
    card); the launch takes both.  span = min(U2, limit): the table kernel
    scans the U2 steps in chunks of span steps, and the hash kernel copies
    the U2 + 1 table rows in n_win windows, window w holding rows
    [w (span + 1), min((w + 1)(span + 1), U2 + 1)).  U2 <= limit gives one
    chunk and one window."""
    span = max(1, min(int(u2), int(limit)))
    return span, -(-(int(u2) + 1) // (span + 1))


# pairs, points, tab, out, n, F, m, U2, span, n_win, slices, stream
_build.declare("rw_hash", {
    "rw_hash": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "rw_prefix_table": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "rw_hash_setup": [],
    "rw_hash_resident": [ctypes.c_int]})
_LIMITS = {}    # device -> the largest span one pass takes there
_RESIDENT = {}  # (device, span) -> hash blocks resident at once


def _limit(device: int) -> int:
    """The largest span of CUDA device ``device`` (``plan_rw_windows``); the
    first call on a device also sets the kernels' shared-memory attribute
    there."""
    got = _LIMITS.get(device)
    if got is None:
        with torch.cuda.device(device):
            got = _build.entry("rw_hash", "rw_hash_setup")()
        if got <= 0:
            raise RuntimeError(f"rw_hash: device set-up failed with error {-got}")
        _LIMITS[device] = got
    return got


def max_u2() -> int:
    """The largest U2 the kernels take in one pass on the current CUDA
    device: a hash block holds the (U2+1) x 32 table slice and 512 x 16
    offsets in shared memory.  A larger U2 takes several windows."""
    return _limit(torch.cuda.current_device())


def resident_blocks(device: int, u2: int) -> int:
    """Hash blocks CUDA device ``device`` keeps resident at once at this U2
    (its window's span): SMs x blocks an SM, read from the device once."""
    span = plan_rw_windows(u2, _limit(device))[0]
    got = _RESIDENT.get((device, span))
    if got is None:
        with torch.cuda.device(device):
            got = _build.entry("rw_hash", "rw_hash_resident")(span)
        if got <= 0:
            raise RuntimeError(f"rw_hash: occupancy query failed with error {-got}")
        _RESIDENT[(device, span)] = got
    return got


def _check_cuda(pairs: torch.Tensor, points=None) -> int:
    """The inputs' CUDA device, their types and layout checked."""
    if pairs.dtype != torch.int8 or (points is not None and points.dtype != torch.int32):
        raise TypeError(f"rw_hash: pairs int8 and points int32 expected, got "
                        f"{pairs.dtype} and {None if points is None else points.dtype}")
    device = pairs.get_device()
    if device < 0 or (points is not None and points.get_device() != device):
        raise ValueError("rw_hash: pairs and points must lie on one CUDA device")
    if not (pairs.is_contiguous() and (points is None or points.is_contiguous())):
        raise ValueError("rw_hash: pairs and points must be contiguous")
    return device


def rw_prefix_table_cuda(pairs: torch.Tensor) -> torch.Tensor:
    """Launch the table kernel alone: ``rw_prefix_table_plain(pairs,
    padded_fns(F))`` on the card.  ``rw_hash_cuda`` launches it itself."""
    if pairs.dim() != 3:
        raise ValueError(f"rw_hash: pairs (F, m, U2) expected, got {tuple(pairs.shape)}")
    device = _check_cuda(pairs)
    f, m, u2 = pairs.shape
    tab = torch.empty((m, u2 + 1, padded_fns(f)), dtype=torch.int32, device=pairs.device)
    if tab.numel():
        span = plan_rw_windows(u2, _limit(device))[0]
        _build.launch("rw_prefix_table", _build.entry("rw_hash", "rw_prefix_table"), device,
                      pairs.data_ptr(), tab.data_ptr(), f, m, u2, span)
    return tab


def rw_hash_cuda(pairs: torch.Tensor, points: torch.Tensor, slices=None) -> torch.Tensor:
    """Launch the table kernel and the hash kernel on CUDA tensors, in one
    call; raises on what they cannot take.

    pairs must be contiguous int8 and points contiguous int32, on one card;
    any U2 (above ``max_u2()`` in several windows).  ``slices`` fixes the
    split of the dimensions (the tests use it); by default ``plan_rw_hash``
    picks it.
    """
    _check_shapes(pairs, points)
    device = _check_cuda(pairs, points)
    f, m, u2 = pairs.shape
    n = points.shape[0]
    if n == 0 or f == 0 or m == 0 or u2 == 0:
        return torch.zeros((n, f), dtype=torch.int32, device=points.device)
    span, n_win = plan_rw_windows(u2, _limit(device))
    n_slices = plan_rw_hash(n, f, m, resident_blocks(device, u2) if slices is None else 0,
                            slices)
    tab = torch.empty((m, u2 + 1, padded_fns(f)), dtype=torch.int32, device=points.device)
    out = torch.empty((n, f), dtype=torch.int32, device=points.device)
    _build.launch("rw_hash", _build.entry("rw_hash", "rw_hash"), device, pairs.data_ptr(),
                  points.data_ptr(), tab.data_ptr(), out.data_ptr(), n, f, m, u2, span,
                  n_win, n_slices)
    _build.count("rw_prefix_table")             # the same call launched the table kernel
    return out
