"""Random-walk raw hash: CUDA kernel (``csrc/rw_hash.cu``) and its
plain-torch version.

Replaces ``rw_hash_pallas`` (``src/repro/kernels/rw_hash.py:55``).
Contract (both versions, and the JAX package's ``ref.rw_hash``):

    f[n, k] = sum_{i, u} 1{u < points[n, i] >> 1} * pairs[k, i, u]

pairs (F, m, U2) int8, points (n, m) int32 -> (n, F) int32, for every int32
coordinate: ``>>`` is arithmetic, so the code is all zeros for a negative
coordinate and saturates at U2 above the universe.  The plain version is
the float32 thermometer product; the kernel sums prefix sums of the steps
at ``clamp(points >> 1, 0, U2)`` in int32, which is the same sum.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rw_hash_plain", "rw_hash_cuda"]

PLAIN_CHUNK_BYTES = 1 << 30  # bound on one row chunk's float32 code


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


# pairs, points, out, n, F, m, U2, stream
_build.declare("rw_hash", {
    "rw_hash": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "rw_hash_max_u2": []})


def max_u2() -> int:
    """The largest U2 the kernel takes on the current device: its block
    holds the (U2+1) x 32 prefix table in shared memory."""
    return _build.entry("rw_hash", "rw_hash_max_u2")()


def rw_hash_cuda(pairs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; raises on what it cannot take.

    pairs must be contiguous int8 and points contiguous int32, on one card,
    and U2 at most ``max_u2()``.
    """
    _check_shapes(pairs, points)
    if pairs.dtype != torch.int8 or points.dtype != torch.int32:
        raise TypeError(f"rw_hash: pairs int8 and points int32 expected, got "
                        f"{pairs.dtype} and {points.dtype}")
    if pairs.device.type != "cuda" or points.device != pairs.device:
        raise ValueError("rw_hash: pairs and points must lie on one CUDA device")
    if not (pairs.is_contiguous() and points.is_contiguous()):
        raise ValueError("rw_hash: pairs and points must be contiguous")
    f, m, u2 = pairs.shape
    n = points.shape[0]
    if n == 0 or f == 0 or m == 0 or u2 == 0:
        return torch.zeros((n, f), dtype=torch.int32, device=points.device)
    out = torch.empty((n, f), dtype=torch.int32, device=points.device)
    with torch.cuda.device(points.device):
        limit = max_u2()
        if u2 > limit:
            raise ValueError(f"rw_hash kernel takes U2 <= {limit} here, got {u2}")
        _build.launch("rw_hash", _build.entry("rw_hash", "rw_hash"), points.get_device(),
                      pairs.data_ptr(), points.data_ptr(), out.data_ptr(), n, f, m, u2)
    return out
