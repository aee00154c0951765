"""Fused rerank: CUDA kernel (``csrc/fused_rerank.cu``) and its plain-torch
version.

Replaces ``fused_rerank_pallas`` (``src/repro/kernels/fused_rerank.py:140``).
Contract (both versions, and the JAX package's): the k lex-(dist,
id)-smallest pairs over the *unique* valid candidate ids, ascending; ids < 0
or >= n are invalid and ids need not be deduplicated; empty slots carry
``(BIG_DIST, -1)``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["BIG_DIST", "fused_rerank_plain", "fused_rerank_cuda", "empty_result"]

BIG_DIST = np.iinfo(np.int32).max // 2
_INT64_MAX = np.iinfo(np.int64).max
SMEM_LIMIT = 48 * 1024  # bytes of shared memory the kernel may ask for


def empty_result(q: int, k: int, device):
    return (torch.full((q, k), BIG_DIST, dtype=torch.int32, device=device),
            torch.full((q, k), -1, dtype=torch.int32, device=device))


def fused_rerank_plain(dataset, queries, ids, k: int, chunk: int = 512):
    """Plain-torch rerank: id-sort dedup, chunked distances, one key sort.

    Chunked over candidates like ``fused_rerank_xla``, so the gathered
    (Q, chunk, m) rows stay small at any candidate width.  Selection sorts
    packed int64 keys ``(dist << 32) | id``, whose order is exactly the
    lex-(dist, id) order.
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
    keys = torch.empty((q, ctot), dtype=torch.int64, device=ids.device)
    for lo in range(0, ctot, chunk):
        step = sid[:, lo:lo + chunk]
        rows = dataset[step.clamp(0, n - 1)].to(torch.int32)        # (Q, c, m)
        d = (rows - qs[:, None, :]).abs().sum(dim=-1, dtype=torch.int32)
        keys[:, lo:lo + chunk] = torch.where(
            step < n, (d.to(torch.int64) << 32) | step, _INT64_MAX)
    keys = torch.sort(keys, dim=-1).values[:, :k]
    if keys.shape[1] < k:
        fill = torch.full((q, k - keys.shape[1]), _INT64_MAX, dtype=torch.int64,
                          device=keys.device)
        keys = torch.cat([keys, fill], dim=-1)
    bad = keys == _INT64_MAX
    d = torch.where(bad, BIG_DIST, keys >> 32).to(torch.int32)
    i = torch.where(bad, -1, keys & 0xFFFFFFFF).to(torch.int32)
    return d, i


_ENTRY = {torch.int32: "fused_rerank_i32", torch.int16: "fused_rerank_i16"}


def _fn(dtype):
    fn = getattr(_build.library("fused_rerank"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_rerank_cuda(dataset, queries, ids, k: int):
    """Launch the CUDA kernel on CUDA tensors; raises on what it cannot take."""
    if dataset.dtype not in _ENTRY:
        raise TypeError(f"fused_rerank: dataset must be int32 or int16, got {dataset.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"fused_rerank: ids must be int32, got {ids.dtype}")
    n, m = dataset.shape
    q, ctot = ids.shape
    if queries.shape != (q, m):
        raise ValueError(f"fused_rerank: queries {tuple(queries.shape)} != ({q}, {m})")
    if not (dataset.device == queries.device == ids.device):
        raise ValueError("fused_rerank: inputs must share one device")
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
    dout = torch.empty((q, k), dtype=torch.int32, device=ids.device)
    iout = torch.empty((q, k), dtype=torch.int32, device=ids.device)
    with torch.cuda.device(ids.device):
        _build.launch("fused_rerank", _fn(dataset.dtype), _build.ptr(dataset),
                      _build.ptr(queries), _build.ptr(ids), _build.ptr(dout),
                      _build.ptr(iout), q, n, m, ctot, k, vec,
                      _build.stream_of(ids))
    return dout, iout
