"""Two-way sorted top-k merge: CUDA kernel (``csrc/topk_merge.cu``) and its
plain-torch version.

Replaces ``topk_merge_pallas`` (``src/repro/kernels/topk_merge.py:122``).
Both versions run the TPU kernel's bitonic network: pad k to a power of two
with ``(INT32_MAX//2 or inf, -1)``, keep the lex-(dist, id) min of ``a[j]``
and the reversed partner ``b[kp-1-j]``, then log2(kp) clean-up stages.  On
lex-ascending inputs that is the k lex-smallest of the union; on any input it
is the TPU kernel's result, bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["topk_merge_plain", "topk_merge_cuda", "MAX_K"]

MAX_K = 1024  # above kp = 32 a block keeps 4 rows of kp (dist, id) pairs in shared memory
_BIG = np.iinfo(np.int32).max // 2


def _pad_value(dtype: torch.dtype):
    if dtype == torch.int32:
        return _BIG
    if dtype == torch.float32:
        return float("inf")
    raise TypeError(f"topk_merge: dists must be int32 or float32, got {dtype}")


def _lex_gt(d1, i1, d2, i2):
    return (d1 > d2) | ((d1 == d2) & (i1 > i2))


def topk_merge_plain(da, ia, db, ib):
    """Merge two (Q, k) lists with the bitonic network, in torch ops."""
    q, k = da.shape
    kp = 1 << (k - 1).bit_length()
    pad = _pad_value(da.dtype)
    if kp != k:
        da = torch.nn.functional.pad(da, (0, kp - k), value=pad)
        db = torch.nn.functional.pad(db, (0, kp - k), value=pad)
        ia = torch.nn.functional.pad(ia, (0, kp - k), value=-1)
        ib = torch.nn.functional.pad(ib, (0, kp - k), value=-1)
    dbr, ibr = db.flip(-1), ib.flip(-1)
    take_a = ~_lex_gt(da, ia, dbr, ibr)
    d = torch.where(take_a, da, dbr)
    i = torch.where(take_a, ia, ibr)
    s = kp // 2
    while s >= 1:
        dr = d.reshape(q, kp // (2 * s), 2, s)
        ir = i.reshape(q, kp // (2 * s), 2, s)
        lo_d, hi_d, lo_i, hi_i = dr[:, :, 0], dr[:, :, 1], ir[:, :, 0], ir[:, :, 1]
        swap = _lex_gt(lo_d, lo_i, hi_d, hi_i)
        d = torch.stack([torch.where(swap, hi_d, lo_d),
                         torch.where(swap, lo_d, hi_d)], dim=2).reshape(q, kp)
        i = torch.stack([torch.where(swap, hi_i, lo_i),
                         torch.where(swap, lo_i, hi_i)], dim=2).reshape(q, kp)
        s //= 2
    return d[:, :k].contiguous(), i[:, :k].contiguous()


_ENTRY = {torch.int32: "topk_merge_i32", torch.float32: "topk_merge_f32"}
# da, ia, db, ib, dout, iout, q, k, stream
SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_build.declare("topk_merge", {name: SIGNATURE for name in _ENTRY.values()})


def topk_merge_cuda(da, ia, db, ib):
    """Launch the CUDA kernel on CUDA tensors; raises on what it cannot take.

    The host path is kept lean, since at the served k = 10 it is most of a
    call: no copy of contiguous inputs, no device switch when the inputs'
    device is current, and the C entry point bound once."""
    name = _ENTRY.get(da.dtype)
    if name is None:
        _pad_value(da.dtype)
    if db.dtype != da.dtype or ia.dtype != torch.int32 or ib.dtype != torch.int32:
        raise TypeError("topk_merge: ids must be int32 and dists of one dtype")
    shape = da.shape
    device = da.get_device()
    if ia.shape != shape or db.shape != shape or ib.shape != shape:
        raise ValueError("topk_merge: inputs must share one shape")
    if device < 0 or ia.get_device() != device or db.get_device() != device \
            or ib.get_device() != device:
        raise ValueError("topk_merge: inputs must lie on one CUDA device")
    q, k = shape
    if k > MAX_K:
        raise ValueError(f"topk_merge kernel takes k <= {MAX_K}, got {k}")
    if not (da.is_contiguous() and ia.is_contiguous() and db.is_contiguous()
            and ib.is_contiguous()):
        da, ia, db, ib = (t.contiguous() for t in (da, ia, db, ib))
    dout, iout = torch.empty_like(da), torch.empty_like(ia)
    if q == 0 or k == 0:
        return dout, iout
    _build.launch("topk_merge", _build.entry("topk_merge", name), device,
                  da.data_ptr(), ia.data_ptr(), db.data_ptr(), ib.data_ptr(),
                  dout.data_ptr(), iout.data_ptr(), q, k)
    return dout, iout
