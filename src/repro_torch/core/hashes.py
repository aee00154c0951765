"""LSH families and bucket-key mixing, torch counterpart of
``repro.core.hashes``.

All three families share the bucket quantization h(s) = floor((f(s) + b) / W)
(paper Sect. 2.1) and differ in the raw hash f:

  * RW-LSH : f(s) = sum_i tau_i(s_i), tau_i precomputed random walks (Sect. 3.1);
  * CP-LSH : f(s) = <s, eta>, eta i.i.d. standard Cauchy;
  * GP-LSH : f(s) = <s, eta>, eta i.i.d. standard Gaussian.

Bucket vectors are mixed into one 32-bit key per table.

Keys are uint32 values carried in int64 tensors (``[0, 2^32)``): torch has no
uint32 add, shift or ``searchsorted`` on every device, and int64 sorts and
searches in the same order as uint32.  Every product and sum is masked back
to 32 bits, so the keys equal the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops

from . import walks as walks_lib

__all__ = ["LshParams", "make_rw_params", "make_cp_params", "make_gp_params",
           "params_fingerprint", "raw_hash", "project", "to_int32_saturating",
           "bucket_and_offsets", "mix_keys"]

MASK32 = 0xFFFFFFFF
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1
_KEY_MUL = 2654435761  # Knuth multiplicative constant


@dataclasses.dataclass
class LshParams:
    """Parameters for L tables x M hash functions.

    family  : 'rw' | 'cauchy' | 'gaussian'
    width   : bucket width W
    offsets : (L, M) float32, b ~ U[0, W)
    mix_a   : (L, M) int64 odd 32-bit multipliers for key mixing
    mix_c   : (L,)   int64 32-bit additive constants
    walks   : WalkTable with num_fns = L*M for 'rw', else None
    proj    : (L, M, m) float32 projection vectors for 'cauchy'/'gaussian'
    """

    family: str
    width: float
    offsets: torch.Tensor
    mix_a: torch.Tensor
    mix_c: torch.Tensor
    walks: Optional[walks_lib.WalkTable] = None
    proj: Optional[torch.Tensor] = None
    _ckpt_static = ("family", "width")     # not checkpoint leaves

    @property
    def num_tables(self) -> int:
        return self.offsets.shape[0]

    @property
    def num_hashes(self) -> int:
        return self.offsets.shape[1]

    def to(self, device) -> "LshParams":
        return LshParams(self.family, self.width, self.offsets.to(device),
                         self.mix_a.to(device), self.mix_c.to(device),
                         None if self.walks is None else self.walks.to(device),
                         None if self.proj is None else self.proj.to(device))


def _common(num_tables, num_hashes, width, generator):
    offsets = torch.rand((num_tables, num_hashes), generator=generator,
                         dtype=torch.float32) * width
    imax = np.iinfo(np.int32).max
    mix_a = torch.randint(0, imax, (num_tables, num_hashes),
                          generator=generator, dtype=torch.int64) * 2 + 1
    mix_c = torch.randint(0, imax, (num_tables,), generator=generator,
                          dtype=torch.int64)
    return offsets, mix_a, mix_c


def make_rw_params(num_tables: int, num_hashes: int, dim: int, universe: int,
                   width: int, generator: Optional[torch.Generator] = None,
                   ) -> LshParams:
    """Random RW-LSH parameters drawn from ``generator`` (CPU)."""
    walks = walks_lib.make_walks(num_tables * num_hashes, dim, universe,
                                 generator)
    offsets, mix_a, mix_c = _common(num_tables, num_hashes, width, generator)
    return LshParams("rw", float(width), offsets, mix_a, mix_c, walks=walks)


def _make_proj_params(family, num_tables, num_hashes, dim, width, generator):
    proj = torch.empty((num_tables, num_hashes, dim), dtype=torch.float32)
    if family == "cauchy":
        proj.cauchy_(generator=generator)     # heavy-tailed, median 0, scale 1
    else:
        proj.normal_(generator=generator)
    offsets, mix_a, mix_c = _common(num_tables, num_hashes, width, generator)
    return LshParams(family, float(width), offsets, mix_a, mix_c, proj=proj)


def make_cp_params(num_tables: int, num_hashes: int, dim: int, width,
                   generator: Optional[torch.Generator] = None) -> LshParams:
    """Random CP-LSH (Cauchy projection) parameters drawn from ``generator``."""
    return _make_proj_params("cauchy", num_tables, num_hashes, dim, width,
                             generator)


def make_gp_params(num_tables: int, num_hashes: int, dim: int, width,
                   generator: Optional[torch.Generator] = None) -> LshParams:
    """Random GP-LSH (Gaussian projection) parameters drawn from ``generator``."""
    return _make_proj_params("gaussian", num_tables, num_hashes, dim, width,
                             generator)


def params_fingerprint(params: LshParams) -> int:
    """Content hash of a parameter set; segments of one index must share it.

    Hashes the leaves in the JAX package's order and dtypes (offsets, mixers
    as uint32, walks, projections), so both packages give one fingerprint
    for one parameter set.
    """
    h = hashlib.sha1()
    h.update(f"{params.family}:{params.width}".encode())
    leaves = [params.offsets.cpu().numpy(),
              params.mix_a.cpu().numpy().astype(np.uint32),
              params.mix_c.cpu().numpy().astype(np.uint32)]
    if params.walks is not None:
        leaves += [params.walks.pairs.cpu().numpy(),
                   params.walks.prefix.cpu().numpy()]
    if params.proj is not None:
        leaves.append(params.proj.cpu().numpy())
    for arr in leaves:
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return int.from_bytes(h.digest()[:8], "big")


def project(points: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """points (n, m) times proj (F, m) -> (n, F) float32.

    Accumulated in float64 and rounded once: on the card no global TF32
    setting reaches it, and the result is the float32 nearest the exact
    product, whatever order a backend sums in (the JAX package's float32
    sum differs from it by that sum's own rounding).
    """
    return (points.to(torch.float64) @ proj.to(torch.float64).t()).to(torch.float32)


def raw_hash(params: LshParams, points: torch.Tensor,
             impl: str = "gather") -> torch.Tensor:
    """Raw hash values f(s): points (n, m) -> (n, L, M) float32.

    'rw' takes int32 even points; ``impl``: 'gather' reads the prefix table,
    'thermo' takes the plain thermometer product, 'pallas' the ``rw_hash``
    kernel (its plain version on the CPU).  All three give the same bits for
    coordinates in [0, U].  'cauchy' and 'gaussian' project the points
    (``project``; ``impl`` plays no part).
    """
    n, l, m = points.shape[0], params.num_tables, params.num_hashes
    if params.family in ("cauchy", "gaussian"):
        if params.proj is None:
            raise ValueError(f"family {params.family!r} needs a projection")
        f = project(points, params.proj.reshape(l * m, -1))
        return f.reshape(n, l, m)
    if params.family != "rw":
        raise ValueError(f"unknown family {params.family!r}")
    if impl == "gather":
        f = walks_lib.eval_prefix(params.walks, points)             # (n, L*M)
    elif impl == "thermo":
        f = walks_lib.eval_pairs_thermo(params.walks, points)
    elif impl == "pallas":
        f = kops.rw_hash(params.walks.pairs,
                         points.to(torch.int32).contiguous())
    else:
        raise ValueError(f"unknown rw impl {impl!r}")
    return f.reshape(n, l, m).to(torch.float32)


def to_int32_saturating(x: torch.Tensor) -> torch.Tensor:
    """Integral float32 -> int32 as XLA converts: values beyond the range
    saturate to INT32_MAX / INT32_MIN and NaN becomes 0, on every device
    (torch's own cast gives INT32_MIN for all of them on the CPU)."""
    high = x >= 2.0 ** 31                 # exact in float32, as is -2^31
    low = x < -2.0 ** 31
    inside = torch.where(high | low | torch.isnan(x), 0.0, x).to(torch.int32)
    return torch.where(high, _INT32_MAX, torch.where(low, _INT32_MIN, inside))


def bucket_and_offsets(params: LshParams, f: torch.Tensor):
    """Quantize raw hashes (..., L, M) -> (bucket int32, x_neg float32).

    float32 throughout and in the JAX package's operation order (add,
    true division, floor, subtract, multiply), so buckets and offsets agree
    bit for bit.  A projection family's bucket beyond int32 saturates as
    XLA's does (a heavy-tailed Cauchy projection can reach it); the RW raw
    hash is bounded by m * U and keeps the plain cast.
    """
    shifted = (f + params.offsets) / params.width
    bucket = torch.floor(shifted)
    x_neg = (shifted - bucket) * params.width
    if params.family == "rw":
        return bucket.to(torch.int32), x_neg
    return to_int32_saturating(bucket), x_neg


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x * c) mod 2^32 for x, c in [0, 2^32), without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix_keys(params: LshParams, bucket: torch.Tensor) -> torch.Tensor:
    """Mix an (..., L, M) bucket vector into (..., L) 32-bit keys (int64).

    key_l = c_l + sum_j a_{l,j} * h_j (mod 2^32), then a multiplicative
    finaliser — the JAX package's uint32 arithmetic, masked.
    """
    h = bucket.to(torch.int64) & MASK32
    key = (_mul32(h, params.mix_a).sum(dim=-1) + params.mix_c) & MASK32
    return _mul32(key, _KEY_MUL) ^ (key >> 15)
