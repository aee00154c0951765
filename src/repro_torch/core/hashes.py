"""RW-LSH hashing and bucket-key mixing, torch counterpart of
``repro.core.hashes``.

h(s) = floor((f(s) + b) / W) with f the random-walk raw hash (paper Sect.
2.1, 3.1).  Bucket vectors are mixed into one 32-bit key per table.

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

from . import walks as walks_lib

__all__ = ["LshParams", "make_rw_params", "params_fingerprint", "raw_hash",
           "bucket_and_offsets", "mix_keys"]

MASK32 = 0xFFFFFFFF
_KEY_MUL = 2654435761  # Knuth multiplicative constant


@dataclasses.dataclass
class LshParams:
    """Parameters for L tables x M hash functions.

    family  : 'rw' (the Cauchy and Gaussian families are not ported yet)
    width   : bucket width W
    offsets : (L, M) float32, b ~ U[0, W)
    mix_a   : (L, M) int64 odd 32-bit multipliers for key mixing
    mix_c   : (L,)   int64 32-bit additive constants
    walks   : WalkTable with num_fns = L*M
    """

    family: str
    width: float
    offsets: torch.Tensor
    mix_a: torch.Tensor
    mix_c: torch.Tensor
    walks: Optional[walks_lib.WalkTable] = None

    @property
    def num_tables(self) -> int:
        return self.offsets.shape[0]

    @property
    def num_hashes(self) -> int:
        return self.offsets.shape[1]

    def to(self, device) -> "LshParams":
        return LshParams(self.family, self.width, self.offsets.to(device),
                         self.mix_a.to(device), self.mix_c.to(device),
                         None if self.walks is None else self.walks.to(device))


def make_rw_params(num_tables: int, num_hashes: int, dim: int, universe: int,
                   width: int, generator: Optional[torch.Generator] = None,
                   ) -> LshParams:
    """Random RW-LSH parameters drawn from ``generator`` (CPU)."""
    walks = walks_lib.make_walks(num_tables * num_hashes, dim, universe,
                                 generator)
    offsets = torch.rand((num_tables, num_hashes), generator=generator,
                         dtype=torch.float32) * width
    imax = np.iinfo(np.int32).max
    mix_a = torch.randint(0, imax, (num_tables, num_hashes),
                          generator=generator, dtype=torch.int64) * 2 + 1
    mix_c = torch.randint(0, imax, (num_tables,), generator=generator,
                          dtype=torch.int64)
    return LshParams("rw", float(width), offsets, mix_a, mix_c, walks=walks)


def params_fingerprint(params: LshParams) -> int:
    """Content hash of a parameter set; segments of one index must share it.

    Hashes the leaves in the JAX package's order and dtypes (mixers as
    uint32), so both packages give one fingerprint for one parameter set.
    """
    h = hashlib.sha1()
    h.update(f"{params.family}:{params.width}".encode())
    leaves = [params.offsets.cpu().numpy(),
              params.mix_a.cpu().numpy().astype(np.uint32),
              params.mix_c.cpu().numpy().astype(np.uint32)]
    if params.walks is not None:
        leaves += [params.walks.pairs.cpu().numpy(),
                   params.walks.prefix.cpu().numpy()]
    for arr in leaves:
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return int.from_bytes(h.digest()[:8], "big")


def raw_hash(params: LshParams, points: torch.Tensor,
             impl: str = "gather") -> torch.Tensor:
    """Raw hash values f(s): points (n, m) int32 even -> (n, L, M) float32."""
    if params.family != "rw":
        raise NotImplementedError(
            f"family {params.family!r} is not ported yet (only 'rw')")
    if impl != "gather":
        raise NotImplementedError(
            f"hash_impl {impl!r} is not ported yet (only 'gather')")
    f = walks_lib.eval_prefix(params.walks, points)                 # (n, L*M)
    return f.reshape(points.shape[0], params.num_tables,
                     params.num_hashes).to(torch.float32)


def bucket_and_offsets(params: LshParams, f: torch.Tensor):
    """Quantize raw hashes (..., L, M) -> (bucket int32, x_neg float32).

    float32 throughout and in the JAX package's operation order (add,
    true division, floor, subtract, multiply), so buckets and offsets agree
    bit for bit.
    """
    shifted = (f + params.offsets) / params.width
    bucket = torch.floor(shifted)
    x_neg = (shifted - bucket) * params.width
    return bucket.to(torch.int32), x_neg


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
