"""Random walks for RW-LSH (paper Sect. 3.1), torch counterpart of
``repro.core.walks``.

Data coordinates are nonnegative even integers, so walks are stored in
paired-step form: pair_j = step_{2j-1} + step_{2j} in {-2, 0, +2} and
tau(2t) = sum_{j<=t} pair_j.  ``prefix`` holds tau(0), tau(2), ..., tau(U) per
(hash fn, dim); a raw hash is one gather per coordinate (``eval_prefix``) or
one product of the thermometer code of s // 2 with ``pairs``
(``eval_pairs_thermo``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.rw_hash import rw_hash_plain

__all__ = ["WalkTable", "make_walks", "prefix_from_pairs", "eval_prefix",
           "eval_pairs_thermo"]


@dataclasses.dataclass
class WalkTable:
    """pairs  : (F, m, U2)   int8  paired steps in {-2, 0, +2}
    prefix : (F, m, U2+1) int32 prefix sums tau(0), tau(2), ..., tau(U)"""

    pairs: torch.Tensor
    prefix: torch.Tensor
    _gather: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def num_fns(self) -> int:
        return self.prefix.shape[0]

    @property
    def u2(self) -> int:
        return self.prefix.shape[2] - 1

    def gather_table(self) -> torch.Tensor:
        """``eval_prefix``'s table, built on first use: (m, U2+2, F) int32,
        the prefix with dimensions first and a fill row of INT32_MIN."""
        if self._gather is None:
            table = self.prefix.permute(1, 2, 0)
            fill = torch.full((table.shape[0], 1, table.shape[2]),
                              torch.iinfo(torch.int32).min, dtype=torch.int32,
                              device=table.device)
            self._gather = torch.cat([table, fill], dim=1)
        return self._gather

    def to(self, device) -> "WalkTable":
        return WalkTable(self.pairs.to(device), self.prefix.to(device))


def make_walks(num_fns: int, dim: int, universe: int,
               generator: Optional[torch.Generator] = None) -> WalkTable:
    """``num_fns`` independent m-dim random walks over t in {0, 2, ..., U}.

    Draws from ``generator`` (a CPU ``torch.Generator``); the stream differs
    from ``jax.random``, so parity tests bridge the JAX walks instead.
    """
    if universe % 2 != 0:
        raise ValueError(f"universe must be even, got {universe}")
    bits = torch.randint(0, 2, (num_fns, dim, universe // 2, 2),
                         generator=generator, dtype=torch.int8)
    pairs = (2 * bits - 1).sum(dim=-1, dtype=torch.int8)
    return WalkTable(pairs=pairs, prefix=prefix_from_pairs(pairs))


def prefix_from_pairs(pairs: torch.Tensor) -> torch.Tensor:
    """(F, m, U2) paired steps -> (F, m, U2+1) int32 prefix sums, tau(0)=0."""
    csum = torch.cumsum(pairs.to(torch.int32), dim=-1, dtype=torch.int32)
    zero = torch.zeros(csum.shape[:-1] + (1,), dtype=torch.int32,
                       device=pairs.device)
    return torch.cat([zero, csum], dim=-1)


def eval_prefix(walks: WalkTable, points: torch.Tensor) -> torch.Tensor:
    """Gather-based raw hash: f[k](s) = sum_i prefix[k, i, s_i // 2].

    points : (n, m) int32; meant to be nonnegative, even and <= U, but every
             int32 answers as the JAX package's ``jnp.take`` does.
    returns: (n, F) int32.

    One row gather and add per dimension into an (n, F) accumulator; the
    (F, n, m) gathered tensor never exists.  An index t = s >> 1 reads row
    t for t in [0, U2], row t + U2 + 1 for t in [-(U2+1), -1], and
    INT32_MIN (``jnp.take``'s fill) otherwise; the int32 sum wraps.  The
    fill is one extra row of ``walks.gather_table()``, and each index is
    mapped onto [0, U2+1] before the gather, so nothing out of range reaches
    ``index_select``.
    """
    rows = walks.u2 + 1
    t = (points.to(torch.int32) >> 1).to(torch.int64)               # (n, m)
    t = torch.where(t < 0, t + rows, t)
    t = torch.where((t >= 0) & (t < rows), t, rows)                 # fill row
    table = walks.gather_table()                                    # (m, U2+2, F)
    acc = torch.zeros((points.shape[0], walks.num_fns), dtype=torch.int32,
                      device=points.device)
    for i in range(points.shape[1]):
        acc += table[i].index_select(0, t[:, i])
    return acc


def eval_pairs_thermo(walks: WalkTable, points: torch.Tensor) -> torch.Tensor:
    """Thermometer-product raw hash, the plain counterpart of the ``rw_hash``
    kernel: f[k](s) = sum_i sum_u 1{u < s_i // 2} * pairs[k, i, u].

    points : (n, m) int32.  returns: (n, F) int32.

    One float32 product of the (rows, m*U2) 0/1 code with the (m*U2, F)
    steps, then round, as the JAX package does; ``rw_hash_plain`` computes
    it a chunk of rows at a time.  float32 is exact: every partial sum is an
    integer of magnitude at most 2*m*U2 (65,280 at m=128, U2=255), below
    2^24.
    """
    return rw_hash_plain(walks.pairs, points)
