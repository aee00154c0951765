"""Random walks for RW-LSH (paper Sect. 3.1), torch counterpart of
``repro.core.walks``.

Data coordinates are nonnegative even integers, so walks are stored in
paired-step form: pair_j = step_{2j-1} + step_{2j} in {-2, 0, +2} and
tau(2t) = sum_{j<=t} pair_j.  ``prefix`` holds tau(0), tau(2), ..., tau(U) per
(hash fn, dim); a raw hash is one gather per coordinate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["WalkTable", "make_walks", "prefix_from_pairs", "eval_prefix"]


@dataclasses.dataclass
class WalkTable:
    """pairs  : (F, m, U2)   int8  paired steps in {-2, 0, +2}
    prefix : (F, m, U2+1) int32 prefix sums tau(0), tau(2), ..., tau(U)"""

    pairs: torch.Tensor
    prefix: torch.Tensor

    @property
    def num_fns(self) -> int:
        return self.prefix.shape[0]

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

    points : (n, m) int32, nonnegative even, <= U.
    returns: (n, F) int32.

    One row gather and add per dimension into an (n, F) accumulator; the
    (F, n, m) gathered tensor never exists.
    """
    t = (points.to(torch.int32) >> 1).to(torch.int64)               # (n, m)
    table = walks.prefix.permute(1, 2, 0).contiguous()              # (m, U2+1, F)
    acc = torch.zeros((points.shape[0], walks.num_fns), dtype=torch.int32,
                      device=points.device)
    for i in range(points.shape[1]):
        acc += table[i].index_select(0, t[:, i])
    return acc
