"""Multi-probe template (paper Sect. 2.2, 3.3): host-side construction and
batched per-query instantiation.

``heap_sequence``, ``build_template`` and ``template_matrix`` are numpy
copies of ``repro.core.multiprobe``; ``instantiate_template`` is the torch
counterpart of its device half.

Conventions.  For one hash table with M hash functions, the epicenter offsets
are a_i = frac((f_i(q)+b_i)/W) * W = x_i(-1), and x_i(+1) = W - a_i.  The 2M
boundary distances are stored concatenated: x_all = [x_1(-1)..x_M(-1),
x_1(+1)..x_M(+1)].  A perturbation index set is a subset of sorted ranks
{1..2M} (1-based); rank j and rank 2M+1-j belong to the same dimension, so a
valid set holds at most one of each such pair.
"""
from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .probability import expected_zj_sq

__all__ = ["heap_sequence", "build_template", "template_matrix",
           "instantiate_template"]


def heap_sequence(z_sq: np.ndarray, num_probes: int) -> List[Tuple[int, ...]]:
    """The first ``num_probes`` valid perturbation index sets in increasing
    order of sum_{j in A} z_sq[j-1] (z_sq sorted ascending; 1-based ranks).
    Shift/expand successor generation, so only O(T) sets are scored."""
    two_m = len(z_sq)

    def score(a: Tuple[int, ...]) -> float:
        return float(sum(z_sq[j - 1] for j in a))

    def valid(a: Tuple[int, ...]) -> bool:
        s = set(a)
        return all((two_m + 1 - j) not in s for j in a) and all(1 <= j <= two_m for j in a)

    out: List[Tuple[int, ...]] = []
    heap: List[Tuple[float, Tuple[int, ...]]] = [(score((1,)), (1,))]
    seen = set()
    while heap and len(out) < num_probes:
        _, a = heapq.heappop(heap)
        if a in seen:
            continue
        seen.add(a)
        if valid(a):
            out.append(a)
        j = a[-1]
        if j + 1 <= two_m:
            shift = a[:-1] + (j + 1,)
            expand = a + (j + 1,)
            heapq.heappush(heap, (score(shift), shift))
            heapq.heappush(heap, (score(expand), expand))
    return out


def build_template(num_hashes: int, width: float, num_probes: int) -> List[Tuple[int, ...]]:
    """The universal probing template: ``num_probes`` rank sets ordered by
    expected subset-sum of E[z_j^2].  Query-independent."""
    return heap_sequence(expected_zj_sq(num_hashes, width), num_probes)


def template_matrix(sets: Sequence[Tuple[int, ...]], num_hashes: int) -> np.ndarray:
    """(T, 2M) 0/1 int8 matrix over sorted-z ranks (column = rank - 1)."""
    t = np.zeros((len(sets), 2 * num_hashes), np.int8)
    for r, a in enumerate(sets):
        for j in a:
            t[r, j - 1] = 1
    return t


def instantiate_template(template: torch.Tensor, x_neg: torch.Tensor,
                         width: float) -> torch.Tensor:
    """Batched template instantiation.

    template : (T, 2M) int8 0/1 matrix over sorted ranks.
    x_neg    : (..., M) float32 epicenter offsets; x(+1) = W - x_neg.
    returns  : (..., T, M) int8 perturbation vectors.

    Both argsorts are stable, as ``jnp.argsort`` is: ties occur whenever
    ``x_neg == W/2``, and the rank order then decides which side is probed.
    """
    m = x_neg.shape[-1]
    x_all = torch.cat([x_neg, width - x_neg], dim=-1)               # (..., 2M)
    perm = torch.argsort(x_all, dim=-1, stable=True)                # rank -> orig
    invperm = torch.argsort(perm, dim=-1, stable=True)              # orig -> rank
    lead = x_neg.shape[:-1]
    tmpl = template.reshape((1,) * len(lead) + tuple(template.shape))
    tmpl = tmpl.expand(lead + tuple(template.shape))
    idx = invperm.unsqueeze(-2).expand(lead + tuple(template.shape))
    mapped = torch.gather(tmpl, -1, idx)                            # (..., T, 2M)
    return (mapped[..., m:] - mapped[..., :m]).to(torch.int8)
