"""Multi-probe template (paper Sect. 2.2, 3.3) and success model (Sect. 4):
host-side construction, batched per-query instantiation, and the success
probabilities the recall autotuner inverts.

``heap_sequence``, ``build_template``, ``template_matrix`` and the analysis
half (``perturbations_from_sets``, ``coord_landing_probs``,
``exact_topk_success``, ``sequence_success``, ``success_table_mc``) are
numpy copies of the JAX package's ``core.multiprobe``, with the same
operations, order and seeded ``default_rng``; ``instantiate_template`` is
the torch counterpart of its device half.

Conventions.  For one hash table with M hash functions, the epicenter offsets
are a_i = frac((f_i(q)+b_i)/W) * W = x_i(-1), and x_i(+1) = W - a_i.  The 2M
boundary distances are stored concatenated: x_all = [x_1(-1)..x_M(-1),
x_1(+1)..x_M(+1)].  A perturbation index set is a subset of sorted ranks
{1..2M} (1-based); rank j and rank 2M+1-j belong to the same dimension, so a
valid set holds at most one of each such pair.
"""
from __future__ import annotations

import heapq
from functools import reduce
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .probability import expected_zj_sq, interval_prob

__all__ = ["heap_sequence", "build_template", "template_matrix",
           "instantiate_template", "perturbations_from_sets",
           "coord_landing_probs", "exact_topk_success", "sequence_success",
           "success_table_mc"]


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


def perturbations_from_sets(sets: Sequence[Tuple[int, ...]],
                            x_all: np.ndarray) -> np.ndarray:
    """Host-side instantiation: rank sets -> (T, M) int8 perturbation
    vectors, for (2M,) boundary distances ``x_all`` in the concat layout."""
    two_m = x_all.shape[0]
    m = two_m // 2
    perm = np.argsort(x_all, kind="stable")  # rank r (0-based) -> orig index
    out = np.zeros((len(sets), m), np.int8)
    for r, a in enumerate(sets):
        for j in a:
            orig = perm[j - 1]
            if orig < m:
                out[r, orig] = -1
            else:
                out[r, orig - m] = 1
    return out


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


# --------------------------------------------------------------------------
# Success probabilities (paper Sect. 4, Tables 1 & 2), host-side numpy.
# --------------------------------------------------------------------------

def coord_landing_probs(a: np.ndarray, width: float, family: str, d: float) -> np.ndarray:
    """(M, 3) probabilities, for delta in (-1, 0, +1), that a neighbour at
    distance d lands in [delta*W - a, delta*W - a + W) per coordinate, given
    (M,) epicenter offsets ``a``."""
    a = np.asarray(a, np.float64)
    deltas = np.array([-1.0, 0.0, 1.0])
    lo = deltas[None, :] * width - a[:, None]
    hi = lo + width
    return interval_prob(family, d, lo, hi)


def exact_topk_success(a: np.ndarray, width: float, family: str, d: float,
                       t_probes: Sequence[int]) -> np.ndarray:
    """P_T(d) of the *optimal* probing sequence by enumerating all 3^M
    buckets (paper Table 1), one value per T in ``t_probes`` (epicenter + T
    buckets)."""
    m = len(a)
    if m > 14:
        raise ValueError("exact enumeration is 3^M; use heap_sequence for M>14")
    probs3 = coord_landing_probs(a, width, family, d)           # (M, 3)
    full = reduce(np.multiply.outer, probs3)                    # (3,)*M tensor
    flat = np.sort(full.ravel())[::-1]
    csum = np.cumsum(flat)
    return np.array([csum[min(t, len(flat) - 1)] for t in t_probes])


def sequence_success(deltas: np.ndarray, a: np.ndarray, width: float,
                     family: str, d: float, t_probes: Sequence[int]) -> np.ndarray:
    """P_T(d) of an explicit probing sequence, (T, M) ``deltas`` in
    {-1, 0, 1}, with the epicenter prepended."""
    probs3 = coord_landing_probs(a, width, family, d)           # (M, 3)
    seq = np.concatenate([np.zeros((1, deltas.shape[1]), np.int8), deltas])
    per = probs3[np.arange(seq.shape[1])[None, :], seq + 1]     # (T+1, M)
    bucket_p = per.prod(axis=1)
    csum = np.cumsum(bucket_p)
    return np.array([csum[min(t, len(csum) - 1)] for t in t_probes])


def success_table_mc(family: str, num_hashes: int, width: float,
                     d_values: Sequence[float], t_values: Sequence[int],
                     runs: int = 1000, seed: int = 0,
                     use_template: bool = False) -> np.ndarray:
    """Monte-Carlo P_T(d) (paper Tables 1 & 2): epicenter offsets
    a ~ U[0, W)^M a run from ``default_rng(seed)``, averaged over ``runs``;
    the optimal sequence, or with ``use_template`` the universal template
    the query path runs.  Returns (len(d_values), len(t_values))."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(d_values), len(t_values)))
    tmax = max(t_values)
    sets = build_template(num_hashes, width, tmax) if use_template else None
    for _ in range(runs):
        a = rng.uniform(0.0, width, size=num_hashes)
        for di, d in enumerate(d_values):
            if use_template:
                x_all = np.concatenate([a, width - a])
                deltas = perturbations_from_sets(sets, x_all)
                out[di] += sequence_success(deltas, a, width, family, d, t_values)
            else:
                out[di] += exact_topk_success(a, width, family, d, t_values)
    return out / runs
