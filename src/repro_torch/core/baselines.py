"""Baselines the paper compares against (Sect. 5), torch counterpart of
``repro.core.baselines``:

  * brute-force exact L1 k-NN (ground truth for recall and overall ratio);
  * RW-LSH single-probe (MP-RW-LSH with T = 0), CP-LSH (Cauchy projection,
    single-probe) and MP-CP-LSH, as index configurations;
  * SRS: a Cauchy projection to M dims, the exact t-NN in projection space,
    then an exact L1 rerank of those t (a brute-force projected t-NN in
    place of the paper's cover tree, as in the JAX package);
  * recall@k and the overall ratio.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops

from .hashes import project
from .index import IndexConfig
from .pipeline import l1_distance_chunked

__all__ = ["brute_force_l1", "single_probe_config", "cp_lsh_config",
           "mp_cp_lsh_config", "SrsState", "build_srs", "query_srs", "recall",
           "overall_ratio"]

_INT64_MAX = np.iinfo(np.int64).max


def brute_force_l1(dataset: torch.Tensor, queries: torch.Tensor, k: int,
                   chunk: int = 2048):
    """Exact k-NN in L1, a chunk of dataset rows at a time: each chunk's
    distances through ``l1_distance`` (the kernel on the card, int32 sums),
    then a running top-k of (dist, id) keys.

    Returns (dists (Q, k) int32, ids (Q, k) int32), lex-(dist, id)
    ascending (ties go to the smaller id), as ``repro``'s brute force does.
    """
    n = dataset.shape[0]
    q = queries.shape[0]
    qs = queries.to(torch.int32).contiguous()
    best = torch.full((q, k), _INT64_MAX, dtype=torch.int64, device=qs.device)
    for lo in range(0, n, chunk):
        rows = dataset[lo:lo + chunk].to(torch.int32).contiguous()
        d = kops.l1_distance(qs, rows)
        ids = torch.arange(lo, lo + rows.shape[0], device=qs.device)
        keys = (d.to(torch.int64) << 32) | ids[None, :]
        both = torch.cat([best, keys], dim=-1)
        best = torch.topk(both, min(k, both.shape[1]), dim=-1, largest=False).values
    bad = best == _INT64_MAX
    dist = torch.where(bad, np.iinfo(np.int32).max // 2, best >> 32).to(torch.int32)
    ids = torch.where(bad, -1, best & 0xFFFFFFFF).to(torch.int32)
    return dist, ids


def single_probe_config(cfg: IndexConfig) -> IndexConfig:
    """RW-LSH baseline: the same index probed only at the epicenter."""
    return dataclasses.replace(cfg, num_probes=0)


def cp_lsh_config(cfg: IndexConfig, width: int) -> IndexConfig:
    return dataclasses.replace(cfg, family="cauchy", width=width, num_probes=0,
                               hash_impl="gather")


def mp_cp_lsh_config(cfg: IndexConfig, width: int) -> IndexConfig:
    return dataclasses.replace(cfg, family="cauchy", width=width,
                               hash_impl="gather")


# --------------------------------------------------------------------------
# SRS
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SrsState:
    proj: torch.Tensor       # (M, m) Cauchy projection
    projected: torch.Tensor  # (n, M) f(D), float32
    dataset: torch.Tensor    # (n, m)


def build_srs(dataset: torch.Tensor, num_proj: int = 10,
              generator: Optional[torch.Generator] = None,
              proj: Optional[torch.Tensor] = None) -> SrsState:
    """Project ``dataset`` with ``proj`` (M, m), or with a Cauchy projection
    drawn from ``generator`` (CPU) when none is given."""
    if proj is None:
        proj = torch.empty((num_proj, dataset.shape[1]), dtype=torch.float32)
        proj.cauchy_(generator=generator)
    proj = proj.to(device=dataset.device, dtype=torch.float32)
    return SrsState(proj=proj, projected=project(dataset, proj), dataset=dataset)


SRS_CHUNK_ELEMS = 1 << 27   # bound on one query chunk's (Qc, n, M) differences


def query_srs(state: SrsState, queries: torch.Tensor, t: int, k: int):
    """t-NN in projection space (squared L2), exact L1 rerank of those t.

    A chunk of queries at a time forms its (Qc, n, M) differences, so the
    memory stays bounded at any n.  The t candidates of a query are the t
    smallest (projected distance, row) keys in that order: a tie at the t-th
    distance keeps the lower row, as ``lax.top_k`` does."""
    n, nproj = state.projected.shape
    fq = project(queries, state.proj)                                # (Q, M)
    step = max(1, SRS_CHUNK_ELEMS // max(1, n * nproj))
    rows = torch.arange(n, device=fq.device)
    cands = []
    for lo in range(0, fq.shape[0], step):
        diff = state.projected[None, :, :] - fq[lo:lo + step, None, :]
        d2 = (diff * diff).sum(dim=-1)                               # (Qc, n)
        del diff
        # d2 >= 0, so its float32 bits order as the values do
        keys = (d2.view(torch.int32).to(torch.int64) << 32) | rows
        del d2
        top = torch.topk(keys, t, dim=1, largest=False).values
        cands.append(top & 0xFFFFFFFF)
    cand = torch.cat(cands).to(torch.int32)
    return l1_distance_chunked(state.dataset, queries, cand, k, chunk=min(t, 512))


# --------------------------------------------------------------------------
# Quality metrics (paper Sect. 5.1)
# --------------------------------------------------------------------------

def recall(result_ids, true_ids) -> float:
    """Recall@k: |R ∩ R*| / |R*| averaged over queries; negative padding is
    dropped from both rows and duplicate ids count once.  A Python loop, as
    the JAX package's: its float sum decides which side of a target a
    recall falls on."""
    result_ids = np.atleast_2d(np.asarray(result_ids))
    true_ids = np.atleast_2d(np.asarray(true_ids))
    if result_ids.shape[0] != true_ids.shape[0]:
        raise ValueError(
            f"row count mismatch: {result_ids.shape[0]} result rows vs "
            f"{true_ids.shape[0]} ground-truth rows")
    if result_ids.shape[0] == 0:
        return 0.0
    r = 0.0
    for a, b in zip(result_ids, true_ids):
        truth = set(b[b >= 0].tolist())
        if truth:
            r += len(set(a[a >= 0].tolist()) & truth) / len(truth)
    return r / len(result_ids)


def overall_ratio(result_d, true_d) -> float:
    """(1/k) sum_i ||q - o_i|| / ||q - o_i*||, averaged over queries; result
    entries at the sentinel distance are left out."""
    rd = np.asarray(result_d, np.float64)
    td = np.asarray(true_d, np.float64)
    ok = rd < np.iinfo(np.int32).max // 4
    ratio = np.where(ok, rd / np.maximum(td, 1e-9), np.nan)
    return float(np.nanmean(ratio))
