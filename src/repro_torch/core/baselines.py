"""Exact L1 ground truth and recall, torch counterpart of the
``brute_force_l1`` / ``recall`` subset of ``repro.core.baselines``."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["brute_force_l1", "recall"]

_INT64_MAX = np.iinfo(np.int64).max


def brute_force_l1(dataset: torch.Tensor, queries: torch.Tensor, k: int,
                   chunk: int = 2048):
    """Exact k-NN in L1 with int32 accumulation, chunked over dataset rows.

    Returns (dists (Q, k) int32, ids (Q, k) int32), lex-(dist, id)
    ascending (ties go to the smaller id), as ``repro``'s brute force does.
    """
    n = dataset.shape[0]
    q = queries.shape[0]
    qs = queries.to(torch.int32)
    best = torch.full((q, k), _INT64_MAX, dtype=torch.int64, device=qs.device)
    for lo in range(0, n, chunk):
        rows = dataset[lo:lo + chunk].to(torch.int32)
        d = (qs[:, None, :] - rows[None, :, :]).abs().sum(dim=-1, dtype=torch.int32)
        ids = torch.arange(lo, lo + rows.shape[0], device=qs.device)
        keys = (d.to(torch.int64) << 32) | ids[None, :]
        both = torch.cat([best, keys], dim=-1)
        best = torch.topk(both, min(k, both.shape[1]), dim=-1, largest=False).values
    bad = best == _INT64_MAX
    dist = torch.where(bad, np.iinfo(np.int32).max // 2, best >> 32).to(torch.int32)
    ids = torch.where(bad, -1, best & 0xFFFFFFFF).to(torch.int32)
    return dist, ids


def recall(result_ids, true_ids) -> float:
    """Recall@k: |R ∩ R*| / |R*| averaged over queries; negative padding is
    dropped from both rows and duplicate ids count once."""
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
