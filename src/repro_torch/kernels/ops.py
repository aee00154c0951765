"""Public wrappers for the kernels of the serving path.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor runs the kernel's plain-torch version, a CUDA tensor launches the
CUDA kernel — and raises if the kernel cannot be built or launched.  There
is no switch and no fallback from a kernel to its plain version.

``LAUNCHES`` counts kernel launches per kernel (``reset_launches`` zeroes
it), so a run can show that it went through the kernels.
"""
from __future__ import annotations

from ._build import LAUNCHES, reset_launches
from .fused_probe import (compact_gather, fused_probe_cuda, fused_probe_plain,
                          probe_extents)
from .fused_rerank import fused_rerank_cuda, fused_rerank_plain
from .topk_merge import topk_merge_cuda, topk_merge_plain

__all__ = ["LAUNCHES", "reset_launches", "topk_merge", "fused_rerank",
           "fused_probe", "probe_extents"]


def _on_cuda(t) -> bool:
    return t.device.type == "cuda"


def topk_merge(da, ia, db, ib):
    """Merge two lex-ascending (Q, k) (dist, id) lists into the k smallest."""
    if _on_cuda(da):
        return topk_merge_cuda(da, ia, db, ib)
    return topk_merge_plain(da, ia, db, ib)


def fused_rerank(dataset, queries, ids, k: int, chunk: int = 512):
    """Gather + exact L1 + top-k over unique valid candidates (``chunk`` sizes
    the plain version's candidate steps; the kernel needs none)."""
    if _on_cuda(ids):
        return fused_rerank_cuda(dataset, queries, ids, k)
    return fused_rerank_plain(dataset, queries, ids, k, chunk=chunk)


def fused_probe(sorted_keys, sorted_ids, probe_keys, cap: int, cbucket: int,
                extents=None, occ_from=None):
    """Bucket lookup + compacted gather.

    ``extents`` — phase A's (lo, occ) — lets the plain version skip the
    search; the kernel re-searches from the probe keys, as the TPU kernel
    does.  ``cap`` may be tighter than the cap of the extents' counts.
    """
    if _on_cuda(probe_keys):
        return fused_probe_cuda(sorted_keys, sorted_ids, probe_keys, cap,
                                cbucket, occ_from=occ_from)
    if extents is not None:
        return compact_gather(sorted_ids, extents[0], extents[1],
                              probe_keys.shape[2], cbucket, cap)
    return fused_probe_plain(sorted_keys, sorted_ids, probe_keys, cap, cbucket,
                             occ_from=occ_from)
