"""The split rerank's decomposition, on the CPU: the CUDA kernel cuts each
query's candidate slots into S contiguous slices, takes the top-k of unique
keys in each, and merges the S lists with equal keys skipped.  Here each
slice's list comes from ``fused_rerank_plain`` and the merge is written out
in torch; the result must equal ``fused_rerank_plain`` of the whole row and
the JAX package's ``ref.fused_rerank``, bit for bit.  The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import fused_rerank as tfr
from test_torch_cases import RERANK_CASES

torch.set_num_threads(1)
_EMPTY = torch.iinfo(torch.int64).max


def _keys(d, i):
    """(dist, id) -> packed (dist << 32) | id, an empty slot the largest key."""
    return torch.where(i < 0, _EMPTY, (d.to(torch.int64) << 32) | i.to(torch.int64))


def _merge(lists, k):
    """First k unique keys of the union of sorted per-slice key lists."""
    q = lists[0].shape[0]
    d = torch.full((q, k), tfr.BIG_DIST, dtype=torch.int32)
    i = torch.full((q, k), -1, dtype=torch.int32)
    union = torch.cat(lists, dim=1)
    for r in range(q):
        keys = torch.unique(union[r])            # sorted, equal keys once
        keys = keys[keys != _EMPTY][:k]
        d[r, :keys.numel()] = (keys >> 32).to(torch.int32)
        i[r, :keys.numel()] = (keys & 0xFFFFFFFF).to(torch.int32)
    return d, i


def _slices(ctot, slices, kernel_split):
    if kernel_split:                             # the kernel's own partition
        n = tfr.plan_slices(1, ctot, 0, slices)
        return [tfr.slice_slots(ctot, n, s) for s in range(n)]
    edges = np.linspace(0, ctot, slices + 1).astype(int)   # contiguous slices
    return [np.arange(lo, hi) for lo, hi in zip(edges[:-1], edges[1:])]


@pytest.mark.parametrize("slices", [1, 2, 3, 7])
@pytest.mark.parametrize("name", sorted(RERANK_CASES))
def test_split_merge_equals_whole(name, slices):
    data, queries, ids, k = RERANK_CASES[name]
    td, tq, ti = (torch.from_numpy(np.ascontiguousarray(x)) for x in (data, queries, ids))
    whole = tfr.fused_rerank_plain(td, tq, ti, k)
    want = ref.fused_rerank(jnp.asarray(data), jnp.asarray(queries), jnp.asarray(ids), k)
    np.testing.assert_array_equal(np.asarray(want[0]), whole[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), whole[1].numpy())
    for kernel_split in (True, False):
        parts = _slices(ids.shape[1], slices, kernel_split)
        assert np.array_equal(np.sort(np.concatenate(parts)), np.arange(ids.shape[1]))
        lists = [_keys(*tfr.fused_rerank_plain(td, tq, ti[:, torch.from_numpy(part)], k))
                 for part in parts if part.size]
        got = _merge(lists, k)
        np.testing.assert_array_equal(whole[0].numpy(), got[0].numpy(), err_msg="dists")
        np.testing.assert_array_equal(whole[1].numpy(), got[1].numpy(), err_msg="ids")


@pytest.mark.parametrize("q,ctot,resident,slices,want", [
    (64, 131_072, 792, None, 12),    # the served batch, 6 blocks an SM: one wave
    (64, 131_072, 1056, None, 16),   # the probe's gather there, 8 blocks an SM
    (64, 131_072, 660, None, 10),    # ... at 5 blocks an SM
    (3, 600, 1056, None, 1),         # a gather row of 3 chunks: one slice
    (64, 131_072, 4224, None, 32),   # 32 blocks an SM: capped at 32
    (64, 2048, 792, None, 4),        # the delta scan: >= 2 chunks a slice
    (3, 4000, 792, None, 8),
    (1, 40, 792, None, 1),
    (10_000, 131_072, 792, None, 1), # the grid is full without a split
    (5, 67, 0, 7, 1), (2, 5000, 0, 3, 3), (4, 10_000, 0, 64, 32)])
def test_plan_slices(q, ctot, resident, slices, want):
    """At most MAX_SLICES slices, none empty; planned, one wave of resident
    blocks; each slot in exactly one slice.  The probe's gather kernel
    splits its output rows with the same planner and chunks."""
    n = tfr.plan_slices(q, ctot, resident, slices)
    assert n == want
    parts = [tfr.slice_slots(ctot, n, s) for s in range(n)]
    assert all(part.size for part in parts)
    assert np.array_equal(np.sort(np.concatenate(parts)), np.arange(ctot))
