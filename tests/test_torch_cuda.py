"""The port's CUDA kernels against their plain-torch versions, on the card,
bit for bit, at the adversarial shapes of ``test_torch_cases``.  Needs no jax:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here is marked ``cuda`` and skips without a card (a CUDA kernel
has no CPU mode)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_probe as tfp
from repro_torch.kernels import fused_rerank as tfr
from repro_torch.kernels import l1_distance as tl1
from repro_torch.kernels import rw_hash as trw
from repro_torch.kernels import topk_merge as ttm
from test_torch_cases import (L1_CASES, L1_ROWS_CASES, MERGE_CASES, PROBE_CASES,
                              RERANK_CASES, RW_HASH_CASES)

torch.set_num_threads(1)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_fused_probe_kernel_matches_plain(card, name):
    keys, ids, pk, cap, cbucket = PROBE_CASES[name]
    tk = _t(keys.astype(np.int64)).to(card)
    tpk = _t(pk.astype(np.int64)).to(card)
    tids = _t(ids).to(card)
    occ = (torch.searchsorted(tk, tk, right=True)
           - torch.arange(tk.shape[1], device=card)).to(torch.int32)
    want = tfp.fused_probe_plain(tk, tids, tpk, cap, cbucket)
    for occ_from in (None, occ):
        got = tfp.fused_probe_cuda(tk, tids, tpk, cap, cbucket, occ_from=occ_from)
        torch.cuda.synchronize()
        _eq(want[0].cpu(), got[0].cpu())
        _eq(want[1].cpu(), got[1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RERANK_CASES))
def test_fused_rerank_kernel_matches_plain(card, name):
    data, queries, ids, k = RERANK_CASES[name]
    args = [_t(x).to(card) for x in (data, queries, ids)]
    want = tfr.fused_rerank_plain(*args, k)
    got = tfr.fused_rerank_cuda(*args, k)
    torch.cuda.synchronize()
    _eq(want[0].cpu(), got[0].cpu())
    _eq(want[1].cpu(), got[1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 2, 3, 7, 32])
@pytest.mark.parametrize("name", sorted(RERANK_CASES))
def test_fused_rerank_kernel_at_each_split(card, name, slices):
    """The kernel at a fixed slice count (one block a query, a few, the
    most) equals plain: the slice lists and their merge lose nothing."""
    data, queries, ids, k = RERANK_CASES[name]
    args = [_t(x).to(card) for x in (data, queries, ids)]
    want = tfr.fused_rerank_plain(*args, k)
    got = tfr.fused_rerank_cuda(*args, k, slices=slices)
    torch.cuda.synchronize()
    _eq(want[0].cpu(), got[0].cpu())
    _eq(want[1].cpu(), got[1].cpu())


@pytest.mark.cuda
def test_fused_rerank_kernel_refuses_what_it_cannot_take(card):
    data = torch.zeros((10, 4), dtype=torch.int32, device=card)
    q = torch.zeros((2, 4), dtype=torch.int32, device=card)
    ids = torch.zeros((2, 8), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        tfr.fused_rerank_cuda(data.to(torch.int64), q, ids, 3)
    with pytest.raises(ValueError):                 # shared memory: 64 k + 4 m
        tfr.fused_rerank_cuda(data, q, ids, tfr.SMEM_LIMIT // 64)
    with pytest.raises(ValueError):
        tfr.fused_rerank_cuda(data, q.cpu(), ids, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_topk_merge_kernel_matches_plain(card, name):
    args = [_t(x).to(card) for x in MERGE_CASES[name]]
    want = ttm.topk_merge_plain(*args)
    got = ttm.topk_merge_cuda(*args)
    torch.cuda.synchronize()
    _eq(want[0].cpu(), got[0].cpu())
    _eq(want[1].cpu(), got[1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RW_HASH_CASES))
def test_rw_hash_kernel_matches_plain(card, name):
    pairs, pts = (_t(x).to(card) for x in RW_HASH_CASES[name])
    want = trw.rw_hash_plain(pairs, pts)
    got = trw.rw_hash_cuda(pairs, pts)
    torch.cuda.synchronize()
    _eq(want.cpu(), got.cpu())


@pytest.mark.cuda
def test_rw_hash_kernel_at_the_u2_limit(card):
    """U2 up to the device's limit equals plain (a table over 48 KB of
    shared memory, scan segments of many steps); one step more raises."""
    rng = np.random.default_rng(5)
    limit = trw.max_u2()
    assert limit >= 1000
    for u2 in (1000, limit):
        pairs = torch.from_numpy(
            (2 * rng.integers(0, 2, (33, 3, u2, 2)) - 1).sum(-1).astype(np.int8)).to(card)
        pts = torch.from_numpy(
            rng.integers(-9, 2 * u2 + 9, (50, 3)).astype(np.int32)).to(card)
        _eq(trw.rw_hash_plain(pairs, pts).cpu(), trw.rw_hash_cuda(pairs, pts).cpu(),
            f"U2={u2}")
    over = torch.zeros((1, 1, limit + 1), dtype=torch.int8, device=card)
    with pytest.raises(ValueError):
        trw.rw_hash_cuda(over, torch.zeros((1, 1), dtype=torch.int32, device=card))


def _typed(arr, dtype, card):
    return _t(arr).to(card).to(getattr(torch, dtype)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(L1_CASES))
def test_l1_distance_kernel_matches_plain(card, name):
    queries, points, dtype = L1_CASES[name]
    q, x = _typed(queries, dtype, card), _typed(points, dtype, card)
    want = tl1.l1_distance_plain(q, x)
    got = tl1.l1_distance_cuda(q, x)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    _eq(want.cpu(), got.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(L1_ROWS_CASES))
def test_l1_distance_rows_kernel_matches_plain(card, name):
    queries, rows, dtype = L1_ROWS_CASES[name]
    q, r = _typed(queries, dtype, card), _typed(rows, dtype, card)
    want = tl1.l1_distance_rows_plain(q, r)
    got = tl1.l1_distance_rows_cuda(q, r)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    _eq(want.cpu(), got.cpu())
