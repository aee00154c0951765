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
from repro_torch.kernels import topk_merge as ttm
from test_torch_cases import MERGE_CASES, PROBE_CASES, RERANK_CASES

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
@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_topk_merge_kernel_matches_plain(card, name):
    args = [_t(x).to(card) for x in MERGE_CASES[name]]
    want = ttm.topk_merge_plain(*args)
    got = ttm.topk_merge_cuda(*args)
    torch.cuda.synchronize()
    _eq(want[0].cpu(), got[0].cpu())
    _eq(want[1].cpu(), got[1].cpu())
