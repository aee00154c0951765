"""The per-row L1 kernel's launch plan (``l1_distance.plan_rows``), on the CPU.

The plan picks the 16-byte vector path only where a row is a whole number of
aligned 16-byte vectors, and its blocks cover every (query, row) once.  The
vector and scalar kernels' index arithmetic (``csrc/l1_distance.cu``:
``l1_rows_vec_kernel``, ``l1_rows_scalar_kernel``) is replayed here over
numpy lanes: within a tile, every (row, vector) or (row, coordinate) is
loaded exactly once, and a row's lanes are one aligned segment, the lanes
that its shuffles reduce over.  The kernels themselves run on the card
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.l1_distance import plan_rows

DTYPES = (torch.int32, torch.int16, torch.float32, torch.bfloat16)
MS = (1, 3, 8, 17, 64, 127, 128, 129, 256, 960, 1040, 8200)
OFFSETS = (0, 2, 4, 8)
WARPS, LOADS = 8, 4                     # kRowWarps, kRowLoads
BASE = 1 << 20                          # an address aligned to 16 bytes


def _vector_tile(plan, nv, nrows):
    """Loads of each (row, vector) in one tile of the vector kernel, and
    whether every row's lanes fall in one aligned segment of ``plan.seg``."""
    k, seg = plan.slots, plan.seg
    held, per = max(1, LOADS // k), 32 // seg
    group, span = per * held, 32 * k
    lane = np.arange(32)
    sub, lrow = lane & (seg - 1), lane // seg
    seen = np.zeros((nrows, nv), np.int64)
    one_segment = True
    for warp in range(WARPS):
        for base in range(warp * group, nrows, WARPS * group):
            for ch in range(-(-nv // span)):
                for p in range(held):
                    row = base + p * per + lrow
                    for j in range(k):
                        v = ch * span + sub + 32 * j
                        ok = (row < nrows) & (v < nv)
                        np.add.at(seen, (row[ok], v[ok]), 1)
                    for r in np.unique(row):
                        lanes = lane[row == r]
                        one_segment &= (len(lanes) == seg and lanes[0] % seg == 0)
    return seen, one_segment


def _scalar_tile(m, nrows):
    """Loads of each (row, coordinate) in one tile of the scalar kernel."""
    seen = np.zeros((nrows, m), np.int64)
    for warp in range(WARPS):
        for j in range(warp, nrows, WARPS):
            for k0 in range(0, m, 32):
                k = k0 + np.arange(32)
                np.add.at(seen[j], k[k < m], 1)
    return seen


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plan_rows(dtype, m, offset):
    size = dtype.itemsize
    whole = m * size % 16 == 0
    q = 3
    for rows_off, queries_off in ((offset, 0), (0, offset)):
        plan = plan_rows(dtype, m, 1, q, BASE + rows_off, BASE + queries_off)
        # the vector path exactly where a row is whole aligned 16-byte vectors
        assert (plan.slots > 0) == (whole and offset == 0)
    c = 2 * plan.tile + 3                   # two whole tiles and a part tile
    plan = plan_rows(dtype, m, c, q, BASE + offset, BASE)
    # what the kernel family takes (launch_rows refuses anything else)
    assert plan.slots in (0, 1, 2, 4, 8)
    assert plan.seg in (1, 2, 4, 8, 16, 32) and (plan.slots <= 1 or plan.seg == 32)
    assert 64 <= plan.tile <= 2048
    # the query in shared memory: the scalar path, and rows over 256 vectors
    staged = m * size <= 32 * 1024 and (plan.slots == 0 or m * size > 16 * 256)
    assert plan.stage == int(staged)
    assert plan.tiles == -(-c // plan.tile) and plan.blocks == q * plan.tiles
    smem = -(-plan.tile * 4 // 16) * 16 + plan.stage * -(-m * size // 16) * 16
    assert smem <= 48 * 1024
    # the blocks cover every (query, row) exactly once
    cover = np.zeros((q, c), np.int64)
    for b in range(plan.blocks):
        r0 = b % plan.tiles * plan.tile
        cover[b // plan.tiles, r0:min(c, r0 + plan.tile)] += 1
    assert (cover == 1).all()
    # within a tile (a whole one and the part one), every value is read once
    for nrows in {plan.tile, c - (plan.tiles - 1) * plan.tile}:
        if plan.slots:
            seen, one_segment = _vector_tile(plan, m * size // 16, nrows)
            assert one_segment
        else:
            seen = _scalar_tile(m, nrows)
        assert (seen == 1).all()
