"""The port's CUDA kernels against their plain-torch versions, on the card,
bit for bit, at the adversarial shapes of ``test_torch_cases``.  Needs no jax:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test here is marked ``cuda`` and skips without a card (a CUDA kernel
has no CPU mode)."""
import numpy as np
import pytest
import torch

from repro_torch.core.index import IndexConfig
from repro_torch.kernels import fused_probe as tfp
from repro_torch.kernels import ops
from repro_torch.kernels import fused_rerank as tfr
from repro_torch.kernels import l1_distance as tl1
from repro_torch.kernels import rw_hash as trw
from repro_torch.kernels import topk_merge as ttm
from repro_torch.serve.engine import AnnServingEngine, ServeConfig
from test_torch_cases import (KERNEL_RERANK_CASES, L1_CASES, L1_ROWS_CASES, MERGE_CASES,
                              PROBE_CASES, RERANK_CASES, RW_HASH_CASES, reaches_big)

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


def _probe_inputs(name, card):
    """(keys, ids, probe keys, run-length table) of a probe case on the card."""
    keys, ids, pk, cap, cbucket = PROBE_CASES[name]
    tk = _t(keys.astype(np.int64)).to(card)
    occ = (torch.searchsorted(tk, tk, right=True)
           - torch.arange(tk.shape[1], device=card)).to(torch.int32)
    return tk, _t(ids).to(card), _t(pk.astype(np.int64)).to(card), occ, cap, cbucket


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_fused_probe_kernel_matches_plain(card, name):
    """The one-pass route (the extents kernel, then the gather kernel) and
    its dispatch through ``ops.fused_probe``."""
    tk, tids, tpk, occ, cap, cbucket = _probe_inputs(name, card)
    want = tfp.fused_probe_plain(tk, tids, tpk, cap, cbucket)
    for occ_from in (None, occ):
        for fn in (tfp.fused_probe_cuda, ops.fused_probe):
            got = fn(tk, tids, tpk, cap, cbucket, occ_from=occ_from)
            torch.cuda.synchronize()
            _eq(want[0].cpu(), got[0].cpu())
            _eq(want[1].cpu(), got[1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_probe_extents_kernel_matches_plain(card, name):
    tk, _, tpk, occ, cap, _ = _probe_inputs(name, card)
    for occ_from in (None, occ):
        want = tfp.probe_extents(tk, tpk, cap, occ_from)
        got = tfp.probe_extents_cuda(tk, tpk, cap, occ_from)
        torch.cuda.synchronize()
        for w, g, what in zip(want, got, ("lo", "occ", "counts")):
            _eq(w.cpu(), g.cpu(), f"{what}, occ_from {'given' if occ_from is not None else None}")


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [None, 1, 2, 3, 7, 32])
@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_compact_gather_kernel_matches_plain(card, name, slices):
    """The gather from phase A's extents at the full cap and tighter ones,
    at the planned split and at fixed ones; the served route through
    ``ops.fused_probe(extents=...)`` too."""
    tk, tids, tpk, occ, cap, cbucket = _probe_inputs(name, card)
    lo, raw, _ = tfp.probe_extents(tk, tpk, cap, occ)
    p = tpk.shape[2]
    for c in sorted({cap, 1, 3}):
        want = tfp.compact_gather(tids, lo, raw, p, cbucket, c)
        got = tfp.compact_gather_cuda(tids, lo, raw, p, cbucket, c, slices=slices)
        served = ops.fused_probe(tk, tids, tpk, c, cbucket, extents=(lo, raw))
        torch.cuda.synchronize()
        for g in (got, served):
            _eq(want[0].cpu(), g[0].cpu(), f"ids at cap {c}")
            _eq(want[1].cpu(), g[1].cpu(), f"counts at cap {c}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_RERANK_CASES))
def test_fused_rerank_kernel_matches_plain(card, name):
    data, queries, ids, k = KERNEL_RERANK_CASES[name]
    args = [_t(x).to(card) for x in (data, queries, ids)]
    want = tfr.fused_rerank_plain(*args, k)
    got = tfr.fused_rerank_cuda(*args, k)
    torch.cuda.synchronize()
    _eq(want[0].cpu(), got[0].cpu())
    _eq(want[1].cpu(), got[1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 2, 3, 7, 32])
@pytest.mark.parametrize("name", sorted(KERNEL_RERANK_CASES))
def test_fused_rerank_kernel_at_each_split(card, name, slices):
    """The kernel at a fixed slice count (one block a query, a few, the
    most) equals plain: the slice lists and their merge lose nothing.  The
    cases include a wrapped int32 sum, which ranks first."""
    data, queries, ids, k = KERNEL_RERANK_CASES[name]
    args = [_t(x).to(card) for x in (data, queries, ids)]
    want = tfr.fused_rerank_plain(*args, k)
    got = tfr.fused_rerank_cuda(*args, k, slices=slices)
    torch.cuda.synchronize()
    _eq(want[0].cpu(), got[0].cpu())
    _eq(want[1].cpu(), got[1].cpu())


def _valid_multiset(ids, n):
    return torch.sort(torch.where((ids >= 0) & (ids < n), ids, -1), dim=1).values


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 64, 1 << 20])
@pytest.mark.parametrize("name", sorted(KERNEL_RERANK_CASES))
def test_fused_rerank_windowed_matches_plain(card, name, rows):
    """The windowed path at a fixed window (one row a window, a few, all
    rows in one) equals plain, and leaves each row's valid ids reordered
    with their multiset kept."""
    data, queries, ids, k = KERNEL_RERANK_CASES[name]
    args = [_t(x).to(card) for x in (data, queries, ids)]
    n = args[0].shape[0]
    if -(-n // rows) > tfr.MAX_WINDOWS:
        rows = 1 << (n - 1).bit_length()
    want = tfr.fused_rerank_plain(*args, k)
    work = args[2].clone()
    got = tfr.fused_rerank_cuda(args[0], args[1], work, k, window_rows=rows)
    torch.cuda.synchronize()
    _eq(want[0].cpu(), got[0].cpu())
    _eq(want[1].cpu(), got[1].cpu())
    _eq(_valid_multiset(work, n).cpu(), _valid_multiset(args[2], n).cpu())


def _window_traps(rng, q, n, m, ctot, dtype, rows):
    """Random rows with the windowed path's traps: ids at the edges of every
    window, each id twice, copies in the next partition chunk, -1 and n, a
    row with no valid id, and a row of one id (k above its valid count)."""
    data = rng.integers(0, 256, (n, m)).astype(dtype)
    queries = rng.integers(0, 256, (q, m)).astype(np.int32)
    ids = rng.integers(-1, n + 1, (q, ctot)).astype(np.int32)
    edges = np.arange(0, n, rows)
    e = np.concatenate([edges - 1, edges, edges + 1])
    ids[:, :min(e.size, ctot)] = e[:ctot]
    ids[:, 1::2] = ids[:, 0::2][:, :ids[:, 1::2].shape[1]]
    if ctot > tfr.WINDOW_PART + 500:
        ids[:, tfr.WINDOW_PART:tfr.WINDOW_PART + 500] = ids[:, :500]
    ids[0] = -1
    if q > 1:
        ids[-1, 1:] = n
    return data, queries, ids


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3, 130, 1024])
@pytest.mark.parametrize("m", [128, 960])
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_fused_rerank_windowed_at_served_widths(card, dtype, m, q):
    """Served widths and types, Q from 1 to a bulk batch, rows of several
    partition chunks: the windowed path at two windows and by the rule
    equals plain and the sliced path, bit for bit."""
    rng = np.random.default_rng(q * 1000 + m)
    n, ctot, k = 6000, 2 * tfr.WINDOW_PART + 1000, 10
    data, queries, ids = _window_traps(rng, q, n, m, ctot, dtype, 256)
    args = [_t(x).to(card) for x in (data, queries, ids)]
    want = tfr.fused_rerank_plain(*args, k)
    sliced = tfr.fused_rerank_cuda(*args, k, slices=1)
    for rows in (256, 4096, None):
        work = args[2].clone()
        got = tfr.fused_rerank_cuda(args[0], args[1], work, k, window_rows=rows)
        torch.cuda.synchronize()
        for a, b, c in zip(want, got, sliced):
            _eq(a.cpu(), b.cpu(), f"rows={rows}")
            _eq(c.cpu(), b.cpu(), f"rows={rows}")
        _eq(_valid_multiset(work, n).cpu(), _valid_multiset(args[2], n).cpu())


def _check_grouped(args, k, rows, group, msg=""):
    """The grouped windowed path at (rows, group) against plain bit for bit,
    the valid multiset of the ids kept, and its counters: one load a row of
    an item, at most one pair a (query, row)."""
    from repro_torch.kernels import _build
    data, queries, ids = args
    n = data.shape[0]
    want = tfr.fused_rerank_plain(data, queries, ids, k)
    work = ids.clone()
    _build.take_path("fused_rerank")
    got = tfr.fused_rerank_cuda(data, queries, work, k, window_rows=rows, group=group)
    torch.cuda.synchronize()
    _eq(want[0].cpu(), got[0].cpu(), msg)
    _eq(want[1].cpu(), got[1].cpu(), msg)
    _eq(_valid_multiset(work, n).cpu(), _valid_multiset(ids, n).cpu(), msg)
    path, detail = _build.take_path("fused_rerank")
    stats = ops.rerank_attrs(path, detail)
    assert path == "windowed" and stats["group"] == group, msg
    assert 0 <= stats["row_loads"] <= stats["pairs"], (msg, stats)
    distinct = sum(int(torch.unique(r[(r >= 0) & (r < n)]).numel()) for r in ids.cpu())
    assert stats["pairs"] == distinct, (msg, stats)
    assert min(stats["partition_us"], stats["items_us"], stats["output_us"]) >= 0, (msg, stats)
    assert _build.take_path("fused_rerank") is None
    return stats


@pytest.mark.cuda
@pytest.mark.parametrize("group", [2, 3, tfr.WINDOW_GROUP_MAX])
@pytest.mark.parametrize("rows", [4, 64, tfr.GROUP_ROWS_MAX])
@pytest.mark.parametrize("name", sorted(KERNEL_RERANK_CASES))
def test_fused_rerank_grouped_matches_plain(card, name, rows, group):
    """(group, window) items at forced groups (two queries, three, which
    divides no case's Q but 3, and the most that fits the case's width) and
    windows (a few rows, all rows in one) equal plain, the wrapped int32 sum
    and the ties included; int16 cases are refused a group."""
    data, queries, ids, k = KERNEL_RERANK_CASES[name]
    m = data.shape[1]
    chunks = -(-ids.shape[1] // tfr.WINDOW_PART)
    group = max(g for g in range(2, group + 1)
                if tfr.group_smem_bytes(m, k, g, rows, chunks) <= tfr.WINDOW_SMEM_LIMIT)
    args = [_t(x).to(card) for x in (data, queries, ids)]
    if data.dtype == np.int16:
        with pytest.raises(ValueError, match="int32"):
            tfr.fused_rerank_cuda(*args, k, window_rows=rows, group=group)
        return
    _check_grouped(args, k, rows, group)


def _grouped_traps(rng, q, n, m, ctot, dtype, rows):
    """``_window_traps``, and a row every query names, a query naming one
    row many times, and a window no query names."""
    data, queries, ids = _window_traps(rng, q, n, m, ctot, dtype, rows)
    ids[:, ctot // 2] = rows + 3                     # every query names it
    if q > 2:
        ids[1, ctot // 3:] = 2 * rows + 5            # one row, many times
    hole = (ids >= 3 * rows) & (ids < 4 * rows)       # window 3: no query's
    ids[hole] = -1
    return data, queries, ids


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 64, 130])
@pytest.mark.parametrize("m", [128, 960, 101])    # kRegVec, kSharedVec, kScalar
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_fused_rerank_grouped_traps(card, dtype, m, q):
    """The grouped path at each read mode, at Q from a partial group to
    several, on the windowed traps: ids < 0 and >= n, repeats, copies in the
    next chunk, window edges, a row every query names, a query naming one
    row many times, a window no query names; at forced groups of 2, the
    planner's most for the shape, and one dividing no Q; and by the rule.
    int16 rows are refused a group and take the rule's (query, window) or
    sliced path."""
    rng = np.random.default_rng(q * 7 + m)
    n, ctot, k, rows = 6000, tfr.WINDOW_PART + 700, 10, 256
    args = [_t(x).to(card) for x in _grouped_traps(rng, q, n, m, ctot, dtype, rows)]
    most = max(g for g in range(2, tfr.WINDOW_GROUP_MAX + 1)
               if tfr.group_smem_bytes(m, k, g, rows, 2) <= tfr.WINDOW_SMEM_LIMIT)
    for group in sorted({2, 7, most}):
        if dtype == np.int16:
            with pytest.raises(ValueError, match="int32"):
                tfr.fused_rerank_cuda(args[0], args[1], args[2].clone(), k, window_rows=rows,
                                      group=group)
        else:
            _check_grouped(args, k, rows, group, f"group={group}")
    dev = card.index or 0
    g = tfr.plan_group(q, n, m, np.dtype(dtype).itemsize, ctot, k, tfr.smem_optin(dev))
    assert dtype == np.int32 or g == 1
    want = tfr.fused_rerank_plain(*args, k)
    got = tfr.fused_rerank_cuda(args[0], args[1], args[2].clone(), k, group=g)
    _eq(want[0].cpu(), got[0].cpu(), f"rule group={g}")
    _eq(want[1].cpu(), got[1].cpu(), f"rule group={g}")


@pytest.mark.cuda
def test_fused_rerank_grouped_largest_k(card):
    """The largest k a group of 64 queries of 128 values takes (its lists
    fill the opt-in shared memory; the wrapper's check of the sliced
    kernel's holds too), over a full group and a partial one."""
    dtype = np.int32
    rng = np.random.default_rng(11)
    n, m, q, ctot, rows, group = 3000, 128, 70, 2000, 512, tfr.WINDOW_GROUP_MAX
    k = max(kk for kk in range(1, 1000)
            if tfr.group_smem_bytes(m, kk, group, rows, 1) <= tfr.WINDOW_SMEM_LIMIT
            and 64 * kk + 4 * m <= tfr.SMEM_LIMIT)
    assert k > 200
    args = [_t(x).to(card) for x in _grouped_traps(rng, q, n, m, ctot, dtype, rows)]
    _check_grouped(args, k, rows, group, f"k={k}")


@pytest.mark.cuda
def test_fused_rerank_paths_counted(card):
    """``PATHS['fused_rerank']`` counts each launch by the path it took: the
    rule picks the windowed path where the batch names each row often and
    the sliced one where it does not; ``take_path`` gives the launching
    thread each path (and the windows) once; ``LAUNCHES`` counts both
    alike."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(5)
    n, m, k = 200_000, 128, 10
    data = _t(rng.integers(0, 256, (n, m)).astype(np.int32)).to(card)
    rule = tfr.plan_call(data, 256, 32_768, k)
    assert rule is not None and rule.windows >= 2
    _build.reset_launches()
    for q, ctot, path in ((256, 32_768, "windowed"), (4, 4096, "sliced")):
        queries = _t(rng.integers(0, 256, (q, m)).astype(np.int32)).to(card)
        ids = _t(rng.integers(-1, n + 1, (q, ctot)).astype(np.int32)).to(card)
        want = tfr.fused_rerank_plain(data, queries, ids, k)
        got = ops.fused_rerank(data, queries, ids, k)
        _eq(want[0].cpu(), got[0].cpu())
        _eq(want[1].cpu(), got[1].cpu())
        took, detail = _build.take_path("fused_rerank")
        assert took == path
        assert ops.rerank_attrs(took, detail)["windows"] == (
            rule.windows if path == "windowed" else 0)
        assert _build.take_path("fused_rerank") is None
    assert _build.PATHS["fused_rerank"] == {"sliced": 1, "windowed": 1}
    assert _build.LAUNCHES["fused_rerank"] == 2
    _build.reset_launches()
    assert _build.PATHS["fused_rerank"] == {"sliced": 0, "windowed": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(set(RERANK_CASES) - set(KERNEL_RERANK_CASES)))
def test_serving_on_card_refuses_distances_beyond_big_dist(card, name):
    """The rerank cases outside the kernel's contract (a valid distance >=
    BIG_DIST) never reach it from the serving path: an index on the card
    holding their data refuses their queries."""
    data, queries, ids, k = RERANK_CASES[name]
    assert reaches_big(RERANK_CASES[name])
    cfg = IndexConfig(num_tables=2, num_hashes=4, width=24, num_probes=8,
                      candidate_cap=8, universe=64, k=k, hash_impl="thermo")
    eng = AnnServingEngine(cfg, ServeConfig(batch_size=4, warm_buckets=False,
                                            cand_cap_sample=2), data, device="cuda")
    with pytest.raises(ValueError, match="BIG_DIST"):
        eng.query_batch(queries)


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
@pytest.mark.parametrize("name", sorted(RW_HASH_CASES))
def test_rw_prefix_table_kernel_matches_plain(card, name):
    pairs = _t(RW_HASH_CASES[name][0]).to(card)
    want = trw.rw_prefix_table_plain(pairs, trw.padded_fns(pairs.shape[0]))
    got = trw.rw_prefix_table_cuda(pairs)
    torch.cuda.synchronize()
    _eq(want.cpu(), got.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 2, 3, 7, "m"])
@pytest.mark.parametrize("name", sorted(RW_HASH_CASES))
def test_rw_hash_kernel_at_each_split(card, name, slices):
    """The hash kernel with the dimensions split over a fixed number of
    slices (one, a few, one dimension each) equals plain: the atomics add
    the same bits in any order."""
    pairs, pts = (_t(x).to(card) for x in RW_HASH_CASES[name])
    want = trw.rw_hash_plain(pairs, pts)
    got = trw.rw_hash_cuda(pairs, pts, slices=pairs.shape[1] if slices == "m" else slices)
    torch.cuda.synchronize()
    _eq(want.cpu(), got.cpu())


@pytest.mark.cuda
def test_rw_hash_kernel_at_the_u2_limit(card):
    """U2 up to the device's one-window limit equals plain (a table over
    48 KB of shared memory, scan segments of many steps), and so does one
    step more, which takes a second window."""
    rng = np.random.default_rng(5)
    limit = trw.max_u2()
    assert limit >= 1000
    for u2 in (1000, limit, limit + 1):
        pairs = torch.from_numpy(
            (2 * rng.integers(0, 2, (33, 3, u2, 2)) - 1).sum(-1).astype(np.int8)).to(card)
        pts = torch.from_numpy(
            rng.integers(-9, 2 * u2 + 9, (50, 3)).astype(np.int32)).to(card)
        _eq(trw.rw_hash_plain(pairs, pts).cpu(), trw.rw_hash_cuda(pairs, pts).cpu(),
            f"U2={u2}")
    assert trw.plan_rw_windows(limit, limit) == (limit, 1)
    assert trw.plan_rw_windows(limit + 1, limit) == (limit, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [None, 1, 5])
@pytest.mark.parametrize("beyond", [1, 8192])
def test_rw_hash_kernels_beyond_one_window(card, beyond, slices):
    """U2 of the limit + 1 and 8,192 (several windows): the table kernel and
    the hash kernel equal plain bit for bit, on in-range, odd, negative,
    above-universe and int32-extreme coordinates, at rows over two row
    tiles and dimensions over two 16-dimension chunks."""
    u2 = trw.max_u2() + 1 if beyond == 1 else beyond
    rng = np.random.default_rng(u2)
    pairs = torch.from_numpy(
        (2 * rng.integers(0, 2, (37, 18, u2, 2)) - 1).sum(-1).astype(np.int8)).to(card)
    pts = rng.integers(-40, 2 * u2 + 40, (600, 18)).astype(np.int32)
    pts[:50] = (rng.integers(0, u2 + 1, (50, 18)) * 2)
    pts[50] = np.iinfo(np.int32).min
    pts[51] = np.iinfo(np.int32).max
    pts = torch.from_numpy(pts).to(card)
    _eq(trw.rw_prefix_table_plain(pairs, trw.padded_fns(37)).cpu(),
        trw.rw_prefix_table_cuda(pairs).cpu(), "table")
    _eq(trw.rw_hash_plain(pairs, pts).cpu(), trw.rw_hash_cuda(pairs, pts, slices=slices).cpu(),
        "hash")


@pytest.mark.cuda
def test_walk_range_on_the_card(card):
    """The gather hash and a served batch with an out-of-range query and an
    out-of-range insert, on the card: no device assert, and the CPU's bits
    (which equal the JAX package's, tests/test_torch_walks_range.py)."""
    from repro_torch.core import walks as tw
    from repro_torch.core.index import make_params
    from repro_torch.core.segments import SegmentedIndex
    from test_torch_cases import WALK_RANGE_U, walk_range_case
    coords, data, inserts, queries = walk_range_case()
    cfg = IndexConfig(num_tables=3, num_hashes=6, width=8, num_probes=12, candidate_cap=16,
                      universe=WALK_RANGE_U, k=5, rerank_chunk=64)
    params = make_params(cfg, data.shape[1], seed=4)
    _eq(tw.eval_prefix(params.walks, _t(coords)),
        tw.eval_prefix(params.walks.to(card), _t(coords).to(card)).cpu())
    out = []
    for dev in ("cpu", card):
        idx = SegmentedIndex.from_dataset(cfg, data, delta_cap=64, params=params, device=dev)
        idx.insert(inserts)
        idx.delete([5, 257])
        got = [idx.query_compact(_t(queries).to(dev))[:2]]
        idx.compact()
        got.append(idx.query_compact(_t(queries).to(dev))[:2])
        torch.cuda.synchronize()
        out.append([(d.cpu(), i.cpu()) for d, i in got])
    for (cd, ci), (gd, gi) in zip(*out):
        _eq(cd, gd)
        _eq(ci, gi)


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
@pytest.mark.parametrize("wide", [False, True])
def test_l1_distance_kernel_at_scale(card, wide):
    """64 x 300,000 x 128 in [0, 510]: every block runs the float loop; with
    one value at 2^30, the blocks of its point tile run the int32 loop for
    that value's stage."""
    gen = torch.Generator(device=card).manual_seed(18)
    q = torch.randint(0, 511, (64, 128), generator=gen, device=card, dtype=torch.int32)
    x = torch.randint(0, 511, (300_000, 128), generator=gen, device=card, dtype=torch.int32)
    if wide:
        x[123_457, 77] = 1 << 30
    want = tl1.l1_distance_plain(q, x)
    got = tl1.l1_distance_cuda(q, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_l1_distance_kernel_non_integer_floats(card):
    """Non-integer float32 values: the kernel adds the m terms in order, the
    plain version in torch's order; 64 float32 additions of positive terms
    differ by at most 63 * 2^-24 (3.8e-6) relative, so rtol 1e-5."""
    rng = np.random.default_rng(4)
    q = _t(rng.uniform(-3, 3, (70, 64)).astype(np.float32)).to(card)
    x = _t(rng.uniform(-3, 3, (300, 64)).astype(np.float32)).to(card)
    want = tl1.l1_distance_plain(q, x)
    got = tl1.l1_distance_cuda(q, x)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_l1_distance_query_limit(card):
    """The grid's y axis holds 65,535 query tiles of 64: one query more raises."""
    q = torch.zeros((64 * 65_535 + 1, 1), dtype=torch.int32, device=card)
    x = torch.zeros((3, 1), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        tl1.l1_distance_cuda(q, x)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int32", "int16", "float32", "bfloat16"])
def test_l1_distance_rows_kernel_misaligned(card, dtype):
    """Contiguous views one element into their storage (rows, then queries):
    not 16-byte aligned, so ``plan_rows`` puts the kernel on the scalar
    path, and it still equals the plain version; the aligned tensors take
    the vector path."""
    rng = np.random.default_rng(28)
    queries, rows = rng.integers(-200, 200, (4, 128)), rng.integers(-200, 200, (4, 300, 128))
    q, r = _typed(queries, dtype, card), _typed(rows, dtype, card)
    flat_r = torch.empty(r.numel() + 1, dtype=r.dtype, device=card)
    flat_q = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
    r1 = flat_r[1:].view(r.shape).copy_(r)
    q1 = flat_q[1:].view(q.shape).copy_(q)
    want = tl1.l1_distance_rows_plain(q, r)
    for args, path in (((q, r), "vector"), ((q, r1), "scalar"), ((q1, r), "scalar")):
        assert args[0].is_contiguous() and args[1].is_contiguous()
        plan = tl1.plan_rows(args[0].dtype, r.shape[2], r.shape[1], r.shape[0],
                             args[1].data_ptr(), args[0].data_ptr())
        assert ("vector" if plan.slots else "scalar") == path
        got = tl1.l1_distance_rows_cuda(*args)
        torch.cuda.synchronize()
        _eq(want.cpu(), got.cpu())


@pytest.mark.cuda
def test_staged_probe_and_concat_fold_on_the_card(card):
    """``probe_impl='staged'`` (plain searches and gather, then the rerank
    kernel) equals the fused probe's kernels, and the concat fold of a
    fragmented index equals the ``topk_merge`` fold, bit for bit."""
    import dataclasses
    from repro_torch.core import index as tidx
    from repro_torch.core.segments import SegmentedIndex
    from repro_torch.data import ann_synthetic as ds
    spec = ds.DatasetSpec("staged", n=2000, dim=16, universe=64, num_clusters=8)
    data = ds.make_dataset(spec)
    q = _t(ds.make_queries(spec, data, 12)).to(card)
    cfg = IndexConfig(num_tables=3, num_hashes=8, width=24, num_probes=20,
                      candidate_cap=16, universe=64, k=8, rerank_chunk=128)
    state = tidx.build_index(cfg, _t(data).to(card))
    staged = tidx.query_index(dataclasses.replace(cfg, probe_impl="staged"), state, q)
    fused = tidx.query_index(cfg, state, q)
    for a, b in zip(staged, fused):
        _eq(a.cpu(), b.cpu())
    frag = SegmentedIndex.from_dataset(cfg, data[:900], delta_cap=200, device=card)
    frag.insert(data[900:1500])
    assert frag.num_segments >= 3 and frag.delta_fill > 0
    for got, want in ((frag.query(q, use_merge_kernel=False), frag.query(q)),
                      (frag.query_compact(q, 64, False)[:2], frag.query_compact(q, 64)[:2])):
        _eq(got[0].cpu(), want[0].cpu())
        _eq(got[1].cpu(), want[1].cpu())


@pytest.mark.cuda
def test_rerank_slots_count_one_compacted_batch(card):
    """``SLOTS['fused_rerank']`` grows by Q x the rung for one compacted
    batch of a one-segment index with no delta (one rerank launch), and
    ``reset_launches`` zeroes it with the launch counts."""
    from repro_torch.core.segments import SegmentedIndex
    from repro_torch.data import ann_synthetic as ds
    from repro_torch.kernels import _build
    spec = ds.DatasetSpec("slots", n=2000, dim=16, universe=64, num_clusters=8)
    data = ds.make_dataset(spec)
    q = _t(ds.make_queries(spec, data, 12)).to(card)
    cfg = IndexConfig(num_tables=3, num_hashes=8, width=24, num_probes=20,
                      candidate_cap=16, universe=64, k=8)
    index = SegmentedIndex.from_dataset(cfg, data, device=card)
    assert index.num_segments == 1 and index.delta_fill == 0
    _build.reset_launches()
    assert _build.SLOTS == {"fused_rerank": 0}
    _, _, used = index.query_compact(q, 64)
    torch.cuda.synchronize()
    (_, rung, _), = used
    assert _build.LAUNCHES["fused_rerank"] == 1
    assert _build.SLOTS["fused_rerank"] == q.shape[0] * rung
    _build.reset_launches()
    assert _build.SLOTS["fused_rerank"] == 0 and _build.LAUNCHES["fused_rerank"] == 0


@pytest.mark.cuda
def test_tombstone_skip_on_the_card_matches_cpu(card):
    """A one-segment index on the card answers ``query_compact`` as the same
    index on the CPU, before and after a delete of each query's nearest
    point, and ``tombstone_passes`` counts one skipped pass (nothing
    deleted) and then one masked pass."""
    from repro_torch.core.segments import SegmentedIndex
    from repro_torch.data import ann_synthetic as ds
    spec = ds.DatasetSpec("tomb", n=2000, dim=16, universe=64, num_clusters=8)
    data = ds.make_dataset(spec)
    q = _t(ds.make_queries(spec, data, 12))
    cfg = IndexConfig(num_tables=3, num_hashes=8, width=24, num_probes=20,
                      candidate_cap=16, universe=64, k=8)
    on_cpu = SegmentedIndex.from_dataset(cfg, data, device="cpu")
    on_card = SegmentedIndex.from_dataset(cfg, data, params=on_cpu.params, device=card)
    for when in ("fresh", "after a delete"):
        want = on_cpu.query_compact(q, 64)
        got = on_card.query_compact(q.to(card), 64)
        torch.cuda.synchronize()
        _eq(want[0], got[0].cpu(), f"dists, {when}")
        _eq(want[1], got[1].cpu(), f"gids, {when}")
        assert got[2] == want[2]
        if when == "fresh":
            assert on_card.tombstone_passes == {"masked": 0, "skipped": 1}
            nearest = np.unique(want[1][:, 0].numpy())
            assert on_cpu.delete(nearest) == on_card.delete(nearest) == len(nearest)
    assert on_card.tombstone_passes == {"masked": 1, "skipped": 1}
    assert not set(got[1].cpu().numpy().ravel().tolist()) & set(nearest.tolist())


@pytest.mark.cuda
def test_cluster_router_on_the_card(card, tmp_path):
    """The in-process router with its replicas on the card, the kernels
    launched from its pool's threads, equals the same router on the CPU bit
    for bit: fresh, after mutations, and after a kill and recovery."""
    from repro_torch.cluster import ClusterConfig, ClusterRouter
    from repro_torch.data import ann_synthetic as ds
    from repro_torch.kernels import _build
    spec = ds.DatasetSpec("cluster-card", n=900, dim=16, universe=64, num_clusters=8)
    data = ds.make_dataset(spec)
    queries = ds.make_queries(spec, data, 24)
    cfg = IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=20,
                      candidate_cap=256, universe=64, k=8, rerank_chunk=128)
    serve = ServeConfig(batch_size=16, delta_cap=128)
    routers = [ClusterRouter(cfg, serve, ClusterConfig(wal_fsync=False, cache_capacity=0),
                             data, str(tmp_path / dev), device=dev) for dev in ("cpu", "cuda")]
    _build.reset_launches()

    def same():
        (hd, hi), (cd, ci) = (r.query(queries) for r in routers)
        _eq(hd, cd)
        _eq(hi, ci)

    same()
    for r in routers:
        g = r.insert((queries[:6] + 2).astype(np.int32))
        r.delete([0, 3, int(g[1])])
    same()
    for r in routers:
        r.kill_replica(0, 0)
        r.delete([int(g[2])])
        r.recover_replica(0, 0)
        r.kill_replica(0, 1)
    same()
    assert _build.LAUNCHES["topk_merge"] > 0 and _build.LAUNCHES["fused_rerank"] > 0
    for r in routers:
        r.close()


@pytest.mark.cuda
def test_process_router_on_the_card(card, tmp_path):
    """A 2 x 2 process router whose workers run their engines on the card
    equals the same router with its workers on the CPU, bit for bit: fresh,
    after mutations, and through a SIGKILL, failover and recovery.  Each
    card worker's telemetry reports device ``cuda`` and its own launches of
    the probe's two kernels and the rerank; the parent folds with
    ``topk_merge`` on the card."""
    from repro_torch.cluster import ClusterConfig, ClusterRouter
    from repro_torch.data import ann_synthetic as ds
    from repro_torch.kernels import _build
    spec = ds.DatasetSpec("cluster-card", n=900, dim=16, universe=64, num_clusters=8)
    data = ds.make_dataset(spec)
    queries = ds.make_queries(spec, data, 24)
    cfg = IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=20,
                      candidate_cap=256, universe=64, k=8, rerank_chunk=128)
    serve = ServeConfig(batch_size=16, delta_cap=128)
    ccfg = ClusterConfig(transport="process", hedge_ms=60000, wal_fsync=False,
                         cache_capacity=0)
    routers = [ClusterRouter(cfg, serve, ccfg, data, str(tmp_path / dev), device=dev)
               for dev in ("cpu", "cuda")]
    _build.reset_launches()

    def same():
        (hd, hi), (cd, ci) = (r.query(queries) for r in routers)
        _eq(hd, cd)
        _eq(hi, ci)

    try:
        same()
        for r in routers:
            g = r.insert((queries[:6] + 2).astype(np.int32))
            r.delete([0, 3, int(g[1])])
        same()
        for r in routers:
            r.replicas[0][0].handle.sigkill()      # unannounced
            r._rr[0] = 0                           # the dead worker is preferred
        same()
        for r in routers:
            r.delete([int(g[2])])
            r.recover_replica(0, 0)
            r.kill_replica(0, 1)
        same()
        for group in routers[1].replicas:
            for rep in group:
                if rep.alive:
                    t = rep.telemetry()
                    assert t["device"] == "cuda"
                    assert all(t["launches"][k] > 0 for k in (
                        "fused_probe_extents", "fused_probe_gather", "fused_rerank"))
        assert routers[1].summary()["failovers"] >= 1
        assert _build.LAUNCHES["topk_merge"] > 0
    finally:
        for r in routers:
            r.close()


@pytest.mark.cuda
def test_checkpoint_restore_defaults_to_the_card(card, tmp_path):
    """``CheckpointManager.restore`` with no ``device`` puts every leaf on
    the card, as the JAX package's restore puts it on the accelerator."""
    from repro_torch.ckpt import CheckpointManager
    tree = {"w": torch.arange(6, dtype=torch.float32), "m": {"n": torch.tensor(3)}}
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, tree)
    step, back = mgr.restore_latest(tree)
    assert step == 1 and back["w"].device.type == "cuda" and back["m"]["n"].is_cuda
    assert torch.equal(back["w"].cpu(), tree["w"])


@pytest.mark.cuda
def test_dist_ranks_on_the_card_match_cpu_ranks(card):
    """Two gloo ranks sharing the card (the exchanges through the host)
    answer as the same two ranks on the CPU, bit for bit, under every merge
    and on both meshes; the card ranks launch the probe's two kernels, the
    rerank and (for the ring and tree folds) ``topk_merge``.  'nccl' with
    more ranks than cards raises before any rank starts."""
    from repro_torch.core.index import make_params
    from repro_torch.data import ann_synthetic as ds
    from repro_torch.launch import dist_index as di
    spec = ds.DatasetSpec("dist-card", n=2048, dim=16, universe=64, num_clusters=8)
    data = ds.make_dataset(spec)
    queries = ds.make_queries(spec, data, 16)
    cfg = IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=20,
                      candidate_cap=32, universe=64, k=8, rerank_chunk=128)
    params = make_params(cfg, 16)
    runs = [{"shape": (2, 1), "cfg": cfg, "params": params, "merge": m} for m in di.MERGES]
    runs.append({"shape": (1, 2), "cfg": cfg, "params": params})
    got = {dev: di.spawn_ranks(2, di.run_meshes, data, queries, runs, backend="gloo",
                               device=dev, timeout_s=300) for dev in ("cpu", "cuda")}
    for k in range(len(runs)):
        want = di.assemble([rep["result"] for rep in got["cpu"]], k)
        card_out = di.assemble([rep["result"] for rep in got["cuda"]], k)
        _eq(want[0], card_out[0])
        _eq(want[1], card_out[1])
    for rep in got["cuda"]:
        assert rep["device"] == "cuda:0" or torch.cuda.device_count() > 1
        assert all(r["exchange"] == "host" for r in rep["result"])
        assert all(rep["launches"][k] > 0 for k in (
            "fused_probe_extents", "fused_probe_gather", "fused_rerank", "topk_merge"))
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="two ranks on one card"):
            di.spawn_ranks(2, di.run_meshes, data, queries, runs, backend="nccl",
                           device="cuda")


@pytest.mark.cuda
def test_quickstart_on_the_card(card, monkeypatch):
    """The quickstart example at its own sizes on the card (its recall), and
    at a shrunk spec the card's (d, i) == the CPU's, bit for bit."""
    from repro_torch.data import ann_synthetic as ds
    from repro_torch.examples import quickstart
    full = quickstart.main(device="cuda")
    assert full["answers"]["query"][1].shape == (quickstart.NUM_QUERIES, 10)
    assert 0.5 <= full["recall"] <= 1.0
    monkeypatch.setattr(quickstart, "SPEC", ds.DatasetSpec(
        "quickstart", n=2000, dim=16, universe=128, num_clusters=8))
    monkeypatch.setattr(quickstart, "NUM_QUERIES", 16)
    on_card, on_cpu = quickstart.main(device="cuda"), quickstart.main(device="cpu")
    for card_t, cpu_t in zip(on_card["answers"]["query"], on_cpu["answers"]["query"]):
        _eq(card_t, cpu_t)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm_360m", "granite_moe_3b_a800m", "zamba2_1_2b",
                                  "seamless_m4t_medium"])
def test_lm_reduced_on_the_card_matches_cpu(card, arch):
    """A reduced arch's prefill and 4 decode steps with the same draws on the
    card and the CPU, float32 with TF32 off, within 1e-3."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    cfg = get_reduced(arch)
    params = M.init_params(cfg, device="cpu")
    toks = _t(np.random.default_rng(0).integers(1, cfg.vocab, (2, 8)).astype(np.int32))
    batch = {"tokens": toks}
    if cfg.kind == "encdec":
        batch["frontend"] = torch.full((2, cfg.frontend_len, cfg.d_model), 0.02)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for dev in ("cpu", card):
            p = tf.tree_map(lambda t: t.to(dev), params)
            b = {k: v.to(dev) for k, v in batch.items()}
            ekv = None
            if cfg.kind == "encdec":
                ekv = tf.encode_cross_kv(p, cfg, tf.encoder_stack(p, cfg, b["frontend"]))
            got = [M.prefill(p, cfg, b)]
            caches = M.make_caches(cfg, 2, 6, torch.float32, device=dev)
            for i in range(4):
                lg, caches = M.decode_step(p, cfg, caches, b["tokens"][:, i:i + 1], i,
                                           enc_kv=ekv)
                got.append(lg)
            outs.append([g.cpu() for g in got])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm_360m", "granite_moe_3b_a800m", "zamba2_1_2b",
                                  "seamless_m4t_medium"])
def test_train_step_on_the_card_matches_cpu(card, arch):
    """A reduced arch's gradient and one train step with the same draws on
    the card and the CPU, float32 with TF32 off: each gradient leaf within
    1e-3 of the CPU leaf's max |g|; the loss and grad norm within 1e-4
    relative; every parameter after the step within 2 lr plus 1e-4 of its
    leaf's max (one step from zero moments: a sign flip of a gradient near
    zero moves its parameter by 2 lr)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.lm_synthetic import LmDataConfig, batch_at_step
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step, value_and_grad
    cfg = get_reduced(arch)
    params = M.init_params(cfg, device="cpu")
    tokens, labels = batch_at_step(LmDataConfig(vocab=cfg.vocab, global_batch=4, seq_len=32), 0)
    batch = {"tokens": _t(tokens), "labels": _t(labels)}
    if cfg.frontend or cfg.kind == "encdec":
        # not a constant: equal keys would leave the cross-attention's K/V
        # weights a gradient of rounding noise alone
        batch["frontend"] = _t(np.random.default_rng(2).normal(
            0, 0.02, (4, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    opt = OptConfig(lr=5e-4, warmup_steps=1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for dev in ("cpu", card):
            p = tf.tree_map(lambda t: t.to(dev), params)
            b = {k: v.to(dev) for k, v in batch.items()}
            (_, metrics), grads = value_and_grad(cfg)(p, b)
            new, _, m = make_train_step(cfg, opt)(p, init_opt_state(p, opt), b)
            outs.append(([float(metrics["loss"]), float(m["grad_norm"])],
                         [g.cpu() for g in tf.tree_leaves(grads)],
                         [t.cpu() for t in tf.tree_leaves(new)]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (want_v, want_g, want_p), (got_v, got_g, got_p) = outs
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4)
    for w, g in zip(want_g, got_g):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max()) + 1e-12
    for w, g in zip(want_p, got_p):
        assert float((g - w).abs().max()) <= 2 * opt.lr + 1e-4 * float(w.abs().max())
