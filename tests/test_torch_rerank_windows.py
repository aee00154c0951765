"""The windowed rerank's plan and decomposition, on the CPU.

``plan_windows`` is a pure function of the shapes and the card's L2 size:
here it is pinned at the served shapes and at the edges of its rule.  The
CUDA kernel's windowed path partitions each (query, chunk) of the ids in
place by window, reranks each (query, window) item and merges the items'
lists; here a plain-torch model of the partition is checked for what the
kernel relies on, and its per-window top-k lists, each from
``fused_rerank_plain``, merged with equal keys skipped, must equal
``fused_rerank_plain`` of the whole row bit for bit.  The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py).
Last, the path a launch took, as ``_build.take_path`` gives it to the
``stage_rerank`` span."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.index import IndexConfig
from repro_torch.data import ann_synthetic as ds
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fused_rerank as tfr
from repro_torch.obs import render as trender
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import AnnServingEngine, ServeConfig
from test_torch_cases import KERNEL_RERANK_CASES

torch.set_num_threads(1)
_EMPTY = torch.iinfo(torch.int64).max
L2_H100 = 50 << 20           # cudaDevAttrL2CacheSize of an H100 80GB HBM3
G_H100 = 528                 # the windowed kernel's resident blocks there (4 an SM)


def _partition(ids, n, shift, part):
    """The kernel's phase 1 on one (Q, ctot) int32 tensor: each chunk of
    ``part`` slots holds its valid ids at its front grouped by window
    (``id >> shift``), a later slot that held a valid id -1, the others as
    they were; returns the new ids and the (Q, chunks, windows + 1) bin
    starts (the last the chunk's valid count)."""
    q, ctot = ids.shape
    windows = -(-n // (1 << shift))
    chunks = -(-ctot // part)
    out = ids.clone()
    offsets = torch.zeros((q, chunks, windows + 1), dtype=torch.int64)
    for r in range(q):
        for c in range(chunks):
            chunk = ids[r, c * part:(c + 1) * part]
            valid = chunk[(chunk >= 0) & (chunk < n)]
            bins = valid.to(torch.int64) >> shift
            counts = torch.bincount(bins, minlength=windows)
            offsets[r, c, 1:] = torch.cumsum(counts, 0)
            order = torch.argsort(bins, stable=True)
            dst = out[r, c * part:(c + 1) * part]
            held = (chunk >= 0) & (chunk < n)
            held[:valid.numel()] = False
            dst[held] = -1
            dst[:valid.numel()] = valid[order]
    return out, offsets


def _window_ids(ids, offsets, part, w):
    """Item (row, w)'s ids, gathered from each chunk's segment; -1 pads."""
    rows = []
    for r in range(ids.shape[0]):
        segs = [ids[r, c * part + int(offsets[r, c, w]):c * part + int(offsets[r, c, w + 1])]
                for c in range(offsets.shape[1])]
        rows.append(torch.cat(segs))
    width = max(1, max(x.numel() for x in rows))
    out = torch.full((ids.shape[0], width), -1, dtype=torch.int32)
    for r, x in enumerate(rows):
        out[r, :x.numel()] = x
    return out


def _keys(d, i):
    return torch.where(i < 0, _EMPTY, (d.to(torch.int64) << 32) | i.to(torch.int64))


def _merge(lists, k):
    """First k unique keys of the union of sorted key lists, as (d, i)."""
    q = lists[0].shape[0]
    d = torch.full((q, k), tfr.BIG_DIST, dtype=torch.int32)
    i = torch.full((q, k), -1, dtype=torch.int32)
    union = torch.cat(lists, dim=1)
    for r in range(q):
        keys = torch.unique(union[r])
        keys = keys[keys != _EMPTY][:k]
        d[r, :keys.numel()] = (keys >> 32).to(torch.int32)
        i[r, :keys.numel()] = (keys & 0xFFFFFFFF).to(torch.int32)
    return d, i


def _check_partition(data, queries, ids, k, shift, part):
    n = data.shape[0]
    new, offsets = _partition(ids, n, shift, part)
    windows = offsets.shape[2] - 1
    # offsets monotone, the last the chunk's valid count
    assert bool((offsets[..., 1:] >= offsets[..., :-1]).all())
    for c in range(offsets.shape[1]):
        chunk = ids[:, c * part:(c + 1) * part]
        assert torch.equal(offsets[:, c, -1], ((chunk >= 0) & (chunk < n)).sum(1))
    # every valid id once in its window's segment; the row's valid multiset kept
    for w in range(windows):
        got = _window_ids(new, offsets, part, w)
        got = got[got >= 0]
        assert bool(((got.to(torch.int64) >> shift) == w).all())
    valid = lambda t: torch.sort(torch.where((t >= 0) & (t < n), t, -1), dim=1).values
    assert torch.equal(valid(new), valid(ids))
    # the per-window lists merged equal the whole row's top-k, in any order
    whole = tfr.fused_rerank_plain(data, queries, ids, k)
    lists = [_keys(*tfr.fused_rerank_plain(data, queries, _window_ids(new, offsets, part, w), k))
             for w in range(windows)]
    for order in (lists, lists[::-1]):
        got = _merge(order, k)
        assert torch.equal(whole[0], got[0]) and torch.equal(whole[1], got[1])
    # and the reordered ids rerank to the same answer
    again = tfr.fused_rerank_plain(data, queries, new, k)
    assert torch.equal(whole[0], again[0]) and torch.equal(whole[1], again[1])


@pytest.mark.parametrize("part", [tfr.WINDOW_PART, 64, 7])
@pytest.mark.parametrize("shift", [1, 3, 6])
@pytest.mark.parametrize("name", sorted(KERNEL_RERANK_CASES))
def test_partition_model_merges_to_the_whole(name, shift, part):
    data, queries, ids, k = KERNEL_RERANK_CASES[name]
    _check_partition(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (data, queries, ids)),
                     k, shift, part)


def test_partition_model_over_several_kernel_chunks():
    """Rows of more than one of the kernel's chunks, ids at window edges,
    each id twice, copies in the next chunk, -1 and n, a row without a
    valid id and one with a single id (k above the valid count)."""
    rng = np.random.default_rng(35)
    n, m, q, ctot, k, shift = 5000, 24, 4, 2 * tfr.WINDOW_PART + 300, 10, 8
    data = torch.from_numpy(rng.integers(0, 60, (n, m)).astype(np.int32))
    queries = torch.from_numpy(rng.integers(0, 60, (q, m)).astype(np.int32))
    ids = rng.integers(-1, n + 1, (q, ctot)).astype(np.int32)
    edges = np.arange(0, n, 1 << shift)
    ids[:, :3 * edges.size] = np.concatenate([edges - 1, edges, edges + 1])
    ids[:, 1::2] = ids[:, 0::2][:, :ids[:, 1::2].shape[1]]
    ids[:, tfr.WINDOW_PART:tfr.WINDOW_PART + 500] = ids[:, :500]
    ids[2] = -1
    ids[3, 1:] = n
    _check_partition(data, queries, torch.from_numpy(ids), k, shift, tfr.WINDOW_PART)


# (q, n, m, itemsize, ctot, k) of the cells' batches and others, and what the
# rule gives on an H100
@pytest.mark.parametrize("shape,want", [
    ((1024, 1_000_000, 960, 4, 131_072, 10), (12, 245, 16, 8_146_960)),    # gist1m.bulk1024
    ((1024, 1_000_000, 960, 4, 205_824, 10), (12, 245, 26, 13_185_040)),   # its top rung
    ((1024, 1_000_000, 960, 2, 131_072, 10), (13, 123, 16, 4_149_264)),    # int16 rows
    ((32, 1_000_000, 960, 4, 131_072, 10), (10, 977, 16, 1_004_176)),      # reuse 4.2: L2 / 8
    ((64, 1_000_000, 128, 4, 131_072, 10), (13, 123, 16, 259_344)),        # a 64-query batch
    ((256, 1_000_000, 128, 4, 131_072, 10), (14, 62, 16, 537_616)),        # Q / 2G of L2
    ((1024, 50_000_000, 128, 4, 262_144, 10), (16, 763, 32, 50_155_536)),  # sift50m.bulk1024
    ((1024, 50_000_000, 128, 4, 411_648, 10), (17, 382, 51, 40_089_616)),  # ... its top rung
    ((1024, 25_000_000, 128, 4, 411_648, 10), (16, 382, 51, 40_089_616)),  # bigann100m.dist4
    ((16_384, 1_000_000, 960, 4, 131_072, 10), (13, 123, 16, 66_387_984)), # offsets: 2x rows
    ((64, 50_000_000, 128, 4, 262_144, 10), None),     # sift50m.online64: reuse 0.34
    ((16, 1_000_000, 960, 4, 131_072, 10), None),      # reuse 2.1 < WINDOW_REUSE_MIN
    ((1024, 2_000, 960, 4, 131_072, 10), None),        # the rows fit one window
    ((1024, 1_000_000, 960, 4, 600_000, 10), None),    # 74 chunks > MAX_WINDOW_CHUNKS
    ((1_000_000, 1_000_000, 960, 4, 131_072, 10), None),   # the lists alone pass the limit
    ((1024, 1_000_000, 960, 4, 131_072, 600), None),   # k=600: shared memory
    ((1024, 0, 960, 4, 131_072, 10), None),
])
def test_plan_windows_rule(shape, want):
    plan = tfr.plan_windows(*shape, L2_H100, G_H100)
    if want is None:
        assert plan is None
        return
    assert (plan.shift, plan.windows, plan.chunks, plan.workspace_bytes) == want
    q, n, m, itemsize, ctot, k = shape
    budget = tfr.window_budget(q, L2_H100, G_H100)
    assert L2_H100 / 8 <= budget <= L2_H100 / 2
    base = 1 << (budget // (m * itemsize)).bit_length() - 1
    assert base * m * itemsize <= budget < 2 * base * m * itemsize
    assert plan.rows >= base
    if plan.rows > base:                 # doubled, as half the rows would not do
        half = -(-n // (plan.rows // 2))
        assert (half > tfr.MAX_WINDOWS or tfr.window_workspace_bytes(q, k, half, plan.chunks)
                > tfr.WINDOW_WORKSPACE_LIMIT)
    assert (plan.windows - 1) * plan.rows < n <= plan.windows * plan.rows
    assert plan.workspace_bytes <= tfr.WINDOW_WORKSPACE_LIMIT
    assert plan.windows <= tfr.MAX_WINDOWS and plan.chunks <= tfr.MAX_WINDOW_CHUNKS
    assert q * ctot >= tfr.WINDOW_REUSE_MIN * n
    assert tfr.window_smem_bytes(m, k) <= tfr.SMEM_LIMIT


def test_plan_windows_gist1m_workspace_within_budget():
    """gist1m's top rung: the lists, locks, ticket and offsets stay within
    40 MB, the 0.79 GiB ids buffer never doubled."""
    plan = tfr.plan_windows(1024, 1_000_000, 960, 4, 205_824, 10, L2_H100, G_H100)
    assert plan.workspace_bytes == 8 * 1024 * 10 + 4 * 1024 + 16 + 2 * 1024 * 26 * 246
    assert plan.workspace_bytes <= 40e6


@pytest.mark.parametrize("rows,n,ctot,want", [
    (1, 40, 24, (0, 40, 1)), (64, 5000, 20_000, (6, 79, 3)),
    (4096, 1_000_000, 131_072, (12, 245, 16)), (1 << 20, 10, 5, (20, 1, 1))])
def test_plan_windows_forced(rows, n, ctot, want):
    """``rows`` forces the path at any reuse, even one window."""
    plan = tfr.plan_windows(1, n, 8, 4, ctot, 5, 0, 0, rows)
    assert (plan.shift, plan.windows, plan.chunks) == want
    assert plan.workspace_bytes == tfr.window_workspace_bytes(1, 5, want[1], want[2])


@pytest.mark.parametrize("rows,n,ctot,m,k", [
    (3, 100, 10, 8, 5),                                   # not a power of two
    (1, tfr.MAX_WINDOWS + 1, 10, 8, 5),                   # too many windows
    (64, 1000, tfr.MAX_WINDOW_CHUNKS * tfr.WINDOW_PART + 1, 8, 5),   # too many chunks
    (64, 1000, 10, 8, 600),                               # shared memory
])
def test_plan_windows_forced_refuses(rows, n, ctot, m, k):
    with pytest.raises(ValueError):
        tfr.plan_windows(1, n, m, 4, ctot, k, 0, 0, rows)


@pytest.mark.parametrize("m,k,want", [(960, 10, 40_992), (128, 10, 40_992),
                                      (4096, 10, 50_388), (128, 200, 48_196)])
def test_window_smem_bytes(m, k, want):
    assert tfr.window_smem_bytes(m, k) == want


def test_take_path_off_the_card():
    """Off the card the rerank is the plain version: it launches nothing, so
    no path is given out."""
    _build.take_path("fused_rerank")
    data = torch.zeros((10, 4), dtype=torch.int32)
    ops.fused_rerank(data, torch.zeros((2, 4), dtype=torch.int32),
                     torch.zeros((2, 5), dtype=torch.int32), 3)
    assert _build.take_path("fused_rerank") is None


def test_take_path_is_each_threads_own():
    """``count_path`` counts every thread's launch in ``PATHS``; each thread
    takes back only its own last path, once."""
    before = dict(_build.PATHS["fused_rerank"])
    _build.take_path("fused_rerank")
    got = {}

    def launch(path, windows):
        _build.count_path("fused_rerank", path, windows)
        got[path] = (_build.take_path("fused_rerank"), _build.take_path("fused_rerank"))

    try:
        _build.count_path("fused_rerank", "sliced")
        threads = [threading.Thread(target=launch, args=("windowed", 245))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert got == {"windowed": (("windowed", 245), None)}
        assert _build.take_path("fused_rerank") == ("sliced", 0)
        assert _build.take_path("fused_rerank") is None
        after = _build.PATHS["fused_rerank"]
        assert after == {"sliced": before["sliced"] + 1, "windowed": before["windowed"] + 1}
    finally:
        _build.PATHS["fused_rerank"].update(before)


def test_traced_rerank_span_names_the_path(monkeypatch, tmp_path):
    """While tracing, each ``stage_rerank`` span carries ``path`` and
    ``windows``: "none" and 0 where no kernel ran, as on the CPU; and the
    windowed launch's ``group``, ``row_loads``, ``pairs`` and phase times
    (``partition_us``, ``items_us``, ``output_us``), zero off it."""
    spec = ds.DatasetSpec("rw-t", n=300, dim=8, universe=32, num_clusters=3)
    data = ds.make_dataset(spec)
    queries = ds.make_queries(spec, data, 8)
    cfg = IndexConfig(num_tables=2, num_hashes=6, width=16, num_probes=10,
                      candidate_cap=16, universe=32, k=4, rerank_chunk=64)
    eng = AnnServingEngine(cfg, ServeConfig(batch_size=8, bucket_min=4, delta_cap=32),
                           data, device="cpu")
    eng.warmup()
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    eng.query_batch(queries)
    obs_trace.flush()
    spans = [r for r in trender.load_spans(str(tmp_path)) if r["name"] == "stage_rerank"]
    assert spans
    assert {(r["args"]["path"], r["args"]["windows"]) for r in spans} == {("none", 0)}
    for r in spans:
        assert {key: r["args"][key] for key in ("group", "row_loads", "pairs", "partition_us",
                                                "items_us", "output_us")} == {
            "group": 0, "row_loads": 0, "pairs": 0, "partition_us": 0.0, "items_us": 0.0,
            "output_us": 0.0}


def _wrap32(v):
    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


def _grouped_model(data, queries, ids, k, shift, part, group, reverse=False):
    """The kernel's grouped windowed path on the CPU: phase 1's partition,
    then (group, window) items in window-major order (``reverse``: the
    opposite order), each on the running lists as they stand: the items'
    ids set one (row, query) bit per distinct pair, the named rows in order
    each with its queries in order, the L1 sum of each pair wrapped to
    int32, each query's keys kept below its running list's worst when the
    item began, the k smallest of them merged into the running list (the
    first k unique keys of the union).  Returns (d, i) and the counters
    (row loads, pairs)."""
    n = data.shape[0]
    x = data.numpy().astype(np.int64)
    qv = queries.numpy().astype(np.int64)
    q = ids.shape[0]
    new, offsets = _partition(ids, n, shift, part)
    windows = offsets.shape[2] - 1
    running = [[] for _ in range(q)]   # sorted unique keys, at most k
    loads = pairs = 0
    items = [(g0, w) for w in range(windows) for g0 in range(0, q, group)]
    for g0, w in (items[::-1] if reverse else items):
        got = _window_ids(new[g0:g0 + group], offsets[g0:g0 + group], part, w).numpy()
        named = {}
        for j, row in enumerate(got):
            for r in row[row >= 0].tolist():
                named.setdefault(r, set()).add(j)
        keys = {j: [] for j in range(got.shape[0])}
        for r in sorted(named):
            loads += 1
            for j in sorted(named[r]):
                pairs += 1
                d = _wrap32(int(np.abs(x[r] - qv[g0 + j]).sum()))
                keys[j].append((d << 32) | r)
        for j, ks in keys.items():
            run = running[g0 + j]
            bound = run[-1] if len(run) == k else _EMPTY
            mine = sorted(set(kk for kk in ks if kk < bound))[:k]
            running[g0 + j] = sorted(set(run) | set(mine))[:k]
    d = torch.full((q, k), tfr.BIG_DIST, dtype=torch.int32)
    i = torch.full((q, k), -1, dtype=torch.int32)
    for r, run in enumerate(running):
        for c, key in enumerate(run):
            d[r, c] = key >> 32
            i[r, c] = key & 0xFFFFFFFF
    return (d, i), (loads, pairs)


def _check_grouped(data, queries, ids, k, shift, part, group):
    n = data.shape[0]
    want = tfr.fused_rerank_plain(data, queries, ids, k)
    distinct = sum(int(np.unique(r[(r >= 0) & (r < n)]).size) for r in ids.numpy())
    for reverse in (False, True):
        (d, i), (loads, pairs) = _grouped_model(data, queries, ids, k, shift, part, group, reverse)
        assert torch.equal(want[0], d) and torch.equal(want[1], i)
        assert pairs == distinct and loads <= pairs


@pytest.mark.parametrize("group", [2, 3, tfr.WINDOW_GROUP_MAX])
@pytest.mark.parametrize("shift", [1, 6])
@pytest.mark.parametrize("name", sorted(KERNEL_RERANK_CASES))
def test_grouped_model_matches_plain(name, shift, group):
    """A plain model of the (group, window) items, at groups of two, three
    (which divides few of the cases' Q) and the most, in either item order,
    equals ``fused_rerank_plain`` bit for bit, the wrapped int32 sum, the
    ties and the repeated ids included; each distinct (query, id) pair is
    computed once."""
    data, queries, ids, k = KERNEL_RERANK_CASES[name]
    _check_grouped(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (data, queries, ids)),
                   k, shift, 64, group)


def test_grouped_model_on_the_traps():
    """Ids out of range (-1, n), a row every query names, a query naming one
    row many times, copies in the next partition chunk, a window no query
    names, a query with no valid id, over two partition chunks."""
    rng = np.random.default_rng(37)
    n, m, q, ctot, k, shift, part = 600, 12, 7, 300, 6, 5, 128
    data = torch.from_numpy(rng.integers(0, 60, (n, m)).astype(np.int32))
    queries = torch.from_numpy(rng.integers(0, 60, (q, m)).astype(np.int32))
    ids = rng.integers(-1, n + 1, (q, ctot)).astype(np.int32)
    ids[:, 150] = 35                           # every query names row 35
    ids[2, 100:] = 77                          # one row, many times
    ids[:, part:part + 40] = ids[:, :40]       # copies in the next chunk
    ids[(ids >= 64) & (ids < 96)] = -1         # window 2 named by no query
    ids[4] = -1                                # no valid id
    _check_grouped(data, queries, torch.from_numpy(ids), k, shift, part, 3)


def test_grouped_model_counts_one_load_a_named_row():
    """Two queries naming the same rows: each row is loaded once an item and
    serves both pairs, so the reuse (pairs / row loads) is 2."""
    data = torch.arange(40, dtype=torch.int32).reshape(10, 4)
    queries = torch.zeros((2, 4), dtype=torch.int32)
    ids = torch.tensor([[1, 2, 3, 8], [3, 2, 1, 8]], dtype=torch.int32)
    _, (loads, pairs) = _grouped_model(data, queries, ids, 3, 2, 8, 2)
    assert (loads, pairs) == (4, 8)
    _, (loads, pairs) = _grouped_model(data, queries, ids, 3, 2, 8, 1)
    assert (loads, pairs) == (8, 8)


# (q, n, m, itemsize, ctot, k) and the G the rule gives on an H100
@pytest.mark.parametrize("shape,want", [
    ((1024, 1_000_000, 960, 4, 131_072, 10), 48),     # gist1m.bulk1024 (measured best)
    ((1024, 1_000_000, 960, 4, 205_824, 10), 47),     # its top rung: 26 chunks' segments
    ((1024, 50_000_000, 128, 4, 262_144, 10), 1),     # sift50m.bulk1024: 512-byte rows
    ((1024, 50_000_000, 128, 4, 411_648, 10), 1),     # its top rung
    ((1024, 25_000_000, 128, 4, 411_648, 10), 1),     # bigann100m.dist4
    ((64, 50_000_000, 128, 4, 262_144, 10), 1),       # sift50m.online64
    ((1024, 1_000_000, 960, 2, 131_072, 10), 1),      # int16 rows
    ((1024, 1_000_000, 256, 4, 131_072, 10), 1),      # 1,024-byte rows
    ((1024, 1_000_000, 512, 4, 131_072, 10), 64),     # 2,048-byte rows, reuse 8.4
    ((1024, 4_000_000, 512, 4, 131_072, 10), 1),      # ... reuse 2.4: 4,870 bytes saved
    ((1024, 8_000_000, 960, 4, 131_072, 10), 48),     # reuse 1.44: 5,530 bytes saved
    ((8, 1_000_000, 960, 4, 131_072, 10), 8),         # G <= Q
    ((1, 1_000_000, 960, 4, 131_072, 10), 1),
    ((1024, 1_000_000, 1032, 4, 131_072, 10), 1),     # wider than a lane's 32 values
    ((1024, 1_000_000, 960, 4, 131_072, 400), 13),    # long lists take the room
])
def test_plan_group_rule(shape, want):
    q, n, m, itemsize, ctot, k = shape
    g = tfr.plan_group(*shape, tfr.WINDOW_SMEM_LIMIT)
    assert g == want
    assert 1 <= g <= max(1, min(q, tfr.WINDOW_GROUP_MAX))
    chunks = -(-ctot // tfr.WINDOW_PART)
    if g > 1:
        assert tfr.group_smem_bytes(m, k, g, tfr.GROUP_ROWS_MAX, chunks) <= tfr.WINDOW_SMEM_LIMIT
        assert (g == min(q, tfr.WINDOW_GROUP_MAX) or tfr.group_smem_bytes(
            m, k, g + 1, tfr.GROUP_ROWS_MAX, chunks) > tfr.WINDOW_SMEM_LIMIT)
        assert tfr.group_reuse(g, ctot / n) * m * itemsize >= tfr.WINDOW_GROUP_BYTES


def test_plan_group_threshold_edge():
    """Just below the bytes a row load must save the rule keeps G = 1; just
    above it groups."""
    q, m, ctot, k = 1024, 960, 131_072, 10
    g = tfr.plan_group(q, 1_000_000, m, 4, ctot, k, tfr.WINDOW_SMEM_LIMIT)
    saved = lambda n: tfr.group_reuse(g, ctot / n) * m * 4
    lo, hi = 1_000_000, 2_000_000_000
    while hi - lo > 1:                          # the largest n that still groups
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if saved(mid) >= tfr.WINDOW_GROUP_BYTES else (lo, mid)
    assert tfr.plan_group(q, lo, m, 4, ctot, k, tfr.WINDOW_SMEM_LIMIT) == g
    assert tfr.plan_group(q, hi, m, 4, ctot, k, tfr.WINDOW_SMEM_LIMIT) == 1


@pytest.mark.parametrize("shape,group,want", [
    ((1024, 1_000_000, 960, 4, 131_072, 10), 48, (12, 245, 16, 8_146_960, 22 * 245)),
    ((1024, 1_000_000, 960, 4, 205_824, 10), 47, (12, 245, 26, 13_185_040, 22 * 245)),
    ((1000, 1_000_000, 960, 4, 131_072, 10), 48, (12, 245, 16, 7_956_016, 21 * 245)),
    ((64, 20_000, 128, 4, 8_192, 10), 64, (12, 5, 1, 6_160, 5)),
    ((1024, 50_000_000, 128, 4, 262_144, 10), 48, None),   # 12,208 windows > MAX_WINDOWS
    ((1024, 4_000, 960, 4, 131_072, 10), 48, None),        # one window
    ((1024, 1_000_000, 960, 4, 131_072, 10), 64, None),    # the queries overflow
])
def test_plan_windows_grouped(shape, group, want):
    """Grouped windows hold GROUP_ROWS_MAX rows; the workspace is the
    (query, window) path's, to the byte; the items are ceil(Q / G) x
    windows."""
    plan = tfr.plan_windows(*shape, L2_H100, G_H100, group=group)
    if want is None:
        assert plan is None
        return
    q, n, m, itemsize, ctot, k = shape
    assert (plan.shift, plan.windows, plan.chunks, plan.workspace_bytes, plan.items(q)) == want
    assert plan.group == group and plan.rows == tfr.GROUP_ROWS_MAX
    assert plan.workspace_bytes == tfr.window_workspace_bytes(q, k, plan.windows, plan.chunks)
    assert tfr.group_smem_bytes(m, k, group, plan.rows, plan.chunks) <= tfr.WINDOW_SMEM_LIMIT


@pytest.mark.parametrize("rows,group,m,k", [
    (8192, 2, 8, 5),              # more rows than a grouped window's masks
    (64, tfr.WINDOW_GROUP_MAX + 1, 8, 5),
    (64, 2, tfr.GROUP_DIM_MAX + 4, 5),
    (64, 64, 960, 10),            # the group's queries overflow shared memory
])
def test_plan_windows_grouped_refuses(rows, group, m, k):
    with pytest.raises(ValueError):
        tfr.plan_windows(70, 1000, m, 4, 100, k, 0, 0, rows, group)


@pytest.mark.parametrize("m,k,group,rows,chunks,want", [
    (960, 10, 48, 4096, 16, 230_276), (960, 10, 47, 4096, 26, 229_984),
    (128, 10, 64, 4096, 1, 74_564), (8, 5, 2, 64, 1, 41_024)])
def test_group_smem_bytes(m, k, group, rows, chunks, want):
    assert tfr.group_smem_bytes(m, k, group, rows, chunks) == want


def test_rerank_attrs_read_the_window_counters():
    """A windowed launch's ``take_path`` detail (windows, group, its stats
    words) gives ``stage_rerank`` its windows, group, row loads, pairs and
    the phase times between block 0's stamps (ns to us); any other path
    gives zeros."""
    stats = torch.tensor([19_704_822, 50_525_072, 1_000, 1_013_000, 18_195_000, 18_195_500])
    _build.take_path("fused_rerank")
    _build.count_path("fused_rerank", "windowed", (245, 48, stats))
    assert tfr.rerank_attrs(*_build.take_path("fused_rerank")) == {
        "windows": 245, "group": 48, "row_loads": 19_704_822, "pairs": 50_525_072,
        "partition_us": 1012.0, "items_us": 17182.0, "output_us": 0.5}
    assert _build.take_path("fused_rerank") is None
    zeros = {"windows": 0, "group": 0, "row_loads": 0, "pairs": 0, "partition_us": 0.0,
             "items_us": 0.0, "output_us": 0.0}
    for path in ("sliced", "none"):
        assert ops.rerank_attrs(path, 0) == zeros


@pytest.mark.parametrize("rows,group", [(None, 48), (64, 2), (4096, tfr.WINDOW_GROUP_MAX)])
def test_plan_windows_grouped_refuses_int16_rows(rows, group):
    """Grouped items take int32 rows only (int16 rows are never grouped,
    and the kernel is built for int32 alone)."""
    assert tfr.plan_group(1024, 1_000_000, 960, 2, 131_072, 10, tfr.WINDOW_SMEM_LIMIT) == 1
    with pytest.raises(ValueError, match="int32"):
        tfr.plan_windows(1024, 1_000_000, 128, 2, 131_072, 10, 0, 0, rows, group)
