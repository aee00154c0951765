"""Port parity, the 'scan' rerank: ``stage_dedup``, ``l1_distance_chunked``
and ``stage_rerank(impl='scan')`` of ``repro_torch`` against ``repro`` on the
CPU, bit for bit, on int32 and int16 data, with duplicate ids, sentinel-only
rows and chunk sizes that do not divide the candidate count; and the whole
query with ``rerank_impl='scan'``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jidx
from repro.core import pipeline as jpipe
from repro.core.segments import SegmentedIndex as JSeg
from repro.data import ann_synthetic as jds
from repro_torch.core import index as tidx
from repro_torch.core import pipeline as tpipe
from repro_torch.core.segments import SegmentedIndex as TSeg
from test_torch_bridge import bridged

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
JCFG = jidx.IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=30,
                        candidate_cap=32, universe=64, k=8, rerank_chunk=100,
                        rerank_impl="scan")
TCFG = tidx.IndexConfig(**dataclasses.asdict(JCFG))


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _candidates(seed, q=9, ctot=301, n=500):
    """Ids with repeats, sentinels (n and beyond), a sentinel-only row and a
    row of one id repeated."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n + 40, (q, ctot)).astype(np.int32)
    ids[ids >= n] = n
    ids[1] = n                         # sentinel-only
    ids[2] = 7                         # one id, repeated
    ids[3, ::3] = ids[3, 0]            # many repeats of one id
    ids[4, :5] = n + 3                 # sentinel beyond n
    return ids


def _data(seed, n=500, m=24, dtype=np.int32, q=9):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 40, (n, m)) * 2
    pts[:50] = pts[50:100]             # equal rows: tied distances
    qs = rng.integers(0, 40, (q, m)) * 2
    return pts.astype(dtype), qs.astype(np.int32)


def test_stage_dedup_matches_jax():
    ids = _candidates(0)
    _eq(jpipe.stage_dedup(jnp.asarray(ids), 500),
        tpipe.stage_dedup(torch.from_numpy(ids), 500))


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("chunk", [1, 7, 64, 301, 512])
@pytest.mark.parametrize("dedup", [True, False])
def test_l1_distance_chunked_matches_jax(dtype, chunk, dedup):
    pts, qs = _data(1, dtype=dtype)
    ids = _candidates(2)
    if dedup:
        ids = np.asarray(jpipe.stage_dedup(jnp.asarray(ids), pts.shape[0]))
    want = jpipe.l1_distance_chunked(jnp.asarray(pts), jnp.asarray(qs),
                                     jnp.asarray(ids), 8, chunk)
    got = tpipe.l1_distance_chunked(torch.from_numpy(pts), torch.from_numpy(qs),
                                    torch.from_numpy(ids), 8, chunk)
    _eq(want[0], got[0], "dists")
    _eq(want[1], got[1], "ids")
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32


def test_l1_distance_chunked_queries_beyond_int16():
    """int16 rows with queries outside int16: the rows are widened, so the
    sums are the JAX package's int32 sums."""
    pts, qs = _data(3, dtype=np.int16)
    qs[0, 0] = 40000
    qs[1, 3] = -33000
    ids = np.asarray(jpipe.stage_dedup(jnp.asarray(_candidates(4)), pts.shape[0]))
    want = jpipe.l1_distance_chunked(jnp.asarray(pts), jnp.asarray(qs),
                                     jnp.asarray(ids), 8, 64)
    got = tpipe.l1_distance_chunked(torch.from_numpy(pts), torch.from_numpy(qs),
                                    torch.from_numpy(ids), 8, 64)
    _eq(want[0], got[0])
    _eq(want[1], got[1])


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_stage_rerank_scan_equals_fused(dtype):
    """'scan' on deduplicated ids == 'fused' on the raw ids, in both packages."""
    pts, qs = _data(5, dtype=dtype)
    ids = _candidates(6)
    n = pts.shape[0]
    jcfg = dataclasses.replace(JCFG, dataset_dtype=np.dtype(dtype).name)
    tcfg = dataclasses.replace(TCFG, dataset_dtype=np.dtype(dtype).name)
    dd = np.asarray(jpipe.stage_dedup(jnp.asarray(ids), n))
    want = jpipe.stage_rerank(jcfg, jnp.asarray(pts), jnp.asarray(qs),
                              jnp.asarray(dd), impl="scan")
    args = (torch.from_numpy(pts), torch.from_numpy(qs))
    scan = tpipe.stage_rerank(tcfg, *args, torch.from_numpy(dd))
    fused = tpipe.stage_rerank(tcfg, *args, torch.from_numpy(ids), impl="fused")
    for got in (scan, fused):
        _eq(want[0], got[0])
        _eq(want[1], got[1])
    assert tpipe.rerank_handles_duplicates(tcfg) is False
    assert tpipe.rerank_handles_duplicates(dataclasses.replace(tcfg, rerank_impl="fused"))
    with pytest.raises(ValueError, match="unknown rerank_impl"):
        tpipe.stage_rerank(tcfg, *args, torch.from_numpy(dd), impl="bogus")


@pytest.fixture(scope="module")
def setup():
    spec = jds.DatasetSpec("seg", n=3000, dim=16, universe=64, num_clusters=8)
    data = jds.make_dataset(spec)
    queries = jds.make_queries(spec, data, 16)
    jp = jidx.make_params(JCFG, KEY, 16)
    return data, queries, jp, bridged(jp)


@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_query_with_scan_rerank(setup, dtype):
    """query_index, the compacted query and the segmented query with
    rerank_impl='scan' (``probe_candidates`` and phase B deduplicate)."""
    data, queries, jp, tp = setup
    jcfg = dataclasses.replace(JCFG, dataset_dtype=dtype)
    tcfg = dataclasses.replace(TCFG, dataset_dtype=dtype)
    js = jidx.build_index(jcfg, KEY, jnp.asarray(data), params=jp)
    ts = tidx.build_index(tcfg, torch.from_numpy(data), params=tp)
    tq = torch.from_numpy(queries)
    want = jidx.query_index(jcfg, js, jnp.asarray(queries))
    fused = tidx.query_index(dataclasses.replace(tcfg, rerank_impl="fused"), ts, tq)
    for got in (tidx.query_index(tcfg, ts, tq),
                tidx.query_index_compact(tcfg, ts, tq, floor=16), fused):
        _eq(want[0], got[0])
        _eq(want[1], got[1])
    jseg = JSeg.from_dataset(jcfg, KEY, jnp.asarray(data), params=jp)
    tseg = TSeg.from_dataset(tcfg, data, params=tp, device="cpu")
    for jq, tq_ in ((jseg.query(jnp.asarray(queries)), tseg.query(queries)),
                    (jseg.query_compact(jnp.asarray(queries))[:2],
                     tseg.query_compact(queries)[:2])):
        _eq(jq[0], tq_[0])
        _eq(jq[1], tq_[1])
    ids = tpipe.probe_candidates(tcfg, ts.params, ts.template, ts.sorted_keys,
                                 ts.sorted_ids, data.shape[0], tq)
    _eq(np.asarray(jidx._probe_candidate_ids(jcfg, js, jnp.asarray(queries))), ids)
