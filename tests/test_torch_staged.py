"""Port parity of the staged probe and the concat merge: the port on the CPU
against the JAX package, bit for bit, on the same numpy inputs and the same
(bridged) hash parameters.

  * ``probe_impl='staged'``: ``stage_bucket_lookup``,
    ``stage_candidate_gather`` (the (Q, L*P*C) slab, sentinel n, and n = 0),
    ``stage_probe_counts``, ``query_index`` and the segmented worst-case
    query, and the ``ValueError`` for a compacted slab;
  * the concat merge: ``stage_merge_concat`` with tied distances and -1
    pads, ``stage_merge_pair(use_kernel=False)``, and
    ``SegmentedIndex.query`` / ``query_compact`` with
    ``use_merge_kernel=False`` over a fragmented index.
"""
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
JCFG = jidx.IndexConfig(num_tables=3, num_hashes=8, width=24, num_probes=20,
                        candidate_cap=16, universe=64, k=8, rerank_chunk=128,
                        probe_impl="staged")
TCFG = tidx.IndexConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def setup():
    spec = jds.DatasetSpec("staged", n=2000, dim=16, universe=64, num_clusters=8)
    data = jds.make_dataset(spec)
    queries = jds.make_queries(spec, data, 12)
    jparams = jidx.make_params(JCFG, KEY, 16)
    tparams = bridged(jparams)
    js = jidx.build_index(JCFG, KEY, jnp.asarray(data), params=jparams)
    ts = tidx.build_index(TCFG, torch.from_numpy(data), params=tparams)
    return data, queries, jparams, tparams, js, ts


def _eq(a, b, msg=""):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype, msg)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _probe_keys(setup):
    data, queries, jparams, tparams, js, ts = setup
    jb, jx = jpipe.stage_hash(JCFG, jparams, jnp.asarray(queries))
    jpk = jpipe.stage_probe_keys(JCFG, jparams, js.template, jb, jx)
    tb, tx = tpipe.stage_hash(TCFG, tparams, torch.from_numpy(queries))
    tpk = tpipe.stage_probe_keys(TCFG, tparams, ts.template, tb, tx)
    _eq(np.asarray(jpk).astype(np.int64), tpk, "probe keys")
    return jpk, tpk


def test_bucket_lookup_and_candidate_gather(setup):
    """The extents (both sides of each search, int32) and the (Q, L*P*C)
    slab in (table, probe, offset) order with sentinel n."""
    data, queries, jparams, tparams, js, ts = setup
    jpk, tpk = _probe_keys(setup)
    jlo, jhi = jpipe.stage_bucket_lookup(js.sorted_keys, jpk)
    tlo, thi = tpipe.stage_bucket_lookup(ts.sorted_keys, tpk)
    _eq(jlo, tlo, "lo")
    _eq(jhi, thi, "hi")
    assert bool((thi - tlo > TCFG.candidate_cap).any()), "a bucket is truncated"
    n = data.shape[0]
    jids = jpipe.stage_candidate_gather(JCFG, js.sorted_ids, jlo, jhi, n)
    tids = tpipe.stage_candidate_gather(TCFG, ts.sorted_ids, tlo, thi, n)
    assert tids.shape == (queries.shape[0], TCFG.num_tables
                          * TCFG.probes_per_table * TCFG.candidate_cap)
    _eq(jids, tids, "slab")
    assert bool((tids == n).any()) and bool((tids < n).any())
    for occ_from in (None, ts.occ_from):
        _eq(jpipe.stage_probe_counts(JCFG, js.sorted_keys, jpk),
            tpipe.stage_probe_counts(TCFG, ts.sorted_keys, tpk, occ_from), "counts")


def test_staged_slab_with_no_points(setup):
    """n == 0: the lookup finds nothing and the slab is all zeros (the
    sentinel for n = 0)."""
    _, _, _, _, js, ts = setup
    jpk, tpk = _probe_keys(setup)
    l = TCFG.num_tables
    jkeys = jnp.zeros((l, 0), jnp.uint32)
    tkeys = torch.zeros((l, 0), dtype=torch.int64)
    jlo, jhi = jpipe.stage_bucket_lookup(jkeys, jpk)
    tlo, thi = tpipe.stage_bucket_lookup(tkeys, tpk)
    _eq(jlo, tlo)
    _eq(jhi, thi)
    jids = jpipe.stage_candidate_gather(JCFG, jnp.zeros((l, 0), jnp.int32), jlo, jhi, 0)
    tids = tpipe.stage_candidate_gather(TCFG, torch.zeros((l, 0), dtype=torch.int32),
                                        tlo, thi, 0)
    _eq(jids, tids)
    assert not bool(tids.any())


@pytest.mark.parametrize("rerank", ["fused", "scan"])
def test_query_index_staged(setup, rerank):
    """``query_index`` under ``probe_impl='staged'`` equals the JAX package's
    and, on the candidate set, the fused probe's result."""
    data, queries, jparams, tparams, js, ts = setup
    jcfg = dataclasses.replace(JCFG, rerank_impl=rerank)
    tcfg = dataclasses.replace(TCFG, rerank_impl=rerank)
    jd, ji = jidx.query_index(jcfg, js, jnp.asarray(queries))
    td, ti = tidx.query_index(tcfg, ts, torch.from_numpy(queries))
    _eq(jd, td, "dists")
    _eq(ji, ti, "ids")
    fd, fi = tidx.query_index(dataclasses.replace(tcfg, probe_impl="fused"), ts,
                              torch.from_numpy(queries))
    _eq(fd, td, "staged == fused dists")
    _eq(fi, ti, "staged == fused ids")


def test_staged_refuses_a_compacted_slab(setup):
    _, queries, _, tparams, _, ts = setup
    n = ts.dataset.shape[0]
    for kw in ({"cbucket": 64}, {"c_cap": 4}):
        with pytest.raises(ValueError, match="probe_impl='fused'"):
            tpipe.probe_candidates(TCFG, tparams, ts.template, ts.sorted_keys,
                                   ts.sorted_ids, n, torch.from_numpy(queries), **kw)
    with pytest.raises(ValueError, match="unknown probe_impl"):
        tidx.IndexConfig(probe_impl="bogus")


def test_segmented_staged_query(setup):
    """The segmented worst-case query runs the staged slab per segment."""
    data, queries, jparams, tparams, _, _ = setup
    jx = JSeg.from_dataset(JCFG, KEY, jnp.asarray(data[:1200]), delta_cap=128,
                           params=jparams)
    tx = TSeg.from_dataset(TCFG, data[:1200], delta_cap=128, params=tparams,
                           device="cpu")
    for idx in (jx, tx):
        idx.insert(data[1200:1500])
        idx.delete([3, 1250, 7])
    jd, ji = jx.query(jnp.asarray(queries))
    td, ti = tx.query(torch.from_numpy(queries))
    _eq(jd, td)
    _eq(ji, ti)


# --------------------------------------------------------------------------
# The concat merge
# --------------------------------------------------------------------------

def _lists(seed, q, r, k, dist_hi, pad_share):
    """R ascending (Q, k) top-k lists with tied distances, -1 pads at
    ``BIG_DIST``, and gids that repeat across lists."""
    rng = np.random.default_rng(seed)
    ds, is_ = [], []
    for _ in range(r):
        d = np.sort(rng.integers(0, dist_hi, (q, k)), axis=1).astype(np.int32)
        i = rng.integers(0, 50, (q, k)).astype(np.int32)
        pad = rng.random((q, k)) < pad_share
        pad = np.sort(pad, axis=1)                      # pads at the tail
        d = np.where(pad, jpipe.BIG_DIST, d).astype(np.int32)
        i = np.where(pad, -1, i).astype(np.int32)
        order = np.lexsort((i, d), axis=1)
        ds.append(np.take_along_axis(d, order, 1))
        is_.append(np.take_along_axis(i, order, 1))
    return np.concatenate(ds, axis=1), np.concatenate(is_, axis=1)


MERGE_CONCAT_CASES = {
    "ties": dict(seed=1, q=6, r=3, k=8, dist_hi=4, pad_share=0.0),
    "ties_and_pads": dict(seed=2, q=5, r=4, k=5, dist_hi=3, pad_share=0.4),
    "all_pads": dict(seed=3, q=3, r=2, k=4, dist_hi=5, pad_share=1.0),
    "wide": dict(seed=4, q=4, r=2, k=33, dist_hi=1000, pad_share=0.1),
}


@pytest.mark.parametrize("name", sorted(MERGE_CONCAT_CASES))
def test_stage_merge_concat(name):
    c = MERGE_CONCAT_CASES[name]
    ds, is_ = _lists(c["seed"], c["q"], c["r"], c["k"], c["dist_hi"], c["pad_share"])
    jd, ji = jpipe.stage_merge_concat(jnp.asarray(ds), jnp.asarray(is_), c["k"])
    td, ti = tpipe.stage_merge_concat(torch.from_numpy(ds), torch.from_numpy(is_), c["k"])
    _eq(jd, td, "dists")
    _eq(ji, ti, "ids")


def test_stage_merge_concat_extreme_keys():
    """Signed int32 extremes of both keys order as the pair does."""
    big = np.iinfo(np.int32)
    ds = np.array([[big.max, -5, big.min, 0, 0, big.max]], np.int32)
    is_ = np.array([[big.min, 7, big.max, -1, big.min, big.max]], np.int32)
    for k in (1, 3, 6):
        jd, ji = jpipe.stage_merge_concat(jnp.asarray(ds), jnp.asarray(is_), k)
        td, ti = tpipe.stage_merge_concat(torch.from_numpy(ds), torch.from_numpy(is_), k)
        _eq(jd, td)
        _eq(ji, ti)


@pytest.mark.parametrize("name", ["ties", "ties_and_pads", "wide"])
def test_stage_merge_pair_concat_route(name):
    """``use_kernel=False`` equals the JAX package's concat route and, on
    ascending lists, the bitonic merge."""
    c = dict(MERGE_CONCAT_CASES[name], r=2)
    ds, is_ = _lists(c["seed"], c["q"], 2, c["k"], c["dist_hi"], c["pad_share"])
    k = c["k"]
    parts = [ds[:, :k], is_[:, :k], ds[:, k:], is_[:, k:]]
    jd, ji = jpipe.stage_merge_pair(*map(jnp.asarray, parts), use_kernel=False)
    td, ti = tpipe.stage_merge_pair(*map(torch.from_numpy, parts), use_kernel=False)
    _eq(jd, td)
    _eq(ji, ti)
    kd, ki = tpipe.stage_merge_pair(*map(torch.from_numpy, parts))
    _eq(kd, td)
    _eq(ki, ti)


def test_segmented_concat_fold(setup):
    """A fragmented index (sealed segments plus a delta) folded by the
    concat sort: ``query`` and ``query_compact`` equal the JAX package's
    and the kernel fold."""
    data, queries, jparams, tparams, _, _ = setup
    jcfg = dataclasses.replace(JCFG, probe_impl="fused")
    tcfg = dataclasses.replace(TCFG, probe_impl="fused")
    jx = JSeg.from_dataset(jcfg, KEY, jnp.asarray(data[:900]), delta_cap=200,
                           params=jparams)
    tx = TSeg.from_dataset(tcfg, data[:900], delta_cap=200, params=tparams,
                           device="cpu")
    for idx in (jx, tx):
        idx.insert(data[900:1500])
        idx.delete([1, 950, 1499, 12])
    assert tx.num_segments >= 3 and tx.delta_fill > 0
    jq, tq = jnp.asarray(queries), torch.from_numpy(queries)
    jd, ji = jx.query(jq, use_merge_kernel=False)
    td, ti = tx.query(tq, use_merge_kernel=False)
    _eq(jd, td)
    _eq(ji, ti)
    kd, ki = tx.query(tq)
    _eq(kd, td)
    _eq(ki, ti)
    jd, ji, jused = jx.query_compact(jq, 64, False)
    td, ti, tused = tx.query_compact(tq, 64, False)
    _eq(jd, td)
    _eq(ji, ti)
    assert tused == jused
    kd, ki, _ = tx.query_compact(tq, 64)
    _eq(kd, td)
    _eq(ki, ti)
