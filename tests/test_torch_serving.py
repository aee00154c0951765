"""Port parity, the serving path as a whole: ``query_index_compact``,
``SegmentedIndex.query_compact`` after one insert/delete/compact stream, and
``AnnServingEngine.drain`` — ``repro_torch`` on the CPU against ``repro``,
bit for bit, at the tests/test_segments.py config."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jidx
from repro.core.baselines import brute_force_l1 as j_brute
from repro.core.segments import SegmentedIndex as JSeg
from repro.data import ann_synthetic as jds
from repro.serve.engine import AnnServingEngine as JEngine
from repro.serve.engine import ServeConfig as JServe
from repro_torch import bridge
from repro_torch.core import index as tidx
from repro_torch.core.baselines import brute_force_l1 as t_brute
from repro_torch.core.segments import SegmentedIndex as TSeg
from repro_torch.serve.engine import AnnServingEngine as TEngine
from repro_torch.serve.engine import ServeConfig as TServe

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
JCFG = jidx.IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=30,
                        candidate_cap=32, universe=64, k=8, rerank_chunk=128)
TCFG = tidx.IndexConfig(**dataclasses.asdict(JCFG))


def bridged(jparams):
    return bridge.params_from_numpy(
        jparams.width, np.asarray(jparams.offsets), np.asarray(jparams.mix_a),
        np.asarray(jparams.mix_c), np.asarray(jparams.walks.pairs),
        np.asarray(jparams.walks.prefix))


@pytest.fixture(scope="module")
def setup():
    spec = jds.DatasetSpec("seg", n=3000, dim=16, universe=64, num_clusters=8)
    data = jds.make_dataset(spec)
    queries = jds.make_queries(spec, data, 16)
    jparams = jidx.make_params(JCFG, KEY, 16)
    return data, queries, jparams, bridged(jparams)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def test_query_index_compact(setup):
    data, queries, jparams, tparams = setup
    js = jidx.build_index(JCFG, KEY, jnp.asarray(data), params=jparams)
    ts = tidx.build_index(TCFG, torch.from_numpy(data), params=tparams)
    tq = torch.from_numpy(queries)
    full = tidx.query_index(TCFG, ts, tq)
    for floor in (16, 4096):
        jd, ji = jidx.query_index_compact(JCFG, js, jnp.asarray(queries), floor=floor)
        td, ti = tidx.query_index_compact(TCFG, ts, tq, floor=floor)
        _eq(jd, td, "dists")
        _eq(ji, ti, "ids")
        _eq(full[0], td)
        _eq(full[1], ti)


def test_segmented_query_compact_after_mutations(setup):
    """One stream through both packages: seed, insert (seals a segment and
    leaves a delta), delete, query; then compact and query again."""
    data, queries, jparams, tparams = setup
    jx = JSeg.from_dataset(JCFG, KEY, jnp.asarray(data[:1500]), delta_cap=256,
                           params=jparams)
    tx = TSeg.from_dataset(TCFG, data[:1500], delta_cap=256, params=tparams,
                           device="cpu")
    for idx in (jx, tx):
        idx.insert(data[1500:1900])
        idx.delete([1, 2, 1600, 1899, 5])
    assert tx.structure_signature() == jx.structure_signature()
    stats_j, stats_t = {}, {}
    jd, ji, jused = jx.query_compact(jnp.asarray(queries), stats=stats_j)
    td, ti, tused = tx.query_compact(torch.from_numpy(queries), stats=stats_t)
    _eq(jd, td, "dists")
    _eq(ji, ti, "gids")
    assert tused == jused and stats_t == stats_j
    assert tx.candidate_ladders() == jx.candidate_ladders()
    assert tx.skew_summary() == jx.skew_summary()
    # the worst-case-slab query folds the same sources to the same bits
    wd, wi = tx.query(torch.from_numpy(queries))
    _eq(jd, wd)
    _eq(ji, wi)
    for idx in (jx, tx):
        idx.compact()
    jd, ji, jused = jx.query_compact(jnp.asarray(queries))
    td, ti, tused = tx.query_compact(torch.from_numpy(queries))
    _eq(jd, td, "dists after compact")
    _eq(ji, ti, "gids after compact")
    assert tused == jused
    # checkpoint round trip
    state, gids, next_gid = tx.checkpoint_payload()
    back = TSeg.from_checkpoint(TCFG, state, gids, next_gid)
    bd, bi, _ = back.query_compact(torch.from_numpy(queries))
    _eq(td, bd)
    _eq(ti, bi)


def test_truncate_rung_matches(setup):
    data, queries, jparams, tparams = setup
    jx = JSeg.from_dataset(JCFG, KEY, jnp.asarray(data), params=jparams)
    tx = TSeg.from_dataset(TCFG, data, params=tparams, device="cpu")
    for idx in (jx, tx):
        for seg in idx.segments:
            idx._ensure_caps(seg)
            seg.ctot_norm, seg.c_norm = 64, 1
    stats_j, stats_t = {}, {}
    jd, ji, jused = jx.query_compact(jnp.asarray(queries), overflow="truncate",
                                     stats=stats_j)
    td, ti, tused = tx.query_compact(torch.from_numpy(queries), overflow="truncate",
                                     stats=stats_t)
    _eq(jd, td)
    _eq(ji, ti)
    assert tused == jused and stats_t == stats_j
    assert stats_t["truncated_candidates"] > 0


def test_engine_drain(setup):
    """The engine over a bridged index drains the same bits as the JAX
    engine, through insert -> delete -> drain -> compact -> drain."""
    data, queries, jparams, tparams = setup
    common = dict(batch_size=8, bucket_min=8, delta_cap=512,
                  cand_bucket_min=512)
    jidx_ = JSeg.from_dataset(JCFG, KEY, jnp.asarray(data), delta_cap=512,
                              params=jparams)
    tidx_ = TSeg.from_dataset(TCFG, data, delta_cap=512, params=tparams,
                              device="cpu")
    je = JEngine(JCFG, JServe(persistent_cache=False, **common), index=jidx_)
    te = TEngine(TCFG, TServe(**common), index=tidx_)
    inserted = queries[:5] + 2
    for e in (je, te):
        gids = e.insert(inserted)
        e.delete([3, 7, int(gids[1])])
        e.submit(queries[:11])
    jd, ji = je.drain()
    td, ti = te.drain()
    _eq(jd, td, "dists")
    _eq(ji, ti, "gids")
    assert te.stats["bucket_cold_hits"] == 0
    for e in (je, te):
        e.compact()
        e.submit(queries)
    jd, ji = je.drain()
    td, ti = te.drain()
    _eq(jd, td, "dists after compact")
    _eq(ji, ti, "gids after compact")
    s = te.summary()
    assert s["queries"] == 27 and s["compactions"] == 1 and s["device"] == "cpu"
    assert s["cand_buckets"] == dict(sorted(je.stats["cand_buckets"].items()))
    qd, qi = te.query_batch(queries[:3])
    _eq(td[:3], qd)
    _eq(ti[:3], qi)


def test_engine_refuses_distances_beyond_big_dist():
    """Data and queries whose L1 distances could reach BIG_DIST are refused
    where they enter: at build, at insert and in a served batch (the rerank
    kernel ranks only distances below it as the reference does)."""
    cfg = dataclasses.replace(TCFG, num_probes=8, hash_impl="thermo")  # clamps coordinates
    serve = TServe(batch_size=4, warm_buckets=False, cand_cap_sample=2)
    far = (2 ** 28 - np.random.default_rng(0).integers(0, 1000, (40, 5))).astype(np.int32)
    eng = TEngine(cfg, serve, far, device="cpu")        # spread ~1000: admitted
    d, i = eng.query_batch(far[:2])
    assert (d[:, 0] == 0).all() and (i[:, 0] == [0, 1]).all()
    with pytest.raises(ValueError, match="BIG_DIST"):
        eng.query_batch(np.zeros((2, 5), np.int32))     # the fault's queries
    with pytest.raises(ValueError, match="BIG_DIST"):
        eng.insert(np.zeros((1, 5), np.int32))
    assert eng.index.next_gid == 40                     # nothing was inserted
    wide = np.zeros((4, 5), np.int32)
    wide[0] = 2 ** 28
    with pytest.raises(ValueError, match="BIG_DIST"):
        TSeg.from_dataset(cfg, wide, device="cpu")


def test_brute_force_l1(setup):
    data, queries, _, _ = setup
    jd, ji = j_brute(jnp.asarray(data), jnp.asarray(queries), 8)
    td, ti = t_brute(torch.from_numpy(data), torch.from_numpy(queries), 8,
                     chunk=700)
    _eq(jd, td)
    _eq(ji, ti)


def test_launch_serve_cpu(capsys):
    import json

    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--n", "600", "--dim", "8", "--queries", "12",
                "--batch", "8", "--probes", "10", "--tables", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["queries"] == 12 and 0.0 <= out["recall"] <= 1.0
