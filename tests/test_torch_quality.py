"""Port parity, the quality protocol as a whole: ``repro_torch.eval``'s
``QualityRun`` against ``repro.eval``'s on the CPU at the
tests/test_eval_quality.py config, with the JAX package's parameters
bridged.  RW records equal bit for bit; CP and SRS records within one result
of recall and 1e-3 of ratio; the claim, the cross-layer oracles and the
distributed query equal."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import ann_synthetic as ds
from repro.eval import QualityRun as JRun
from repro.eval import QualitySpec as JSpec
from repro_torch.eval import SCHEMES, QualityRun, QualitySpec, tables_needed
from test_torch_bridge import params_source, srs_projection

torch.set_num_threads(1)

SPEC = ds.DatasetSpec("evalq", n=2048, dim=16, universe=64, num_clusters=8, seed=5)
QKW = dict(k=8, table_sweep=(1, 2, 4), probe_sweep=(30,), candidate_cap=32,
           num_hashes_rw=8, num_hashes_cp=8, rerank_chunk=256, srs_t=256,
           target_recall=0.8)
ORACLE = ("mp-rw-lsh", 4, 30)


@pytest.fixture(scope="module")
def runs():
    data = ds.make_dataset(SPEC)
    queries = ds.make_queries(SPEC, data, 16)
    jrun = JRun(data, queries, SPEC.universe, JSpec(**QKW))
    trun = QualityRun(data, queries, SPEC.universe, QualitySpec(**QKW), device="cpu",
                      params_fn=params_source(jrun.key),
                      srs_proj=srs_projection(jrun.key, data, jrun.spec.srs_proj))
    return jrun, trun


@pytest.fixture(scope="module")
def sweeps(runs):
    jrun, trun = runs
    return jrun.sweep(), trun.sweep()


def test_ground_truth_and_widths(runs):
    jrun, trun = runs
    np.testing.assert_array_equal(jrun.true_d, trun.true_d)
    np.testing.assert_array_equal(jrun.true_i, trun.true_i)
    assert (jrun.dbar, jrun.w_rw, jrun.w_cp) == (trun.dbar, trun.w_rw, trun.w_cp)


@pytest.mark.parametrize("scheme", ["mp-rw-lsh", "rw-lsh", "cp-lsh", "mp-cp-lsh"])
def test_scheme_config_field_for_field(runs, scheme):
    jrun, trun = runs
    for tables, probes in ((1, None), (4, 30), (2, 7)):
        assert (dataclasses.asdict(trun.scheme_config(scheme, tables, probes))
                == dataclasses.asdict(jrun.scheme_config(scheme, tables, probes)))
    with pytest.raises(ValueError, match="no IndexConfig"):
        trun.scheme_config("srs", 1)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sweep_matches_jax(runs, sweeps, scheme):
    jrec = [r for r in sweeps[0] if r["scheme"] == scheme]
    trec = [r for r in sweeps[1] if r["scheme"] == scheme]
    assert [(r["num_tables"], r["num_probes"]) for r in trec] == \
        [(r["num_tables"], r["num_probes"]) for r in jrec]
    tol = 1.0 / (runs[1].queries.shape[0] * QKW["k"])
    for j, t in zip(jrec, trec):
        assert 0.0 <= t["recall"] <= 1.0 and t["ratio"] >= 1.0 - 1e-9
        if scheme in ("mp-rw-lsh", "rw-lsh"):
            assert (t["recall"], t["ratio"]) == (j["recall"], j["ratio"])
        else:
            assert abs(t["recall"] - j["recall"]) <= tol
            assert abs(t["ratio"] - j["ratio"]) <= 1e-3


def test_table_claim_matches(runs, sweeps):
    jrun, trun = runs
    assert trun.table_claim(sweeps[1]) == jrun.table_claim(sweeps[0])
    for target in (0.5, 0.8, 0.99):
        assert trun.table_claim(sweeps[1], target) == jrun.table_claim(sweeps[0], target)
        for s in SCHEMES:
            assert tables_needed(sweeps[1], s, target) == tables_needed(sweeps[0], s, target)


@pytest.mark.parametrize("check", ["check_segmented", "check_compact", "check_skew_cap"])
def test_oracles_match_jax(runs, check):
    jrun, trun = runs
    want = getattr(jrun, check)(jrun.scheme_config(*ORACLE))
    got = getattr(trun, check)(trun.scheme_config(*ORACLE))
    assert got == want
    assert all(v for k, v in got.items() if isinstance(v, bool))


def test_cross_layer_matches_jax(runs):
    """Without the cluster oracle (tests/test_torch_cluster.py holds it):
    the segmented, compacted and distributed oracles, the JAX package's
    dict, six flags, all true."""
    jrun, trun = runs
    got = trun.check_cross_layer(trun.scheme_config(*ORACLE), cluster=False)
    assert got == jrun.check_cross_layer(jrun.scheme_config(*ORACLE), cluster=False)
    flags = {k: v for k, v in got.items() if isinstance(v, bool)}
    assert len(flags) == 6 and all(flags.values()), flags


def test_check_distributed_matches_jax(runs):
    jrun, trun = runs
    got = trun.check_distributed(trun.scheme_config(*ORACLE))
    assert got == jrun.check_distributed(jrun.scheme_config(*ORACLE))
    assert got == {"devices": 1, "dist_matches_flat": True}


def test_query_dist_matches_jax(runs):
    jrun, trun = runs
    d, i = trun.query_dist(trun.scheme_config(*ORACLE))
    jd, ji = jrun.query_dist(jrun.scheme_config(*ORACLE))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_timed_records(runs, sweeps):
    _, trun = runs
    cfg = trun.scheme_config("cp-lsh", 2)
    rec = trun.eval_config(cfg, timed=True)
    want = [r for r in sweeps[1] if r["scheme"] == "cp-lsh" and r["num_tables"] == 2][0]
    assert (rec["recall"], rec["ratio"]) == (want["recall"], want["ratio"])
    assert rec["ms_per_query"] > 0
    srs = trun.eval_srs(timed=True)
    assert srs["ms_per_query"] > 0
