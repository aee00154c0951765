"""The paper's headline on the port: tables needed at recall 0.9, at the JAX
package's benchmark smoke config (benchmarks/quality_bench.py, PRNGKey(0)
bridged).  The port runs its whole sweep; the JAX package evaluates only the
configurations that decide ``tables_needed`` (its whole sweep is too slow
for these tests), and each port record falls on the same side of 0.9."""
import pytest
import torch

from repro.data import ann_synthetic as ds
from repro.eval import QualityRun as JRun
from repro.eval import QualitySpec as JSpec
from repro_torch.eval import QualityRun, QualitySpec
from test_torch_bridge import params_source, srs_projection

torch.set_num_threads(1)

DSPEC = ds.DatasetSpec("quality-smoke", n=4096, dim=32, universe=128,
                       num_clusters=16, seed=3)
QKW = dict(k=10, table_sweep=(1, 2, 4, 8, 16), table_sweep_single=(4, 8, 16, 32, 64),
           probe_sweep=(60,), candidate_cap=32, num_hashes_rw=10, num_hashes_cp=8,
           rerank_chunk=512, srs_t=512, target_recall=0.9)
# BENCH_summary.json: the JAX package's tables_needed at this config
CLAIM = {"mp-rw-lsh": 8, "rw-lsh": 64, "cp-lsh": None, "mp-cp-lsh": 16}
DECIDING = [("mp-rw-lsh", 4), ("mp-rw-lsh", 8), ("rw-lsh", 32), ("rw-lsh", 64),
            ("mp-cp-lsh", 8), ("mp-cp-lsh", 16), ("cp-lsh", 64)]


@pytest.fixture(scope="module")
def headline():
    data = ds.make_dataset(DSPEC)
    queries = ds.make_queries(DSPEC, data, 32)
    jrun = JRun(data, queries, DSPEC.universe, JSpec(**QKW))
    trun = QualityRun(data, queries, DSPEC.universe, QualitySpec(**QKW), device="cpu",
                      params_fn=params_source(jrun.key),
                      srs_proj=srs_projection(jrun.key, data, jrun.spec.srs_proj))
    return jrun, trun, trun.sweep()


def test_table_claim_reproduces_the_jax_package(headline):
    _, trun, records = headline
    claim = trun.table_claim(records)
    assert claim["tables_needed"] == CLAIM
    assert claim["ratio_vs_mp_rw"] == {"rw-lsh": 8.0, "cp-lsh": None, "mp-cp-lsh": 2.0}
    assert claim["sweep_max_tables"] == 64
    assert len(records) == 21
    for r in records:
        assert 0.0 <= r["recall"] <= 1.0 and r["ratio"] >= 1.0 - 1e-9


@pytest.mark.parametrize("scheme, tables", DECIDING)
def test_deciding_records_on_the_same_side(headline, scheme, tables):
    jrun, trun, records = headline
    j = jrun.eval_config(jrun.scheme_config(scheme, tables, 60))
    t = [r for r in records if r["scheme"] == scheme and r["num_tables"] == tables][0]
    target = QKW["target_recall"]
    assert (t["recall"] >= target) == (j["recall"] >= target), (t, j)
    if scheme.endswith("rw-lsh"):
        assert (t["recall"], t["ratio"]) == (j["recall"], j["ratio"])
    else:
        assert abs(t["recall"] - j["recall"]) <= 1.0 / (32 * QKW["k"])
        assert abs(t["ratio"] - j["ratio"]) <= 1e-3
