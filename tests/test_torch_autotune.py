"""Port parity of the recall-target engine: the success model of
``core/multiprobe.py`` (its analysis half), ``data/normalize.py``, the
autotuner ``eval/autotune.py`` and the engine built with
``ServeConfig(target_recall=...)`` — the port on the CPU against the JAX
package on the same numpy inputs.

The success tables are float64 and equal to 1e-12; the tuner, given the JAX
package's parameters for every candidate configuration
(``test_torch_bridge.params_source``), walks the same history to the same
configuration with the same predicted and validated recall; the engine
reports the same ``quality`` block and serves the same results.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.core import multiprobe as jmp
from repro.core import probability as jprob
from repro.data import ann_synthetic as jds
from repro.data import normalize as jnorm
from repro.eval import QualityRun as JRun
from repro.eval import QualitySpec as JSpec
from repro.eval import autotune as jat
from repro.serve.engine import AnnServingEngine as JEngine
from repro.serve.engine import ServeConfig as JServe
from repro_torch.core import index as tidx
from repro_torch.core import multiprobe as tmp
from repro_torch.core import probability as tprob
from repro_torch.data import normalize as tnorm
from repro_torch.eval import autotune as tat
from repro_torch.serve.engine import AnnServingEngine as TEngine
from repro_torch.serve.engine import ServeConfig as TServe
from test_torch_bridge import params_source

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
SPEC = jds.DatasetSpec("evalq", n=2048, dim=16, universe=64, num_clusters=8, seed=5)
QSPEC = JSpec(k=8, table_sweep=(1, 2, 4), probe_sweep=(30,), candidate_cap=32,
              num_hashes_rw=8, num_hashes_cp=8, rerank_chunk=256, srs_t=256,
              target_recall=0.8)
ATOL = 1e-12


@pytest.fixture(scope="module")
def run():
    """The JAX package's quality fixture (``tests/test_eval_quality.py``):
    data, queries and the per-dataset widths its configs use."""
    data = jds.make_dataset(SPEC)
    queries = jds.make_queries(SPEC, data, 16)
    return JRun(data, queries, SPEC.universe, QSPEC)


def _tcfg(jcfg):
    return tidx.IndexConfig(**dataclasses.asdict(jcfg))


# --------------------------------------------------------------------------
# The success model (numpy on the host)
# --------------------------------------------------------------------------

FAMILY_WIDTH = {"rw": 24.0, "cauchy": 40.0, "gaussian": 6.0}


@pytest.mark.parametrize("family", sorted(FAMILY_WIDTH))
def test_success_model_pieces(family):
    """``coord_landing_probs``, ``exact_topk_success``,
    ``perturbations_from_sets`` and ``sequence_success`` on the same
    offsets."""
    width = FAMILY_WIDTH[family]
    rng = np.random.default_rng(3)
    sets = jmp.build_template(6, width, 40)
    assert tmp.build_template(6, width, 40) == sets
    for d in (1, 4, 17):
        d = d if family == "rw" else float(d) * 1.5
        a = rng.uniform(0.0, width, size=6)
        np.testing.assert_allclose(tmp.coord_landing_probs(a, width, family, d),
                                   jmp.coord_landing_probs(a, width, family, d),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            tmp.exact_topk_success(a, width, family, d, [0, 5, 40, 10_000]),
            jmp.exact_topk_success(a, width, family, d, [0, 5, 40, 10_000]),
            rtol=0, atol=ATOL)
        x_all = np.concatenate([a, width - a])
        deltas = tmp.perturbations_from_sets(sets, x_all)
        np.testing.assert_array_equal(deltas, jmp.perturbations_from_sets(sets, x_all))
        assert deltas.dtype == np.int8
        np.testing.assert_allclose(
            tmp.sequence_success(deltas, a, width, family, d, [0, 3, 40, 99]),
            jmp.sequence_success(deltas, a, width, family, d, [0, 3, 40, 99]),
            rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="3\\^M"):
        tmp.exact_topk_success(np.zeros(15), width, family, 1, [1])


@pytest.mark.parametrize("family,use_template", [
    ("rw", True), ("rw", False), ("cauchy", True), ("gaussian", False)])
def test_success_table_mc(family, use_template):
    width = FAMILY_WIDTH[family]
    dv = [1, 6, 20] if family == "rw" else [2.0, 9.5]
    args = (family, 6, width, dv, [0, 10, 30])
    got = tmp.success_table_mc(*args, runs=8, seed=4, use_template=use_template)
    want = jmp.success_table_mc(*args, runs=8, seed=4, use_template=use_template)
    assert got.shape == want.shape == (len(dv), 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("d", [0, 1, 2, 513, 1022, 1023, 1024, 2049, 3700])
def test_rw_pmf_beyond_float_range(d):
    """Below d = 1024 the port's random-walk pmf is the JAX package's, bit
    for bit; from 1024, where ``2.0**d`` overflows and the JAX package
    raises, it is the exact binomial row over 2^d, correctly rounded."""
    got = tprob.rw_pmf(d)[1]
    if d < 1024:
        np.testing.assert_array_equal(got, jprob.rw_pmf(d)[1])
        return
    with pytest.raises(OverflowError):
        jprob.rw_pmf(d)
    assert abs(got.sum() - 1.0) < 1e-12 and (got >= 0).all()
    np.testing.assert_array_equal(got, got[::-1])
    k = np.arange(d + 1)
    lg = np.vectorize(math.lgamma)
    ref = np.exp(lg(d + 1.0) - lg(k + 1.0) - lg(d - k + 1.0) - d * np.log(2.0))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-300)
    lo, hi = np.array([-200.0, -40.0]), np.array([40.0, 300.0])
    p = tprob.interval_prob("rw", d, lo, hi)
    assert (0 < p).all() and (p < 1).all()


@pytest.mark.parametrize("universe", [64, 256, 510])
def test_normalize_even(universe):
    rng = np.random.default_rng(universe)
    x = rng.normal(3.0, 40.0, (300, 12)) * rng.uniform(0.1, 5.0, 12)
    jn, tn = jnorm.fit_normalizer(x, universe), tnorm.fit_normalizer(x, universe)
    np.testing.assert_array_equal(tn.shift, jn.shift)
    assert (tn.scale, tn.universe) == (jn.scale, jn.universe)
    got = tnorm.normalize_even(x, universe)
    np.testing.assert_array_equal(got, jnorm.normalize_even(x, universe))
    assert got.dtype == np.int32 and (got % 2 == 0).all()
    assert got.min() >= 0 and got.max() <= universe


# --------------------------------------------------------------------------
# The tuner
# --------------------------------------------------------------------------

def test_tuner_helpers(run):
    data = np.asarray(run.data)
    for seed in (0, 7):
        want = jat._calibration_queries(data, 16, SPEC.universe, seed)
        np.testing.assert_array_equal(
            tat._calibration_queries(data, 16, SPEC.universe, seed), want)
        np.testing.assert_array_equal(
            tat._calibration_queries(torch.from_numpy(data.copy()), 16, SPEC.universe, seed),
            want)
    td = np.asarray(run.true_d)
    for family in ("rw", "cauchy"):
        assert tat._rep_distances(td, family) == jat._rep_distances(td, family)
    with pytest.raises(ValueError, match="no valid distances"):
        tat._rep_distances(np.full((2, 3), 2 ** 30, np.int64), "rw")
    cfg = run.scheme_config("mp-rw-lsh", 1, 20)
    d_values = jat._rep_distances(td, "rw")
    for l in (1, 4):
        jc = dataclasses.replace(cfg, num_tables=l)
        assert (tat.predicted_recall(_tcfg(jc), d_values, mc_runs=8)
                == jat.predicted_recall(jc, d_values, mc_runs=8))


TUNE_CASES = {
    # met at the first proposal
    "met": dict(base=("mp-rw-lsh", 2, 30), target=0.8, table_ladder=(1, 2, 4, 8)),
    # out of reach: the cap widens, then the table ladder climbs
    "escalate": dict(base=("mp-rw-lsh", 1, 10), target=0.995, table_ladder=(1, 2, 3)),
    # two probe counts: the cheaper (L, T) wins
    "probe_ladder": dict(base=("mp-rw-lsh", 1, 10), target=0.85,
                         table_ladder=(1, 2, 4), probe_ladder=(10, 30)),
}


@pytest.mark.parametrize("name", sorted(TUNE_CASES))
def test_tune_for_recall_matches_jax(run, name):
    """Bridged parameters for every candidate configuration: the same
    history, the same tuned configuration, the same predicted and
    validated recall."""
    c = TUNE_CASES[name]
    jcfg = run.scheme_config(*c["base"])
    kw = dict(num_calib=16, table_ladder=c["table_ladder"], mc_runs=8,
              probe_ladder=c.get("probe_ladder"))
    want = jat.tune_for_recall(jcfg, np.asarray(run.data), c["target"], key=KEY, **kw)
    got = tat.tune_for_recall(_tcfg(jcfg), np.asarray(run.data), c["target"],
                              params_fn=params_source(KEY), device="cpu", **kw)
    assert got.history == want.history
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert got.predicted_recall == want.predicted_recall
    assert got.validated_recall == want.validated_recall
    assert (got.met_target, got.rounds, got.d_calib) == (
        want.met_target, want.rounds, want.d_calib)
    assert got.state.sorted_keys.shape[0] == got.cfg.num_tables
    if name == "escalate":
        assert got.rounds > 1 and not got.met_target


def test_tune_for_recall_empty_dataset_raises(run):
    cfg = _tcfg(run.scheme_config("mp-rw-lsh", 1, 10))
    with pytest.raises(ValueError, match="empty"):
        tat.tune_for_recall(cfg, np.zeros((0, 16), np.int32), 0.5, device="cpu")


# --------------------------------------------------------------------------
# The engine with a recall target
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(run):
    """The JAX engine of ``test_eval_quality.py``'s target-recall test and
    the port's on the same data and parameters, each after one drain."""
    jcfg = run.scheme_config("mp-rw-lsh", 1, 30)   # deliberately too weak
    serve = dict(batch_size=8, delta_cap=64, target_recall=0.8, autotune_calib=16)
    jeng = JEngine(jcfg, JServe(**serve), run.data)
    teng = TEngine(_tcfg(jcfg), TServe(**serve), np.asarray(run.data), device="cpu",
                   params_fn=params_source(KEY))
    q = np.asarray(run.queries)[:4]
    out = []
    for eng in (jeng, teng):
        eng.submit(q)
        out.append(eng.drain())
    return jeng, teng, out


def test_engine_target_recall_quality_block(engines):
    jeng, teng, ((jd, ji), (td, ti)) = engines
    jq, tq = jeng.summary()["quality"], teng.summary()["quality"]
    assert tq == jq
    assert tq["met_target"] and tq["num_tables"] == teng.cfg.num_tables
    assert teng.autotune.history == jeng.autotune.history
    # start-up seeds the segment from the tuner's validated index
    assert teng.index.segments[0].state is teng.autotune.state
    assert td.dtype == np.int32 and td.shape == (4, teng.cfg.k)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ti, ji)


def test_engine_summary_keys_match_jax(engines):
    """The JAX engine's summary keys, less ``compile_cache`` (the port has
    no JAX compile cache), plus ``device``; the skew and flight blocks
    alike; the histogram quantiles bound the batches."""
    jeng, teng, _ = engines
    js, ts = jeng.summary(), teng.summary()
    assert set(ts) == (set(js) - {"compile_cache"}) | {"device"}
    assert set(ts["skew"]) == set(js["skew"])
    assert set(ts["flight"]) == set(js["flight"])
    for key in ("queries", "batches", "segments", "buckets", "cand_buckets",
                "bucket_cold_hits"):
        assert ts[key] == js[key], key
    assert ts["flight"]["recorded"] == ts["batches"] > 0
    assert 0 < ts["p50_batch_ms"] <= ts["p99_batch_ms"] <= ts["p999_batch_ms"]
    assert teng.metrics.snapshot()["histograms"]["batch_ms"]["count"] == ts["batches"]
    assert teng.stats is teng.metrics
    json.dumps(ts)


def test_engine_state_and_checkpoint_payload(engines):
    _, teng, _ = engines
    assert teng.state is teng.index.segments[0].state
    teng.insert(np.zeros((1, 16), np.int32))
    with pytest.raises(RuntimeError, match="uncompacted"):
        teng.state
    state, gids, next_gid = teng.checkpoint_payload()
    assert teng.index.num_segments == 1 and next_gid == 2049
    assert state is teng.state and int(gids[-1]) == 2048


def test_engine_target_recall_empty_dataset_serves_best_effort(run):
    cfg = _tcfg(run.scheme_config("mp-rw-lsh", 1, 10))
    eng = TEngine(cfg, TServe(batch_size=8, target_recall=0.9),
                  np.zeros((0, 16), np.int32), device="cpu")
    assert eng.autotune is None and eng.summary()["quality"] is None
    eng.submit(np.zeros((2, 16), np.int32))
    d, i = eng.drain()
    assert (i == -1).all() and d.dtype == np.int32


def test_adopted_index_clears_the_target(engines):
    _, teng, _ = engines
    eng = TEngine(teng.cfg, TServe(batch_size=8, target_recall=0.99), index=teng.index)
    assert eng.autotune is None and eng.serve_cfg.target_recall is None


def test_launch_serve_target_recall(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--n", "1500", "--dim", "16", "--queries", "16",
                "--batch", "8", "--probes", "20", "--target-recall", "0.8"])
    out = json.loads(capsys.readouterr().out)
    assert out["quality"]["target_recall"] == 0.8
    assert out["device"] == "cpu" and out["queries"] == 16
    assert set(out["quality"]) == {"target_recall", "validated_recall", "met_target",
                                   "num_tables", "num_probes", "candidate_cap"}
