"""The port's three ANN examples (``repro_torch.examples``) on the CPU, each
with its dataset spec shrunk through its module constant, and each one's
answers against its JAX twin's steps (``examples/*.py``), bit for bit, at
the same shrunk size with the JAX parameters bridged across."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cluster as jcl
from repro.ckpt import CheckpointManager as JManager
from repro.core import index as jidx
from repro.core.baselines import brute_force_l1 as j_brute
from repro.core.baselines import overall_ratio, recall
from repro.core.segments import SegmentedIndex as JSegmented
from repro.data import ann_synthetic as jds
from repro.serve.engine import AnnServingEngine as JEngine
from repro.serve.engine import ServeConfig as JServe
from repro_torch import bridge
from repro_torch.data import ann_synthetic as ds
from repro_torch.examples import ann_serving, cluster_serving, quickstart

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)             # the JAX twins' default key

QUICK_SPEC = ds.DatasetSpec("quickstart", n=2000, dim=16, universe=128,
                            num_clusters=8)
SERVING_SPEC = ds.DatasetSpec("serving", n=1000, dim=8, universe=128,
                              num_clusters=8)
CLUSTER_SPEC = ds.DatasetSpec("cluster-demo", n=1000, dim=16, universe=64,
                              num_clusters=8)


def _jax_params_fn(key):
    """A ``params_fn`` drawing the JAX package's parameters from ``key``."""
    def params_fn(cfg, dim):
        jcfg = jidx.IndexConfig(num_tables=cfg.num_tables,
                                num_hashes=cfg.num_hashes, width=cfg.width,
                                num_probes=cfg.num_probes,
                                candidate_cap=cfg.candidate_cap,
                                universe=cfg.universe, k=cfg.k)
        p = jidx.make_params(jcfg, key, dim)
        return bridge.params_from_numpy(
            p.width, np.asarray(p.offsets), np.asarray(p.mix_a),
            np.asarray(p.mix_c), np.asarray(p.walks.pairs),
            np.asarray(p.walks.prefix))
    return params_fn


@pytest.fixture
def shrunk(monkeypatch):
    monkeypatch.setattr(quickstart, "SPEC", QUICK_SPEC)
    monkeypatch.setattr(quickstart, "RAW_SHAPE", (200, 8))
    monkeypatch.setattr(quickstart, "NUM_QUERIES", 16)
    monkeypatch.setattr(ann_serving, "SPEC", SERVING_SPEC)
    monkeypatch.setattr(cluster_serving, "SPEC", CLUSTER_SPEC)


def _jspec(spec):
    return jds.DatasetSpec(spec.name, n=spec.n, dim=spec.dim,
                           universe=spec.universe,
                           num_clusters=spec.num_clusters)


def _same_answers(want, got):
    """Each step's (d, i), the same keys and arrays bit for bit."""
    assert sorted(want) == sorted(got)
    for step, (d, i) in want.items():
        np.testing.assert_array_equal(np.asarray(d), got[step][0], err_msg=step)
        np.testing.assert_array_equal(np.asarray(i), got[step][1], err_msg=step)


def test_quickstart_runs_on_the_cpu(shrunk, capsys):
    out = quickstart.main(device="cpu")
    printed = capsys.readouterr().out
    assert "recall@10 :" in printed and "overall ratio:" in printed
    d, i = out["answers"]["query"]
    assert i.shape == (16, 10) and d.dtype == np.int32
    assert 0.5 <= out["recall"] <= 1.0 and out["overall_ratio"] >= 1.0


def test_quickstart_equals_the_jax_steps(shrunk):
    """The JAX quickstart's steps 2-5 at the shrunk size, and the port's
    ``main`` with the same parameters: the same (d, i), bit for bit, and
    the same recall and overall ratio."""
    out = quickstart.main(device="cpu", params_fn=_jax_params_fn(KEY))
    spec = jds.DatasetSpec("quickstart", n=QUICK_SPEC.n, dim=QUICK_SPEC.dim,
                           universe=QUICK_SPEC.universe,
                           num_clusters=QUICK_SPEC.num_clusters)
    data = jds.make_dataset(spec)
    queries = jds.make_queries(spec, data, 16)
    cfg = jidx.IndexConfig(num_tables=8, num_hashes=12, width=56,
                           num_probes=200, candidate_cap=128,
                           universe=spec.universe, k=10)
    state = jidx.build_index(cfg, KEY, jnp.asarray(data))
    d, i = jidx.query_index(cfg, state, jnp.asarray(queries))
    _same_answers({"query": (d, i)}, out["answers"])
    td, ti = j_brute(jnp.asarray(data), jnp.asarray(queries), 10)
    assert recall(np.asarray(i), np.asarray(ti)) == out["recall"]
    assert overall_ratio(np.asarray(d), np.asarray(td)) == out["overall_ratio"]


def test_ann_serving_runs_on_the_cpu(shrunk, capsys):
    """Its own asserts hold: self-hit 1.0 on inserts, no deleted gid
    returned, the restored node's results identical."""
    out = ann_serving.main(device="cpu")
    printed = capsys.readouterr().out
    assert "restored-node results identical: True" in printed
    assert out["self_hit"] == 1.0 and out["restored_identical"]
    assert 0.5 <= out["recall"] <= 1.0


def test_cluster_serving_runs_on_the_cpu(shrunk, capsys):
    """Its own asserts hold: self-hits, the failover and the recovered
    replica bit-identical, the rendered trace's spans check."""
    out = cluster_serving.main(device="cpu")
    printed = capsys.readouterr().out
    assert "answers bit-identical" in printed and "schema ok=True" in printed
    assert out["failovers"] >= 1 and out["trace_ok"] and out["spans"] > 0


def _jax_ann_serving(spec, root):
    """The JAX ann_serving example's steps at ``spec``: each drain's answers,
    the recall and the inserted gids."""
    data = jds.make_dataset(spec)
    cfg = jidx.IndexConfig(num_tables=8, num_hashes=12, width=56,
                           num_probes=200, candidate_cap=128,
                           universe=spec.universe, k=10)
    engine = JEngine(
        cfg, JServe(batch_size=64, delta_cap=512, compact_watermark=0.6),
        jnp.asarray(data), key=KEY)
    answers = {}
    rng = np.random.default_rng(1)
    for burst in (30, 64, 100, 17):
        engine.submit(jds.make_queries(spec, data, burst,
                                       seed=int(rng.integers(1e6))))
        answers[f"burst_{burst}"] = engine.drain()
    q = jds.make_queries(spec, data, 64, seed=9)
    engine.submit(q)
    d, i = answers["quality"] = engine.drain()
    _, ti = j_brute(jnp.asarray(data), jnp.asarray(q), 10)
    r = recall(i, np.asarray(ti))
    new_pts = (rng.integers(0, spec.universe // 2, (400, spec.dim)) * 2
               ).astype(np.int32)
    gids = engine.insert(new_pts)
    engine.submit(new_pts[:64])
    answers["inserts"] = engine.drain()
    engine.delete(gids)
    engine.submit(new_pts[:64])
    answers["deleted"] = engine.drain()
    payload = engine.checkpoint_payload()
    engine.submit(q)
    answers["before_restore"] = engine.drain()
    mgr = JManager(str(root), keep=1)
    mgr.save(1, payload)
    r_state, r_gids, r_next = mgr.restore(1, payload)
    node = JSegmented.from_checkpoint(cfg, r_state, r_gids, r_next)
    answers["restored"] = node.query(jnp.asarray(q))
    return answers, r, gids


def test_ann_serving_equals_the_jax_steps(shrunk, tmp_path):
    """The JAX ann_serving's steps and the port's ``main`` with the same
    parameters: every drain's (d, i) bit for bit (the bursts, the quality
    batch, the inserts' self-hits, after the delete, before the checkpoint
    and from the restored node), the same recall and the same gids."""
    out = ann_serving.main(device="cpu", params_fn=_jax_params_fn(KEY))
    answers, r, gids = _jax_ann_serving(_jspec(SERVING_SPEC), tmp_path)
    _same_answers(answers, out["answers"])
    assert r == out["recall"]
    np.testing.assert_array_equal(np.asarray(gids), out["gids"])


def _jax_cluster_serving(spec, root):
    """The JAX cluster_serving example's steps at ``spec``: each query's
    answers and the inserted gids."""
    data = np.asarray(jds.make_dataset(spec))
    cfg = jidx.IndexConfig(num_tables=6, num_hashes=10, width=28,
                           num_probes=40, candidate_cap=256,
                           universe=spec.universe, k=10, rerank_chunk=512)
    router = jcl.ClusterRouter(
        cfg, JServe(batch_size=64),
        jcl.ClusterConfig(num_shards=2, num_replicas=2, hedge_ms=5000.0),
        data, str(root), key=KEY)
    answers = {}
    queries = np.asarray(jds.make_queries(spec, data, 96))
    answers["fresh"] = router.query(queries)
    new_pts = (np.random.default_rng(1).integers(
        0, spec.universe // 2, (200, spec.dim)) * 2).astype(np.int32)
    gids = router.insert(new_pts)
    answers["inserts"] = router.query(new_pts[:32])
    answers["post_insert"] = router.query(queries)
    router.replicas[0][0].fail_next_queries = 10 ** 9
    router.clear_cache()
    answers["failover"] = router.query(queries)
    router.replicas[0][0].alive = False
    router.delete(gids[:50])
    router.recover_replica(0, 0)
    answers["post_delete"] = router.query(queries)
    router.kill_replica(0, 1)
    router.clear_cache()
    answers["recovered"] = router.query(queries)
    router.clear_cache()
    answers["traced"] = router.query(queries[:32])
    router.close()
    return answers, gids


def test_cluster_serving_equals_the_jax_steps(shrunk, tmp_path):
    """The JAX cluster_serving's steps (its traced query untraced) and the
    port's ``main`` with the same parameters: every query's (d, i) bit for
    bit — fresh, the inserts' self-hits, after the insert, on failover,
    after the delete and recovery, from the recovered replica and the
    traced query — and the same gids."""
    out = cluster_serving.main(device="cpu", params_fn=_jax_params_fn(KEY))
    assert "REPRO_TRACE" not in os.environ
    answers, gids = _jax_cluster_serving(_jspec(CLUSTER_SPEC), tmp_path)
    _same_answers(answers, out["answers"])
    np.testing.assert_array_equal(np.asarray(gids), out["gids"])
