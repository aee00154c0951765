"""End-to-end cluster serving walkthrough (DESIGN.md §7): a sharded,
replicated, WAL-durable MP-RW-LSH cluster surviving a replica crash with
zero dropped queries, recovering it from snapshot + WAL replay, and serving
bit-identical answers throughout — then one traced query (DESIGN.md §12)
rendered as a Chrome trace you can open in Perfetto.

  PYTHONPATH=src python -m repro_torch.examples.cluster_serving [--device cpu]
"""
import json
import os
import shutil
import tempfile

import numpy as np

from repro_torch.cluster import ClusterConfig, ClusterRouter
from repro_torch.core.index import IndexConfig
from repro_torch.data import ann_synthetic as ds
from repro_torch.examples import cli_device
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.render import check_spans, load_spans, to_chrome
from repro_torch.serve.engine import ServeConfig

SPEC = ds.DatasetSpec("cluster-demo", n=8000, dim=32, universe=64,
                      num_clusters=16)


def main(device=None, params_fn=None):
    spec = SPEC
    data = np.asarray(ds.make_dataset(spec))
    cfg = IndexConfig(num_tables=6, num_hashes=10, width=28, num_probes=40,
                      candidate_cap=256, universe=spec.universe, k=10,
                      rerank_chunk=512)
    root = tempfile.mkdtemp(prefix="cluster_demo_")
    router = ClusterRouter(
        cfg, ServeConfig(batch_size=64),
        ClusterConfig(num_shards=2, num_replicas=2, hedge_ms=5000.0),
        data, root, params_fn=params_fn, device=device)
    try:
        out = _walkthrough(spec, data, router, root)
    finally:
        router.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


def _walkthrough(spec, data, router, root):
    print(f"cluster up: 2 shards x 2 replicas over n={spec.n} "
          f"(WAL+snapshots under {root})")

    answers = {}
    queries = np.asarray(ds.make_queries(spec, data, 96))
    d0, i0 = answers["fresh"] = router.query(queries)
    print(f"served {len(queries)} queries; "
          f"top-1 gid of q0 = {int(i0[0, 0])}")

    # live mutations are WAL'd on every replica before being acknowledged
    new_pts = (np.random.default_rng(1).integers(
        0, spec.universe // 2, (200, spec.dim)) * 2).astype(np.int32)
    gids = router.insert(new_pts)
    d, i = answers["inserts"] = router.query(new_pts[:32])
    assert (i[:, 0] == gids[:32]).all(), "inserts must be their own top-1"
    print(f"inserted {len(gids)} points; self-hit@1 on inserts: 1.00")

    # a replica starts failing unannounced; traffic is failed over
    base_d, base_i = answers["post_insert"] = router.query(queries)
    router.replicas[0][0].fail_next_queries = 10 ** 9
    router.clear_cache()                         # force real dispatches
    d1, i1 = answers["failover"] = router.query(queries)
    s = router.summary()
    assert np.array_equal(i1, base_i) and np.array_equal(d1, base_d)
    print(f"replica 0/0 crashed mid-traffic: {s['failovers']} failovers, "
          f"0 dropped queries, answers bit-identical")

    # mutations keep flowing while it is down, then it recovers:
    # snapshot restore + WAL replay + catch-up from its live peer
    router.replicas[0][0].alive = False
    router.delete(gids[:50])
    info = router.recover_replica(0, 0)
    print(f"replica recovered: replayed {info['replayed']} WAL records, "
          f"caught up {info['caught_up']} from peer")

    post_d, post_i = answers["post_delete"] = router.query(queries)
    router.kill_replica(0, 1)          # force the recovered replica to serve
    router.clear_cache()
    d2, i2 = answers["recovered"] = router.query(queries)
    assert np.array_equal(i2, post_i) and np.array_equal(d2, post_d)
    print("recovered replica serves; answers unchanged. summary:")
    s = router.summary()
    print({k: s[k] for k in ("queries", "batches", "failovers", "recoveries",
                             "cache_hits", "replicas_marked_dead")})
    # the same counters, as one mergeable cluster roll-up (DESIGN.md §12):
    # per-replica registry snapshots folded order-independently, with the
    # engine batch latency as exact-bound histogram quantiles
    cm = s["cluster_metrics"]
    print(f"cluster roll-up: {cm['counters']['batches']} engine batches, "
          f"p99 batch <= {cm['histograms']['batch_ms']['p99_ms']:.2f} ms; "
          f"router dispatch p50 <= {s['dispatch_ms']['p50_ms']:.2f} ms")

    # -- traced query (DESIGN.md §12) -------------------------------------
    # REPRO_TRACE=1 turns the span machinery on (off, every span call is a
    # shared no-op); one cache-bypassed query then leaves its whole tree —
    # cluster_batch -> fanout -> shard_query -> replica_query ->
    # engine_batch -> phase_a/phase_b_rerank/merge — as JSONL in
    # REPRO_TRACE_DIR, rendered here into Chrome trace-event JSON.
    trace_dir = os.path.join(root, "trace")
    saved = {k: os.environ.get(k) for k in ("REPRO_TRACE", "REPRO_TRACE_DIR")}
    os.environ["REPRO_TRACE"] = "1"
    os.environ["REPRO_TRACE_DIR"] = trace_dir
    try:
        router.clear_cache()
        answers["traced"] = router.query(queries[:32])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    obs_trace.flush()
    spans = load_spans(trace_dir)
    report = check_spans(spans)
    assert report["ok"], report
    out_path = os.path.join(trace_dir, "trace.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(to_chrome(spans), f)
    slowest = max((r for r in spans if r["name"] == "replica_query"),
                  key=lambda r: r["dur"], default=None)
    print(f"traced query: {report['records']} spans on "
          f"{report['traces']} trace(s), schema ok={report['ok']}; "
          f"slowest replica_query {slowest['dur'] / 1000:.2f} ms "
          f"(shard {slowest['args']['shard']})")
    print(f"open {out_path} in https://ui.perfetto.dev to see the tree")
    return {"recall": None, "self_hit": 1.0, "failovers": s["failovers"],
            "replayed": info["replayed"], "caught_up": info["caught_up"],
            "spans": report["records"], "trace_ok": report["ok"],
            "gids": gids, "answers": answers}


if __name__ == "__main__":
    main(cli_device(__doc__))
