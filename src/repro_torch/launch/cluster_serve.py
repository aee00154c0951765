"""Cluster serving launcher of the port (the counterpart of
``python -m repro.launch.cluster_serve``, with the same flags plus
``--device``): S shards x R replicas behind the ``ClusterRouter`` (sharded
fan-out, replica hedging and failover, WAL-durable mutations, admission
control), with an optional kill/recover chaos drill.

  PYTHONPATH=src python -m repro_torch.launch.cluster_serve --n 20000 --dim 32 --shards 2 --replicas 2 --queries 256 --chaos
  PYTHONPATH=src python -m repro_torch.launch.cluster_serve --device cpu --n 4000 --dim 16 --queries 64 --chaos

``--workers N`` switches to the multi-process deployment: N shard-worker
subprocesses (x ``--replicas`` each) behind the RPC transport, supervised by
this launcher, each running its engine on ``--device`` in a process of its
own; a worker process that dies is respawned and recovered (snapshot + WAL
replay + peer catch-up) by the supervision sweep, and its leaked
shared-memory slabs are reaped.  The chaos drill then SIGKILLs a real
process instead of flipping a flag:

  PYTHONPATH=src python -m repro_torch.launch.cluster_serve --workers 4 --chaos

``--transport`` picks the wire: ``process`` (AF_UNIX + the shared-memory
fast path) or ``tcp`` (loopback AF_INET, the multi-host transport on one
machine); both imply worker subprocesses, so ``--workers`` defaults to
``--shards`` there.  The ground truth is ``core.baselines.brute_force_l1``
on ``--device`` (the ``l1_distance`` kernel on the card).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cluster import ClusterConfig, ClusterRouter
from repro_torch.cluster import shm
from repro_torch.core.baselines import brute_force_l1, recall
from repro_torch.core.index import IndexConfig
from repro_torch.data import ann_synthetic as ds
from repro_torch.serve.engine import ServeConfig


def supervise_once(router: ClusterRouter) -> list:
    """One supervision sweep over a multi-process router: any replica whose
    worker process is gone (crash, OOM kill, SIGKILL) is respawned and
    recovered (snapshot restore + WAL replay in the fresh worker, then peer
    catch-up for anything acknowledged while it was down).  Returns the
    [shard, replica] pairs restarted; call it from a periodic loop (or after
    an alert) in a long-running deployment."""
    restarted = []
    for s, group in enumerate(router.replicas):
        for r, rep in enumerate(group):
            handle = getattr(rep, "handle", None)
            if handle is not None and not handle.running():
                router.recover_replica(s, r)
                restarted.append([s, r])
    # a SIGKILL'd worker leaks its /dev/shm slab ring; the supervisor is the
    # long-lived process, so the sweep collects orphans even when no
    # respawn happened this round
    shm.reap_orphan_slabs()
    return restarted


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--tables", type=int, default=8)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--probes", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--hedge-ms", type=float, default=1000.0)
    ap.add_argument("--root", default=None,
                    help="WAL/snapshot directory (default: a temp dir)")
    ap.add_argument("--chaos", action="store_true",
                    help="kill a replica mid-traffic, then recover it")
    ap.add_argument("--workers", type=int, default=None,
                    help="multi-process mode: this many shard workers "
                         "(x --replicas) as supervised subprocesses over "
                         "the RPC transport (overrides --shards)")
    ap.add_argument("--transport", default=None,
                    choices=("inproc", "process", "tcp"),
                    help="wire selection (default: 'process' when "
                         "--workers is set, else 'inproc'); 'tcp' runs "
                         "worker subprocesses on loopback host:port "
                         "endpoints, the multi-host transport")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="drain-pipeline depth (default: 4 with --workers, "
                         "else 1)")
    ap.add_argument("--sanitize", action="store_true",
                    help="run the drill under the race sanitizer "
                         "(REPRO_SANITIZE=1, repro_torch.analysis."
                         "racecheck): replica entry points get owner/epoch "
                         "tokens and any query-vs-mutation overlap raises")
    ap.add_argument("--trace", action="store_true",
                    help="run under distributed tracing (REPRO_TRACE=1): "
                         "router and worker spans land as JSONL in "
                         "--trace-dir; render with "
                         "`python -m repro_torch.obs render <dir>`")
    ap.add_argument("--trace-dir", default=None,
                    help="span output directory (default: "
                         "$REPRO_TRACE_DIR or ./repro_trace)")
    ap.add_argument("--hedge-drill", action="store_true",
                    help="slow every shard-0 replica past --hedge-ms for "
                         "one batch so that a hedged re-issue (winner and "
                         "loser) happens")
    ap.add_argument("--device", default=None,
                    help="torch device of the engines and the fold; "
                         "default the card ('cuda')")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.sanitize:
        # before router construction: instrumentation hooks fire in the
        # replica constructors, and the workers inherit the environment
        os.environ["REPRO_SANITIZE"] = "1"
    if args.trace_dir is not None:
        # absolute: the router and the worker subprocesses (which inherit
        # the environment but not the working directory) must agree
        os.environ["REPRO_TRACE_DIR"] = os.path.abspath(args.trace_dir)
    if args.trace:
        os.environ["REPRO_TRACE"] = "1"

    spec = ds.DatasetSpec("cluster", n=args.n, dim=args.dim, universe=128,
                          num_clusters=32)
    data = ds.make_dataset(spec)
    queries = ds.make_queries(spec, data, args.queries)
    cfg = IndexConfig(num_tables=args.tables, num_hashes=12,
                      width=args.width, num_probes=args.probes,
                      candidate_cap=128, universe=spec.universe, k=args.k,
                      rerank_chunk=1024)
    root = args.root or tempfile.mkdtemp(prefix="cluster_serve_")
    transport = args.transport or (
        "process" if args.workers is not None else "inproc")
    multiproc = transport in ("process", "tcp")
    shards = args.workers if args.workers is not None else args.shards
    depth = (args.pipeline_depth if args.pipeline_depth is not None
             else (4 if multiproc else 1))
    router = ClusterRouter(
        cfg, ServeConfig(batch_size=args.batch),
        ClusterConfig(num_shards=shards, num_replicas=args.replicas,
                      hedge_ms=args.hedge_ms, transport=transport,
                      pipeline_depth=depth),
        data, root, device=device)

    d, i = router.query(queries)
    _, ti = brute_force_l1(torch.from_numpy(data).to(device),
                           torch.from_numpy(queries).to(device), args.k)
    out = {"recall": round(recall(i, ti.cpu().numpy()), 4),
           "transport": transport, "shards": shards,
           "pipeline_depth": depth, "device": str(device)}

    if args.hedge_drill:
        if args.replicas < 2:
            raise SystemExit("--hedge-drill needs --replicas >= 2 "
                             "(hedging re-issues to a peer)")
        # slow every shard-0 replica: the preferred replica rotates per
        # batch, so slowing one would let the rotation dodge the drill
        before_h = int(router.stats["hedged_batches"])
        before_w = int(router.stats["hedge_wins"])
        for rep in router.replicas[0]:
            rep.slow_ms = args.hedge_ms * 3
        try:
            router.clear_cache()                           # real dispatches
            dh, ih = router.query(queries[: args.batch])
        finally:
            for rep in router.replicas[0]:
                rep.slow_ms = 0.0
        out["hedge_drill"] = {
            "hedged_batches": int(router.stats["hedged_batches"]) - before_h,
            "hedge_wins": int(router.stats["hedge_wins"]) - before_w,
            "identical": bool(np.array_equal(ih, i[: dh.shape[0]])),
        }

    if args.chaos:
        if multiproc:
            # the real drill: SIGKILL the worker process, unannounced
            router.replicas[0][0].handle.sigkill()
        else:
            router.replicas[0][0].fail_next_queries = 10 ** 9
        router.clear_cache()                               # real dispatches
        d2, i2 = router.query(queries)
        out["chaos_identical"] = bool(np.array_equal(i, i2))
        if multiproc:
            # crash-restart: the supervision sweep finds the dead process,
            # respawns it, and recovers it from its own WAL and its peers
            out["supervisor_restarted"] = supervise_once(router)
            gids = router.insert(queries[: args.batch])
        else:
            router.replicas[0][0].alive = False
            gids = router.insert(queries[: args.batch])    # WAL'd while down
            out["recovery"] = router.recover_replica(0, 0)
        router.delete(gids)

    out.update(router.summary())
    out.pop("shards", None)
    if os.environ.get("REPRO_TRACE") == "1":
        from repro_torch.obs import trace as obs_trace
        obs_trace.flush()
        out["trace_dir"] = obs_trace.trace_dir()
    print(json.dumps(out, indent=1))
    router.close()
    if args.root is None:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
