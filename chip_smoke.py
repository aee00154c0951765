#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port: serve a SIFT1M-shaped segmented
MP-RW-LSH index on one NVIDIA card through the port's own entry points, run
the paper's quality protocol at the same size, and hold every CUDA kernel of
those paths against its plain-torch version.  It checks; it times nothing
(the benchmark, ``portbench/``, measures the port).

  python3 chip_smoke.py                  # from the repository root; needs one card
  python3 chip_smoke.py --dist-cards 4   # the distributed index on 4 cards only

Phases (each path runs with the launch counters zeroed just before it and
read just after, and must launch the kernels named in ``PATHS``):
  lint           ``python -m repro_torch.analysis --check --json`` in a
                 subprocess, before any card phase: exit 0, and its report
                 of every sanctioned finding (allowed inline or baselined)
                 for ``host_syncs``;
  build          compile csrc/*.cu with nvcc (sm_90a), one process per
                 source, and print ptxas's registers and spills;
  cuda           the card tests, ``python -m pytest -q -m cuda
                 tests/test_torch_cuda.py``, in a subprocess started here
                 that runs beside every phase below and is waited for last:
                 every kernel against its plain version at the adversarial
                 shapes of ``tests/test_torch_cases.py``, and the
                 card-against-CPU tests; exit 0, and none failed, errored
                 or skipped (its output and junit report under
                 ``build/chip_smoke_cuda/``);
  ground_truth   exact L1 k-NN of the queries through ``ops.l1_distance``,
                 each chunk of distances held against the plain version;
  serve          the main path: build the engine on the card, insert 512
                 points, delete 64 gids, drain 1024 queries, compact, drain
                 again;
  serve_rw_hash  the same traffic through a second engine with
                 hash_impl='pallas' (the rw_hash kernel in build and in every
                 query), whose results and tables must equal the first
                 engine's bit for bit;
  checks         every served result against the ground truth, its
                 distances recomputed through ``ops.l1_distance_rows`` and
                 held against the plain version;
  host_syncs     each engine ('gather', then 'pallas') at the serve
                 configuration under torch's sync debug mode ("warn"): after
                 warm-up and one drain over a segment, a delta and
                 tombstones, 8 drained batches of 64, a compaction, 8 more;
                 each sync recorded at its innermost frame in the port (and
                 its frames there), and every sync inside r1-host-sync's
                 scope must lie on a line the lint allows or baselines, or
                 in a host helper called from one (``hold_syncs``), else the
                 run fails; prints one ``{"host_syncs": ...}`` line (syncs a
                 batch, the count at each file:line, the compaction's, the
                 sanctioned lines not hit, whether ``torch.cuda.synchronize``
                 is reported);
  examples       ``repro_torch.examples``' ann_serving and cluster_serving,
                 each ``main()`` on the card at its own sizes (each checks
                 its own claims), then on the CPU: every step's (d, i) equal,
                 bit for bit; and ``generate``, whose greedy tokens on the
                 card equal the CPU's;
  lm             the language models (no kernel of the repo): every arch's
                 reduced() on the card against the CPU (float32, TF32 off;
                 train_loss, prefill, 8 decode steps and their caches,
                 within 1e-3), then smollm-360m at full width and depth:
                 float32 teacher-forced decode against the full forward
                 (the JAX package's 2e-2), then in bf16 through
                 ``LanguageModel``: prefill against float32 (0.1 x max
                 |logit|), a 192-slot cache filled by 128 single-token steps
                 against prefill, 64 greedy steps (finite logits, tokens in
                 the vocabulary); one ``{"lm": ...}`` line;
  lm_retrieval   ``repro_torch.examples.retrieval_augmented_lm.main()`` on
                 the card at its own sizes (hit rate >= 0.9, recall@5 >=
                 0.5), its index's answers and ground truth again through
                 the kernels' plain versions on the card, bit for bit, and
                 its embeddings against the CPU's;
  train          language-model training (no kernel of the repo on it): every
                 arch's reduced() on the card against the CPU (float32, TF32
                 off): the gradient of one batch (each leaf within
                 TRAIN_GRAD_SHARE of its max |g|), then three train steps'
                 losses and grad norms; ``smollm-360m`` at full width and
                 depth (bf16 parameters, float32 moments, remat as
                 configured), B 8 x S 128 from ``batch_at_step``: 20 steps
                 through ``make_train_step`` (finite losses and grad norms,
                 every leaf changed), the gradients with and without remat
                 (equal within TRAIN_REMAT_SHARE, the peak of allocated
                 memory without remat above the peak with); then
                 ``repro_torch.examples.train_smollm`` (``improved=yes``),
                 and 100 steps resumed to 200 against the straight run;
                 one ``{"train": ...}`` line;
  shard          the sharding rules and the dry-run (no kernel on it): the
                 dry-run's cells at full width and depth on fake ``cuda``
                 tensors, each a ``python -m repro_torch.launch.dryrun``
                 process, all started together (``smollm-360m`` train_4k,
                 prefill_32k and decode_32k on (16, 16), train_4k on
                 (2, 16, 16), ``mamba2-370m`` long_500k, the ANN cell):
                 each ``ok``, collectives counted, useful FLOPs at most
                 1.05 of the counted ones, no kernel launched, and each
                 smollm cell's per-rank peak against the card's 80 GB
                 (``fits_one_card``; one that does not fit holds its
                 attention's float32 scores); meanwhile ``smollm-360m`` in
                 float32 at full width and depth, placed by the rules on a
                 (2, 2) mesh of four gloo ranks on the CPU, prefill's logits
                 against the unsharded prefill on the card; one
                 ``{"dryrun": ...}`` line and one ``{"shard_ranks": ...}``
                 line;
  quality        the paper's protocol (``repro_torch.eval.QualityRun``) on
                 the same 1 M points and 256 queries at the JAX package's
                 full QualitySpec: the exact ground truth, 35 records over
                 MP-RW-LSH, RW-LSH, CP-LSH, MP-CP-LSH and SRS, the
                 tables-needed claim, the served configuration's recall, and
                 the segmented, compacted and distributed (nccl, one rank
                 a card) cross-layer oracles at the claim's configuration;
                 then, outside the counted path, the
                 path's ground truth, SRS and fragmented index's fold, and
                 one configuration of each family ('rw', 'cauchy',
                 'gaussian'), through the kernels and through their plain
                 versions on the card (equal bit for bit), and the card's
                 Cauchy buckets against a float64 reference on the CPU with
                 TF32 off and on;
  tuned          the recall-target engine: ``ServeConfig(target_recall=0.9,
                 autotune_calib=32)`` on the same 1 M points and the serve
                 phase's configuration as the base, tuned at start-up
                 (ground truth through ``l1_distance``, each validation
                 through ``query_index``) and seeded from the tuner's index,
                 then the serve phase's traffic; outside the counted path:
                 the tuner again under the kernels' plain versions (the same
                 history, configuration and predicted recall), the served
                 results' checks, one traced drain (``REPRO_TRACE=1``: the
                 spans render and check, one ``engine_batch`` and the four
                 phase spans a batch), one batch through
                 ``probe_impl='staged'`` equal to the fused probe, the
                 concat fold of a fragmented index equal to the kernel fold,
                 and one drain under ``REPRO_SANITIZE=1``;
  cluster        the in-process cluster (``repro_torch.cluster``): S 2 x R 2
                 replicas on the one card over the same 1 M points (a 500 K
                 row shard each), snapshots and WALs under a temporary
                 directory, the serve traffic through the router (insert,
                 delete, drain, compact, drain), then kill replica (0, 0),
                 delete the inserted gids, recover (0, 0) from its snapshot,
                 WAL and peer, and kill its peer; drain again.  Every drain
                 through ``check_results``; the recovered replica answers a
                 batch as its peer did before the peer died, bit for bit;
  cluster_process the same cluster over worker processes
                 (``transport='process'``): one worker a replica, each with
                 its own CUDA context on the one card, WAL fsync on, the same
                 traffic, then a real SIGKILL of worker (0, 0) and a drain
                 that fails over with no dropped query, the inserted gids
                 deleted while it is down, its respawn and recovery, the kill
                 of its peer and a last drain; the same checks, and each
                 worker's engine on the card (its telemetry).  The path's
                 launches are the workers' (each reads its own counts, taken
                 just before it is killed or closed) plus this process's
                 (the router's fold);
  cluster_oracle ``QualityRun.check_cluster`` (flat == cluster before and after
                 a kill and recovery, at the oracle's non-truncating cap) at
                 128 dims over the first 250,000 points (halved until the
                 flat query's slab at the raised cap fits 4 GiB; the
                 ground truth and the sizing run before the counted path),
                 in-process, then over worker processes on the card with
                 ``transport='process'`` and ``'tcp'`` (each its own path);
  dist           the distributed index (``repro_torch.launch.dist_index``):
                 four rank processes sharing the one card under gloo (the
                 exchanges copied through the host), over the same 1 M
                 points and 1,024 drain queries: a (2, 2) mesh (500 K rows
                 a shard, 512 queries a block) under 'allgather', 'ring'
                 and 'tree', bit for bit alike, every distance <= the flat
                 index's, every id's distance exact through
                 ``l1_distance_rows`` (held against its plain version);
                 four more (2, 2) calls with the cap from the built
                 histogram's 0.999 quantile and a bucket covering the
                 counts, alike under every merge and twice; the dry-run's
                 ANN configuration (k = 50) through 'tree'; the first 50,000
                 points on the card == on four CPU ranks (plain versions);
                 a (1, 4) mesh == the flat ``query_index``; 'nccl' with four
                 ranks on one card refused by the port, and NCCL's own
                 answer to two ranks on card 0 ("Duplicate GPU detected")
                 recorded; then ``check_distributed``
                 under nccl, one rank a card.  The path's launches are the
                 ranks' (each counts its own);
  batch          the kernels against their plain versions at the main path's
                 shapes, bit for bit: one served batch over the compacted
                 segment and a delta (the probe's extents, its gather and
                 both in one pass, and in one pass at caps 1 and 3 of
                 every ``PROBE_CASES`` entry; the staged probe's slab, whose valid
                 candidates must equal the gather's; ``fused_rerank`` with
                 each row's valid ids kept; the delta scan; the
                 ``topk_merge`` fold), ``fused_rerank``'s grouped items at
                 ``gist1m.bulk1024``'s shape (1 M x 960 int32, 1,024
                 queries, 131,072 and 205,824 slots; the rule's group and
                 windows, each row's valid ids kept, row loads <= pairs),
                 ``rw_hash`` at the build's 1 M rows
                 (against ``eval_prefix``, and the plain version on the
                 first 65,536) and at the batch, its table kernel, and
                 ``l1_distance_rows`` at the batch's first 4,096 candidates
                 a query and at SRS's shape in four input types on the
                 vector path, and one element into its storage on the
                 scalar path (the path from ``plan_rows``), and
                 ``l1_distance`` at 64 x 1 M x 128 with every coordinate in
                 +-2^30 (the int32 loop in every stage) and in int16.

Prints one ``{"host_syncs": ...}`` line, one ``{"lm": ...}`` line, one
``{"train": ...}`` line, one ``{"dryrun": ...}`` line, one
``{"shard_ranks": ...}`` line, one ``{"quality": ...}`` line, one
``{"tuned": ...}`` line, one ``{"cluster": ...}`` line, one ``{"dist": ...}``
line, the card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``.  Any failed check raises, so the exit code is not 0.
Exits 2 with no result when no card is present or the port's sources are
missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_POINTS, DIM, UNIVERSE = 1_000_000, 128, 510
N_QUERIES, N_INSERT, N_DELETE, K = 1024, 512, 64, 10
RW_PLAIN_ROWS = 65_536      # the plain thermometer at 1 M rows is ~6 TFLOP
CUDA_TESTS_TIMEOUT_S = 1800  # the card tests' subprocess
# the kernels each path must launch
PROBE = ("fused_probe_extents", "fused_probe_gather")
PATHS = {"ground_truth": ("l1_distance",),
         "serve": (*PROBE, "fused_rerank", "topk_merge"),
         "serve_rw_hash": ("rw_hash", "rw_prefix_table", *PROBE, "fused_rerank",
                           "topk_merge"),
         "checks": ("l1_distance_rows",),
         "quality": (*PROBE, "fused_rerank", "topk_merge", "l1_distance",
                     "l1_distance_rows"),
         "tuned": (*PROBE, "fused_rerank", "topk_merge", "l1_distance"),
         "cluster": (*PROBE, "fused_rerank", "topk_merge"),
         "cluster_oracle": (*PROBE, "fused_rerank", "topk_merge"),
         # over worker processes: the workers' launches plus the parent's
         "cluster_process": (*PROBE, "fused_rerank", "topk_merge"),
         "cluster_oracle_process": (*PROBE, "fused_rerank", "topk_merge"),
         "cluster_oracle_tcp": (*PROBE, "fused_rerank", "topk_merge"),
         # over rank processes: the ranks' launches
         "dist": (*PROBE, "fused_rerank", "topk_merge"),
         # the serve traffic under torch's sync debug mode, each engine
         "host_syncs": (*PROBE, "fused_rerank", "topk_merge"),
         "host_syncs_rw_hash": ("rw_hash", "rw_prefix_table", *PROBE, "fused_rerank",
                                "topk_merge"),
         # two ANN examples at their own sizes; ann_serving's brute_force_l1
         # runs l1_distance
         "examples": (*PROBE, "fused_rerank", "topk_merge", "l1_distance"),
         # the retrieval-augmented LM: the one-pass query_index and the
         # brute-force ground truth
         "lm_retrieval": (*PROBE, "fused_rerank", "l1_distance"),
         # language-model training: eager torch, no kernel of the repo
         "train": (),
         # the dry-run (fake tensors: every wrapper takes its plain version)
         # and the sharded forward: no kernel
         "shard": ()}
SYNC_BATCHES = 8            # drained batches before and after the compaction
TUNED_TARGET, TUNED_CALIB = 0.9, 32
QUALITY_QUERIES = 256
SRS_ROWS_CHUNK = 512        # SRS's l1_distance_chunked step (core/baselines.py: min(t, 512))
# the JAX package's full QualitySpec (benchmarks/quality_bench.py:42-47)
QUALITY_SPEC = dict(k=10, table_sweep=(1, 2, 4, 8, 16, 32),
                    table_sweep_single=(8, 16, 32, 64, 128), probe_sweep=(50, 150),
                    candidate_cap=64, num_hashes_rw=12, num_hashes_cp=8,
                    rerank_chunk=1024, srs_t=1024, target_recall=0.9)
CAUCHY_ROWS = 65_536        # rows of the card's Cauchy buckets held against float64
CLUSTER_SHARDS, CLUSTER_REPLICAS = 2, 2
ROUTER_COUNTS = ("queries", "batches", "served", "hedged_batches", "hedge_wins", "failovers",
                 "cache_hits", "cache_misses", "recoveries", "replicas_marked_dead",
                 "dispatch_failures")
# the cluster oracle: rows, queries, and the bound on the flat query's slab
# at the raised cap (ids, the gather's and the rerank's copies)
ORACLE_ROWS, ORACLE_QUERIES, ORACLE_SLAB_BYTES = 250_000, 64, 4 << 30
# the distributed index: four rank processes sharing the one card (gloo, the
# exchanges through the host), the occ_hist quantiles of the capped runs (the
# serving policy's, and one whose cap truncates), the rows and queries of the
# card-against-CPU check, and the dry-run's ANN configuration
# (src/repro/launch/dryrun.py:181-183)
DIST_RANKS = 4
DIST_QUANTILES = {"policy": 0.999, "truncating": 0.9}
DIST_CPU_ROWS, DIST_CPU_QUERIES = 50_000, 64
DRYRUN_ANN = dict(num_tables=8, num_hashes=16, width=256, num_probes=100,
                  candidate_cap=8, universe=512, k=50, rerank_chunk=1024)
# the language models: every arch's reduced() on the card against the CPU
# (float32, TF32 off), then smollm-360m at full width and depth: B 8 prompts
# of 128 tokens, 64 greedy steps against a 192-slot cache; the JAX
# package's own decode-against-forward bound (tests/test_models.py:77-78)
LM_ARCH, LM_BATCH, LM_PROMPT, LM_CACHE, LM_GREEDY = "smollm_360m", 8, 128, 192, 64
LM_REDUCED_TOL, LM_FULL_TOL, LM_BF16_SHARE = 1e-3, 2e-2, 0.1
LM_DECODE_STEPS = 8
# language-model training: every arch's reduced() one step on the card
# against the CPU (float32, TF32 off; B 4 x S 32, the CPU tests' batch):
# each gradient leaf within TRAIN_GRAD_SHARE of its max |g|, then
# TRAIN_REDUCED_STEPS steps' losses and grad norms within TRAIN_STEP_RTOL
# (an AdamW step turns a gradient's rounding into a sign, so parameters are
# not compared); smollm-360m at full width and depth in bf16, B 8 x S 128,
# TRAIN_STEPS steps, and its gradients with and without remat within
# TRAIN_REMAT_SHARE (bf16);
# repro_torch.examples.train_smollm straight and resumed half-way, losses
# within TRAIN_RESUME_RTOL and parameters within TRAIN_RESUME_SHARE of a
# leaf's max |value| (the card's reductions need not repeat bit for bit)
TRAIN_GRAD_SHARE, TRAIN_STEP_RTOL, TRAIN_REDUCED_STEPS = 1e-3, 1e-3, 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 20
TRAIN_REMAT_SHARE, TRAIN_RESUME_RTOL, TRAIN_RESUME_SHARE = 2e-2, 1e-4, 1e-3
# sharding: the dry-run's cells at full width and depth, each a process of
# its own (one fake world a process), all started together: (arch, shape,
# multi_pod), and the ANN cell at the reference's defaults; a per-rank peak
# above SHARD_HBM_BYTES does not fit one card; then the sharded forward of
# SHARD_ARCH at full width and depth in float32 on a SHARD_MESH of four
# gloo rank processes on the CPU against the unsharded prefill on the card,
# within SHARD_SHARE of max |logit| (1.4e-6 measured on the first card call
# of this phase).  The ranks do not share the card: gloo does not take
# DTensor's collectives on CUDA tensors (on that call a rank of four died
# with SIGSEGV); ``--dist-cards 4`` runs them under nccl, one rank a card.
SHARD_CELLS = (("smollm-360m", "train_4k", False), ("smollm-360m", "prefill_32k", False),
               ("smollm-360m", "decode_32k", False), ("smollm-360m", "train_4k", True),
               ("mamba2-370m", "long_500k", False))
SHARD_HBM_BYTES, SHARD_FRAC_MAX, SHARD_CELL_TIMEOUT_S = 80e9, 1.05, 600
SHARD_ARCH, SHARD_MESH, SHARD_BATCH, SHARD_SEQ, SHARD_SHARE = \
    "smollm_360m", (2, 2), 4, 128, 1e-5
SHARD_RANKS_DEVICE = "cpu"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke check failed: {what}")


def equal(a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))


@contextlib.contextmanager
def plain_kernels(ops, kfp, kfr, ktm, kl1, krw):
    """Route every ``ops`` wrapper to its kernel's plain version, on the
    tensors' own device (the card too), for as long as the block runs."""
    saved = {name: getattr(ops, name) for name in (
        "topk_merge", "fused_rerank", "probe_extents", "fused_probe", "rw_hash",
        "l1_distance", "l1_distance_rows")}

    def fused_probe(sorted_keys, sorted_ids, probe_keys, cap, cbucket, extents=None,
                    occ_from=None):
        if extents is None:
            return kfp.fused_probe_plain(sorted_keys, sorted_ids, probe_keys, cap, cbucket,
                                         occ_from=occ_from)
        return kfp.compact_gather(sorted_ids, extents[0], extents[1], probe_keys.shape[2],
                                  cbucket, cap)

    ops.topk_merge, ops.fused_rerank = ktm.topk_merge_plain, kfr.fused_rerank_plain
    ops.probe_extents, ops.fused_probe = kfp.probe_extents, fused_probe
    ops.rw_hash, ops.l1_distance = krw.rw_hash_plain, kl1.l1_distance_plain
    ops.l1_distance_rows = kl1.l1_distance_rows_plain
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def quality_phase(ops, spec, data, queries, served_cfg, kernel_modules):
    """The paper's protocol on the card (the ``quality`` path), then the
    checks that need plain versions or the CPU.  Returns the summary that
    the ``{"quality": ...}`` line prints and the path's launch counts."""
    from repro_torch.core import baselines as bl
    from repro_torch.core import hashes
    from repro_torch.core.index import build_index, query_index
    from repro_torch.eval import QualityRun, QualitySpec

    qspec = QualitySpec(**QUALITY_SPEC)

    def protocol():
        qrun = QualityRun(data, queries, spec.universe, qspec, device="cuda")
        records = qrun.sweep()
        claim = qrun.table_claim(records)
        l_mp = claim["tables_needed"]["mp-rw-lsh"] or max(qspec.table_sweep)
        oracle_cfg = qrun.scheme_config("mp-rw-lsh", l_mp, qspec.probe_sweep[-1])
        cross = qrun.check_cross_layer(oracle_cfg, cluster=False)
        served = qrun.eval_config(served_cfg)
        return qrun, records, claim, oracle_cfg, cross, served

    (qrun, records, claim, oracle_cfg, cross, served), launches = run_path(
        "quality", ops, protocol)
    for r in records:
        check(0.0 <= r["recall"] <= 1.0 and r["ratio"] >= 1.0 - 1e-9,
              f"quality record {r} has recall in [0, 1] and ratio >= 1")
    flags = {k: v for k, v in cross.items() if isinstance(v, bool)}
    check(len(flags) == 6 and all(flags.values()),
          f"every cross-layer flag holds at the claim's config: {flags}")

    # one configuration of each family through the kernels and through their
    # plain versions, both on the card
    plain_equal = {}
    mp_cp = qrun.scheme_config("mp-cp-lsh", 8, qspec.probe_sweep[-1])
    for family, cfg in (("rw", qrun.scheme_config("mp-rw-lsh", 8, qspec.probe_sweep[-1])),
                        ("cauchy", mp_cp),
                        ("gaussian", dataclasses.replace(mp_cp, family="gaussian"))):
        state = build_index(cfg, qrun.data, params=qrun.params(cfg))
        got = query_index(cfg, state, qrun.queries)
        before = dict(ops.LAUNCHES)
        with plain_kernels(ops, *kernel_modules):
            want = query_index(cfg, state, qrun.queries)
        check(dict(ops.LAUNCHES) == before, f"the plain route of {family} launched no kernel")
        check(equal(got[0], want[0]) and equal(got[1], want[1]),
              f"query_index on the card == its plain kernel versions on the card ({family})")
        plain_equal[family] = {"num_tables": cfg.num_tables, "num_probes": cfg.num_probes,
                               "width": cfg.width, "equal": True,
                               "recall": qrun._score(*got)["recall"]}
        del state

    # the path's l1_distance, l1_distance_rows and topk_merge at its own
    # inputs: the ground truth, SRS and the fragmented index's fold, again
    # through the plain versions on the card
    k = qspec.k
    srs = qrun._srs_state()
    srs_t = min(qspec.srs_t, int(qrun.data.shape[0]))
    srs_got = bl.query_srs(srs, qrun.queries, srs_t, k)
    frag = qrun.fragmented(oracle_cfg)
    frag_got = frag.query(qrun.queries)
    before = dict(ops.LAUNCHES)
    with plain_kernels(ops, *kernel_modules):
        gt_plain = bl.brute_force_l1(qrun.data, qrun.queries, k)
        srs_plain = bl.query_srs(srs, qrun.queries, srs_t, k)
        frag_plain = frag.query(qrun.queries)
    check(dict(ops.LAUNCHES) == before, "the plain route of the quality path launched no kernel")
    check(np.array_equal(gt_plain[0].cpu().numpy(), qrun.true_d)
          and np.array_equal(gt_plain[1].cpu().numpy(), qrun.true_i),
          "the quality ground truth (l1_distance) == its plain version on the card")
    srs_rec = next(r for r in records if r["scheme"] == "srs")
    check(equal(srs_got[0], srs_plain[0]) and equal(srs_got[1], srs_plain[1])
          and {x: srs_rec[x] for x in ("recall", "ratio")} == qrun._score(*srs_plain),
          "SRS (l1_distance_rows) == its plain version on the card, and its record")
    check(all(equal(torch.as_tensor(a), torch.as_tensor(b))
              for a, b in zip(frag_got, frag_plain))
          and qrun._score(*frag_plain)["recall"] == cross["mutated_recall"],
          "the fragmented index's query (topk_merge) == its plain version on the card")
    plain_path = {"ground_truth": {"queries": int(qrun.queries.shape[0]),
                                   "rows": int(qrun.data.shape[0]), "equal": True},
                  "srs": {"t": srs_t, "equal": True},
                  "fragmented": {"segments": frag.num_segments,
                                 "delta_fill": frag.delta_fill, "equal": True}}
    del frag, srs

    # the card's Cauchy buckets against float64 on the CPU, with the global
    # float32 matmul precision as it is and with TF32 allowed
    cfg = qrun.scheme_config("cp-lsh", 16)
    params = qrun.params(cfg)
    sub = qrun.data[:CAUCHY_ROWS]
    precision = torch.get_float32_matmul_precision()
    card = lambda: hashes.bucket_and_offsets(params, hashes.raw_hash(params, sub))[0].cpu()
    lm = cfg.num_tables * cfg.num_hashes
    proj = params.proj.reshape(lm, -1)
    b_card = card()
    torch.set_float32_matmul_precision("high")       # TF32 for float32 products
    try:
        b_tf32 = card()
    finally:
        torch.set_float32_matmul_precision(precision)
    f64 = (sub.cpu().double() @ proj.cpu().double().t()).reshape(b_card.shape)
    ref = torch.floor((f64 + params.offsets.cpu().double()) / params.width)
    agree = float((b_card.double() == ref).double().mean())
    check(agree >= 0.9999, f"the card's Cauchy buckets agree >= 0.9999 with float64 ({agree})")
    check(equal(b_card, b_tf32), "the card's Cauchy buckets are the same with TF32 allowed")
    cauchy = {"rows": int(sub.shape[0]), "functions": lm, "width": cfg.width,
              "agreement_float64": agree,
              "float32_matmul_precision": precision,
              "same_with_tf32": True}

    needed = claim["tables_needed"]
    summary = {
        "n": int(qrun.data.shape[0]), "dim": int(qrun.data.shape[1]),
        "queries": int(qrun.queries.shape[0]), "k": qspec.k, "dbar": qrun.dbar,
        "w_rw": qrun.w_rw, "w_cp": qrun.w_cp, "spec": QUALITY_SPEC,
        "records": records, "table_claim": claim,
        "cp_over_mp_rw": claim["ratio_vs_mp_rw"].get("cp-lsh"),
        "cp_over_mp_rw_lower_bound": (
            None if needed.get("mp-rw-lsh") is None or needed.get("cp-lsh") is not None
            else claim["sweep_max_tables"] / needed["mp-rw-lsh"]),
        "paper_cp_over_mp_rw": [15, 53],
        # the same claim at lower targets, reported and not gated
        "claims_by_target": {str(t): {k: c[k] for k in ("tables_needed", "ratio_vs_mp_rw")}
                             for t in (0.8, 0.7, 0.6, 0.5, 0.4)
                             for c in [qrun.table_claim(records, t)]},
        "served": {"num_tables": served_cfg.num_tables, "num_hashes": served_cfg.num_hashes,
                   "width": served_cfg.width, "num_probes": served_cfg.num_probes,
                   "candidate_cap": served_cfg.candidate_cap, **served},
        "oracle_config": {"scheme": "mp-rw-lsh", "num_tables": oracle_cfg.num_tables,
                          "num_probes": oracle_cfg.num_probes},
        "cross_layer": cross, "plain_equal": plain_equal, "plain_path": plain_path,
        "cauchy_buckets": cauchy, "launches": launches}
    return summary, launches


def tuned_phase(ops, kernel_modules, serve, cfg, serve_cfg, data_c, queries, inserted,
                q_c, check_served):
    """The recall-target engine on the card (the ``tuned`` path), then, outside
    the counted path, its checks.  Returns the summary that the
    ``{"tuned": ...}`` line prints and the path's launch counts."""
    from repro_torch.core.index import query_index
    from repro_torch.core.segments import SegmentedIndex
    from repro_torch.eval import autotune
    from repro_torch.obs import render, trace
    from repro_torch.serve.engine import AnnServingEngine

    tuned_serve = dataclasses.replace(serve_cfg, target_recall=TUNED_TARGET,
                                      autotune_calib=TUNED_CALIB)
    real_tune, tunes = autotune.tune_for_recall, []

    def counted_tune(*args, **kw):              # the engine's own tuning run
        tunes.append(1)
        return real_tune(*args, **kw)

    autotune.tune_for_recall = counted_tune
    try:
        (eng, phases), launches = run_path(
            "tuned", ops, lambda: serve(cfg, "tuned", tuned_serve))
    finally:
        autotune.tune_for_recall = real_tune
    res = eng.autotune
    check(res is not None and len(tunes) == 1, "the engine tuned once at start-up")
    check(eng.cfg == res.cfg, "the engine serves the tuned configuration")

    # the tuner again, through the kernels' plain versions on the card
    before = dict(ops.LAUNCHES)
    with plain_kernels(ops, *kernel_modules):
        plain = real_tune(cfg, data_c, TUNED_TARGET, num_calib=TUNED_CALIB,
                          device="cuda")
    torch.cuda.synchronize()
    check(dict(ops.LAUNCHES) == before, "the tuner's plain route launched no kernel")
    check(plain.history == res.history and plain.cfg == res.cfg
          and plain.predicted_recall == res.predicted_recall
          and plain.validated_recall == res.validated_recall
          and plain.d_calib == res.d_calib and plain.met_target == res.met_target,
          "the tuner under the plain versions == under the kernels, field for field")
    del plain

    served = {}
    for name, d, i in phases:
        r, hits = check_served(name, d, i, name.endswith("_delta"))
        served[name] = {"recall": r, "self_hits": hits}
    summ = eng.summary()
    check(summ["batches"] == 2 * -(-N_QUERIES // serve_cfg.batch_size)
          and summ["quality"]["num_tables"] == res.cfg.num_tables,
          "the summary counts every served batch and reports the tuned tables")

    # one batch through the staged probe and the concat fold of a fragmented
    # index, on the compacted tuned index
    seg = eng.index.segments[0]
    check(eng.index.num_segments == 1 and eng.index.delta_fill == 0,
          "the tuned index is compacted")
    batch = q_c[:serve_cfg.batch_size].contiguous()
    staged_cfg = dataclasses.replace(eng.cfg, probe_impl="staged")
    sd, si = query_index(staged_cfg, seg.state, batch)
    fd, fi = query_index(eng.cfg, seg.state, batch)
    check(equal(sd, fd) and equal(si, fi),
          "probe_impl='staged' == the fused probe on the tuned index, bit for bit")
    frag = SegmentedIndex.from_checkpoint(eng.cfg, seg.state, seg.gids,
                                          eng.index.next_gid,
                                          delta_cap=2 * len(inserted) // 5)
    frag.insert(inserted)                       # two sealed segments and a delta
    check(frag.num_segments == 3 and frag.delta_fill > 0, "a fragmented index")
    floor = serve_cfg.cand_bucket_min
    for what, got, want in (
            ("query", frag.query(batch, use_merge_kernel=False), frag.query(batch)),
            ("query_compact", frag.query_compact(batch, floor, False)[:2],
             frag.query_compact(batch, floor)[:2])):
        check(equal(got[0], want[0]) and equal(got[1], want[1]),
              f"the concat fold == the topk_merge fold ({what}), bit for bit")
    concat = {"segments": frag.num_segments, "delta_rows": frag._delta_count,
              "equal": True}
    del frag

    # one traced drain with a delta (all four phase spans), against the same
    # drain untraced
    eng.insert(inserted[:N_INSERT // 2])
    eng.warmup()                                # the new structure, untraced
    trace_dir = ROOT / "build" / "chip_smoke_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.environ["REPRO_TRACE_DIR"] = str(trace_dir)
    os.environ["REPRO_TRACE"] = "1"
    rec0 = eng.flight.recorded
    try:
        eng.submit(queries)
        traced = eng.drain()
    finally:
        del os.environ["REPRO_TRACE"]
    trace.flush()
    n_traced = eng.flight.recorded - rec0
    eng.submit(queries)
    untraced = eng.drain()
    check(all(np.array_equal(a, b) for a, b in zip(traced, untraced)),
          "tracing changes no served result")
    spans = render.load_spans(str(trace_dir))
    report = render.check_spans(spans)
    check(report["ok"], f"the port's trace checks: {report['errors']}")
    (trace_dir / "trace.json").write_text(json.dumps(render.to_chrome(spans)))
    names = ("engine_batch", "phase_a", "phase_b_rerank", "delta_scan", "merge")
    counts = {n: sum(r["name"] == n for r in spans) for n in names}
    check(n_traced > 0 and counts["engine_batch"] == n_traced,
          "one engine_batch span for each batch of the traced drain")
    check(all(counts[n] == n_traced for n in names[1:]),
          "each traced batch has the four phase spans")
    trace_summary = {"dir": str(trace_dir.relative_to(ROOT)), "records": len(spans),
                     "batches": n_traced, "spans": counts}

    # one drain under the race sanitizer, through the constructor's seam
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        guarded = AnnServingEngine(eng.cfg, serve_cfg, index=eng.index)
        check(hasattr(guarded, "__repro_race_token__"), "the sanitizer instruments the engine")
        guarded.submit(queries)
        clean = guarded.drain()
    finally:
        del os.environ["REPRO_SANITIZE"]
    check(all(np.array_equal(a, b) for a, b in zip(clean, untraced)),
          "the sanitized drain is clean and serves the same results")
    del guarded

    summary = {
        "target_recall": TUNED_TARGET, "autotune_calib": TUNED_CALIB,
        "base": {"num_tables": cfg.num_tables, "num_probes": cfg.num_probes,
                 "candidate_cap": cfg.candidate_cap, "width": cfg.width},
        "tuned": {"num_tables": res.cfg.num_tables, "num_probes": res.cfg.num_probes,
                  "candidate_cap": res.cfg.candidate_cap},
        "predicted_recall": res.predicted_recall,
        "validated_recall": res.validated_recall, "met_target": res.met_target,
        "rounds": res.rounds, "history": list(res.history), "d_calib": list(res.d_calib),
        "plain_equal": True, "quality": summ["quality"], "served": served,
        "cand_buckets": summ["cand_buckets"], "trace": trace_summary,
        "staged_equal": True, "concat": concat, "sanitized_clean": True,
        "launches": launches}
    del eng
    return summary, launches


def cluster_phase(ops, cfg, serve_cfg, data, queries, inserted, deleted, check_drain):
    """The in-process cluster on the card (the ``cluster`` path), then its
    recovery checks.  ``check_drain(name, d, i, stage)`` checks a drain's
    results.  Returns the summary of the ``{"cluster": ...}`` line and the
    path's launch counts."""
    from repro_torch.cluster import ClusterConfig, ClusterRouter

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as root:
        def traffic():
            # no result cache: each drain repeats the same queries, and every
            # one of them is to reach the replicas
            router = ClusterRouter(cfg, serve_cfg,
                                   ClusterConfig(num_shards=CLUSTER_SHARDS,
                                                 num_replicas=CLUSTER_REPLICAS,
                                                 cache_capacity=0),
                                   data, root, device="cuda")
            gids = router.insert(inserted)
            check(list(gids[:2]) == [N_POINTS, N_POINTS + 1],
                  "cluster: insert assigns fresh gids")
            check(router.delete(deleted) == len(deleted),
                  "cluster: delete tombstones every gid")
            drains = {}

            def drain(name):
                rec0 = router.flight.recorded
                router.submit(queries)
                d, i = router.drain()
                n = router.flight.recorded - rec0
                check(0 < n <= router.flight.capacity, f"cluster: {n} dispatches recorded")
                drains[name] = (d, i, n)

            drain("cluster_delta")
            router.compact()
            drain("cluster_compacted")
            router.kill_replica(0, 0)
            check(router.delete(gids) == len(gids), "cluster: the inserted gids deleted")
            info = router.recover_replica(0, 0)
            # the recovered replica answers as its peer did, bit for bit
            # (replica queries outside the router, not counted)
            batch = queries[:serve_cfg.batch_size]
            ask = lambda r: tuple(t.cpu() for t in router.replicas[0][r].query(
                batch, batch.shape[0]))
            pd, pi = uncounted(ops, router, lambda: ask(1))
            router.kill_replica(0, 1)
            rd, ri = uncounted(ops, router, lambda: ask(0))
            check(torch.equal(pd, rd) and torch.equal(pi, ri),
                  "cluster: the recovered replica answers as its peer did, bit for bit")
            drain("cluster_recovered")
            router._quiesce()     # late hedge losers launch on the path too
            return router, drains, info

        (router, drains, info), launches = run_path("cluster", ops, traffic)
        summary = router.summary()
        router.close()
    check(summary["recoveries"] >= 1, "cluster: the router recovered a replica")
    check(info["replayed"] + info["caught_up"] >= 1,
          "cluster: the recovery replayed or caught up a record")
    out = {"shards": CLUSTER_SHARDS, "replicas": CLUSTER_REPLICAS,
           "rows_per_shard": N_POINTS // CLUSTER_SHARDS, "recovery": info,
           "router": {k: summary[k] for k in ROUTER_COUNTS},
           "launches": launches, "drains": {}}
    for name, (d, i, n) in drains.items():
        r, hits = check_drain(name, d, i, name)
        out["drains"][name] = {"batches": n, "recall": r, "self_hits": hits}
    return out, launches


@contextlib.contextmanager
def worker_launches():
    """Sum the kernel launches of every worker process that a
    ``RemoteReplica`` kills or closes meanwhile, read from its telemetry
    just before (a worker counts its own launches; they die with it)."""
    from repro_torch.cluster import ReplicaKilled, remote
    got = {k: 0 for k in PATHS["cluster"]}
    kill, close = remote.RemoteReplica.kill, remote.RemoteReplica.close

    def take(rep):
        try:
            for k, n in rep.telemetry()["launches"].items():
                got[k] = got.get(k, 0) + n
        except ReplicaKilled:
            pass                # already dead: its counts were taken then

    def killed(rep):
        take(rep)
        kill(rep)

    def closed(rep):
        take(rep)
        close(rep)

    remote.RemoteReplica.kill, remote.RemoteReplica.close = killed, closed
    try:
        yield got, take
    finally:
        remote.RemoteReplica.kill, remote.RemoteReplica.close = kill, close


def worker_log_tails(router) -> str:
    return "\n".join(f"--- worker s{rep.shard_id}r{rep.replica_id} log ---\n"
                     f"{rep.handle.tail_log()}"
                     for group in router.replicas for rep in group)


def cluster_process_phase(ops, cfg, serve_cfg, data, queries, inserted, deleted,
                          check_drain):
    """The cluster over worker processes on the card (the
    ``cluster_process`` path): one worker a replica, each with its own
    CUDA context, the traffic of the ``cluster`` phase, then a real SIGKILL
    of worker (0, 0), failover, deletes while it is down, its respawn and
    recovery, and the kill of its peer.  The path's launches are the
    parent's (the fold's ``topk_merge``) plus every worker's."""
    from repro_torch.cluster import ClusterConfig, ClusterRouter, ReplicaKilled

    with tempfile.TemporaryDirectory(prefix="chip_smoke_process_") as root, \
            worker_launches() as (w_launches, take):
        def traffic():
            router = ClusterRouter(cfg, serve_cfg,
                                   ClusterConfig(num_shards=CLUSTER_SHARDS,
                                                 num_replicas=CLUSTER_REPLICAS,
                                                 transport="process", cache_capacity=0),
                                   data, root, device="cuda")
            try:
                out = drive(router)
                return router.summary(), *out
            except BaseException:
                log(worker_log_tails(router))
                raise
            finally:
                router.close()          # takes the live workers' counts

        def drive(router):
            devices = {}
            for group in router.replicas:
                for rep in group:
                    try:
                        devices[f"{rep.shard_id}.{rep.replica_id}"] = rep.telemetry()["device"]
                    except ReplicaKilled:
                        continue
            check(set(devices.values()) == {"cuda"}, f"cluster_process: every worker "
                  f"runs its engine on the card ({devices})")
            gids = router.insert(inserted)
            check(list(gids[:2]) == [N_POINTS, N_POINTS + 1],
                  "cluster_process: insert assigns fresh gids")
            check(router.delete(deleted) == len(deleted),
                  "cluster_process: delete tombstones every gid")
            drains = {}

            def drain(name, stage):
                rec0 = router.flight.recorded
                fail0 = router.stats["dispatch_failures"]
                router.submit(queries)
                d, i = router.drain()
                if router.stats["dispatch_failures"] != fail0:
                    log(worker_log_tails(router))
                check(router.stats["dispatch_failures"] == fail0,
                      f"{name}: every batch served (no dropped query)")
                n = router.flight.recorded - rec0
                check(0 < n <= router.flight.capacity, f"{name}: {n} dispatches recorded")
                drains[name] = (d, i, n, stage)

            drain("cluster_process_delta", "cluster_delta")
            router.compact()
            drain("cluster_process_compacted", "cluster_compacted")
            # a real, unannounced process death: the drain fails over
            victim = router.replicas[0][0]
            take(victim)
            victim.handle.sigkill()
            router._rr[0] = 0                  # the dead worker is preferred next
            failovers0 = router.stats["failovers"]
            drain("cluster_process_failover", "cluster_compacted")
            check(router.stats["failovers"] > failovers0,
                  "cluster_process: the SIGKILL'd worker's batches failed over")
            check(router.delete(np.asarray(gids)) == len(gids),
                  "cluster_process: the inserted gids deleted")
            check(not victim.alive, "cluster_process: the dead worker marked down")
            info = router.recover_replica(0, 0)
            # the recovered worker answers as its peer did, bit for bit
            # (replica queries outside the router; their launches taken back)
            batch = queries[:serve_cfg.batch_size]
            pair = router.replicas[0]
            before = [rep.telemetry()["launches"] for rep in pair]
            pd, pi = pair[1].query(batch, batch.shape[0])
            after1 = pair[1].telemetry()["launches"]
            router.kill_replica(0, 1)          # takes (0, 1)'s counts
            rd, ri = pair[0].query(batch, batch.shape[0])
            after0 = pair[0].telemetry()["launches"]
            for k in w_launches:
                w_launches[k] -= (after1[k] - before[1][k]) + (after0[k] - before[0][k])
            check(np.array_equal(pd, rd) and np.array_equal(pi, ri),
                  "cluster_process: the recovered worker answers as its peer did, "
                  "bit for bit")
            drain("cluster_process_recovered", "cluster_recovered")
            router._quiesce()
            return drains, info

        (summary, drains, info), launches = run_path(
            "cluster_process", ops, traffic, more=w_launches)
        parent = {k: launches[k] - w_launches.get(k, 0) for k in launches}
    for k in (*PROBE, "fused_rerank", "topk_merge"):
        check(w_launches.get(k, 0) > 0, f"cluster_process: the workers launched {k}")
    check(parent["topk_merge"] > 0, "cluster_process: the router's fold launched topk_merge")
    check(summary["recoveries"] >= 1, "cluster_process: the router recovered a worker")
    check(info["replayed"] + info["caught_up"] >= 1,
          "cluster_process: the recovery replayed or caught up a record")
    out = {"transport": "process", "shards": CLUSTER_SHARDS, "replicas": CLUSTER_REPLICAS,
           "rows_per_shard": N_POINTS // CLUSTER_SHARDS, "recovery": info,
           "router": {k: summary[k] for k in ROUTER_COUNTS}, "wire": summary["wire"],
           "launches": launches, "launches_parent": parent,
           "launches_workers": dict(w_launches), "drains": {}}
    for name, (d, i, n, stage) in drains.items():
        r, hits = check_drain(name, d, i, stage)
        out["drains"][name] = {"batches": n, "recall": r, "self_hits": hits}
    return out, launches


def cluster_oracle_phase(ops, spec, data):
    """``QualityRun.check_cluster`` on the card (the ``cluster_oracle``
    path) at 128 dims over the first ``ORACLE_ROWS`` points, halved until
    the flat query's slab at the oracle's raised cap fits
    ``ORACLE_SLAB_BYTES``."""
    from repro_torch.core import pipeline as pipe
    from repro_torch.core.index import build_index
    from repro_torch.data import ann_synthetic as ds
    from repro_torch.eval import QualityRun, QualitySpec

    n = ORACLE_ROWS
    while True:                 # size the cut outside the counted path
        rows = data[:n]
        run = QualityRun(rows, ds.make_queries(spec, rows, ORACLE_QUERIES, seed=31),
                         spec.universe, QualitySpec(k=K, candidate_cap=64, num_hashes_rw=12),
                         device="cuda")
        cfg = run.scheme_config("mp-rw-lsh", 8, 50)
        state = build_index(cfg, run.data, params=run.params(cfg))
        cap = pipe.oracle_candidate_cap(cfg, state.sorted_keys, state.occ_from)
        del state
        slab = 3 * 4 * ORACLE_QUERIES * cfg.num_tables * cfg.probes_per_table * cap
        log(f"cluster_oracle: {n} rows x {spec.dim}, raised cap {cap}, flat slab "
            f"{slab / 2 ** 30:.2f} GiB (bound {ORACLE_SLAB_BYTES / 2 ** 30:.0f} GiB)")
        if slab <= ORACLE_SLAB_BYTES:
            break
        n //= 2
    got, launches = run_path("cluster_oracle", ops, lambda: run.check_cluster(cfg))
    check(got["cluster_matches_flat"], "cluster_oracle: cluster == flat, bit for bit")
    check(got["cluster_recovery_matches_flat"],
          "cluster_oracle: after kill and recovery, cluster == flat, bit for bit")
    out = {"rows": n, "cut": f"n {n} of {N_POINTS} (the flat oracle's slab at the raised "
           f"cap), dims {spec.dim} kept", "config": dataclasses.asdict(cfg), **got}
    all_launches = {"cluster_oracle": launches}
    # the same oracle over worker processes on the card, each transport
    for transport in ("process", "tcp"):
        name = f"cluster_oracle_{transport}"
        with worker_launches() as (w_launches, _):
            got, all_launches[name] = run_path(
                name, ops, lambda: run.check_cluster(cfg, transport=transport),
                more=w_launches)
        check(got["cluster_matches_flat"] and got["cluster_recovery_matches_flat"],
              f"{name}: cluster == flat, bit for bit, before and after a SIGKILL and "
              "recovery")
        for k in (*PROBE, "fused_rerank"):
            check(w_launches.get(k, 0) > 0, f"{name}: the workers launched {k}")
        out[transport] = {**got, "launches_workers": dict(w_launches)}
    return out, all_launches


def _nccl_rank_on_card0(rank, init, out):
    """One of two ranks that both take card 0 under nccl (what the port
    refuses): NCCL's own answer at the first collective, written to
    ``out.<rank>``."""
    import datetime
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=init, rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = f"no error: all_reduce gave {t.item()}"
    except Exception as err:         # the answer is the result
        msg = f"{type(err).__name__}: {err}"
    Path(f"{out}.{rank}").write_text(msg)
    os._exit(0)


def nccl_own_answer() -> list:
    """NCCL's own answer to two ranks on one card, each rank's text: the
    reason the ``dist`` phase's ranks share the card under gloo."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        init, out = Path(tmp, "store").as_uri(), os.path.join(tmp, "answer")
        procs = [ctx.Process(target=_nccl_rank_on_card0, args=(r, init, out))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        check(not hung, "NCCL with two ranks on card 0 answered within 120 s")
        return [Path(f"{out}.{r}").read_text() for r in range(2)]


def dist_phase(ops, plain_rows, recall, cfg, data, queries, gt_i0):
    """The distributed index (``repro_torch.launch.dist_index``, the
    ``dist`` path) on the one card: four gloo ranks, each its own process
    and CUDA context, the exchanges copied through the host.  Over the
    serve phase's points and drain queries: a (2, 2) mesh (500 K rows a
    shard, 512 queries a block) under the three merges, then with a cap
    from the built histogram and a bucket covering the counts (four
    calls), the dry-run's ANN configuration through the tree, the first
    50,000 points, and a (1, 4) mesh (the queries over four ranks).  The
    path's launches are the ranks' (each counts its own)."""
    from repro_torch.core.index import IndexConfig, build_index, make_params, query_index
    from repro_torch.core.pipeline import BIG_DIST
    from repro_torch.eval import QualityRun, QualitySpec
    from repro_torch.launch import dist_index as di

    card = torch.device("cuda")
    params = make_params(cfg, DIM)
    dry = IndexConfig(**DRYRUN_ANN)
    base = {"cfg": cfg, "params": params}
    runs = {f"rows2_model2_{m}": {"shape": (2, 2), "merge": m, **base} for m in di.MERGES}
    for tag, q in DIST_QUANTILES.items():
        capped = {"shape": (2, 2), "cand_bucket": "cover", "cap_quantile": q, **base}
        for m in di.MERGES:
            runs[f"rows2_model2_{m}_{tag}"] = {"merge": m, **capped}
        runs[f"rows2_model2_tree_again_{tag}"] = {"merge": "tree", **capped}
    runs.update({
            "dryrun_rows2_model2_tree": {"shape": (2, 2), "merge": "tree", "cfg": dry,
                                         "params": make_params(dry, DIM)},
            "rows2_model2_first_rows": {"shape": (2, 2), "rows": DIST_CPU_ROWS,
                                        "queries": DIST_CPU_QUERIES, **base},
            "model4_allgather": {"shape": (1, 4), **base}})
    names = list(runs)
    rank_launches = {k: 0 for k in ops.LAUNCHES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        path = os.path.join(tmp, "points.npy")
        np.save(path, data)
        if torch.cuda.device_count() < DIST_RANKS:
            try:
                di.spawn_ranks(DIST_RANKS, di.run_meshes, path, queries, [],
                               backend="nccl", device="cuda")
            except ValueError as err:
                nccl_refusal = str(err)
            else:
                check(False, "backend 'nccl' with two ranks on one card raises")
            check("two ranks on one card" in nccl_refusal,
                  f"the nccl refusal names the shared card: {nccl_refusal}")
            nccl_answer = [next((ln.strip() for ln in a.splitlines() if "Duplicate GPU" in ln),
                                a[:300]) for a in nccl_own_answer()]
            log(f"dist: NCCL's own answer to two ranks on card 0: {nccl_answer}")
            check(all("Duplicate GPU" in a for a in nccl_answer),
                  "dist: NCCL itself refuses two ranks on one card")

        def ranks():
            reports = di.spawn_ranks(DIST_RANKS, di.run_meshes, path, queries,
                                     list(runs.values()), backend="gloo", device="cuda",
                                     timeout_s=600)
            for rep in reports:
                for k, n in rep["launches"].items():
                    rank_launches[k] += n
            return reports

        reports, launches = run_path("dist", ops, ranks, more=rank_launches)
        cpu = di.spawn_ranks(DIST_RANKS, di.run_meshes, path, queries,
                             [runs["rows2_model2_first_rows"]], backend="gloo",
                             device="cpu", timeout_s=600)
    recs = [rep["result"] for rep in reports]
    got = {name: di.assemble(recs, k) for k, name in enumerate(names)}
    check(all(rep["device"] == "cuda:0" for rep in reports)
          and all(r["exchange"] == "host" and r["backend"] == "gloo" for rr in recs for r in rr),
          "dist: every rank computes on the card, and exchanges through the host")
    for k, name in enumerate(names):
        if runs[name]["shape"][0] > 1:
            check(all(rr[k]["sent_bytes"] > 0 for rr in recs),
                  f"dist {name}: every rank sent bytes (the (2, 2) mesh exchanges)")
    # the merges, bit for bit
    for m in ("ring", "tree"):
        check(all(np.array_equal(a, b) for a, b in zip(got[f"rows2_model2_{m}"],
                                                        got["rows2_model2_allgather"])),
              f"dist: '{m}' == 'allgather' on the (2, 2) mesh, bit for bit")
    caps = {}
    for tag in DIST_QUANTILES:
        capped = [n for n in names if n.endswith(tag)]
        taken = {(rr[names.index(n)]["cand_cap"], rr[names.index(n)]["cand_bucket"])
                 for n in capped for rr in recs}
        check(len(taken) == 1, f"dist: one cap and one bucket on every rank and {tag} run "
              f"({taken})")
        caps[tag] = taken.pop()
        check(all(np.array_equal(a, b) for n in capped
                  for a, b in zip(got[n], got[f"rows2_model2_allgather_{tag}"])),
              f"dist: the {tag} capped runs equal each other under every merge and twice")
    check(all(np.array_equal(a, b) for a, b in zip(got["rows2_model2_allgather_policy"],
                                                    got["rows2_model2_allgather"])),
          "dist: at the serving policy's cap and a covering bucket, == uncapped, bit for bit")
    check(caps["truncating"][0] < cfg.candidate_cap,
          f"dist: the truncating cap {caps['truncating'][0]} < {cfg.candidate_cap}")
    # against the flat index over the same points and parameters
    data_c, q_c = torch.from_numpy(data).to(card), torch.from_numpy(queries).to(card)
    state = build_index(cfg, data_c, params=params.to(card))
    fd, fi = (x.cpu().numpy() for x in query_index(cfg, state, q_c))
    del state
    d4, i4 = got["model4_allgather"]
    check(np.array_equal(d4, fd) and np.array_equal(i4, fi),
          "dist: the (1, 4) mesh == the flat query_index, bit for bit")
    check(all((got[f"rows2_model2_{m}"][0] <= fd).all() for m in di.MERGES),
          "dist: every (2, 2) distance <= the flat index's at its position")

    def verify(name, d, i):
        """Each returned id's distance again through ``ops.l1_distance_rows``,
        held against its plain version."""
        ok = torch.from_numpy(i >= 0).to(card)
        rows = data_c[torch.from_numpy(np.maximum(i, 0)).long().to(card)].contiguous()
        qs = q_c[:d.shape[0]].contiguous()
        kd, pd = ops.l1_distance_rows(qs, rows), plain_rows(qs, rows)
        check(equal(kd, pd), f"dist {name}: l1_distance_rows kernel == plain")
        check(equal(torch.where(ok, kd, 0), torch.where(ok, torch.from_numpy(d).to(card), 0))
              and bool((torch.from_numpy(d).to(card)[~ok] == BIG_DIST).all()),
              f"dist {name}: every returned id's distance is exact")

    for name in names:
        verify(name, *got[name])
    check(got["dryrun_rows2_model2_tree"][0].shape == (queries.shape[0], dry.k),
          "dist: the dry-run configuration answers k = 50")
    # the card's ranks against the CPU's at the first rows
    cd, ci = di.assemble([rep["result"] for rep in cpu], 0)
    check(np.array_equal(cd, got["rows2_model2_first_rows"][0])
          and np.array_equal(ci, got["rows2_model2_first_rows"][1]),
          f"dist: the (2, 2) mesh on CPU ranks (plain versions) == on the card, first "
          f"{DIST_CPU_ROWS} points, {DIST_CPU_QUERIES} queries, bit for bit")
    check(all(v == 0 for rep in cpu for v in rep["launches"].values()),
          "dist: the CPU ranks launched no kernel")
    # the distributed oracle under nccl, one rank a card
    oracle_q = queries[:QUALITY_QUERIES]
    qrun = QualityRun(data, oracle_q, UNIVERSE, QualitySpec(k=K), device="cuda",
                      params_fn=lambda c, dim: make_params(c, dim))
    oracle = qrun.check_distributed(cfg)
    check(oracle["dist_matches_flat"] and oracle["devices"] == torch.cuda.device_count(),
          f"dist: check_distributed under nccl, one rank a card: {oracle}")

    out = {"ranks": DIST_RANKS, "backend": recs[0][0]["backend"],
           "exchange": recs[0][0]["exchange"],
           "nccl_refusal": nccl_refusal if torch.cuda.device_count() < DIST_RANKS else None,
           "nccl_own_answer": nccl_answer if torch.cuda.device_count() < DIST_RANKS else None,
           "runs": {},
           "check_distributed": {**oracle, "backend": "nccl", "queries": QUALITY_QUERIES},
           "launches": launches}
    for k, name in enumerate(names):
        run, rr = runs[name], [r[k] for r in recs]
        d, i = got[name]
        out["runs"][name] = {
            "shape": list(run["shape"]), "merge": run.get("merge", "allgather"),
            "config": "dryrun" if run["cfg"] is dry else "serve",
            "backend": rr[0]["backend"], "exchange": rr[0]["exchange"],
            "rows": run.get("rows", N_POINTS), "queries": int(d.shape[0]),
            "rows_per_shard": run.get("rows", N_POINTS) // run["shape"][0],
            "queries_per_block": int(d.shape[0]) // run["shape"][1],
            "cand_cap": rr[0]["cand_cap"], "cand_bucket": rr[0]["cand_bucket"],
            "sent_bytes": [r["sent_bytes"] for r in rr],
            "build_sent_bytes": [r["build_sent_bytes"] for r in rr],
            # the ground truth is over every point
            "recall_at_10": None if run.get("rows") else float(recall(i[:, :K], gt_i0))}
    out["flat_recall_at_10"] = float(recall(fi, gt_i0))
    return out, launches


def dist_cards_main(cards: int) -> int:
    """``python3 chip_smoke.py --dist-cards N``: the distributed index under
    nccl, one card a rank, on N cards, and under gloo ranks on the same
    cards (the exchanges through the host), each backend twice: nccl, gloo,
    gloo, nccl.  At the serve configuration over the 1 M points and 1,024
    queries: (2, N/2) and (N, 1) meshes under the three merges and (1, N);
    every result equal across calls, backends and merges, (1, N) equal to
    the flat index; then ``QualityRun.query_dist`` over the N cards (nccl ranks
    spawned) equal to flat; on 4 cards also the shard phase's sharded
    forward (``shard_ranks``) under nccl, one rank a card.  Prints one
    ``{"dist_cards": ...}`` line."""
    from repro_torch.core.baselines import recall
    from repro_torch.core.index import IndexConfig, build_index, make_params, query_index
    from repro_torch.data import ann_synthetic as ds
    from repro_torch.eval import QualityRun, QualitySpec
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import l1_distance as kl1
    from repro_torch.launch import dist_index as di

    check(torch.cuda.device_count() >= cards,
          f"--dist-cards {cards} needs {cards} cards, found {torch.cuda.device_count()}")
    log(nvidia_smi_line())
    for name in _build.build_all():
        _build.library(name)
    spec = ds.DatasetSpec("sift1m", n=N_POINTS, dim=DIM, universe=UNIVERSE)
    data = ds.make_dataset(spec)
    queries = ds.make_queries(spec, data, N_QUERIES)
    card = torch.device("cuda")
    data_c, q_c = torch.from_numpy(data).to(card), torch.from_numpy(queries).to(card)
    gt_d, gt_i = exact_knn(ops, kl1.l1_distance_plain, data_c, q_c, K)
    dbar, gt_i = float(gt_d.float().mean()), gt_i.cpu().numpy()
    cfg = IndexConfig(num_tables=8, num_hashes=12, width=max(8, int(3.0 * math.sqrt(dbar)) & ~1),
                      num_probes=200, candidate_cap=128, universe=UNIVERSE, k=K,
                      rerank_chunk=1024)
    params = make_params(cfg, DIM)
    state = build_index(cfg, data_c, params=params.to(card))
    fd, fi = (x.cpu().numpy() for x in query_index(cfg, state, q_c))
    del state, data_c, q_c
    torch.cuda.empty_cache()
    runs = [{"shape": shape, "merge": m, "cfg": cfg, "params": params}
            for shape in ((2, cards // 2), (cards, 1)) for m in di.MERGES]
    runs.append({"shape": (1, cards), "cfg": cfg, "params": params})
    names = [f"rows{r['shape'][0]}_model{r['shape'][1]}_{r.get('merge', 'allgather')}"
             for r in runs]
    out = {"cards": cards, "width": cfg.width, "calls": []}
    first = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as tmp:
        path = os.path.join(tmp, "points.npy")
        np.save(path, data)
        for backend in ("nccl", "gloo", "gloo", "nccl"):
            reports = di.spawn_ranks(cards, di.run_meshes, path, queries, runs,
                                     backend=backend, device="cuda", timeout_s=600)
            recs = [rep["result"] for rep in reports]
            call = {"backend": backend, "devices": [rep["device"] for rep in reports],
                    "launches": {k: sum(rep["launches"][k] for rep in reports)
                                 for k in reports[0]["launches"]}, "runs": {}}
            got = {name: di.assemble(recs, k) for k, name in enumerate(names)}
            first = first or got
            for k, name in enumerate(names):
                check(all(np.array_equal(a, b) for a, b in zip(got[name], first[name])),
                      f"dist_cards {backend} {name} == the first call's, bit for bit")
                check((got[name][0] <= fd).all(), f"dist_cards {name}: every distance <= flat")
                call["runs"][name] = {
                    "exchange": recs[0][k]["exchange"],
                    "sent_bytes": [rr[k]["sent_bytes"] for rr in recs],
                    "recall_at_10": float(recall(got[name][1], gt_i))}
            check(call["devices"] == [f"cuda:{r}" for r in range(cards)],
                  f"dist_cards {backend}: one card a rank ({call['devices']})")
            for k in (*PROBE, "fused_rerank", "topk_merge"):
                check(call["launches"][k] > 0, f"dist_cards {backend}: the ranks launched {k}")
            log(f"dist_cards {backend}: every run == the first call's, every distance <= flat")
            out["calls"].append(call)
    for shape in ((2, cards // 2), (cards, 1)):
        base = f"rows{shape[0]}_model{shape[1]}"
        check(all(np.array_equal(a, b) for m in ("ring", "tree")
                  for a, b in zip(first[f"{base}_{m}"], first[f"{base}_allgather"])),
              f"dist_cards {base}: ring == tree == allgather, bit for bit")
    d1, i1 = first[f"rows1_model{cards}_allgather"]
    check(np.array_equal(d1, fd) and np.array_equal(i1, fi),
          f"dist_cards: the (1, {cards}) mesh == the flat query_index, bit for bit")
    qrun = QualityRun(data, queries[:QUALITY_QUERIES], UNIVERSE, QualitySpec(k=K),
                      device="cuda", params_fn=lambda c, dim: make_params(c, dim))
    oracle = qrun.check_distributed(cfg)
    check(oracle == {"devices": cards, "dist_matches_flat": True},
          f"dist_cards: check_distributed over {cards} cards: {oracle}")
    out["check_distributed"] = oracle
    if cards == 4:      # the shard phase's sharded forward under nccl, one rank a card
        out["shard_ranks"] = shard_ranks("nccl", "cuda")
        check(out["shard_ranks"]["devices"] == [f"cuda:{r}" for r in range(4)],
              f"dist_cards shard ranks: one card a rank ({out['shard_ranks']['devices']})")
        log(f"dist_cards shard ranks (nccl): max abs err "
            f"{max(out['shard_ranks']['max_abs_err']):.3g} of max |logit| "
            f"{out['shard_ranks']['max_abs_logit']:.4g}")
    log(json.dumps({"dist_cards": out}))
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def lint_phase() -> dict:
    """The port's lint gate, ``python -m repro_torch.analysis --check
    --json``, in a subprocess on this machine's Python; its report (the
    findings and every sanctioned one, with its lines)."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "--json"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(proc.returncode == 0, "python -m repro_torch.analysis --check exits 0:\n"
          + proc.stdout[-2000:] + proc.stderr[-2000:])
    return json.loads(proc.stdout)


@contextlib.contextmanager
def card_tests():
    """The card tests, ``python -m pytest -q -m cuda tests/test_torch_cuda.py``,
    in a subprocess on this machine's Python, started on entry and run beside
    the block (each process has its own CUDA context and launch counters;
    the tests' workers and ranks take ports the kernel picks and file
    stores of their own).  Yields ``wait()``: the tests must exit 0, and
    every one pass (none failed, errored or skipped); it returns their
    number.  A run still going when the block exits is killed.  Both loads
    share the one card, so a memory or timing flake in either fails the
    whole smoke, and a failed card test shows only when the block ends; run
    in line instead, the tests cost the smoke ~47 s more."""
    from xml.etree import ElementTree
    out_dir = ROOT / "build" / "chip_smoke_cuda"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    report, printed = out_dir / "junit.xml", out_dir / "pytest.log"
    with open(printed, "w") as sink:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p", "no:cacheprovider",
             f"--junitxml={report}", "tests/test_torch_cuda.py"],
            stdout=sink, stderr=subprocess.STDOUT, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})

    def wait() -> int:
        rc = proc.wait(timeout=CUDA_TESTS_TIMEOUT_S)
        tail = printed.read_text()[-4000:]
        check(rc == 0, f"the card tests exit 0:\n{tail}")
        suite = ElementTree.parse(report).getroot()
        if suite.tag != "testsuite":
            suite = suite.find("testsuite")
        counts = {k: int(suite.get(k, 0)) for k in ("tests", "failures", "errors", "skipped")}
        check(counts["tests"] > 0 and counts["failures"] == counts["errors"]
              == counts["skipped"] == 0,
              f"every card test passed, none failed, errored or skipped {counts}:\n{tail}")
        return counts["tests"]

    try:
        yield wait
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class SyncRecorder:
    """Records each synchronizing CUDA call that torch's sync debug mode
    ("warn") reports: its frames inside ``src/repro_torch/``, innermost
    first, as package-rooted ``(path, line, function)`` (the warning's own filename
    may point into torch).  ``window`` names where the syncs go."""

    def __init__(self):
        self.pkg = str(ROOT / "src" / "repro_torch") + os.sep
        self.stacks = {}            # site (and "site via ..." per other chain) -> frames
        self.counts = {}            # window -> {site: count}
        self.window = None

    def showwarning(self, message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message) or self.window is None:
            return
        frames = [(os.path.relpath(f.filename, ROOT / "src").replace(os.sep, "/"), f.lineno,
                   f.name)
                  for f in reversed(traceback.extract_stack()) if f.filename.startswith(self.pkg)]
        site = f"{frames[0][0]}:{frames[0][1]}" if frames else f"(outside the port) {filename}:{lineno}"
        if self.stacks.get(site, frames) != frames:     # another chain to the same site
            site_chain = f"{site} via " + " < ".join(f"{p}:{n}" for p, n, _ in frames[1:])
            self.stacks.setdefault(site_chain, frames)
        else:
            self.stacks.setdefault(site, frames)
        win = self.counts.setdefault(self.window, {})
        win[site] = win.get(site, 0) + 1

    @contextlib.contextmanager
    def recording(self):
        """Sync debug mode "warn" for the block, reset to 0 in any case."""
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self.showwarning
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode(0)


def host_syncs_phase(ops, cfg, serve_cfg, data, queries, inserted, deleted, sanctioned):
    """Serve at the serve configuration with each engine under torch's sync
    debug mode: after warm-up and one drain (outside the record), 8 drained
    batches over a segment and a delta, a compaction, 8 more.  Every sync
    is recorded at its innermost frame in the port and held against the
    lint's sanctioned reads (``hold_syncs``): a sync inside r1-host-sync's
    scope that no allow or baseline entry covers fails the phase."""
    from repro_torch.analysis.rules import hold_syncs
    from repro_torch.serve.engine import AnnServingEngine
    out, launches, batch = {}, {}, serve_cfg.batch_size
    for tag, path, run_cfg in (("gather", "host_syncs", cfg),
                               ("pallas", "host_syncs_rw_hash",
                                dataclasses.replace(cfg, hash_impl="pallas"))):
        rec = SyncRecorder()

        def serve_recorded():
            eng = AnnServingEngine(run_cfg, serve_cfg, data, device="cuda")
            eng.insert(inserted)
            eng.delete(deleted)
            eng.submit(queries[:batch])
            eng.drain()                 # the delta's and tombstones' copies
            with rec.recording():
                for window, lo in (("drains", 0), ("compact", None),
                                   ("drains", SYNC_BATCHES * batch)):
                    rec.window = window
                    if lo is None:
                        eng.compact()
                        continue
                    for b in range(SYNC_BATCHES):
                        eng.submit(queries[lo + b * batch:lo + (b + 1) * batch])
                        eng.drain()
                rec.window = None
            return eng

        eng, launches[path] = run_path(path, ops, serve_recorded)
        check(eng.index.num_segments == 1 and eng.index.compactions == 1,
              f"host_syncs {tag}: one compaction into one segment")
        missed, unhit = hold_syncs(rec.stacks, sanctioned)
        drains = rec.counts.get("drains", {})
        n_batches = 2 * SYNC_BATCHES
        out[tag] = {
            "batches": n_batches,
            "syncs_per_batch": sum(drains.values()) / n_batches,
            "drain_sites": dict(sorted(drains.items())),
            "compact_sites": dict(sorted(rec.counts.get("compact", {}).items())),
            "chains": {site: [f"{p}:{n}" for p, n, _ in frames]
                       for site, frames in sorted(rec.stacks.items())},
            "missed_by_the_lint": missed,
            "sanctioned_not_hit": unhit,
        }
        del eng
    # does torch report the engine's explicit synchronize (its batch timing)?
    rec = SyncRecorder()
    with rec.recording():
        rec.window = "synchronize"
        torch.cuda.synchronize()
        rec.window = None
    out["synchronize_reported"] = bool(rec.counts)
    for tag in ("gather", "pallas"):
        check(not out[tag]["missed_by_the_lint"],
              f"host_syncs {tag}: every sync inside r1-host-sync's scope carries an allow "
              f"or a baseline entry (missed: {out[tag]['missed_by_the_lint']})")
    return out, launches


def examples_phase() -> dict:
    """Two ANN examples' ``main()`` on the card at their own sizes (each
    checks its own claims; a failed assert fails the run), then each again
    on the CPU (the kernels' plain versions): every step's (d, i), the
    recall and the inserted gids equal the card's, bit for bit; then
    ``generate``'s greedy tokens on the card and on the CPU.  Each one's
    recall and the tail of what it printed."""
    from repro_torch.examples import ann_serving, cluster_serving, generate
    out = {}
    for name, mod in (("ann_serving", ann_serving), ("cluster_serving", cluster_serving)):
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            res = mod.main()
        with contextlib.redirect_stdout(io.StringIO()):
            plain = mod.main(device="cpu")
        steps = sorted(res["answers"])
        check(steps == sorted(plain["answers"]) and all(
            np.array_equal(a, b) for step in steps
            for a, b in zip(res["answers"][step], plain["answers"][step])),
              f"examples {name}: every step's (d, i) on the card == on the CPU, bit for bit")
        check(res["recall"] == plain["recall"] and np.array_equal(
            res.get("gids", ()), plain.get("gids", ())),
              f"examples {name}: recall and gids on the card == on the CPU")
        out[name] = {"recall": res["recall"], "steps_equal_on_the_cpu": steps,
                     **{k: v for k, v in res.items()
                        if k not in ("recall", "answers", "gids")},
                     "printed_tail": printed.getvalue().strip().splitlines()[-2:]}
    # the greedy generation example: the same tokens on the card and the CPU
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        res = generate.main()
    with contextlib.redirect_stdout(io.StringIO()):
        plain = generate.main(device="cpu")
    check(np.array_equal(res["sequence"], plain["sequence"]),
          "examples generate: the greedy sequence on the card == on the CPU")
    out["generate"] = {"arch": res["arch"], "shape": list(res["sequence"].shape),
                       "printed_tail": printed.getvalue().strip().splitlines()[-1:]}
    return out


def _lm_run(M, tf, cfg, params, device) -> dict:
    """One reduced arch on ``device``: train_loss and its metrics, prefill
    logits, LM_DECODE_STEPS teacher-forced decode steps and the caches they
    return (tests/test_models.py's batch), each result on the CPU."""
    rng = np.random.default_rng
    b, s = 2, 16
    batch = {"tokens": rng(0).integers(1, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng(1).integers(1, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend or cfg.kind == "encdec":
        batch["frontend"] = np.full((b, cfg.frontend_len, cfg.d_model), 0.02, np.float32)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    total, metrics = M.train_loss(params, cfg, batch)
    out = {"total": total, **{k: metrics[k] for k in ("loss", "aux")},
           "prefill": M.prefill(params, cfg, batch)}
    ekv = None
    if cfg.kind == "encdec":
        ekv = tf.encode_cross_kv(params, cfg, tf.encoder_stack(params, cfg, batch["frontend"]))
    caches = M.make_caches(cfg, b, 12, torch.float32, device=device)
    for i in range(LM_DECODE_STEPS):
        out[f"decode{i}"], caches = M.decode_step(params, cfg, caches,
                                                  batch["tokens"][:, i:i + 1], i, enc_kv=ekv)
    stack = [("caches", caches)]
    while stack:
        name, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((f"{name}.{k}", v) for k, v in node.items())
        else:
            out[name] = node
    return {k: torch.as_tensor(v).float().cpu() for k, v in out.items()}


def lm_phase() -> dict:
    """The language models on the card.  Every arch's reduced() against the
    same port on the CPU (float32, TF32 off): train_loss, prefill and
    LM_DECODE_STEPS decode steps with their caches, within LM_REDUCED_TOL.
    Then smollm-360m at full width and depth: in float32, LM_PROMPT
    teacher-forced decode steps against the full forward's logits (and the
    last one against prefill's) within LM_FULL_TOL; in its config's bf16
    (the same seed-0 draws, which ``init_params`` casts), through
    ``LanguageModel``: prefill logits within LM_BF16_SHARE x max |float32
    logits| (a sanity bound: a wrong cast or mask, not rounding), the
    prompt into a LM_CACHE-slot cache by LM_PROMPT single-token steps from
    pos0 = 0 (the reference's multi-token decode step gives every token
    position pos0, so it is not a prefill; the last step's logits against
    prefill's, same bound), then LM_GREEDY greedy steps at B LM_BATCH:
    finite logits, tokens inside the vocabulary."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {"reduced": {}}
    try:
        with torch.no_grad():
            for arch in configs.ARCHS:
                cfg = configs.get_reduced(arch)
                params = M.init_params(cfg, device="cpu")
                card = _lm_run(M, tf, cfg, tf.tree_map(lambda t: t.cuda(), params), "cuda")
                cpu = _lm_run(M, tf, cfg, params, "cpu")
                check(sorted(card) == sorted(cpu) and all(
                    torch.allclose(card[k], cpu[k], atol=LM_REDUCED_TOL, rtol=LM_REDUCED_TOL)
                    for k in cpu), f"lm {arch}: reduced() on the card == on the CPU within "
                    f"{LM_REDUCED_TOL}")
                out["reduced"][arch] = {
                    "max_abs_err": max(float((card[k] - cpu[k]).abs().max()) for k in cpu),
                    "loss": float(card["loss"]), "results": len(cpu)}
            out["full"] = _lm_full(M, tf, configs)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


def _lm_f32(M, tf, cfg32, toks) -> dict:
    """smollm-360m in float32: LM_PROMPT teacher-forced decode steps against
    the full forward (and the last against prefill); returns prefill's
    logits and the errors.  Every tensor it makes is freed on return."""
    vocab = cfg32.vocab
    params = M.init_params(cfg32, device="cuda")
    pos = tf._positions(LM_BATCH, LM_PROMPT, toks.device)
    h, _, _ = tf.decoder_stack(params, cfg32, M._embed(params, cfg32, toks), positions=pos)
    full = tf.logits_from_hidden(params, cfg32, h)[..., :vocab]
    pre32 = M.prefill(params, cfg32, {"tokens": toks})[:, 0, :vocab].clone()
    check(torch.allclose(pre32, full[:, -1], atol=1e-4, rtol=1e-4),
          "lm full: prefill == the full forward's last position (float32)")
    caches = M.make_caches(cfg32, LM_BATCH, LM_CACHE, torch.float32, device="cuda")
    worst = 0.0
    for i in range(LM_PROMPT):
        lg, caches = M.decode_step(params, cfg32, caches, toks[:, i:i + 1], i)
        lg = lg[:, 0, :vocab]
        check(torch.allclose(lg, full[:, i], atol=LM_FULL_TOL, rtol=LM_FULL_TOL),
              f"lm full: float32 decode step {i} == the full forward within {LM_FULL_TOL}")
        worst = max(worst, float((lg - full[:, i]).abs().max()))
    check(torch.allclose(lg, pre32, atol=LM_FULL_TOL, rtol=LM_FULL_TOL),
          "lm full: the last teacher-forced step's logits == prefill's (float32)")
    return {"pre32": pre32, "params": sum(t.numel() for t in _leaves(params)),
            "decode_vs_forward_max_abs_err": worst,
            "last_vs_prefill_max_abs_err": float((lg - pre32).abs().max()),
            "max_abs_logit": float(full.abs().max())}


def _lm_full(M, tf, configs) -> dict:
    """smollm-360m at full width and depth: float32 checks, then the bf16
    model (the same draws, cast as ``init_params`` casts them) served
    through ``LanguageModel``."""
    cfg16 = configs.get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    vocab = cfg16.vocab
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)).cuda()
    f32 = _lm_f32(M, tf, cfg32, toks)
    pre32 = f32.pop("pre32")
    torch.cuda.empty_cache()
    res = {"config": {"name": cfg16.name, "n_layers": cfg16.n_layers, "d_model": cfg16.d_model,
                      "n_heads": cfg16.n_heads, "n_kv": cfg16.n_kv, "d_ff": cfg16.d_ff,
                      "vocab": vocab, "dtype": cfg16.dtype,
                      "param_count": cfg16.param_count(), "params": f32.pop("params")},
           "batch": LM_BATCH, "prompt": LM_PROMPT, "cache": LM_CACHE, "greedy": LM_GREEDY,
           "f32": f32}

    # bfloat16, through the module: the same seed-0 draws, cast to bf16
    lm = M.LanguageModel(cfg16, device="cuda")
    pre16 = lm.prefill({"tokens": toks})[:, 0, :vocab].float()
    bound = LM_BF16_SHARE * float(pre32.abs().max())
    err16 = float((pre16 - pre32).abs().max())
    check(torch.isfinite(pre16).all() and err16 <= bound,
          f"lm full: bf16 prefill logits within {bound:.3f} of float32's ({err16:.3f})")
    caches = lm.make_caches(LM_BATCH, LM_CACHE, torch.bfloat16)
    check(caches["sub0"]["k"].dtype == torch.bfloat16 and
          caches["sub0"]["k"].shape == (cfg16.n_groups, LM_BATCH, LM_CACHE, cfg16.n_kv,
                                        cfg16.head_dim), "lm full: the bf16 cache's layout")
    for i in range(LM_PROMPT):
        lg, caches = lm.decode_step(caches, toks[:, i:i + 1], i)
    last = lg[:, 0, :vocab].float()
    err_fill = float((last - pre16).abs().max())
    check(err_fill <= bound, f"lm full: bf16 cache fill's last logits within {bound:.3f} of "
          f"prefill's ({err_fill:.3f})")
    tok = torch.argmax(lg[..., :vocab], dim=-1).to(torch.int32)
    seq = [tok]
    for i in range(LM_PROMPT, LM_PROMPT + LM_GREEDY):
        lg, caches = lm.decode_step(caches, tok, i)
        tok = torch.argmax(lg[..., :vocab], dim=-1).to(torch.int32)
        seq.append(tok)
    seq = torch.cat(seq, dim=1)
    check(bool(torch.isfinite(lg[..., :vocab]).all()) and bool(((seq >= 0) & (seq < vocab)).all()),
          "lm full: greedy logits finite, tokens inside the vocabulary")
    res["bf16"] = {"prefill_vs_f32_max_abs_err": err16, "bound": bound,
                   "fill_vs_prefill_max_abs_err": err_fill,
                   "greedy_tokens_first_row": seq[0, :8].tolist()}
    del lm, caches
    torch.cuda.empty_cache()
    return res


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _train_batch(cfg, b: int, s: int, step: int, device) -> dict:
    """``batch_at_step``'s tokens and labels (and a seeded frontend for the
    frontend and enc-dec archs) on ``device``."""
    from repro_torch.data.lm_synthetic import LmDataConfig, batch_at_step
    tokens, labels = batch_at_step(LmDataConfig(vocab=cfg.vocab, global_batch=b, seq_len=s),
                                   step)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    if cfg.frontend or cfg.kind == "encdec":
        batch["frontend"] = torch.from_numpy(np.random.default_rng(step).normal(
            0, 0.02, (b, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


def _leaf_share(want: dict, got: dict) -> float:
    """The largest of each leaf's max |got - want| over its max |want|."""
    worst = 0.0
    for w, g in zip(_leaves(want), _leaves(got)):
        w, g = w.float().cpu(), g.float().cpu()
        worst = max(worst, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    return worst


def _train_reduced(arch: str) -> dict:
    """One arch's reduced(): the gradient on the card against the CPU, then
    TRAIN_REDUCED_STEPS train steps' losses and grad norms."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step, value_and_grad
    cfg = configs.get_reduced(arch)
    params = M.init_params(cfg, device="cpu")
    opt = OptConfig(lr=5e-3, warmup_steps=5)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tf.tree_map(lambda t: t.to(dev), params)
        (total, metrics), grads = value_and_grad(cfg)(p, _train_batch(cfg, 4, 32, 0, dev))
        state, step, curve = init_opt_state(p, opt), make_train_step(cfg, opt), []
        for i in range(TRAIN_REDUCED_STEPS):
            p, state, m = step(p, state, _train_batch(cfg, 4, 32, i, dev))
            curve.append((m["loss"], m["grad_norm"]))
        runs[dev] = {"values": [float(total), float(metrics["loss"]), float(metrics["aux"])],
                     "grads": grads,
                     "curve": [[float(a), float(b)] for a, b in curve]}
    cpu, card = runs["cpu"], runs["cuda"]
    share = _leaf_share(cpu["grads"], card["grads"])
    check(share <= TRAIN_GRAD_SHARE, f"train {arch}: the card's gradient within "
          f"{TRAIN_GRAD_SHARE} of each leaf's max |g| of the CPU's ({share:.3g})")
    check(np.allclose(card["values"], cpu["values"], rtol=TRAIN_STEP_RTOL, atol=1e-6),
          f"train {arch}: total, loss and aux on the card == the CPU's {card['values']} "
          f"{cpu['values']}")
    check(np.allclose(card["curve"], cpu["curve"], rtol=TRAIN_STEP_RTOL),
          f"train {arch}: {TRAIN_REDUCED_STEPS} steps' losses and grad norms on the card == "
          f"the CPU's {card['curve']} {cpu['curve']}")
    return {"grad_share": share, "loss": card["values"][1], "curve": card["curve"],
            "curve_max_rel_err": float(np.max(np.abs(np.subtract(card["curve"], cpu["curve"]))
                                              / np.abs(cpu["curve"])))}


def _train_full() -> dict:
    """smollm-360m at full width and depth in its config's bf16 (remat on,
    float32 moments), the launcher's AdamW: TRAIN_STEPS steps on
    ``batch_at_step``'s B TRAIN_BATCH x S TRAIN_SEQ; then, at the trained
    parameters, the gradients with remat and without, and each one's peak
    of allocated memory.  The first draws stay on the host, so that the
    card holds only what training holds."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step, value_and_grad
    cfg = configs.get_config(LM_ARCH)
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.opt_moment_dtype == "float32",
          "train full: smollm-360m trains with remat, bf16 parameters, float32 moments")
    host = M.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    p = tf.tree_map(lambda t: t.cuda(), host)
    opt = OptConfig(lr=3e-3, moment_dtype=cfg.opt_moment_dtype, warmup_steps=20)
    st = init_opt_state(p, opt)
    batches = [_train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, i, "cuda") for i in range(TRAIN_STEPS)]
    step = make_train_step(cfg, opt)
    curve = []
    for batch in batches:
        p, st, m = step(p, st, batch)
        curve.append((m["loss"], m["grad_norm"]))
    curve = [[float(a), float(b)] for a, b in curve]
    check(bool(np.isfinite(curve).all()), f"train full: every loss and grad norm finite {curve}")
    changed = [not torch.equal(a, b.cpu()) for a, b in zip(_leaves(host), _leaves(p))]
    check(all(changed), f"train full: every parameter leaf changed ({sum(changed)}/"
          f"{len(changed)})")
    del host

    grads, grad_peak = {}, {}
    for name, c in (("remat", cfg), ("no_remat", dataclasses.replace(cfg, remat=False))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, grads[name] = value_and_grad(c)(p, batches[0])
        torch.cuda.synchronize()
        grad_peak[name] = torch.cuda.max_memory_allocated() - base
    share = _leaf_share(grads["remat"], grads["no_remat"])
    check(share <= TRAIN_REMAT_SHARE, f"train full: the gradients without remat within "
          f"{TRAIN_REMAT_SHARE} of each leaf's max |g| of remat's ({share:.3g})")
    check(grad_peak["no_remat"] > grad_peak["remat"],
          f"train full: the gradient's peak without remat {grad_peak['no_remat']} above "
          f"remat's {grad_peak['remat']}")
    del grads, p, st, batches
    torch.cuda.empty_cache()
    return {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "vocab": cfg.vocab, "dtype": cfg.dtype, "remat": cfg.remat,
                       "remat_policy": cfg.remat_policy,
                       "moment_dtype": cfg.opt_moment_dtype},
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
            "curve": curve, "grad_peak_above": grad_peak, "remat_grad_share": share}


def _train_example() -> dict:
    """``repro_torch.examples.train_smollm.main()`` on the card: 200 steps
    straight (its ``improved=yes``), then 100 steps, stopped, and resumed
    to 200 from the checkpoint, against the straight run."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.examples import train_smollm
    printed = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        def run(name, steps, resume):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                losses = train_smollm.main(steps=steps, ckpt_dir=os.path.join(root, name),
                                           resume=resume)
            printed[f"{name}_{steps}"] = out.getvalue().strip().splitlines()
            return losses
        straight = run("straight", train_smollm.STEPS, False)
        half = train_smollm.STEPS // 2
        first = run("resumed", half, False)
        resumed = run("resumed", train_smollm.STEPS, True)
        last = printed[f"straight_{train_smollm.STEPS}"][-1]
        check(last.endswith("improved=yes"), f"train example: {last}")
        check(any(line == f"resumed from step {half}"
                  for line in printed[f"resumed_{train_smollm.STEPS}"]),
              "train example: the second run resumed from its checkpoint")
        check(len(first) + len(resumed) == len(straight) and np.allclose(
            first + resumed, straight, rtol=TRAIN_RESUME_RTOL, atol=0),
              f"train example: the resumed run's losses == the straight run's within "
              f"{TRAIN_RESUME_RTOL}")
        want = CheckpointManager(os.path.join(root, "straight")).restore_flat_step(
            train_smollm.STEPS)
        got = CheckpointManager(os.path.join(root, "resumed")).restore_flat_step(
            train_smollm.STEPS)
        check(sorted(want) == sorted(got), "train example: the same checkpoint leaves")
        as_t = lambda a: torch.as_tensor(a).float()
        share = max(float((as_t(got[k]) - as_t(want[k])).abs().max())
                    / max(float(as_t(want[k]).abs().max()), 1e-30) for k in want)
        check(share <= TRAIN_RESUME_SHARE, f"train example: the resumed run's parameters and "
              f"moments within {TRAIN_RESUME_SHARE} of each leaf's max of the straight run's "
              f"({share:.3g})")
        exact = all(np.array_equal(np.asarray(want[k]), np.asarray(got[k])) for k in want
                    if not torch.is_tensor(want[k]))
    return {"last_line": last, "loss_first": straight[0], "loss_last": straight[-1],
            "resume_max_abs_loss_err": float(np.max(np.abs(np.subtract(first + resumed,
                                                                       straight)))),
            "resume_leaf_share": share, "resume_bit_for_bit": exact,
            "printed_tail": printed[f"straight_{train_smollm.STEPS}"][-2:]}


def train_phase() -> dict:
    """Language-model training on the card (the ``train`` path): every
    arch's reduced() against the CPU, smollm-360m at full width and depth,
    and the training example with its resume."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        from repro_torch import configs
        out = {"reduced": {arch: _train_reduced(arch) for arch in configs.ARCHS}}
        out["full"] = _train_full()
        out["example"] = _train_example()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


def _dryrun_cells(out_dir: str) -> list:
    """Start every dry-run cell (``SHARD_CELLS`` and the ANN cell) as a
    process of its own, all together; returns (cell, json path, process)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    started = []
    for arch, shape, multi_pod in (*SHARD_CELLS, ("ann", None, False)):
        path = os.path.join(out_dir, f"{arch}_{shape}_{int(multi_pod)}.json")
        argv = ([sys.executable, "-m", "repro_torch.launch.dryrun", "--json", path]
                + (["--ann"] if arch == "ann" else ["--arch", arch, "--shape", shape])
                + (["--multi-pod"] if multi_pod else []))
        started.append(((arch, shape, multi_pod), path, subprocess.Popen(
            argv, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return started


def _dryrun_results(started) -> list:
    """Each started cell's record, checked: ``ok``; collective bytes above 0
    (every cell has more than one rank); an LM cell's useful FLOPs at most
    SHARD_FRAC_MAX of its counted FLOPs; each smollm cell's per-rank peak
    against one card's memory (``fits_one_card``; a cell that does not fit
    must hold at least its attention's float32 scores, which set it)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    cells = []
    for (arch, shape, multi_pod), path, proc in started:
        try:
            out, _ = proc.communicate(timeout=SHARD_CELL_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(proc.returncode == 0, f"dry-run cell {arch} {shape}: exit "
              f"{proc.returncode}: {out[-2000:]}")
        with open(path) as f:
            (cell,) = json.load(f)
        check(cell["status"] == "ok", f"dry-run cell {arch} {shape}: {cell}")
        check(cell["coll_bytes"] > 0, f"dry-run cell {arch} {shape}: collectives counted")
        if arch == "ann":
            check(sum(cell["launches"].values()) == 0,
                  f"dry-run ANN cell: no kernel launched on fake tensors ({cell['launches']})")
        else:
            check(cell["useful_flops_frac"] <= SHARD_FRAC_MAX,
                  f"dry-run cell {arch} {shape}: useful FLOPs share "
                  f"{cell['useful_flops_frac']} <= {SHARD_FRAC_MAX}")
        if arch.startswith("smollm"):
            cell["fits_one_card"] = cell["peak_bytes_device"] < SHARD_HBM_BYTES
            if not cell["fits_one_card"]:
                cfg, info = get_config(arch), dryrun.SHAPES[shape]
                scores = (info["batch"] // (32 if multi_pod else 16) * cfg.n_heads
                          * info["seq"] ** 2 * 4)
                check(cell["peak_bytes_device"] >= scores,
                      f"dry-run cell {arch} {shape}: a peak above one card's "
                      f"{SHARD_HBM_BYTES:.3g} B holds the attention's scores ({scores} B)")
        cells.append(cell)
    return cells


def shard_phase(launches: dict) -> dict:
    """The ``shard`` path: the dry-run's cells on this machine (fake
    tensors, started first, running while the ranks run), then the sharded
    forward of SHARD_ARCH at full width on four rank processes against the
    unsharded prefill on the card; returns the cells and the ranks' record,
    and adds to ``launches`` those the processes made (the ANN cell's and
    the ranks')."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        started = _dryrun_cells(tmp)
        try:
            ranks = shard_ranks("gloo", SHARD_RANKS_DEVICE)
        finally:
            cells = _dryrun_results(started)
    for counts in (ranks.pop("launches"), *(c.get("launches", {}) for c in cells)):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    return {"dryrun": cells, "ranks": ranks}


def shard_ranks(backend: str, device: str) -> dict:
    """SHARD_ARCH at full width and depth in float32 (TF32 off on the card),
    its parameters and a B SHARD_BATCH x S SHARD_SEQ batch placed by the
    sharding rules over a SHARD_MESH of four rank processes
    (``sharding.run_sharded``), prefill's logits whole on every rank,
    against the unsharded prefill of the same weights on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dist_index as di
    from repro_torch.models import model as M
    from repro_torch.models import sharding as shd
    cfg = dataclasses.replace(get_config(SHARD_ARCH), dtype="float32")
    params = M.init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, (SHARD_BATCH, SHARD_SEQ)).astype(np.int32))
    runs = [{"shape": SHARD_MESH, "step": "prefill", "batch": {"tokens": toks}}]
    reports = di.spawn_ranks(4, shd.run_sharded, [(cfg, params, runs)], backend=backend,
                             device=device, timeout_s=600)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = M.prefill({k: v for k, v in _on_card(params).items()}, cfg,
                         {"tokens": toks.cuda()}).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    scale = float(want.abs().max())
    errs = [float((rep["result"][0][0] - want).abs().max()) for rep in reports]
    check(all(e <= SHARD_SHARE * scale for e in errs),
          f"shard ranks ({backend}, {device}): sharded prefill within {SHARD_SHARE} of max "
          f"|logit| {scale:.4g} of the unsharded one on the card: {errs}")
    return {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "dtype": cfg.dtype}, "mesh": list(SHARD_MESH), "backend": backend,
            "devices": [rep["device"] for rep in reports],
            "batch": [SHARD_BATCH, SHARD_SEQ], "max_abs_logit": scale,
            "max_abs_err": errs, "tolerance_share": SHARD_SHARE,
            "launches": {k: sum(rep["launches"][k] for rep in reports)
                         for k in reports[0]["launches"]}}


def _on_card(tree):
    return {k: _on_card(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}


def lm_retrieval_phase(ops, kernel_modules):
    """``retrieval_augmented_lm.main()`` on the card at its own sizes (the
    ``lm_retrieval`` path): its claims (near-duplicate queries find their
    source passage: top-1 hit rate >= 0.9; recall@5 >= 0.5); then its index
    answered again, and its ground truth taken again, through the kernels'
    plain versions on the card, bit for bit; then the same example on the
    CPU: the embeddings within LM_REDUCED_TOL (TF32 off)."""
    from repro_torch.core.baselines import brute_force_l1
    from repro_torch.core.index import query_index
    from repro_torch.examples import retrieval_augmented_lm as rag
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        printed = io.StringIO()

        def quiet_main():
            with contextlib.redirect_stdout(printed):
                return rag.main()
        res, launches = run_path("lm_retrieval", ops, quiet_main)
        check(res["hit_rate"] >= 0.9 and res["recall"] >= 0.5,
              f"lm_retrieval: hit rate {res['hit_rate']} >= 0.9, recall@5 {res['recall']} >= 0.5")
        idx = res["index"]
        before = dict(ops.LAUNCHES)
        with plain_kernels(ops, *kernel_modules):
            d, i = query_index(idx["cfg"], idx["state"], idx["queries"])
            td, ti = brute_force_l1(idx["points"], idx["queries"], rag.K)
        torch.cuda.synchronize()
        check(dict(ops.LAUNCHES) == before, "lm_retrieval: the plain route launched no kernel")
        for name, (wd, wi) in (("query", (d, i)), ("brute_force", (td, ti))):
            got = res["answers"][name]
            check(np.array_equal(got[0], wd.cpu().numpy())
                  and np.array_equal(got[1], wi.cpu().numpy()),
                  f"lm_retrieval: {name} through the kernels == their plain versions on the "
                  f"card, bit for bit")
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = rag.main(device="cpu")
        errs = {name: float(np.abs(res["embeddings"][name] - cpu["embeddings"][name]).max())
                for name in ("memory", "query")}
        check(all(np.allclose(res["embeddings"][n], cpu["embeddings"][n], atol=LM_REDUCED_TOL,
                              rtol=LM_REDUCED_TOL) for n in errs),
              f"lm_retrieval: the card's embeddings == the CPU's within {LM_REDUCED_TOL} {errs}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"hit_rate": res["hit_rate"],
            "recall": res["recall"], "cpu_hit_rate": cpu["hit_rate"], "cpu_recall": cpu["recall"],
            "embedding_max_abs_err": errs, "plain_equal": True,
            "memory": list(res["embeddings"]["memory"].shape),
            "printed_tail": printed.getvalue().strip().splitlines()[-1:]}, launches


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def uncounted(ops, router, fn):
    """Run ``fn`` (a check outside the router) in the middle of
    a counted path, with the router's in-flight work waited out first, and
    take its launches back out of the counts."""
    router._quiesce()
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    ops.LAUNCHES.update(before)
    return out


def run_path(name: str, ops, fn, more=None):
    """Drive one path with the launch counters zeroed just before it; return
    fn's result and the counts read just after, having checked that the
    path launched each kernel ``PATHS`` names for it.  ``more`` holds the
    launches the path made in worker processes (``worker_launches``),
    added to this process's."""
    torch.cuda.synchronize()
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if more is not None:
        log(f"{name} path launches in this process: {json.dumps(launches)}, "
            f"in its workers: {json.dumps(more)}")
        for k, n in more.items():
            launches[k] += n
    log(f"{name} path launches: {json.dumps(launches)}")
    for kernel in PATHS[name]:
        check(launches[kernel] > 0, f"kernel {kernel} launched on the {name} path")
    return out, launches


# --------------------------------------------------------------------------
# Ground truth: the exact k-NN through the port's public L1 op, each chunk
# held against the plain version on the same inputs.
# --------------------------------------------------------------------------

def exact_knn(ops, plain, points: torch.Tensor, queries: torch.Tensor, k: int,
              dead: torch.Tensor = None, chunk: int = 250_000):
    best_d = best_i = None
    for lo in range(0, points.shape[0], chunk):
        d = ops.l1_distance(queries, points[lo:lo + chunk])
        check(equal(d, plain(queries, points[lo:lo + chunk])),
              f"l1_distance kernel == plain on ground-truth chunk {lo}")
        if dead is not None:
            d[:, dead[lo:lo + chunk]] = torch.iinfo(torch.int32).max
        cd, ci = torch.topk(d, k, dim=1, largest=False)
        ci = ci + lo
        if best_d is not None:
            cd, sel = torch.topk(torch.cat([best_d, cd], 1), k, dim=1, largest=False)
            ci = torch.gather(torch.cat([best_i, ci], 1), 1, sel)
        best_d, best_i = cd, ci
    return best_d, best_i


def check_results(ops, plain, phase, d, i, queries, points, deleted, inserted_rows,
                  gt_ids, big, recall_fn, exact_delta):
    """The served results' invariants; returns (recall@10, self-hits).

    A query equal to an inserted point must find it at distance 0 while the
    point sits in the delta buffer, which is scanned exactly.  Once compacted
    into a segment it is one more row of its buckets, and a bucket holding
    more than ``candidate_cap`` rows keeps its lowest ids, so there the
    self-hits are counted, not required."""
    d = torch.from_numpy(d).cuda()
    i = torch.from_numpy(i).cuda()
    valid = i >= 0
    rows = points[i.clamp(min=0).long()]
    exact = ops.l1_distance_rows(queries, rows)
    check(equal(exact, plain(queries, rows)),
          f"{phase}: l1_distance_rows kernel == plain on the served rows")
    check(bool(torch.all(torch.where(valid, exact == d, d == big))),
          f"{phase}: every distance equals the exact L1 of its gid")
    lex = (d[:, :-1] < d[:, 1:]) | ((d[:, :-1] == d[:, 1:]) & (i[:, :-1] < i[:, 1:]))
    both_empty = ~valid[:, :-1] & ~valid[:, 1:]
    check(bool(torch.all(lex | both_empty)), f"{phase}: rows lex-ascending")
    check(not bool(torch.isin(i, deleted).any()), f"{phase}: no deleted gid returned")
    hits = int((d[inserted_rows, 0] == 0).sum())
    if exact_delta:
        check(hits == inserted_rows.numel(),
              f"{phase}: a query equal to an inserted point gets distance 0 at rank 0")
    r = recall_fn(i.cpu().numpy(), gt_ids)
    check(r >= 0.5, f"{phase}: recall@10 {r:.4f} >= 0.5")
    return r, hits


def grouped_rerank_check(kfr, _build, device) -> None:
    """``fused_rerank``'s grouped items at ``gist1m.bulk1024``'s shape, where
    no other check reaches them: 1 M x 960 int32 rows, 1,024 queries, the
    main rung's 131,072 slots and the top rung's 205,824 (G x chunks 768 and
    1,222 segments, past one a thread of the 512-thread scan), 30-50% of a
    row's slots valid, then padding n, with repeats, -1 and a row of no
    valid id.  The rule must pick a group and windows of 4,096 rows; the
    kernel must equal plain on a copy of the ids taken before it ran, keep
    each row's valid ids, and count row loads <= pairs."""
    n, m, q = 1_000_000, 960, 1024
    gen = torch.Generator(device=device).manual_seed(37)
    data = torch.randint(0, 257, (n, m), generator=gen, device=device, dtype=torch.int32)
    queries = torch.randint(0, 257, (q, m), generator=gen, device=device, dtype=torch.int32)
    in_rows = lambda x: torch.sort(torch.where((x >= 0) & (x < n), x, -1), dim=1).values
    for ctot in (131_072, 205_824):
        plan = kfr.plan_call(data, q, ctot, K)
        check(plan is not None and plan.group > 1 and plan.rows == 4096,
              f"fused_rerank's rule groups gist1m's batch at {ctot} slots (plan {plan})")
        ids = torch.randint(0, n, (q, ctot), generator=gen, device=device, dtype=torch.int32)
        fill = (torch.rand((q, 1), generator=gen, device=device) * 0.2 + 0.3) * ctot
        ids = torch.where(torch.arange(ctot, device=device) < fill, ids, n)
        ids[:, 1::7] = ids[:, 0::7][:, :ids[:, 1::7].shape[1]]     # repeats
        ids[:, 3::97] = -1
        ids[0] = -1
        fresh = ids.clone()
        _build.take_path("fused_rerank")
        gd, gi = kfr.fused_rerank_cuda(data, queries, ids, K)
        took = _build.take_path("fused_rerank")
        pd, pi = kfr.fused_rerank_plain(data, queries, fresh, K, chunk=128)
        check(equal(gd, pd) and equal(gi, pi),
              f"fused_rerank grouped kernel == plain at gist1m's shape, {ctot} slots")
        check(equal(in_rows(ids), in_rows(fresh)),
              f"fused_rerank's grouped path keeps each row's valid ids, {ctot} slots")
        attrs = kfr.rerank_attrs(*took)
        check(took[0] == "windowed" and attrs["group"] == plan.group
              and 0 < attrs["row_loads"] <= attrs["pairs"],
              f"fused_rerank's grouped launch at {ctot} slots counted {attrs}")
        log(f"phase batch: grouped rerank at 1,024 x {ctot} slots over 1 M x 960: G "
            f"{attrs['group']}, {plan.windows} windows, reuse "
            f"{attrs['pairs'] / attrs['row_loads']:.2f}, == plain")
        del ids, fresh


def batch_phase(engine, cfg, serve_cfg, inserted, q_c, data_c) -> dict:
    """The kernels against their plain versions at the main path's shapes,
    bit for bit: one served batch over the engine's compacted segment and a
    delta (the probe's two launches apart and in one pass, the staged
    probe's slab, the rerank, the delta scan, the fold), the grouped rerank
    at gist1m's shape (``grouped_rerank_check``), the one-pass probe
    at caps 1 and 3 of ``PROBE_CASES``, ``rw_hash`` at the build's rows and
    at the batch, ``l1_distance`` on wide int32 and on int16 inputs at the
    ground truth's shape, and ``l1_distance_rows`` on both of its paths.
    Returns what the log prints."""
    from repro_torch.core import pipeline as pipe
    from repro_torch.core import walks
    from repro_torch.core.index import probe_index
    from repro_torch.core.segments import _gid_map
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_probe as kfp
    from repro_torch.kernels import fused_rerank as kfr
    from repro_torch.kernels import l1_distance as kl1
    from repro_torch.kernels import rw_hash as krw
    from repro_torch.kernels import topk_merge as ktm

    idx = engine.index
    idx.insert(inserted[:N_INSERT // 2])     # a delta again, for the fold
    batch = q_c[:serve_cfg.batch_size].contiguous()
    seg = idx.segments[0]
    st = seg.state
    n_rows = st.dataset.shape[0]
    idx._ensure_caps(seg)
    pk, lo, occ, counts = probe_index(cfg, st, batch)
    cb, c_cap, _ = pipe.pick_rung(int(counts.max()), seg.ctot_cap,
                                  serve_cfg.cand_bucket_min, seg.ctot_norm,
                                  seg.c_norm, serve_cfg.cand_overflow)
    cap = cfg.candidate_cap if c_cap is None else min(cfg.candidate_cap, c_cap)
    ext = kfp.probe_extents_cuda(st.sorted_keys, pk, cfg.candidate_cap, st.occ_from)
    check(all(equal(a, b) for a, b in zip(ext, kfp.probe_extents(
        st.sorted_keys, pk, cfg.candidate_cap, st.occ_from))) and equal(ext[0], lo),
          "fused_probe extents kernel == plain on the served batch")
    got = kfp.compact_gather_cuda(st.sorted_ids, lo, occ, cfg.probes_per_table, cb, cap)
    want = kfp.compact_gather(st.sorted_ids, lo, occ, cfg.probes_per_table, cb, cap)
    check(equal(got[0], want[0]) and equal(got[1], want[1]),
          "fused_probe gather kernel == plain on the served batch")
    one = kfp.fused_probe_cuda(st.sorted_keys, st.sorted_ids, pk, cap, cb, occ_from=st.occ_from)
    check(all(equal(a, b) for a, b in zip(one, want)),
          "fused_probe one-pass kernels == plain on the served batch")
    # the one-pass route at the tighter caps 1 and 3 of each adversarial case
    # (the served path reaches such caps through c_cap)
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cases import PROBE_CASES
    for name, (keys, ids_np, pk_np, case_cap, cbucket) in sorted(PROBE_CASES.items()):
        tk, tids, tpk = (torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32 else x)
                         .to(batch.device) for x in (keys, ids_np, pk_np))
        t_occ = (torch.searchsorted(tk, tk, right=True)
                 - torch.arange(tk.shape[1], device=batch.device)).to(torch.int32)
        c_lo, c_raw, _ = kfp.probe_extents(tk, tpk, case_cap, t_occ)
        for c in (1, 3):
            c_want = kfp.compact_gather(tids, c_lo, c_raw, pk_np.shape[2], cbucket, c)
            for occ_from in (None, t_occ):
                c_got = kfp.fused_probe_cuda(tk, tids, tpk, c, cbucket, occ_from=occ_from)
                check(equal(c_got[0], c_want[0]) and equal(c_got[1], c_want[1]),
                      f"fused_probe one-pass kernels == plain on {name} cap={c}")
    # the staged probe at the same cap: two torch.searchsorted calls a table,
    # then a gather of the (Q, L*P*C) slab
    staged_cfg = dataclasses.replace(cfg, candidate_cap=cap, probe_impl="staged")
    s_lo, s_hi = pipe.stage_bucket_lookup(st.sorted_keys, pk)
    check(equal(s_lo.reshape(lo.shape), lo) and equal((s_hi - s_lo).reshape(occ.shape), occ),
          "the staged lookup's extents == the extents kernel's on the served batch")
    slab = pipe.stage_candidate_gather(staged_cfg, st.sorted_ids, s_lo, s_hi, n_rows)
    front = torch.sort((slab == n_rows).to(torch.int8), dim=1, stable=True).indices
    check(equal(torch.gather(slab, 1, front)[:, :cb], got[0]),
          "the staged slab's valid candidates == the gather's, in order")
    del slab, front
    tomb = idx._tombstone_array()
    ids = pipe.stage_tombstone(got[0], seg.gids, tomb, n_rows)
    # the windowed path reorders ids in place (same answer, same work): the
    # plain version takes a copy in the gather's order, as served
    ids_fresh = ids.clone()
    _build.take_path("fused_rerank")
    sd, si = kfr.fused_rerank_cuda(st.dataset, batch, ids, K)
    rr_path = _build.take_path("fused_rerank")
    wd, wi = kfr.fused_rerank_plain(st.dataset, batch, ids_fresh, K, chunk=cfg.rerank_chunk)
    check(equal(sd, wd) and equal(si, wi), "fused_rerank kernel == plain on the served batch")
    in_rows = lambda x: torch.sort(torch.where((x >= 0) & (x < n_rows), x, -1), dim=1).values
    check(equal(in_rows(ids), in_rows(ids_fresh)),
          f"fused_rerank's {rr_path[0]} path keeps each row's valid ids on the served batch")
    grouped_rerank_check(kfr, _build, batch.device)
    delta_pts, delta_gids = idx._delta_arrays()
    cap_d = delta_pts.shape[0]
    slots = torch.arange(cap_d, dtype=torch.int32, device=batch.device)
    dids = torch.where(slots < idx._delta_count, slots, cap_d).expand(
        batch.shape[0], cap_d).contiguous()
    dids = pipe.stage_tombstone(dids, delta_gids, tomb, cap_d)
    pd, pi = kfr.fused_rerank_plain(delta_pts, batch, dids, K)
    dd, di = kfr.fused_rerank_cuda(delta_pts, batch, dids, K)
    check(equal(dd, pd) and equal(di, pi), "fused_rerank kernel == plain on the delta scan")
    ia, ib = _gid_map(si, seg.gids, n_rows), _gid_map(di, delta_gids, cap_d)
    mk, mp = ktm.topk_merge_cuda(sd, ia, dd, ib), ktm.topk_merge_plain(sd, ia, dd, ib)
    check(equal(mk[0], mp[0]) and equal(mk[1], mp[1]), "topk_merge kernel == plain on the fold")

    # rw_hash at the build's shape (every point) and at the served batch;
    # plain on a subset, the prefix-gather hash on every point
    walk_tab = idx.params.walks
    wp = walk_tab.pairs
    rw_out = krw.rw_hash_cuda(wp, data_c)
    check(equal(rw_out, walks.eval_prefix(walk_tab, data_c)),
          "rw_hash kernel == eval_prefix on every point")
    check(equal(rw_out[:RW_PLAIN_ROWS], krw.rw_hash_plain(wp, data_c[:RW_PLAIN_ROWS])),
          f"rw_hash kernel == plain on {RW_PLAIN_ROWS} rows")
    del rw_out
    check(equal(krw.rw_prefix_table_cuda(wp),
                krw.rw_prefix_table_plain(wp, krw.padded_fns(wp.shape[0]))),
          "rw_hash table kernel == plain at the served steps")
    check(equal(krw.rw_hash_cuda(wp, batch), krw.rw_hash_plain(wp, batch)),
          "rw_hash kernel == plain on the served batch")

    # l1_distance_rows at the batch's first 4,096 candidates a query and at
    # SRS's shape (QUALITY_QUERIES queries x its 512-row chunk) in four input
    # types, through the vector path; SRS's rows one element into their
    # storage (not 16-byte aligned) take the scalar path
    def rows_check(qd, rd, what, path):
        plan = kl1.plan_rows(qd.dtype, rd.shape[2], rd.shape[1], rd.shape[0],
                             rd.data_ptr(), qd.data_ptr())
        took = "vector" if plan.slots else "scalar"
        check(took == path and equal(kl1.l1_distance_rows_cuda(qd, rd),
                                     kl1.l1_distance_rows_plain(qd, rd)),
              f"l1_distance_rows kernel == plain {what}, on the {path} path (took {took})")

    cand = ids_fresh[:, :4096].clamp(0, n_rows - 1).long()
    srs_cand = torch.randint(0, n_rows, (QUALITY_QUERIES, SRS_ROWS_CHUNK),
                             generator=torch.Generator(device=batch.device).manual_seed(28),
                             device=batch.device)
    srs_q = q_c[:QUALITY_QUERIES].contiguous()
    for what, qd, rd in (("at the served batch", batch, st.dataset[cand]),
                         ("at SRS's shape", srs_q, st.dataset[srs_cand])):
        for dtype in (torch.int32, torch.int16, torch.float32, torch.bfloat16):
            rows_check(qd.to(dtype), rd.to(dtype).contiguous(),
                       f"in {dtype} {what} {list(rd.shape)}", "vector")
    rs = st.dataset[srs_cand].to(torch.int32)
    mis = torch.empty(rs.numel() + 1, dtype=torch.int32, device=batch.device)[1:].view(
        rs.shape).copy_(rs)
    rows_check(srs_q.to(torch.int32), mis, "at SRS's shape one element into its storage",
               "scalar")
    # l1_distance at the ground truth's shape (the batch against every point)
    # with every coordinate drawn in +-2^30, so every stage of every block runs
    # the int32 loop, and in int16
    gen = torch.Generator(device=batch.device).manual_seed(18)
    wq, wx = (torch.randint(-2 ** 30, 2 ** 30, t.shape, generator=gen, device=batch.device,
                            dtype=torch.int32) for t in (batch, data_c))
    check(equal(kl1.l1_distance_cuda(wq, wx), kl1.l1_distance_plain(wq, wx)),
          "l1_distance kernel == plain on the wide input (int32 loop) at 64 x 1 M x 128")
    del wq, wx
    hq, hx = batch.to(torch.int16), data_c.to(torch.int16)
    check(equal(kl1.l1_distance_cuda(hq, hx), kl1.l1_distance_plain(hq, hx)),
          "l1_distance kernel == plain in int16 at 64 x 1 M x 128")
    del hq, hx
    return {"queries": int(batch.shape[0]), "cbucket": int(cb),
            "c_cap": None if c_cap is None else int(c_cap),
            "rerank_path": [rr_path[0], kfr.rerank_attrs(*rr_path)["windows"]],
            "delta_rows": int(idx._delta_count)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-cards":
        return dist_cards_main(int(sys.argv[2]))
    from repro_torch.core import pipeline as pipe
    from repro_torch.core.baselines import recall
    from repro_torch.core.index import IndexConfig, probe_index
    from repro_torch.data import ann_synthetic as ds
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_probe as kfp
    from repro_torch.kernels import fused_rerank as kfr
    from repro_torch.kernels import l1_distance as kl1
    from repro_torch.kernels import rw_hash as krw
    from repro_torch.kernels import topk_merge as ktm
    from repro_torch.serve.engine import AnnServingEngine, ServeConfig

    card = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(nvidia_smi_line())
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    # -- lint: the port's analysis gate, before any card phase ---------------
    lint = lint_phase()
    by_how = {}
    for ent in lint["sanctioned"]:
        key = f"{ent['rule']} {ent['how']}"
        by_how[key] = by_how.get(key, 0) + 1
    log(f"phase lint: python -m repro_torch.analysis --check --json exits 0; "
        f"{len(lint['findings'])} finding(s), all baselined; "
        f"sanctioned by rule and kind {json.dumps(dict(sorted(by_how.items())))}")

    # -- build -------------------------------------------------------------
    libs = _build.build_all()
    for name in libs:
        _build.library(name)
    log(f"phase build: {sorted(libs)}")
    for name, path in libs.items():
        lines = (path.parent / f"{name}.log").read_text().splitlines()
        regs = [ln.strip() for ln in lines if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in lines if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        log(f"  ptxas {name}: {' | '.join(regs)}; spills: {' | '.join(spills) or 'none'}")

    # -- cuda: the card tests (every kernel at its adversarial shapes, the
    # card against the CPU at small sizes) beside the phases below ---------
    with card_tests() as wait_card_tests:
        # -- data, width and ground truth ----------------------------------------
        spec = ds.DatasetSpec("sift1m", n=N_POINTS, dim=DIM, universe=UNIVERSE)
        data = ds.make_dataset(spec)
        queries = ds.make_queries(spec, data, N_QUERIES)
        inserted = ds.make_queries(spec, data, N_INSERT, seed=11)
        inserted_rows = np.arange(32)
        queries[inserted_rows] = inserted[:32]          # self-hit probes
        log(f"cut: n {N_POINTS} (SIFT1M) instead of the paper's SIFT50M 50M, for "
            f"host data generation and the smoke's time limit; widths kept: "
            f"dim {DIM}, universe {UNIVERSE}")
        data_c = torch.from_numpy(data).to(card)
        q_c = torch.from_numpy(queries).to(card)
        points = torch.cat([data_c, torch.from_numpy(inserted).to(card)])
        dead = torch.zeros(points.shape[0], dtype=torch.bool, device=card)

        def ground_truth():
            gt_d0, gt_i0 = exact_knn(ops, kl1.l1_distance_plain, data_c, q_c, K)
            # delete the exact 1-NN of 64 queries, so the tombstones bite
            deleted = np.unique(gt_i0[32:32 + N_DELETE, 0].cpu().numpy()).astype(np.int32)
            dead[torch.from_numpy(deleted).long().to(card)] = True
            return float(gt_d0.float().mean()), deleted, exact_knn(
                ops, kl1.l1_distance_plain, points, q_c, K, dead=dead)[1], gt_i0

        (dbar, deleted, gt_i, gt_i0), _ = run_path("ground_truth", ops, ground_truth)
        width = max(8, int(3.0 * math.sqrt(dbar)) & ~1)
        cfg = IndexConfig(num_tables=8, num_hashes=12, width=width, num_probes=200,
                          candidate_cap=128, universe=UNIVERSE, k=K, rerank_chunk=1024)
        gt_ids = gt_i.cpu().numpy()
        deleted_c = torch.from_numpy(deleted).to(card)
        self_rows = torch.from_numpy(inserted_rows).to(card)
        log(f"phase data: dbar {dbar:.1f} -> W {width}; L 8 M 12 T 200 C 128 k {K} batch 64")

        # -- serve and serve_rw_hash: the same traffic through two engines --------
        serve_cfg = ServeConfig(batch_size=64, delta_cap=2048)

        def serve(run_cfg, tag, run_serve_cfg=serve_cfg):
            """build, insert, delete, drain, compact, drain; returns the engine
            and its drains (name, dists, gids)."""
            eng = AnnServingEngine(run_cfg, run_serve_cfg, data, device="cuda")
            gids_new = eng.insert(inserted)
            check(list(gids_new[:2]) == [N_POINTS, N_POINTS + 1], "insert assigns fresh gids")
            check(eng.delete(deleted) == len(deleted), "delete tombstones every gid")
            check(eng.index.num_segments == 1 and eng.index.delta_fill > 0,
                  "one segment plus a delta buffer: the fold runs topk_merge")
            out = []
            for name in (f"{tag}_delta", f"{tag}_compacted"):
                if name.endswith("_compacted"):
                    eng.compact()
                eng.submit(queries)
                out.append((name, *eng.drain()))
            return eng, out

        (engine, phases), launches = run_path("serve", ops, lambda: serve(cfg, "serve"))
        check(launches["rw_hash"] == 0, "the 'gather' path launches no rw_hash")
        rw_cfg = dataclasses.replace(cfg, hash_impl="pallas")
        rw_rows, dispatch = [], ops.rw_hash

        def rw_hash_recorded(pairs, points):    # the row count of each call
            rw_rows.append(points.shape[0])
            return dispatch(pairs, points)

        ops.rw_hash = rw_hash_recorded
        try:
            (rw_engine, rw_phases), rw_launches = run_path(
                "serve_rw_hash", ops, lambda: serve(rw_cfg, "serve_rw_hash"))
        finally:
            ops.rw_hash = dispatch
        rw_rows = [r for r in rw_rows if r > 0]     # a call on no rows launches nothing
        check(len(rw_rows) == rw_launches["rw_hash"] == rw_launches["rw_prefix_table"],
              "every rw_hash call of the path launched both kernels once")
        for (name, d, i), (rw_name, rd, ri) in zip(phases, rw_phases):
            check(np.array_equal(d, rd) and np.array_equal(i, ri),
                  f"{rw_name} serves the (d, i) of {name}, bit for bit")
        for what in ("sorted_keys", "sorted_ids", "occ_from", "occ_hist"):
            check(equal(getattr(engine.index.segments[0].state, what),
                        getattr(rw_engine.index.segments[0].state, what)),
                  f"hash_impl='pallas' builds the segment's {what} of 'gather'")
        log("phase serve_rw_hash: (d, i) of both drains and the compacted segment's "
            "tables equal the 'gather' engine's, bit for bit")

        def checks():
            for name, d, i in phases + rw_phases:
                r, hits = check_results(ops, kl1.l1_distance_rows_plain, name, d, i, q_c,
                                        points, deleted_c, self_rows, gt_ids, pipe.BIG_DIST,
                                        recall, exact_delta=name.endswith("_delta"))
                log(f"phase {name}: recall@10 {r:.4f}, self-hits {hits}/{inserted_rows.size}")

        run_path("checks", ops, checks)
        del rw_engine

        # -- host_syncs: the serve traffic under torch's sync debug mode ----------
        syncs, _ = host_syncs_phase(ops, cfg, serve_cfg, data, queries, inserted, deleted,
                                    lint["sanctioned"])
        for tag in ("gather", "pallas"):
            row = syncs[tag]
            log(f"phase host_syncs {tag}: {row['syncs_per_batch']:.2f} syncs a batch over "
                f"{row['batches']} batches {json.dumps(row['drain_sites'])}; compaction "
                f"{json.dumps(row['compact_sites'])}; sanctioned, not hit: "
                f"{json.dumps(row['sanctioned_not_hit'])}")
        log(f"phase host_syncs: torch.cuda.synchronize reported as a sync: "
            f"{syncs['synchronize_reported']}")
        log(json.dumps({"host_syncs": syncs}))

        # -- examples: two ANN examples and generate at their own sizes ----------
        examples, _ = run_path("examples", ops, examples_phase)
        for name, row in examples.items():
            log(f"phase examples {name}: printed ... {json.dumps(row['printed_tail'])}")

        # -- lm: the language models; lm_retrieval: the model feeding the index --
        lm = lm_phase()
        for arch, row in lm["reduced"].items():
            log(f"phase lm {arch}: reduced() card == CPU, max abs err {row['max_abs_err']:.3g} "
                f"over {row['results']} results")
        full = lm["full"]
        log(f"phase lm {full['config']['name']} ({full['config']['params']} parameters, "
            f"B {LM_BATCH}, prompt {LM_PROMPT}, cache {LM_CACHE}): float32 decode vs forward "
            f"max abs err {full['f32']['decode_vs_forward_max_abs_err']:.4g}; bf16 prefill vs "
            f"float32 {full['bf16']['prefill_vs_f32_max_abs_err']:.4g} (bound "
            f"{full['bf16']['bound']:.4g})")
        log(json.dumps({"lm": lm}))
        lm_rag, _ = lm_retrieval_phase(ops, (kfp, kfr, ktm, kl1, krw))
        log(f"phase lm_retrieval: hit rate {lm_rag['hit_rate']}, recall@5 {lm_rag['recall']}, "
            f"embeddings vs CPU {json.dumps(lm_rag['embedding_max_abs_err'])}")
        # -- train: language-model training (no kernel of the repo) ---------------
        train, _ = run_path("train", ops, train_phase)
        for arch, row in train["reduced"].items():
            log(f"phase train {arch}: reduced() card == CPU, gradient within "
                f"{row['grad_share']:.3g} of max |g|, {TRAIN_REDUCED_STEPS} steps' losses and "
                f"grad norms within {row['curve_max_rel_err']:.3g}")
        full, ex = train["full"], train["example"]
        log(f"phase train {full['config']['name']} (bf16, remat, B {TRAIN_BATCH} x S {TRAIN_SEQ},"
            f" {TRAIN_STEPS} steps): loss {full['curve'][0][0]:.4f} -> {full['curve'][-1][0]:.4f};"
            f" gradients without remat within {full['remat_grad_share']:.3g} of remat's")
        log(f"phase train example: {ex['last_line']}; resumed == straight within "
            f"{ex['resume_leaf_share']:.3g} (bit for bit: {ex['resume_bit_for_bit']})")
        log(json.dumps({"train": train}))
        # -- shard: the dry-run's cells and a sharded forward (no kernel) ---------
        sh_more = {}
        shard, sh_launches = run_path("shard", ops, lambda: shard_phase(sh_more), more=sh_more)
        check(sum(sh_launches.values()) == 0,
              f"no kernel launched on the shard path ({json.dumps(sh_launches)})")
        for cell in shard["dryrun"]:
            log(f"phase shard dryrun {cell['arch']} {cell['shape']} {cell['mesh']}: ok, "
                f"collectives {json.dumps(cell['coll_breakdown'])}, fits one card "
                f"{cell.get('fits_one_card')}")
        rk = shard["ranks"]
        log(f"phase shard ranks ({rk['backend']} on {rk['devices']}, {rk['mesh']}): "
            f"{rk['config']['name']} float32 prefill within {max(rk['max_abs_err']):.3g} of the "
            f"unsharded card's (max |logit| {rk['max_abs_logit']:.4g})")
        log(json.dumps({"dryrun": shard["dryrun"]}))
        log(json.dumps({"shard_ranks": rk}))
        # why a compacted self-hit can miss: its epicenter buckets overflow the cap
        seg = engine.index.segments[0]
        _, _, occ_e, _ = probe_index(cfg, seg.state, q_c[:inserted_rows.size])
        epi = occ_e.reshape(inserted_rows.size, cfg.num_tables, cfg.probes_per_table)[:, :, 0]
        over = int((epi > cfg.candidate_cap).all(dim=1).sum())
        log(f"self-hit queries whose epicenter bucket holds > {cfg.candidate_cap} rows "
            f"in every table: {over}/{inserted_rows.size}")
        summ = engine.summary()
        log(f"engine: segments {summ['segments']}, compactions {summ['compactions']}, "
            f"cand_buckets {summ['cand_buckets']}, cold hits {summ['bucket_cold_hits']}, "
            f"skew {json.dumps(summ['skew']['segments'])}")

        # -- quality: the paper's protocol at the serving phases' size -------------
        quality, _ = quality_phase(
            ops, spec, data, ds.make_queries(spec, data, QUALITY_QUERIES), cfg,
            (kfp, kfr, ktm, kl1, krw))
        log(f"phase quality: {len(quality['records'])} records, "
            f"tables needed {json.dumps(quality['table_claim']['tables_needed'])}")
        log(json.dumps({"quality": quality}))

        # -- tuned: the recall-target engine, the serve phase's traffic ------------
        def check_served(name, d, i, exact_delta):
            return check_results(ops, kl1.l1_distance_rows_plain, name, d, i, q_c, points,
                                 deleted_c, self_rows, gt_ids, pipe.BIG_DIST, recall,
                                 exact_delta)

        tuned, _ = tuned_phase(ops, (kfp, kfr, ktm, kl1, krw), serve, cfg, serve_cfg,
                               data_c, queries, inserted, q_c, check_served)
        log(f"phase tuned: tuned {json.dumps(tuned['tuned'])}, predicted "
            f"{tuned['predicted_recall']:.4f}, validated {tuned['validated_recall']:.4f}, "
            f"met {tuned['met_target']}, rounds {tuned['rounds']}, served recall@10 "
            f"{json.dumps({n: r['recall'] for n, r in tuned['served'].items()})}")
        log(json.dumps({"tuned": tuned}))

        # -- cluster: S x R replicas on the card, the serve traffic, kill/recover --
        dead_final = dead.clone()
        dead_final[N_POINTS:] = True                # the inserted gids, deleted at the end
        gt_final = exact_knn(ops, kl1.l1_distance_plain, points, q_c, K, dead=dead_final)[1]
        deleted_final = torch.cat([deleted_c, torch.arange(
            N_POINTS, N_POINTS + N_INSERT, dtype=deleted_c.dtype, device=card)])

        def check_drain(name, d, i, stage):
            final = stage == "cluster_recovered"
            return check_results(ops, kl1.l1_distance_rows_plain, name, d, i, q_c, points,
                                 deleted_final if final else deleted_c, self_rows,
                                 (gt_final if final else gt_i).cpu().numpy(), pipe.BIG_DIST,
                                 recall, exact_delta=stage == "cluster_delta")

        cluster, _ = cluster_phase(ops, cfg, serve_cfg, data, queries, inserted, deleted,
                                   check_drain)
        # -- cluster_process: the same traffic over one worker process a replica --
        process, _ = cluster_process_phase(ops, cfg, serve_cfg, data, queries, inserted,
                                           deleted, check_drain)
        for name, row in {**cluster["drains"], **process["drains"]}.items():
            log(f"phase {name}: batches {row['batches']}, recall@10 {row['recall']:.4f}, "
                f"self-hits {row['self_hits']}/{inserted_rows.size}")
        for tag, row in (("cluster", cluster), ("cluster_process", process)):
            log(f"phase {tag}: recovery {json.dumps(row['recovery'])}, router "
                f"{json.dumps(row['router'])}")
        oracle, _ = cluster_oracle_phase(ops, spec, data)
        log(f"phase cluster_oracle: {oracle['cut']}, matches {oracle['cluster_matches_flat']}, "
            f"after recovery {oracle['cluster_recovery_matches_flat']}, oracle cap "
            f"{oracle['cluster_oracle_cap']}; "
            + ", ".join(f"{t}: matches {oracle[t]['cluster_matches_flat']}, after recovery "
                        f"{oracle[t]['cluster_recovery_matches_flat']}"
                        for t in ("process", "tcp")))
        log(json.dumps({"cluster": {**cluster, "process": process, "oracle": oracle}}))

        # -- dist: the distributed index over rank processes on the card ---------
        dist, _ = dist_phase(ops, kl1.l1_distance_rows_plain, recall, cfg, data, queries,
                             gt_i0.cpu().numpy())
        for name, row in dist["runs"].items():
            log(f"phase dist {name}: {row['shape']} {row['merge']} ({row['config']}), sent "
                f"{json.dumps(row['sent_bytes'])} B, recall@10 {row['recall_at_10']}")
        log(json.dumps({"dist": dist}))

        # -- batch: one served batch's kernels against their plain versions -------
        batch = batch_phase(engine, cfg, serve_cfg, inserted, q_c, data_c)
        log(f"phase batch: {json.dumps(batch)}; every kernel == plain")

        # -- cuda: the card tests' result --------------------------------------
        log(f"phase cuda: {wait_card_tests()} card tests passed, none failed or skipped")
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
