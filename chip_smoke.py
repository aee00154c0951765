#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: serve a SIFT1M-shaped segmented
MP-RW-LSH index on one NVIDIA card through the port's own entry points, run
the paper's quality protocol at the same size, and hold every CUDA kernel of
those paths against its plain-torch version.

  python3 chip_smoke.py          # from the repository root; needs one card
  python3 chip_smoke.py --dist-cards 4   # the distributed index on 4 cards only
  python3 chip_smoke.py --rerank-paths   # fused_rerank's two paths at the cells' batches only

Phases (each path runs with the launch counters zeroed just before it and
read just after, and must launch the kernels named in ``PATHS``):
  lint           ``python -m repro_torch.analysis --check --json`` in a
                 subprocess, before any card phase: exit 0, and its report
                 of every sanctioned finding (allowed inline or baselined)
                 for ``host_syncs``;
  build          compile csrc/*.cu with nvcc (sm_90a), one process per source;
  kernels        each kernel against its plain version at small adversarial
                 shapes (ties, duplicate ids, uint32 extremes, truncating
                 buckets, tighter caps, n in {0, 1}, Ctot < k, k > 32, int16;
                 odd, negative and above-universe coordinates; ragged Q, N,
                 C, m with m = 300 and m = 1 in four input types; the
                 probe's extents with and without the run-length table, its
                 gather at every cap, the rerank and the gather at their
                 planned split and at 1, 2, 3, 7 and 32 slices, the
                 rerank's windowed path at 1-, 4- and 64-row windows and
                 one window of every row; wrapped
                 int32 sums; l1_distance's two loops, a block mixing them and
                 float sums flushed; rw_hash's table kernel and its hash
                 kernel at the planned split and at 1, 2, 3, 7 and m
                 slices, and both at a U2 above the one-pass limit and at
                 8,192, which take several shared-memory windows), bit for
                 bit; an index on the card refuses the rerank cases whose
                 distances reach BIG_DIST;
  walk_range     one served batch with an out-of-range query (negative, odd
                 and above-universe coordinates) over a segment and a delta
                 holding an out-of-range insert, then after a compaction
                 that hashes it, on the card at the serve configuration over
                 the first 50,000 points: no device assert, and the (d, i)
                 of the same engine on the CPU, bit for bit;
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
  order          the two engines' batches timed alternately (ABBA), so the
                 order of the two serve phases does not enter the gap, and
                 one profiled batch of each;
  host_syncs     each engine ('gather', then 'pallas') at the serve
                 configuration under torch's sync debug mode ("warn"): after
                 warm-up and one drain over a segment, a delta and
                 tombstones, 8 drained batches of 64, a compaction, 8 more;
                 each sync recorded at its innermost frame in the port (and
                 its frames there), and every sync inside r1-host-sync's
                 scope must lie on a line the lint allows or baselines, or
                 in a host helper called from one (``hold_syncs``), else the
                 run fails; prints one
                 ``{"host_syncs": ...}`` line (syncs a batch, the count at
                 each file:line, the compaction's, the sanctioned lines not
                 hit, whether ``torch.cuda.synchronize`` is reported);
  examples       ``repro_torch.examples``' quickstart, ann_serving and
                 cluster_serving, each ``main()`` on the card at its own
                 sizes (each checks its own claims), then on the CPU: every
                 step's (d, i) equal, bit for bit; their seconds and recall;
                 and ``generate``, whose greedy tokens on the card equal the
                 CPU's;
  lm             the language models (no kernel of the repo): every arch's
                 reduced() on the card against the CPU (float32, TF32 off;
                 train_loss, prefill, 8 decode steps and their caches,
                 within 1e-3), then smollm-360m at full width and depth:
                 float32 teacher-forced decode against the full forward
                 (the JAX package's 2e-2), bf16 prefill against float32
                 (0.1 x max |logit|), then in bf16 through
                 ``LanguageModel``: prefill ms of 8 x 128 tokens, a
                 192-slot cache filled by 128 single-token steps, 64 greedy
                 steps (ms a step, tokens/s), the peak of allocated memory
                 by stage, a profiled decode step and prefill; one
                 ``{"lm": ...}`` line with the card's name and power limit;
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
                 through ``make_train_step`` (ms a step from CUDA events,
                 the median after 2; tokens/s; the peak of allocated memory
                 by stage; finite losses and grad norms, every leaf
                 changed), one profiled step, the gradients with and without
                 remat (equal within TRAIN_REMAT_SHARE, the peak without
                 above the peak with) and one step without remat; then
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
                 full QualitySpec: the exact ground truth, 35 timed records
                 over MP-RW-LSH, RW-LSH, CP-LSH, MP-CP-LSH and SRS, the
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
                 spans render and check, one ``engine_batch`` a batch, the
                 median of each phase span), one batch through
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
                 shapes, and their times beside the least time the card
                 could take (bytes over 3.35 TB/s, or operations over 67 T/s,
                 the larger): ``ms`` from CUDA events around one call (for a
                 launch-bound kernel that is the wrapper's host work),
                 ``device_ms`` the kernels' own device time a call from
                 torch.profiler, the same two for the library call.  The
                 probe's row gives its two launches apart and the one-pass
                 route; the rw_hash row gives the build's shape (1 M rows)
                 and the served batch's (``batch_*``), the table kernel
                 alone (``table``) and its path's calls by row count; the
                 l1_distance row gives a wide input's times (``wide_*``:
                 coordinates in +-2^30, the int32 loop), int16's
                 (``int16_*``), and the SASS of each inner loop
                 (``sass``: instructions per update from cuobjdump) with
                 the issue floor it gives (``*issue_floor_ms``: that count
                 x updates / (SMs x 128 lanes x the SM clock's maximum, which
                 nvidia-smi reports as ``clocks.max.sm``)).  Every row also
                 gives ``quality_launches``, ``tuned_launches``,
                 ``cluster_launches``, ``cluster_process_launches``,
                 ``cluster_oracle_launches``,
                 ``cluster_oracle_process_launches``,
                 ``cluster_oracle_tcp_launches``, ``dist_launches``,
                 ``host_syncs_launches``, ``host_syncs_rw_hash_launches``,
                 ``examples_launches``, ``lm_retrieval_launches``,
                 ``train_launches`` and ``shard_launches``, its launches on
                 those paths.  The probe's library call is the
                 staged probe at the same cap (``stage_bucket_lookup``'s two
                 ``torch.searchsorted`` calls, then ``stage_candidate_gather``),
                 whose valid candidates must equal the gather's.

Prints one ``{"host_syncs": ...}`` line, one ``{"lm": ...}`` line, one
``{"train": ...}`` line, one ``{"dryrun": ...}`` line, one
``{"shard_ranks": ...}`` line, one ``{"quality": ...}`` line, one ``{"tuned": ...}`` line, one
``{"cluster": ...}`` line, one ``{"dist": ...}`` line (each run's mesh,
merge, backend and exchange, each rank's boot, build seconds and bytes
sent a call, the query's wall ms: the maximum over ranks, median of 5
calls after one, recall@10), one ``{"kernels": [...]}`` line, the
card's name and power limit, and as its last line ``{"ok": true, "device":
{...}}``.  Any failed check raises, so the exit code is not 0.  Exits 2 with
no result when no card is present or the port's sources are missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
AMORTISED_CALLS = 50        # calls between one event pair (amortised_ms)
INT32_OPS_PER_S = 67e12     # the data sheet's 32-bit non-tensor rate
# instruction issue: 4 schedulers an SM, each one warp instruction (32
# lanes) a clock; times the SM count and the card's clock gives
# lane-instructions/s
LANES_PER_SM_CLOCK = 4 * 32
N_POINTS, DIM, UNIVERSE = 1_000_000, 128, 510
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core rate
N_QUERIES, N_INSERT, N_DELETE, K = 1024, 512, 64, 10
RW_PLAIN_ROWS = 65_536      # the plain thermometer at 1 M rows is ~6 TFLOP
ORDER_ROUNDS = 32           # alternating batches of each engine
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
         # the three ANN examples at their own sizes; brute_force_l1 runs
         # l1_distance
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
WALK_RANGE_ROWS = 50_000    # the out-of-range batch's index, on the card and the CPU
CLUSTER_SHARDS, CLUSTER_REPLICAS = 2, 2
# the cluster oracle: rows, queries, and the bound on the flat query's slab
# at the raised cap (ids, the gather's and the rerank's copies)
ORACLE_ROWS, ORACLE_QUERIES, ORACLE_SLAB_BYTES = 250_000, 64, 4 << 30
# the distributed index: four rank processes sharing the one card (gloo, the
# exchanges through the host), timed calls a run, the occ_hist quantiles of
# the capped runs (the serving policy's, and one whose cap truncates), the
# rows and queries of the card-against-CPU check, and the dry-run's ANN
# configuration (src/repro/launch/dryrun.py:181-183)
DIST_RANKS, DIST_REPS = 4, 5
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
# TRAIN_STEPS steps (the step time the median after TRAIN_WARM), and its
# gradients with and without remat within TRAIN_REMAT_SHARE (bf16);
# repro_torch.examples.train_smollm straight and resumed half-way, losses
# within TRAIN_RESUME_RTOL and parameters within TRAIN_RESUME_SHARE of a
# leaf's max |value| (the card's reductions need not repeat bit for bit)
TRAIN_GRAD_SHARE, TRAIN_STEP_RTOL, TRAIN_REDUCED_STEPS = 1e-3, 1e-3, 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARM = 8, 128, 20, 2
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


def max_abs_err(pairs) -> float:
    return max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
               if a.numel() else 0.0 for a, b in pairs)


def event_ms(fn) -> float:
    """One call between two CUDA events: the device's time from the first
    event to the last of the call's work, which includes the host's time to
    issue the call where that is longer than the work before it."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def cuda_ms(fn, reps: int = 20, warm: int = 2) -> float:
    """Median time of one call, from CUDA events around each call."""
    for _ in range(warm):
        fn()
    return float(np.median([event_ms(fn) for _ in range(reps)]))


def cuda_ms_pair(fa, fb, reps: int = 20, warm: int = 2):
    """Median times of one call of each of two functions, timed in turns
    (a b, b a, ...), so that drift in the host or the card hits both alike."""
    for _ in range(warm):
        fa()
        fb()
    ta, tb = [], []
    for r in range(reps):
        turn = ((fa, ta), (fb, tb)) if r % 2 == 0 else ((fb, tb), (fa, ta))
        for fn, times in turn:
            times.append(event_ms(fn))
    return float(np.median(ta)), float(np.median(tb))


def amortised_ms(fn, n: int = AMORTISED_CALLS, warm: int = 3, windows: int = 3) -> float:
    """Time of one call from one CUDA event pair around ``n`` calls issued
    back to back, / n, after ``warm`` calls; the median of ``windows`` such
    readings, with Python's collector paused so that no collection of this
    process's large heap falls inside a window (host work there counts in
    full: one window read 7x a call's own time).  The host's issue time of a
    call hides behind the card's work of the calls before it, unless it is
    the longer of the two."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    gc.disable()
    try:
        return float(np.median([event_ms(lambda: [fn() for _ in range(n)]) / n
                                for _ in range(windows)]))
    finally:
        gc.enable()


# the device times that came from CUDA events because every profiler window
# of device_ms recorded nothing
DEVICE_MS_FROM_EVENTS = []


def device_ms(fn, reps: int = 10, tries: int = 3) -> float:
    return device_profile(fn, reps, tries)[0]


def device_profile(fn, reps: int = 10, tries: int = 3):
    """Device time of one call and the device events recorded a call:
    torch.profiler's device-side time over ``reps`` calls (every kernel,
    memset and copy the call launches) / reps, from the fullest of
    ``tries`` windows.  On the H100 a window may lose records (1 event in
    10 calls of a two-launch call was seen) or record none at all,
    and a window short of events reads short of the time; so every window
    is profiled and the one with the most device events is kept, with its
    events a call beside it.  Where every window was empty (seen once in a
    whole run, late in it), the time is that of two CUDA events around
    ``reps`` calls issued back to back, / reps: the host's issue time counts
    where it is the longer, so this reads at or above the profiler's time.
    Such a time is logged and kept in DEVICE_MS_FROM_EVENTS."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = (0, 0.0)                     # (device events, device us) of a window
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, events = 0.0, 0
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            dev = getattr(e, "self_device_time_total", None)
            total += getattr(e, "self_cuda_time_total", 0.0) if dev is None else dev
            events += e.count
        best = max(best, (events, total))
    if best[1] > 0:
        return best[1] / 1e3 / reps, best[0] / reps
    ms = event_ms(lambda: [fn() for _ in range(reps)]) / reps
    DEVICE_MS_FROM_EVENTS.append(ms)
    log(f"device_ms: the profiler recorded no device event in {tries} windows; "
        f"{ms:.6f} ms a call from CUDA events around {reps} calls")
    return ms, None


def sass_loops(lib: Path, kernel: str, updates_per_lds) -> list:
    """The innermost loops of one kernel in a built library, read from
    ``cuobjdump -sass``: for each, its instructions (NOPs left out), shared
    loads, FADDs, and instructions per |q - x| update, where
    ``updates_per_lds(opcode)`` gives the updates one shared load feeds.
    ``kernel`` is a substring of the mangled name.  A loop is a backward
    branch; an innermost one holds no other.  None without ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    code, func = [], None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            func = head.group(1)
            continue
        ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.+?)\s*;", line)
        if ins and func and kernel in func:
            words = [w for w in ins.group(2).split() if not w.startswith("@")]
            code.append((int(ins.group(1), 16), words[0], ins.group(2)))
    back = []
    for addr, op, text in code:
        target = re.search(r"0x([0-9a-f]+)", text.split(op, 1)[1]) if op.startswith("BRA") else None
        if target and int(target.group(1), 16) < addr:
            back.append((int(target.group(1), 16), addr))
    loops = []
    for lo, hi in back:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in back):
            continue
        body = [op for addr, op, _ in code if lo <= addr <= hi and op != "NOP"]
        updates = sum(updates_per_lds(op) for op in body if op.startswith("LDS"))
        if updates:
            loops.append({"instructions": len(body), "updates": updates,
                          "lds": sum(op.startswith("LDS") for op in body),
                          "fadd": sum(op.startswith("FADD") for op in body),
                          "per_update": len(body) / updates})
    return loops


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

    t0 = time.perf_counter()
    qspec = QualitySpec(**QUALITY_SPEC)

    def protocol():
        qrun = QualityRun(data, queries, spec.universe, qspec, device="cuda")
        records = qrun.sweep(timed=True)
        claim = qrun.table_claim(records)
        l_mp = claim["tables_needed"]["mp-rw-lsh"] or max(qspec.table_sweep)
        oracle_cfg = qrun.scheme_config("mp-rw-lsh", l_mp, qspec.probe_sweep[-1])
        cross = qrun.check_cross_layer(oracle_cfg, cluster=False)
        served = qrun.eval_config(served_cfg, timed=True)
        return qrun, records, claim, oracle_cfg, cross, served

    (qrun, records, claim, oracle_cfg, cross, served), launches = run_path(
        "quality", ops, protocol)
    protocol_s = time.perf_counter() - t0
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
        "cauchy_buckets": cauchy,
        "protocol_seconds": protocol_s, "seconds": time.perf_counter() - t0,
        "launches": launches}
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

    t_phase = time.perf_counter()
    tuned_serve = dataclasses.replace(serve_cfg, target_recall=TUNED_TARGET,
                                      autotune_calib=TUNED_CALIB)
    real_tune, tune_s = autotune.tune_for_recall, []

    def timed_tune(*args, **kw):                # the engine's own tuning run
        t0 = time.perf_counter()
        out = real_tune(*args, **kw)
        torch.cuda.synchronize()
        tune_s.append(time.perf_counter() - t0)
        return out

    autotune.tune_for_recall = timed_tune
    try:
        (eng, phases), launches = run_path(
            "tuned", ops, lambda: serve(cfg, "tuned", tuned_serve))
    finally:
        autotune.tune_for_recall = real_tune
    res = eng.autotune
    check(res is not None and len(tune_s) == 1, "the engine tuned once at start-up")
    check(eng.cfg == res.cfg, "the engine serves the tuned configuration")

    # the tuner again, through the kernels' plain versions on the card
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    with plain_kernels(ops, *kernel_modules):
        plain = real_tune(cfg, data_c, TUNED_TARGET, num_calib=TUNED_CALIB,
                          device="cuda")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(dict(ops.LAUNCHES) == before, "the tuner's plain route launched no kernel")
    check(plain.history == res.history and plain.cfg == res.cfg
          and plain.predicted_recall == res.predicted_recall
          and plain.validated_recall == res.validated_recall
          and plain.d_calib == res.d_calib and plain.met_target == res.met_target,
          "the tuner under the plain versions == under the kernels, field for field")
    del plain

    served, all_ms = {}, []
    for name, setup_s, lat, d, i in phases:
        r, hits = check_served(name, d, i, name.endswith("_delta"))
        all_ms += lat
        served[name] = {"setup_s": setup_s, "batches": len(lat),
                        "p50_ms": float(np.percentile(lat, 50)),
                        "p99_ms": float(np.percentile(lat, 99)),
                        "queries_per_s": N_QUERIES / (sum(lat) / 1e3),
                        "recall": r, "self_hits": hits}
    summ = eng.summary()
    check(summ["batches"] == len(all_ms) and summ["quality"]["num_tables"] == res.cfg.num_tables,
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
    traced_ms = batch_ms_since(eng, rec0)
    eng.submit(queries)
    untraced = eng.drain()
    check(all(np.array_equal(a, b) for a, b in zip(traced, untraced)),
          "tracing changes no served result")
    spans = render.load_spans(str(trace_dir))
    report = render.check_spans(spans)
    check(report["ok"], f"the port's trace checks: {report['errors']}")
    (trace_dir / "trace.json").write_text(json.dumps(render.to_chrome(spans)))
    names = ("engine_batch", "phase_a", "phase_b_rerank", "delta_scan", "merge")
    durs = {n: [r["dur"] / 1e3 for r in spans if r["name"] == n] for n in names}
    check(len(durs["engine_batch"]) == len(traced_ms),
          "one engine_batch span for each batch of the traced drain")
    check(all(len(durs[n]) == len(traced_ms) for n in names[1:]),
          "each traced batch has the four phase spans")
    trace_summary = {"dir": str(trace_dir.relative_to(ROOT)), "records": len(spans),
                     "batches": len(traced_ms),
                     "median_ms": {n: float(np.median(v)) for n, v in durs.items()},
                     "batch_p50_ms": float(np.percentile(traced_ms, 50))}

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

    lat_q = {q: summ[f"{q}_batch_ms"] for q in ("p50", "p99", "p999")}
    summary = {
        "target_recall": TUNED_TARGET, "autotune_calib": TUNED_CALIB,
        "base": {"num_tables": cfg.num_tables, "num_probes": cfg.num_probes,
                 "candidate_cap": cfg.candidate_cap, "width": cfg.width},
        "tuned": {"num_tables": res.cfg.num_tables, "num_probes": res.cfg.num_probes,
                  "candidate_cap": res.cfg.candidate_cap},
        "predicted_recall": res.predicted_recall,
        "validated_recall": res.validated_recall, "met_target": res.met_target,
        "rounds": res.rounds, "history": list(res.history), "d_calib": list(res.d_calib),
        "tune_seconds": tune_s[0], "plain_tune_seconds": plain_s, "plain_equal": True,
        "quality": summ["quality"], "served": served,
        "histogram_ms": lat_q,
        "exact_ms": {"p50": float(np.percentile(all_ms, 50)),
                     "p99": float(np.percentile(all_ms, 99))},
        "warmup_ms": summ["warmup_ms"], "cand_buckets": summ["cand_buckets"],
        "flight": summ["flight"], "trace": trace_summary,
        "staged_equal": True, "concat": concat, "sanitized_clean": True,
        "seconds": time.perf_counter() - t_phase, "launches": launches}
    del eng
    return summary, launches


def walk_range_phase(cfg, data, inserted, queries) -> dict:
    """One served batch with an out-of-range query over a segment and a
    delta holding an out-of-range insert, then again after a compaction, on
    the card and on the CPU (the same seeded parameters): equal bit for bit.
    Returns what the log prints."""
    from repro_torch.serve.engine import AnnServingEngine, ServeConfig
    u = cfg.universe
    bad = queries[:64].copy()
    # -2 (U2+2) fills, -2 (U2+1) wraps to row 0, -2 and -1 wrap to row U2,
    # odd values, U, U + 1 and 2U fill
    pattern = np.asarray([-(u + 4), -(u + 2), -2, -1, 1, u - 1, u, u + 1, u + 2, 2 * u])
    bad[1] = np.resize(pattern, bad.shape[1])
    ins = inserted[:64].copy()
    ins[3] = np.resize(pattern[::-1], ins.shape[1])
    bad[2] = ins[3]
    out = []
    for device in ("cuda", "cpu"):
        eng = AnnServingEngine(cfg, ServeConfig(batch_size=64, delta_cap=2048,
                                                warm_buckets=False),
                               data[:WALK_RANGE_ROWS], device=device)
        eng.insert(ins)
        eng.delete([5, 7])
        got = [eng.query_batch(bad)]
        eng.compact()
        got.append(eng.query_batch(bad))
        out.append(got)
        del eng
    torch.cuda.synchronize()
    for (cd, ci), (hd, hi), when in zip(*out, ("delta", "compacted")):
        check(np.array_equal(cd, hd) and np.array_equal(ci, hi),
              f"walk_range: the card's (d, i) == the CPU's, {when}")
    check(out[0][0][1][2, 0] == WALK_RANGE_ROWS + 3 and out[0][0][0][2, 0] == 0,
          "walk_range: the out-of-range insert is found in the delta")
    return {"rows": WALK_RANGE_ROWS, "bad_query_rank0": [int(out[0][0][0][1, 0]),
                                                          int(out[0][0][1][1, 0])]}


def cluster_phase(ops, cfg, serve_cfg, data, queries, inserted, deleted, check_drain):
    """The in-process cluster on the card (the ``cluster`` path), then its
    recovery checks.  ``check_drain(name, d, i, stage)`` checks a drain's
    results.  Returns the summary of the ``{"cluster": ...}`` line and the
    path's launch counts."""
    from repro_torch.cluster import ClusterConfig, ClusterRouter

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as root:
        def traffic():
            t0 = time.perf_counter()
            # no result cache: each drain repeats the same queries, and every
            # one of them is to reach the replicas
            router = ClusterRouter(cfg, serve_cfg,
                                   ClusterConfig(num_shards=CLUSTER_SHARDS,
                                                 num_replicas=CLUSTER_REPLICAS,
                                                 cache_capacity=0),
                                   data, root, device="cuda")
            torch.cuda.synchronize()
            timing = {"startup_s": time.perf_counter() - t0, "snapshot_s": []}
            for group in router.replicas:       # time every later snapshot
                for rep in group:
                    def timed_snapshot(orig=rep.snapshot):
                        t1 = time.perf_counter()
                        step = orig()
                        timing["snapshot_s"].append(time.perf_counter() - t1)
                        return step
                    rep.snapshot = timed_snapshot
            gids = router.insert(inserted)
            check(list(gids[:2]) == [N_POINTS, N_POINTS + 1],
                  "cluster: insert assigns fresh gids")
            check(router.delete(deleted) == len(deleted),
                  "cluster: delete tombstones every gid")
            drains = {}

            def drain(name):
                live = [rep for group in router.replicas for rep in group if rep.alive]
                rec0 = router.flight.recorded
                eng0 = [rep.engine.flight.recorded for rep in live]
                router.submit(queries)
                d, i = router.drain()
                n = router.flight.recorded - rec0
                check(0 < n <= router.flight.capacity, f"cluster: {n} dispatches recorded")
                # each replica engine's own batch times in this drain
                engine_ms = {f"{rep.shard_id}.{rep.replica_id}": float(np.percentile(
                    [ms for _, ms, _ in rep.engine.flight.entries()[-m:]], 50))
                    for rep, e0 in zip(live, eng0)
                    if 0 < (m := rep.engine.flight.recorded - e0)}
                drains[name] = (d, i, [ms for _, ms, _ in router.flight.entries()[-n:]],
                                engine_ms)

            drain("cluster_delta")
            t0 = time.perf_counter()
            router.compact()
            timing["compact_s"] = time.perf_counter() - t0
            drain("cluster_compacted")
            # one replica alone on this thread, the same batches: its batch
            # time without the other shard's host work beside it (outside
            # the router, so not counted)
            def alone():
                rep, times = router.replicas[0][0], []
                for lo in range(0, queries.shape[0], serve_cfg.batch_size):
                    t0 = time.perf_counter()
                    rep.query(queries[lo:lo + serve_cfg.batch_size], serve_cfg.batch_size)
                    times.append((time.perf_counter() - t0) * 1e3)
                return float(np.percentile(times, 50))
            timing["one_replica_alone_p50_ms"] = uncounted(ops, router, alone)
            router.kill_replica(0, 0)
            check(router.delete(gids) == len(gids), "cluster: the inserted gids deleted")
            t0 = time.perf_counter()
            info = router.recover_replica(0, 0)
            torch.cuda.synchronize()
            timing["recovery_s"] = time.perf_counter() - t0
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
            return router, drains, timing, info

        (router, drains, timing, info), launches = run_path("cluster", ops, traffic)
        summary = router.summary()
        router.close()
    check(summary["recoveries"] >= 1, "cluster: the router recovered a replica")
    check(info["replayed"] + info["caught_up"] >= 1,
          "cluster: the recovery replayed or caught up a record")
    out = {"shards": CLUSTER_SHARDS, "replicas": CLUSTER_REPLICAS,
           "rows_per_shard": N_POINTS // CLUSTER_SHARDS, "recovery": info,
           "startup_s": timing["startup_s"], "compact_s": timing["compact_s"],
           "recovery_s": timing["recovery_s"], "snapshot_s": timing["snapshot_s"],
           "one_replica_alone_p50_ms": timing["one_replica_alone_p50_ms"],
           "router": {k: summary[k] for k in (
               "queries", "batches", "served", "hedged_batches", "hedge_wins",
               "failovers", "cache_hits", "cache_misses", "recoveries",
               "replicas_marked_dead", "dispatch_failures")},
           "launches": launches, "drains": {}}
    for name, (d, i, lat, engine_ms) in drains.items():
        r, hits = check_drain(name, d, i, name)
        lat = np.asarray(lat)
        out["drains"][name] = {"batches": int(lat.size), "p50_ms": float(np.percentile(lat, 50)),
                               "p99_ms": float(np.percentile(lat, 99)),
                               "first_ms": float(lat[0]), "engine_p50_ms": engine_ms,
                               "queries_per_s": queries.shape[0] / (lat.sum() / 1e3),
                               "recall": r, "self_hits": hits}
    out["seconds"] = time.perf_counter() - t_phase
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

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_process_") as root, \
            worker_launches() as (w_launches, take):
        def traffic():
            t0 = time.perf_counter()
            router = ClusterRouter(cfg, serve_cfg,
                                   ClusterConfig(num_shards=CLUSTER_SHARDS,
                                                 num_replicas=CLUSTER_REPLICAS,
                                                 transport="process", cache_capacity=0),
                                   data, root, device="cuda")
            try:
                out = drive(router, time.perf_counter() - t0)
                return router.summary(), *out
            except BaseException:
                log(worker_log_tails(router))
                raise
            finally:
                router.close()          # takes the live workers' counts

        def engine_batches(router):
            """{worker: (batches recorded, their times)} of every reachable
            worker, from its telemetry."""
            out = {}
            for group in router.replicas:
                for rep in group:
                    try:
                        t = rep.telemetry()
                    except ReplicaKilled:
                        continue
                    out[f"{rep.shard_id}.{rep.replica_id}"] = (
                        t["flight"]["recorded"], t["engine_batch_ms"], t["device"])
            return out

        def drive(router, startup_s):
            boots = {f"{rep.shard_id}.{rep.replica_id}": rep.boot_s
                     for group in router.replicas for rep in group}
            devices = {k: v[2] for k, v in engine_batches(router).items()}
            check(set(devices.values()) == {"cuda"}, f"cluster_process: every worker "
                  f"runs its engine on the card ({devices})")
            timing = {"startup_s": startup_s, "boot_s": boots}
            gids = router.insert(inserted)
            check(list(gids[:2]) == [N_POINTS, N_POINTS + 1],
                  "cluster_process: insert assigns fresh gids")
            check(router.delete(deleted) == len(deleted),
                  "cluster_process: delete tombstones every gid")
            drains = {}

            def drain(name, stage):
                before = engine_batches(router)
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
                engine_ms = {}
                for w, (rec, ms, _) in engine_batches(router).items():
                    m = rec - before.get(w, (rec, None))[0]
                    if 0 < m <= len(ms):
                        engine_ms[w] = float(np.percentile(ms[-m:], 50))
                drains[name] = (d, i, [ms for _, ms, _ in router.flight.entries()[-n:]],
                                engine_ms, stage)

            drain("cluster_process_delta", "cluster_delta")
            t0 = time.perf_counter()
            router.compact()
            timing["compact_s"] = time.perf_counter() - t0
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
            t0 = time.perf_counter()
            info = router.recover_replica(0, 0)
            timing["recovery_s"] = time.perf_counter() - t0
            timing["recovered_boot_s"] = victim.boot_s
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
            timing["snapshot_s"] = []
            for group in router.replicas:
                for rep in group:
                    if rep.alive:
                        t0 = time.perf_counter()
                        rep.snapshot()
                        timing["snapshot_s"].append(time.perf_counter() - t0)
            return drains, timing, info

        (summary, drains, timing, info), launches = run_path(
            "cluster_process", ops, traffic, more=w_launches)
        parent = {k: launches[k] - w_launches.get(k, 0) for k in launches}
    for k in (*PROBE, "fused_rerank", "topk_merge"):
        check(w_launches.get(k, 0) > 0, f"cluster_process: the workers launched {k}")
    check(parent["topk_merge"] > 0, "cluster_process: the router's fold launched topk_merge")
    check(summary["recoveries"] >= 1, "cluster_process: the router recovered a worker")
    check(info["replayed"] + info["caught_up"] >= 1,
          "cluster_process: the recovery replayed or caught up a record")
    out = {"transport": "process", "shards": CLUSTER_SHARDS, "replicas": CLUSTER_REPLICAS,
           "rows_per_shard": N_POINTS // CLUSTER_SHARDS, "recovery": info, **timing,
           "router": {k: summary[k] for k in (
               "queries", "batches", "served", "hedged_batches", "hedge_wins",
               "failovers", "cache_hits", "cache_misses", "recoveries",
               "replicas_marked_dead", "dispatch_failures")},
           "wire": summary["wire"], "launches": launches,
           "launches_parent": parent, "launches_workers": dict(w_launches), "drains": {}}
    for name, (d, i, lat, engine_ms, stage) in drains.items():
        r, hits = check_drain(name, d, i, stage)
        lat = np.asarray(lat)
        out["drains"][name] = {"batches": int(lat.size), "p50_ms": float(np.percentile(lat, 50)),
                               "p99_ms": float(np.percentile(lat, 99)),
                               "first_ms": float(lat[0]), "engine_p50_ms": engine_ms,
                               "queries_per_s": queries.shape[0] / (lat.sum() / 1e3),
                               "recall": r, "self_hits": hits}
    out["seconds"] = time.perf_counter() - t_phase
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

    t0 = time.perf_counter()
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
    t1 = time.perf_counter()
    got, launches = run_path("cluster_oracle", ops, lambda: run.check_cluster(cfg))
    check(got["cluster_matches_flat"], "cluster_oracle: cluster == flat, bit for bit")
    check(got["cluster_recovery_matches_flat"],
          "cluster_oracle: after kill and recovery, cluster == flat, bit for bit")
    out = {"rows": n, "cut": f"n {n} of {N_POINTS} (the flat oracle's slab at the raised "
           f"cap), dims {spec.dim} kept", "config": dataclasses.asdict(cfg), **got,
           "inproc_seconds": time.perf_counter() - t1}
    all_launches = {"cluster_oracle": launches}
    # the same oracle over worker processes on the card, each transport
    for transport in ("process", "tcp"):
        name = f"cluster_oracle_{transport}"
        t1 = time.perf_counter()
        with worker_launches() as (w_launches, _):
            got, all_launches[name] = run_path(
                name, ops, lambda: run.check_cluster(cfg, transport=transport),
                more=w_launches)
        check(got["cluster_matches_flat"] and got["cluster_recovery_matches_flat"],
              f"{name}: cluster == flat, bit for bit, before and after a SIGKILL and "
              "recovery")
        for k in (*PROBE, "fused_rerank"):
            check(w_launches.get(k, 0) > 0, f"{name}: the workers launched {k}")
        out[transport] = {**got, "seconds": time.perf_counter() - t1,
                          "launches_workers": dict(w_launches)}
    out["seconds"] = time.perf_counter() - t0
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

    t_phase = time.perf_counter()
    card = torch.device("cuda")
    params = make_params(cfg, DIM)
    dry = IndexConfig(**DRYRUN_ANN)
    base = {"cfg": cfg, "params": params}
    runs = {f"rows2_model2_{m}": {"shape": (2, 2), "merge": m, "reps": DIST_REPS, **base}
            for m in di.MERGES}
    for tag, q in DIST_QUANTILES.items():
        capped = {"shape": (2, 2), "cand_bucket": "cover", "cap_quantile": q, **base}
        for m in di.MERGES:
            runs[f"rows2_model2_{m}_{tag}"] = {"merge": m, **capped}
        runs[f"rows2_model2_tree_again_{tag}"] = {"merge": "tree", **capped}
    runs.update({
            "dryrun_rows2_model2_tree": {"shape": (2, 2), "merge": "tree", "reps": DIST_REPS,
                                         "cfg": dry, "params": make_params(dry, DIM)},
            "rows2_model2_first_rows": {"shape": (2, 2), "rows": DIST_CPU_ROWS,
                                        "queries": DIST_CPU_QUERIES, **base},
            "model4_allgather": {"shape": (1, 4), "reps": DIST_REPS, **base}})
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
        t0 = time.perf_counter()
        cpu = di.spawn_ranks(DIST_RANKS, di.run_meshes, path, queries,
                             [runs["rows2_model2_first_rows"]], backend="gloo",
                             device="cpu", timeout_s=600)
        cpu_s = time.perf_counter() - t0
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
    t0 = time.perf_counter()
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
    checks_s = time.perf_counter() - t0

    out = {"ranks": DIST_RANKS, "backend": recs[0][0]["backend"],
           "exchange": recs[0][0]["exchange"],
           "boot_s": [rep["boot_s"] for rep in reports],
           "ready_s": [rep["ready_s"] for rep in reports],
           "rank_seconds": [rep["seconds"] for rep in reports],
           "nccl_refusal": nccl_refusal if torch.cuda.device_count() < DIST_RANKS else None,
           "nccl_own_answer": nccl_answer if torch.cuda.device_count() < DIST_RANKS else None,
           "runs": {}, "cpu_ranks_s": cpu_s,
           "cpu_ranks_boot_s": [rep["boot_s"] for rep in cpu],
           "check_distributed": {**oracle, "backend": "nccl", "queries": QUALITY_QUERIES},
           "checks_s": checks_s, "launches": launches}
    for k, name in enumerate(names):
        run, rr = runs[name], [r[k] for r in recs]
        per_call = np.max([r["query_ms"] for r in rr], axis=0) if run.get("reps") else None
        d, i = got[name]
        out["runs"][name] = {
            "shape": list(run["shape"]), "merge": run.get("merge", "allgather"),
            "config": "dryrun" if run["cfg"] is dry else "serve",
            "backend": rr[0]["backend"], "exchange": rr[0]["exchange"],
            "rows": run.get("rows", N_POINTS), "queries": int(d.shape[0]),
            "rows_per_shard": run.get("rows", N_POINTS) // run["shape"][0],
            "queries_per_block": int(d.shape[0]) // run["shape"][1],
            "cand_cap": rr[0]["cand_cap"], "cand_bucket": rr[0]["cand_bucket"],
            "build_s": [r["build_s"] for r in rr],
            "query_ms": None if per_call is None else float(np.median(per_call)),
            "query_ms_calls": None if per_call is None else per_call.tolist(),
            "sent_bytes": [r["sent_bytes"] for r in rr],
            "build_sent_bytes": [r["build_sent_bytes"] for r in rr],
            # the ground truth is over every point
            "recall_at_10": None if run.get("rows") else float(recall(i[:, :K], gt_i0))}
    out["flat_recall_at_10"] = float(recall(fi, gt_i0))
    out["seconds"] = time.perf_counter() - t_phase
    return out, launches


def dist_cards_main(cards: int) -> int:
    """``python3 chip_smoke.py --dist-cards N``: the distributed index under
    nccl, one card a rank, on N cards, in turns with gloo ranks on the same
    cards (the exchanges through the host): nccl, gloo, gloo, nccl.  At the
    serve configuration over the 1 M points and 1,024 queries: (2, N/2) and
    (N, 1) meshes under the three merges and (1, N), five timed calls each;
    every result equal across backends and merges, (1, N) equal to the flat
    index; then ``QualityRun.query_dist`` over the N cards (nccl ranks
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
    t_start = time.perf_counter()
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
    runs = [{"shape": shape, "merge": m, "reps": DIST_REPS, "cfg": cfg, "params": params}
            for shape in ((2, cards // 2), (cards, 1)) for m in di.MERGES]
    runs.append({"shape": (1, cards), "reps": DIST_REPS, "cfg": cfg, "params": params})
    names = [f"rows{r['shape'][0]}_model{r['shape'][1]}_{r.get('merge', 'allgather')}"
             for r in runs]
    out = {"cards": cards, "width": cfg.width, "calls": []}
    first = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as tmp:
        path = os.path.join(tmp, "points.npy")
        np.save(path, data)
        for backend in ("nccl", "gloo", "gloo", "nccl"):
            t0 = time.perf_counter()
            reports = di.spawn_ranks(cards, di.run_meshes, path, queries, runs,
                                     backend=backend, device="cuda", timeout_s=600)
            recs = [rep["result"] for rep in reports]
            call = {"backend": backend, "seconds": time.perf_counter() - t0,
                    "devices": [rep["device"] for rep in reports],
                    "boot_s": [rep["boot_s"] for rep in reports],
                    "launches": {k: sum(rep["launches"][k] for rep in reports)
                                 for k in reports[0]["launches"]}, "runs": {}}
            got = {name: di.assemble(recs, k) for k, name in enumerate(names)}
            first = first or got
            for k, name in enumerate(names):
                check(all(np.array_equal(a, b) for a, b in zip(got[name], first[name])),
                      f"dist_cards {backend} {name} == the first call's, bit for bit")
                check((got[name][0] <= fd).all(), f"dist_cards {name}: every distance <= flat")
                per_call = np.max([rr[k]["query_ms"] for rr in recs], axis=0)
                call["runs"][name] = {
                    "exchange": recs[0][k]["exchange"], "query_ms": float(np.median(per_call)),
                    "query_ms_calls": per_call.tolist(),
                    "build_s": [rr[k]["build_s"] for rr in recs],
                    "sent_bytes": [rr[k]["sent_bytes"] for rr in recs],
                    "recall_at_10": float(recall(got[name][1], gt_i))}
            check(call["devices"] == [f"cuda:{r}" for r in range(cards)],
                  f"dist_cards {backend}: one card a rank ({call['devices']})")
            for k in (*PROBE, "fused_rerank", "topk_merge"):
                check(call["launches"][k] > 0, f"dist_cards {backend}: the ranks launched {k}")
            log(f"dist_cards {backend}: {call['seconds']:.1f} s, " + ", ".join(
                f"{n} {r['query_ms']:.3f} ms" for n, r in call["runs"].items()))
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
    t0 = time.perf_counter()
    oracle = qrun.check_distributed(cfg)
    check(oracle == {"devices": cards, "dist_matches_flat": True},
          f"dist_cards: check_distributed over {cards} cards: {oracle}")
    out["check_distributed"] = {**oracle, "seconds": time.perf_counter() - t0}
    if cards == 4:      # the shard phase's sharded forward under nccl, one rank a card
        out["shard_ranks"] = shard_ranks("nccl", "cuda")
        check(out["shard_ranks"]["devices"] == [f"cuda:{r}" for r in range(4)],
              f"dist_cards shard ranks: one card a rank ({out['shard_ranks']['devices']})")
        log(f"dist_cards shard ranks (nccl): max abs err "
            f"{max(out['shard_ranks']['max_abs_err']):.3g} of max |logit| "
            f"{out['shard_ranks']['max_abs_logit']:.4g}, {out['shard_ranks']['seconds']:.1f} s")
    out["seconds"] = time.perf_counter() - t_start
    log(json.dumps({"dist_cards": out}))
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# fused_rerank's two paths at the bulk cells' batches: (name, rows n, width
# m, universe, queries Q, rung ctot, valid slots a query), the valid ids
# uniform over the rows and packed to the front, the tail the sentinel n
RERANK_SHAPES = (("gist1m", 1_000_000, 960, 256, 1024, 131_072, 50_600),
                 ("sift50m", 50_000_000, 128, 510, 1024, 262_144, 139_773))
RERANK_REPS = 10


def rerank_paths_main() -> int:
    """``python3 chip_smoke.py --rerank-paths``: ``fused_rerank``'s sliced
    and windowed paths at ``RERANK_SHAPES``, each call on a fresh copy of the
    ids (the windowed path reorders them), timed alone between CUDA events
    (median of ``RERANK_REPS``), the two equal bit for bit, beside the
    bounds: the distinct rows' bytes once, and every valid slot's row once
    (the sliced path's reads).  Prints one ``{"rerank_paths": ...}`` line."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_rerank as kfr

    log(nvidia_smi_line())
    for name in _build.build_all():
        _build.library(name)
    card = torch.device("cuda")
    dev = torch.cuda.current_device()
    out = []
    for name, n, m, universe, q, ctot, valid in RERANK_SHAPES:
        gen = torch.Generator(device=card).manual_seed(35)
        data = torch.randint(0, universe + 1, (n, m), dtype=torch.int32, device=card,
                             generator=gen)
        queries = torch.randint(0, universe + 1, (q, m), dtype=torch.int32, device=card,
                                generator=gen)
        fresh = torch.full((q, ctot), n, dtype=torch.int32, device=card)
        fresh[:, :valid] = torch.randint(0, n, (q, valid), dtype=torch.int32, device=card,
                                         generator=gen)
        ids = fresh.clone()
        plan = kfr.plan_windows(q, n, m, 4, ctot, K, kfr.l2_bytes(dev),
                                kfr.resident_blocks(dev, torch.int32, m, K, 1, windowed=True))
        check(plan is not None, f"the rule takes the windowed path at {name}'s batch")
        slices = kfr.plan_slices(q, ctot, kfr.resident_blocks(dev, torch.int32, m, K, 1))
        calls = {"sliced": lambda: kfr.fused_rerank_cuda(data, queries, ids, K, slices=slices),
                 "windowed": lambda: kfr.fused_rerank_cuda(data, queries, ids, K)}
        ms, res = {}, {}
        for path, fn in calls.items():
            times = []
            for _ in range(RERANK_REPS + 1):
                ids.copy_(fresh)
                times.append(event_ms(fn))
            ms[path] = float(np.median(times[1:]))
            ids.copy_(fresh)
            res[path] = fn()
        check(equal(res["sliced"][0], res["windowed"][0])
              and equal(res["sliced"][1], res["windowed"][1]),
              f"fused_rerank windowed == sliced at {name}'s batch")
        distinct = int(torch.unique(fresh[:, :valid]).numel())
        pairs = q * valid
        base = q * ctot * 4 + q * m * 4 + 2 * q * K * 4
        row_bytes = m * 4
        ops_ms = pairs * m * 3 / INT32_OPS_PER_S * 1e3
        rec = {"shape": name, "n": n, "m": m, "q": q, "ctot": ctot, "valid": valid,
               "distinct_rows": distinct, "slots_a_row": q * ctot / n,
               "windows": plan.windows, "window_rows": plan.rows,
               "workspace_bytes": plan.workspace_bytes, "slices": slices,
               "sliced_ms": ms["sliced"], "windowed_ms": ms["windowed"],
               "bound_ms": max((base + distinct * row_bytes) / HBM_BYTES_PER_S * 1e3, ops_ms),
               "pair_bound_ms": max((base + pairs * row_bytes) / HBM_BYTES_PER_S * 1e3, ops_ms)}
        log(f"rerank paths at {name}: {json.dumps(rec)}")
        out.append(rec)
        del data, queries, fresh, ids, res
        torch.cuda.empty_cache()
    log(json.dumps({"rerank_paths": out, "device": torch.cuda.get_device_name(0)}))
    log(nvidia_smi_line())
    return 0


def lint_phase() -> dict:
    """The port's lint gate, ``python -m repro_torch.analysis --check
    --json``, in a subprocess on this machine's Python; its report (the
    findings and every sanctioned one, with its lines)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "--json"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(proc.returncode == 0, "python -m repro_torch.analysis --check exits 0:\n"
          + proc.stdout[-2000:] + proc.stderr[-2000:])
    report = json.loads(proc.stdout)
    report["seconds"] = time.perf_counter() - t0
    return report


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
    t_phase = time.perf_counter()
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
    out["seconds"] = time.perf_counter() - t_phase
    for tag in ("gather", "pallas"):
        check(not out[tag]["missed_by_the_lint"],
              f"host_syncs {tag}: every sync inside r1-host-sync's scope carries an allow "
              f"or a baseline entry (missed: {out[tag]['missed_by_the_lint']})")
    return out, launches


def examples_phase() -> dict:
    """The three ANN examples' ``main()`` on the card at their own sizes (each
    checks its own claims; a failed assert fails the run), then each again
    on the CPU (the kernels' plain versions): every step's (d, i), the
    recall and the inserted gids equal the card's, bit for bit.  Each one's
    seconds on both, recall and the tail of what it printed."""
    from repro_torch.examples import ann_serving, cluster_serving, quickstart
    out = {}
    for name, mod in (("quickstart", quickstart), ("ann_serving", ann_serving),
                      ("cluster_serving", cluster_serving)):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            res = mod.main()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            plain = mod.main(device="cpu")
        cpu_seconds = time.perf_counter() - t0
        steps = sorted(res["answers"])
        check(steps == sorted(plain["answers"]) and all(
            np.array_equal(a, b) for step in steps
            for a, b in zip(res["answers"][step], plain["answers"][step])),
              f"examples {name}: every step's (d, i) on the card == on the CPU, bit for bit")
        check(res["recall"] == plain["recall"] and np.array_equal(
            res.get("gids", ()), plain.get("gids", ())),
              f"examples {name}: recall and gids on the card == on the CPU")
        out[name] = {"seconds": seconds, "cpu_seconds": cpu_seconds,
                     "recall": res["recall"], "steps_equal_on_the_cpu": steps,
                     **{k: v for k, v in res.items()
                        if k not in ("recall", "answers", "gids")},
                     "printed_tail": printed.getvalue().strip().splitlines()[-2:]}
    # the greedy generation example: the same tokens on the card and the CPU
    from repro_torch.examples import generate
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        res = generate.main()
    seconds = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()):
        plain = generate.main(device="cpu")
    check(np.array_equal(res["sequence"], plain["sequence"]),
          "examples generate: the greedy sequence on the card == on the CPU")
    out["generate"] = {"seconds": seconds, "arch": res["arch"],
                       "shape": list(res["sequence"].shape),
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
    logits| (a sanity bound: a wrong cast or mask, not rounding), prefill
    ms, the prompt into a LM_CACHE-slot cache by LM_PROMPT single-token
    steps from pos0 = 0 (the reference's multi-token decode step gives
    every token position pos0, so it is not a prefill; the last step's
    logits against prefill's, same bound), then LM_GREEDY greedy steps: ms
    a step at B LM_BATCH, tokens per second, the peak of allocated memory
    in each stage, and one profiled decode step and prefill (device busy,
    launches, idle share)."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {"reduced": {}}
    try:
        with torch.no_grad():
            for arch in configs.ARCHS:
                t0 = time.perf_counter()
                cfg = configs.get_reduced(arch)
                params = M.init_params(cfg, device="cpu")
                card = _lm_run(M, tf, cfg, tf.tree_map(lambda t: t.cuda(), params), "cuda")
                torch.cuda.synchronize()
                card_s = time.perf_counter() - t0
                cpu = _lm_run(M, tf, cfg, params, "cpu")
                check(sorted(card) == sorted(cpu) and all(
                    torch.allclose(card[k], cpu[k], atol=LM_REDUCED_TOL, rtol=LM_REDUCED_TOL)
                    for k in cpu), f"lm {arch}: reduced() on the card == on the CPU within "
                    f"{LM_REDUCED_TOL}")
                out["reduced"][arch] = {
                    "max_abs_err": max(float((card[k] - cpu[k]).abs().max()) for k in cpu),
                    "loss": float(card["loss"]), "card_seconds": card_s,
                    "results": len(cpu)}
            out["full"] = _lm_full(M, tf, configs)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out["seconds"] = time.perf_counter() - t_phase
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


def _peak_since(mark: dict, stage: str) -> None:
    """Record the peak of allocated memory since the last mark, and start a
    new one."""
    torch.cuda.synchronize()
    mark[stage] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()


def _lm_full(M, tf, configs) -> dict:
    """smollm-360m at full width and depth: float32 checks, then the bf16
    model (the same draws, cast as ``init_params`` casts them) served
    through ``LanguageModel``."""
    cfg16 = configs.get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    vocab = cfg16.vocab
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)).cuda()
    batch = {"tokens": toks}
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
    memory = {"before": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = M.LanguageModel(cfg16, device="cuda")
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    _peak_since(memory, "weights")
    pre16 = lm.prefill(batch)[:, 0, :vocab].float()
    bound = LM_BF16_SHARE * float(pre32.abs().max())
    err16 = float((pre16 - pre32).abs().max())
    check(torch.isfinite(pre16).all() and err16 <= bound,
          f"lm full: bf16 prefill logits within {bound:.3f} of float32's ({err16:.3f})")
    prefill_ms = cuda_ms(lambda: lm.prefill(batch), reps=10)
    _peak_since(memory, "prefill")
    caches = lm.make_caches(LM_BATCH, LM_CACHE, torch.bfloat16)
    check(caches["sub0"]["k"].dtype == torch.bfloat16 and
          caches["sub0"]["k"].shape == (cfg16.n_groups, LM_BATCH, LM_CACHE, cfg16.n_kv,
                                        cfg16.head_dim), "lm full: the bf16 cache's layout")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(LM_PROMPT):
        lg, caches = lm.decode_step(caches, toks[:, i:i + 1], i)
    stop.record()
    stop.synchronize()
    fill_ms = start.elapsed_time(stop)
    _peak_since(memory, "fill")
    last = lg[:, 0, :vocab].float()
    err_fill = float((last - pre16).abs().max())
    check(err_fill <= bound, f"lm full: bf16 cache fill's last logits within {bound:.3f} of "
          f"prefill's ({err_fill:.3f})")
    tok = torch.argmax(lg[..., :vocab], dim=-1).to(torch.int32)
    seq = [tok]
    start.record()
    for i in range(LM_PROMPT, LM_PROMPT + LM_GREEDY):
        lg, caches = lm.decode_step(caches, tok, i)
        tok = torch.argmax(lg[..., :vocab], dim=-1).to(torch.int32)
        seq.append(tok)
    stop.record()
    stop.synchronize()
    greedy_ms = start.elapsed_time(stop)
    _peak_since(memory, "greedy")
    seq = torch.cat(seq, dim=1)
    check(bool(torch.isfinite(lg[..., :vocab]).all()) and bool(((seq >= 0) & (seq < vocab)).all()),
          "lm full: greedy logits finite, tokens inside the vocabulary")
    step_ms = greedy_ms / LM_GREEDY
    res["bf16"] = {"prefill_vs_f32_max_abs_err": err16, "bound": bound,
                   "fill_vs_prefill_max_abs_err": err_fill,
                   "prefill_ms": prefill_ms, "fill_ms": fill_ms,
                   "fill_ms_per_step": fill_ms / LM_PROMPT,
                   "decode_ms_per_step": step_ms,
                   "tokens_per_s": LM_BATCH * 1e3 / step_ms,
                   # the peak of allocated memory above what the earlier
                   # phases left allocated when this one started
                   "peak_allocated": max(memory[k] for k in memory if k != "before")
                   - memory["before"],
                   "memory_peaks": memory,
                   "weights_bytes": sum(t.numel() * t.element_size() for t in lm.parameters()),
                   "cache_bytes": sum(t.numel() * t.element_size() for t in _leaves(caches)),
                   "greedy_tokens_first_row": seq[0, :8].tolist()}
    res["bf16"]["decode_profile"] = device_split(
        lambda: lm.decode_step(caches, tok, LM_CACHE - 1))
    res["bf16"]["prefill_profile"] = device_split(lambda: lm.prefill(batch))
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
    ``batch_at_step``'s B TRAIN_BATCH x S TRAIN_SEQ, each between two CUDA
    events, the peak of allocated memory by stage above the phase's start,
    one profiled step; then, at the trained parameters, the gradients with
    remat and without (each one's peak) and one step without remat.  The
    first draws stay on the host, so that the card holds only what
    training holds."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step, value_and_grad
    cfg = configs.get_config(LM_ARCH)
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.opt_moment_dtype == "float32",
          "train full: smollm-360m trains with remat, bf16 parameters, float32 moments")
    seconds = {}
    t0 = time.perf_counter()
    host = M.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    seconds["draw"] = time.perf_counter() - t0
    memory = {"before": torch.cuda.memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    p = tf.tree_map(lambda t: t.cuda(), host)
    opt = OptConfig(lr=3e-3, moment_dtype=cfg.opt_moment_dtype, warmup_steps=20)
    st = init_opt_state(p, opt)
    _peak_since(memory, "weights_and_moments")
    batches = [_train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, i, "cuda") for i in range(TRAIN_STEPS)]
    step = make_train_step(cfg, opt)
    ms, curve = [], []
    t0 = time.perf_counter()
    for batch in batches:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        p, st, m = step(p, st, batch)
        stop.record()
        ms.append((start, stop))
        curve.append((m["loss"], m["grad_norm"]))
    _peak_since(memory, "steps")
    seconds["steps"] = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in ms]
    curve = [[float(a), float(b)] for a, b in curve]
    check(bool(np.isfinite(curve).all()), f"train full: every loss and grad norm finite {curve}")
    changed = [not torch.equal(a, b.cpu()) for a, b in zip(_leaves(host), _leaves(p))]
    check(all(changed), f"train full: every parameter leaf changed ({sum(changed)}/"
          f"{len(changed)})")
    del host
    step_ms = float(np.median(ms[TRAIN_WARM:]))
    t0 = time.perf_counter()
    profile = device_split(lambda: step(p, st, batches[0]), reps=1)
    _peak_since(memory, "profile")
    seconds["profile"] = time.perf_counter() - t0

    t0 = time.perf_counter()
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
    del grads
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = make_train_step(dataclasses.replace(cfg, remat=False), opt)(p, st, batches[0])
    stop.record()
    stop.synchronize()
    no_remat_step = {"ms": start.elapsed_time(stop), "loss": float(out[2]["loss"]),
                     "peak_above": torch.cuda.max_memory_allocated() - base}
    seconds["remat_checks"] = time.perf_counter() - t0
    del out, p, st, batches
    torch.cuda.empty_cache()
    return {"config": {"name": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "vocab": cfg.vocab, "dtype": cfg.dtype, "remat": cfg.remat,
                       "remat_policy": cfg.remat_policy,
                       "moment_dtype": cfg.opt_moment_dtype},
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
            "step_ms": step_ms, "step_ms_all": ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3 / step_ms,
            "curve": curve, "peak_allocated": max(v for k, v in memory.items() if k != "before")
            - memory["before"], "memory_peaks": memory,
            "grad_peak_above": grad_peak, "remat_grad_share": share,
            "no_remat_step": no_remat_step, "profile": profile, "seconds": seconds}


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
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                losses = train_smollm.main(steps=steps, ckpt_dir=os.path.join(root, name),
                                           resume=resume)
            printed[f"{name}_{steps}"] = out.getvalue().strip().splitlines()
            return losses, time.perf_counter() - t0
        straight, straight_s = run("straight", train_smollm.STEPS, False)
        half = train_smollm.STEPS // 2
        first, _ = run("resumed", half, False)
        resumed, resumed_s = run("resumed", train_smollm.STEPS, True)
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
    return {"last_line": last, "straight_s": straight_s, "resumed_s": resumed_s,
            "loss_first": straight[0], "loss_last": straight[-1],
            "resume_max_abs_loss_err": float(np.max(np.abs(np.subtract(first + resumed,
                                                                       straight)))),
            "resume_leaf_share": share, "resume_bit_for_bit": exact,
            "printed_tail": printed[f"straight_{train_smollm.STEPS}"][-2:]}


def train_phase() -> dict:
    """Language-model training on the card (the ``train`` path): every
    arch's reduced() against the CPU, smollm-360m at full width and depth,
    and the training example with its resume."""
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        from repro_torch import configs
        out = {"reduced": {arch: _train_reduced(arch) for arch in configs.ARCHS}}
        out["reduced_s"] = time.perf_counter() - t_phase
        out["full"] = _train_full()
        t0 = time.perf_counter()
        out["example"] = _train_example()
        out["example_s"] = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out["seconds"] = time.perf_counter() - t_phase
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
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        started = _dryrun_cells(tmp)
        try:
            ranks = shard_ranks("gloo", SHARD_RANKS_DEVICE)
        finally:
            cells = _dryrun_results(started)
    for counts in (ranks.pop("launches"), *(c.get("launches", {}) for c in cells)):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    return {"dryrun": cells, "ranks": ranks, "seconds": time.perf_counter() - t_phase}


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
    t0 = time.perf_counter()
    reports = di.spawn_ranks(4, shd.run_sharded, [(cfg, params, runs)], backend=backend,
                             device=device, timeout_s=600)
    seconds = time.perf_counter() - t0
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
            "max_abs_err": errs, "tolerance_share": SHARD_SHARE, "seconds": seconds,
            "boot_s": [rep["boot_s"] for rep in reports],
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
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        printed = io.StringIO()

        def quiet_main():
            with contextlib.redirect_stdout(printed):
                return rag.main()
        res, launches = run_path("lm_retrieval", ops, quiet_main)
        seconds = time.perf_counter() - t0
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
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cpu = rag.main(device="cpu")
        cpu_seconds = time.perf_counter() - t1
        errs = {name: float(np.abs(res["embeddings"][name] - cpu["embeddings"][name]).max())
                for name in ("memory", "query")}
        check(all(np.allclose(res["embeddings"][n], cpu["embeddings"][n], atol=LM_REDUCED_TOL,
                              rtol=LM_REDUCED_TOL) for n in errs),
              f"lm_retrieval: the card's embeddings == the CPU's within {LM_REDUCED_TOL} {errs}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"seconds": seconds, "cpu_seconds": cpu_seconds, "hit_rate": res["hit_rate"],
            "recall": res["recall"], "cpu_hit_rate": cpu["hit_rate"], "cpu_recall": cpu["recall"],
            "embedding_max_abs_err": errs, "plain_equal": True,
            "memory": list(res["embeddings"]["memory"].shape),
            "printed_tail": printed.getvalue().strip().splitlines()[-1:]}, launches


def nvidia_smi_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def uncounted(ops, router, fn):
    """Run ``fn`` (a check or a timing outside the router) in the middle of
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


def batch_ms_since(engine, recorded_before) -> list:
    """The exact host-clock time of each batch the engine served since its
    flight recorder had ``recorded_before`` records (its ring keeps 256)."""
    n = engine.flight.recorded - recorded_before
    check(0 < n <= engine.flight.capacity, f"{n} batches fit the flight recorder's ring")
    return [ms for _, ms, _ in engine.flight.entries()[-n:]]


def device_split(fn, reps: int = 3) -> dict:
    """Where one call's time goes: its host-clock wall ms, torch.profiler's
    device-busy ms and device launches a call, the device's idle share of
    the wall time, and the ten largest device rows (ms a call, name)."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                            # steady state first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows, launches = [], 0
    for e in prof.key_averages():
        # device-side events only: an aten op's row repeats its kernels' time
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3 / reps, e.key))
            launches += e.count
    rows.sort(reverse=True)
    busy = sum(ms for ms, _ in rows)
    return {"wall_ms": wall_ms, "busy_ms": busy, "launches": launches / reps,
            "idle_share": max(0.0, 1 - busy / wall_ms) if rows else None,
            "top": [[ms, key[:90]] for ms, key in rows[:10]]}


def log_profile(tag, engine, batch) -> None:
    """Where one served batch's time goes: torch.profiler device time by
    operator, and the device's idle share of the batch's wall time."""
    split = device_split(lambda: engine.query_batch(batch))
    if not split["top"]:
        log(f"profile of one {tag} batch: the profiler recorded no device time")
        return
    log(f"profile of one {tag} batch: wall {split['wall_ms']:.3f} ms, device busy "
        f"{split['busy_ms']:.3f} ms, idle share {split['idle_share']:.3f}")
    for ms, key in split["top"]:
        log(f"  {ms:8.3f} ms  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-cards":
        return dist_cards_main(int(sys.argv[2]))
    if len(sys.argv) == 2 and sys.argv[1] == "--rerank-paths":
        return rerank_paths_main()
    from repro_torch.core import pipeline as pipe
    from repro_torch.core.baselines import recall
    from repro_torch.core.index import IndexConfig, probe_index
    from repro_torch.core.segments import _gid_map
    from repro_torch.data import ann_synthetic as ds
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_probe as kfp
    from repro_torch.core import walks
    from repro_torch.kernels import fused_rerank as kfr
    from repro_torch.kernels import l1_distance as kl1
    from repro_torch.kernels import rw_hash as krw
    from repro_torch.kernels import topk_merge as ktm
    from repro_torch.serve.engine import AnnServingEngine, ServeConfig
    from test_torch_cases import (KERNEL_RERANK_CASES, L1_CASES, L1_ROWS_CASES, MERGE_CASES,
                                  PROBE_CASES, RERANK_CASES, RW_HASH_CASES)

    t_start = time.perf_counter()
    card = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    # -- lint: the port's analysis gate, before any card phase ---------------
    lint = lint_phase()
    by_how = {}
    for ent in lint["sanctioned"]:
        key = f"{ent['rule']} {ent['how']}"
        by_how[key] = by_how.get(key, 0) + 1
    log(f"phase lint: python -m repro_torch.analysis --check --json exits 0 in "
        f"{lint['seconds']:.1f} s; {len(lint['findings'])} finding(s), all baselined; "
        f"sanctioned by rule and kind {json.dumps(dict(sorted(by_how.items())))}")

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.library(name)
    log(f"phase build: {time.perf_counter() - t0:.1f} s for {sorted(libs)}")
    for name, path in libs.items():
        lines = (path.parent / f"{name}.log").read_text().splitlines()
        regs = [ln.strip() for ln in lines if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in lines if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        log(f"  ptxas {name}: {' | '.join(regs)}; spills: {' | '.join(spills) or 'none'}")

    # -- kernels at adversarial shapes ---------------------------------------
    t0 = time.perf_counter()
    n_cases = 0
    for name, (keys, ids, pk, cap, cbucket) in sorted(PROBE_CASES.items()):
        tk = torch.from_numpy(keys.astype(np.int64)).to(card)
        tids = torch.from_numpy(ids).to(card)
        tpk = torch.from_numpy(pk.astype(np.int64)).to(card)
        occ = (torch.searchsorted(tk, tk, right=True)
               - torch.arange(tk.shape[1], device=card)).to(torch.int32)
        for occ_from in (None, occ):
            got, want = ops.probe_extents(tk, tpk, cap, occ_from), kfp.probe_extents(
                tk, tpk, cap, occ_from)
            check(all(equal(g, w) for g, w in zip(got, want)),
                  f"fused_probe extents kernel == plain on {name}")
            n_cases += 1
        lo, raw, _ = got
        for c in sorted({cap, 1, 3}):               # the full and tighter caps
            want = kfp.compact_gather(tids, lo, raw, pk.shape[2], cbucket, c)
            for occ_from in (None, occ):            # the one-pass route
                got = ops.fused_probe(tk, tids, tpk, c, cbucket, occ_from=occ_from)
                check(equal(got[0], want[0]) and equal(got[1], want[1]),
                      f"fused_probe one-pass kernels == plain on {name} cap={c}")
                n_cases += 1
            for slices in (None, 1, 2, 3, 7, 32):   # the served route's gather
                got = kfp.compact_gather_cuda(tids, lo, raw, pk.shape[2], cbucket, c,
                                              slices=slices)
                check(equal(got[0], want[0]) and equal(got[1], want[1]),
                      f"fused_probe gather kernel at {slices} slices == plain on {name} "
                      f"cap={c}")
                n_cases += 1
    for name, (data, queries, ids, k) in sorted(KERNEL_RERANK_CASES.items()):
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(card)
                for x in (data, queries, ids)]
        want = kfr.fused_rerank_plain(*args, k)
        got = ops.fused_rerank(*args, k)
        check(equal(got[0], want[0]) and equal(got[1], want[1]),
              f"fused_rerank kernel == plain on {name}")
        n_cases += 1
        for slices in (1, 2, 3, 7, 32):
            got = kfr.fused_rerank_cuda(*args, k, slices=slices)
            check(equal(got[0], want[0]) and equal(got[1], want[1]),
                  f"fused_rerank kernel at {slices} slices == plain on {name}")
            n_cases += 1
        n_rows = args[0].shape[0]
        for rows in sorted({1, 4, 64, 1 << max(n_rows - 1, 0).bit_length()}):
            if -(-n_rows // rows) > kfr.MAX_WINDOWS:
                continue
            got = kfr.fused_rerank_cuda(args[0], args[1], args[2].clone(), k, window_rows=rows)
            check(equal(got[0], want[0]) and equal(got[1], want[1]),
                  f"fused_rerank windowed kernel at {rows}-row windows == plain on {name}")
            n_cases += 1
    for name in sorted(set(RERANK_CASES) - set(KERNEL_RERANK_CASES)):
        data, queries, _, k = RERANK_CASES[name]    # a distance reaches BIG_DIST
        small = IndexConfig(num_tables=2, num_hashes=4, width=24, num_probes=8,
                            candidate_cap=8, universe=64, k=k, hash_impl="thermo")
        eng = AnnServingEngine(small, ServeConfig(batch_size=4, warm_buckets=False,
                                                  cand_cap_sample=2), data, device="cuda")
        try:
            eng.query_batch(queries)
        except ValueError as err:
            check("BIG_DIST" in str(err), f"the refusal of {name} names BIG_DIST")
        else:
            check(False, f"an index on the card refuses the queries of {name}")
        n_cases += 1
    for name, arrays in sorted(MERGE_CASES.items()):
        args = [torch.from_numpy(x).to(card) for x in arrays]
        got, want = ops.topk_merge(*args), ktm.topk_merge_plain(*args)
        check(equal(got[0], want[0]) and equal(got[1], want[1]),
              f"topk_merge kernel == plain on {name}")
        n_cases += 1
    for name, arrays in sorted(RW_HASH_CASES.items()):
        args = [torch.from_numpy(x).to(card) for x in arrays]
        want = krw.rw_hash_plain(*args)
        check(equal(krw.rw_prefix_table_cuda(args[0]),
                    krw.rw_prefix_table_plain(args[0], krw.padded_fns(args[0].shape[0]))),
              f"rw_hash table kernel == plain on {name}")
        check(equal(ops.rw_hash(*args), want), f"rw_hash kernel == plain on {name}")
        n_cases += 2
        for slices in (1, 2, 3, 7, args[0].shape[1]):
            check(equal(krw.rw_hash_cuda(*args, slices=slices), want),
                  f"rw_hash kernel at {slices} slices == plain on {name}")
            n_cases += 1
    # rw_hash beyond one shared-memory window: U2 above the one-pass limit
    # and 8,192, on in-range, odd, negative and above-universe coordinates
    span = krw.max_u2()
    rng = np.random.default_rng(21)
    for u2 in (span + 1, 8192):
        pairs = torch.from_numpy(
            (2 * rng.integers(0, 2, (37, 18, u2, 2)) - 1).sum(-1).astype(np.int8)).to(card)
        pts = torch.from_numpy(rng.integers(-40, 2 * u2 + 40, (600, 18)).astype(np.int32)).to(card)
        check(equal(krw.rw_prefix_table_cuda(pairs),
                    krw.rw_prefix_table_plain(pairs, krw.padded_fns(37))),
              f"rw_hash table kernel == plain at U2 {u2} (one-pass limit {span})")
        check(equal(ops.rw_hash(pairs, pts), krw.rw_hash_plain(pairs, pts)),
              f"rw_hash kernel == plain at U2 {u2} (one-pass limit {span})")
        n_cases += 2
    del pairs, pts
    for cases, kfns, pfn in (
            (L1_CASES, (ops.l1_distance,), kl1.l1_distance_plain),
            (L1_ROWS_CASES, (ops.l1_distance_rows,), kl1.l1_distance_rows_plain)):
        for name, (qs, xs, dtype) in sorted(cases.items()):
            args = [torch.from_numpy(x).to(card).to(getattr(torch, dtype)).contiguous()
                    for x in (qs, xs)]
            want = pfn(*args)
            for kfn in kfns:
                got = kfn(*args)
                check(got.dtype == want.dtype and equal(got, want),
                      f"{kfn.__name__} kernel == plain on {name}")
                n_cases += 1
    torch.cuda.synchronize()
    log(f"phase kernels: {n_cases} adversarial cases equal to plain, bit for bit, "
        f"{time.perf_counter() - t0:.1f} s")

    # -- data, width and ground truth ----------------------------------------
    t0 = time.perf_counter()
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

    (dbar, deleted, gt_i, gt_i0), gt_launches = run_path("ground_truth", ops, ground_truth)
    width = max(8, int(3.0 * math.sqrt(dbar)) & ~1)
    cfg = IndexConfig(num_tables=8, num_hashes=12, width=width, num_probes=200,
                      candidate_cap=128, universe=UNIVERSE, k=K, rerank_chunk=1024)
    gt_ids = gt_i.cpu().numpy()
    deleted_c = torch.from_numpy(deleted).to(card)
    log(f"phase data: {time.perf_counter() - t0:.1f} s; dbar {dbar:.1f} -> W {width}; "
        f"L 8 M 12 T 200 C 128 k {K} batch 64")

    # -- serve and serve_rw_hash: the same traffic through two engines --------
    serve_cfg = ServeConfig(batch_size=64, delta_cap=2048)

    def serve(run_cfg, tag, run_serve_cfg=serve_cfg):
        """build, insert, delete, drain, compact, drain; returns the engine
        and its phases (name, set-up s, batch ms, dists, gids)."""
        t0 = time.perf_counter()
        eng = AnnServingEngine(run_cfg, run_serve_cfg, data, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gids_new = eng.insert(inserted)
        check(list(gids_new[:2]) == [N_POINTS, N_POINTS + 1], "insert assigns fresh gids")
        check(eng.delete(deleted) == len(deleted), "delete tombstones every gid")
        check(eng.index.num_segments == 1 and eng.index.delta_fill > 0,
              "one segment plus a delta buffer: the fold runs topk_merge")
        out = []
        for name, setup_s in ((f"{tag}_delta", build_s), (f"{tag}_compacted", None)):
            if setup_s is None:
                t0 = time.perf_counter()
                eng.compact()
                setup_s = time.perf_counter() - t0
            rec0 = eng.flight.recorded
            eng.submit(queries)
            d, i = eng.drain()
            out.append((name, setup_s, batch_ms_since(eng, rec0), d, i))
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
    rest = [r for r in rw_rows if r < N_POINTS]
    rw_by_rows = {"build_and_compaction": len(rw_rows) - len(rest), "rest": len(rest),
                  "rest_max_rows": max(rest, default=0)}
    for (name, _, _, d, i), (rw_name, _, _, rd, ri) in zip(phases, rw_phases):
        check(np.array_equal(d, rd) and np.array_equal(i, ri),
              f"{rw_name} serves the (d, i) of {name}, bit for bit")
    for what in ("sorted_keys", "sorted_ids", "occ_from", "occ_hist"):
        check(equal(getattr(engine.index.segments[0].state, what),
                    getattr(rw_engine.index.segments[0].state, what)),
              f"hash_impl='pallas' builds the segment's {what} of 'gather'")
    log("phase serve_rw_hash: (d, i) of both drains and the compacted segment's "
        "tables equal the 'gather' engine's, bit for bit")

    def checks():
        big = pipe.BIG_DIST
        self_rows = torch.from_numpy(inserted_rows).to(card)
        for name, setup_s, lat, d, i in phases + rw_phases:
            r, hits = check_results(ops, kl1.l1_distance_rows_plain, name, d, i, q_c,
                                    points, deleted_c, self_rows, gt_ids, big, recall,
                                    exact_delta=name.endswith("_delta"))
            lat = np.asarray(lat)
            what = "build" if name.endswith("_delta") else "compact"
            log(f"phase {name}: {what} {setup_s:.2f} s, batches {lat.size}, "
                f"p50 {np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
                f"{N_QUERIES / (lat.sum() / 1e3):.1f} queries/s, recall@10 {r:.4f}, "
                f"self-hits {hits}/{inserted_rows.size}")

    _, check_launches = run_path("checks", ops, checks)

    # the two engines' batches alternately (ABBA), each timed on the host's
    # clock to the result on the host, as the drains time them
    order_ms = {"serve": [], "serve_rw_hash": []}
    for r in range(ORDER_ROUNDS):
        pair = [("serve", engine), ("serve_rw_hash", rw_engine)]
        for tag, eng in (pair if r % 2 == 0 else pair[::-1]):
            lo = (r * serve_cfg.batch_size) % N_QUERIES
            t0 = time.perf_counter()
            eng.query_batch(queries[lo:lo + serve_cfg.batch_size])
            order_ms[tag].append((time.perf_counter() - t0) * 1e3)
    for tag, lat in order_ms.items():
        log(f"phase order {tag}: {len(lat)} batches alternating (ABBA), "
            f"p50 {np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms")
    for tag, eng in (("serve", engine), ("serve_rw_hash", rw_engine)):
        log_profile(tag, eng, queries[:serve_cfg.batch_size])
    del rw_engine

    # -- host_syncs: the serve traffic under torch's sync debug mode ----------
    syncs, s_launches = host_syncs_phase(ops, cfg, serve_cfg, data, queries, inserted,
                                         deleted, lint["sanctioned"])
    for tag in ("gather", "pallas"):
        row = syncs[tag]
        log(f"phase host_syncs {tag}: {row['syncs_per_batch']:.2f} syncs a batch over "
            f"{row['batches']} batches {json.dumps(row['drain_sites'])}; compaction "
            f"{json.dumps(row['compact_sites'])}; sanctioned, not hit: "
            f"{json.dumps(row['sanctioned_not_hit'])}")
    log(f"phase host_syncs: {syncs['seconds']:.1f} s; torch.cuda.synchronize reported "
        f"as a sync: {syncs['synchronize_reported']}")
    log(json.dumps({"host_syncs": syncs}))

    # -- examples: the three ANN examples at their own sizes -----------------
    t0 = time.perf_counter()
    examples, e_launches = run_path("examples", ops, examples_phase)
    for name, row in examples.items():
        if name == "generate":
            log(f"phase examples generate: {row['seconds']:.1f} s, {row['arch']} "
                f"{row['shape']}, printed ... {json.dumps(row['printed_tail'])}")
            continue
        log(f"phase examples {name}: {row['seconds']:.1f} s (CPU {row['cpu_seconds']:.1f} s), "
            f"recall@10 {row['recall']}, "
            f"printed ... {json.dumps(row['printed_tail'])}")
    log(f"phase examples: {time.perf_counter() - t0:.1f} s")

    # -- lm: the language models; lm_retrieval: the model feeding the index --
    lm = lm_phase()
    for arch, row in lm["reduced"].items():
        log(f"phase lm {arch}: reduced() card == CPU, max abs err {row['max_abs_err']:.3g} "
            f"over {row['results']} results")
    full = lm["full"]
    log(f"phase lm {full['config']['name']} ({full['config']['params']} parameters, "
        f"B {LM_BATCH}, prompt {LM_PROMPT}, cache {LM_CACHE}): float32 decode vs forward "
        f"max abs err {full['f32']['decode_vs_forward_max_abs_err']:.4g}; bf16 prefill "
        f"{full['bf16']['prefill_ms']:.3f} ms, decode {full['bf16']['decode_ms_per_step']:.3f} "
        f"ms a step, {full['bf16']['tokens_per_s']:.0f} tokens/s, peak allocated "
        f"{full['bf16']['peak_allocated'] / 2**30:.3f} GiB above the phase's start; "
        f"{lm['seconds']:.1f} s "
        f"[{smi}]")
    lm["card"] = smi
    log(json.dumps({"lm": lm}))
    lm_rag, r_launches = lm_retrieval_phase(ops, (kfp, kfr, ktm, kl1, krw))
    log(f"phase lm_retrieval: {lm_rag['seconds']:.1f} s (CPU {lm_rag['cpu_seconds']:.1f} s), "
        f"hit rate {lm_rag['hit_rate']}, recall@5 {lm_rag['recall']}, embeddings vs CPU "
        f"{json.dumps(lm_rag['embedding_max_abs_err'])}")
    # -- train: language-model training (no kernel of the repo) ---------------
    train, tr_launches = run_path("train", ops, train_phase)
    for arch, row in train["reduced"].items():
        log(f"phase train {arch}: reduced() card == CPU, gradient within {row['grad_share']:.3g}"
            f" of max |g|, {TRAIN_REDUCED_STEPS} steps' losses and grad norms within "
            f"{row['curve_max_rel_err']:.3g}")
    full, ex = train["full"], train["example"]
    log(f"phase train {full['config']['name']} (bf16, remat, B {TRAIN_BATCH} x S {TRAIN_SEQ},"
        f" {TRAIN_STEPS} steps): {full['step_ms']:.3f} ms a step, "
        f"{full['tokens_per_s']:.0f} tokens/s, peak allocated "
        f"{full['peak_allocated'] / 2**30:.3f} GiB above the phase's start; gradient peaks "
        f"remat {full['grad_peak_above']['remat'] / 2**30:.3f} GiB, no remat "
        f"{full['grad_peak_above']['no_remat'] / 2**30:.3f} GiB; loss "
        f"{full['curve'][0][0]:.4f} -> {full['curve'][-1][0]:.4f}; profiled step wall "
        f"{full['profile']['wall_ms']:.1f} ms, device busy {full['profile']['busy_ms']:.2f} ms,"
        f" {full['profile']['launches']:.0f} launches, idle share "
        f"{full['profile']['idle_share']} [{smi}]")
    log(f"phase train example: {ex['last_line']}; resumed == straight within "
        f"{ex['resume_leaf_share']:.3g} (bit for bit: {ex['resume_bit_for_bit']}); "
        f"{train['seconds']:.1f} s")
    train["card"] = smi
    log(json.dumps({"train": train}))
    # -- shard: the dry-run's cells and a sharded forward (no kernel) ---------
    sh_more = {}
    shard, sh_launches = run_path("shard", ops, lambda: shard_phase(sh_more), more=sh_more)
    check(sum(sh_launches.values()) == 0,
          f"no kernel launched on the shard path ({json.dumps(sh_launches)})")
    for cell in shard["dryrun"]:
        log(f"phase shard dryrun {cell['arch']} {cell['shape']} {cell['mesh']}: flops "
            f"{cell['flops']:.4g}, bytes {cell['bytes']:.4g}, collectives "
            f"{json.dumps(cell['coll_breakdown'])}, peak {cell['peak_bytes_device']:.4g} B, "
            f"terms {cell['t_compute_s']:.4g} / {cell['t_memory_s']:.4g} / "
            f"{cell['t_collective_s']:.4g} s ({cell['bottleneck']})")
    rk = shard["ranks"]
    log(f"phase shard ranks ({rk['backend']} on {rk['devices']}, {rk['mesh']}): "
        f"{rk['config']['name']} float32 prefill within {max(rk['max_abs_err']):.3g} of the "
        f"unsharded card's (max |logit| {rk['max_abs_logit']:.4g}); {rk['seconds']:.1f} s; "
        f"phase {shard['seconds']:.1f} s [{smi}]")
    shard["card"] = smi
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
        f"warmup {summ['warmup_ms']:.0f} ms, skew {json.dumps(summ['skew']['segments'])}")

    # -- quality: the paper's protocol at the serving phases' size -------------
    quality, q_launches = quality_phase(
        ops, spec, data, ds.make_queries(spec, data, QUALITY_QUERIES), cfg,
        (kfp, kfr, ktm, kl1, krw))
    log(f"phase quality: {quality['seconds']:.1f} s (protocol "
        f"{quality['protocol_seconds']:.1f} s), {len(quality['records'])} records, "
        f"tables needed {json.dumps(quality['table_claim']['tables_needed'])}")
    log(json.dumps({"quality": quality}))

    # -- tuned: the recall-target engine, the serve phase's traffic ------------
    self_rows = torch.from_numpy(inserted_rows).to(card)

    def check_served(name, d, i, exact_delta):
        return check_results(ops, kl1.l1_distance_rows_plain, name, d, i, q_c, points,
                             deleted_c, self_rows, gt_ids, pipe.BIG_DIST, recall,
                             exact_delta)

    tuned, t_launches = tuned_phase(ops, (kfp, kfr, ktm, kl1, krw), serve, cfg, serve_cfg,
                                    data_c, queries, inserted, q_c, check_served)
    log(f"phase tuned: {tuned['seconds']:.1f} s (tuning {tuned['tune_seconds']:.1f} s, "
        f"plain re-run {tuned['plain_tune_seconds']:.1f} s), tuned "
        f"{json.dumps(tuned['tuned'])}, predicted {tuned['predicted_recall']:.4f}, "
        f"validated {tuned['validated_recall']:.4f}, met {tuned['met_target']}, "
        f"rounds {tuned['rounds']}")
    for name, row in tuned["served"].items():
        log(f"phase {name}: set-up {row['setup_s']:.2f} s, batches {row['batches']}, "
            f"p50 {row['p50_ms']:.3f} ms, p99 {row['p99_ms']:.3f} ms, "
            f"{row['queries_per_s']:.1f} queries/s, recall@10 {row['recall']:.4f}, "
            f"self-hits {row['self_hits']}/{inserted_rows.size}")
    log(f"tuned histogram p50/p99/p999 {json.dumps(tuned['histogram_ms'])} against exact "
        f"{json.dumps(tuned['exact_ms'])}; traced phase medians (ms) "
        f"{json.dumps(tuned['trace']['median_ms'])}")
    log(json.dumps({"tuned": tuned}))

    # -- walk_range: an out-of-range query and insert, card against CPU ------
    t0 = time.perf_counter()
    walk_range = walk_range_phase(cfg, data, inserted, queries)
    log(f"phase walk_range: {time.perf_counter() - t0:.1f} s; a batch with an "
        f"out-of-range query over {WALK_RANGE_ROWS} points (cut from {N_POINTS}), "
        f"before and after compacting an out-of-range insert: the card's (d, i) == "
        f"the CPU's; the bad query's rank-0 distances {walk_range['bad_query_rank0']}")

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

    cluster, c_launches = cluster_phase(ops, cfg, serve_cfg, data, queries, inserted,
                                        deleted, check_drain)
    for name, row in cluster["drains"].items():
        log(f"phase {name}: batches {row['batches']}, p50 {row['p50_ms']:.3f} ms, "
            f"p99 {row['p99_ms']:.3f} ms, first {row['first_ms']:.3f} ms, replica engines' "
            f"p50 {json.dumps(row['engine_p50_ms'])}, {row['queries_per_s']:.1f} queries/s, "
            f"recall@10 {row['recall']:.4f}, self-hits {row['self_hits']}/{inserted_rows.size}")
    log(f"phase cluster: {cluster['seconds']:.1f} s; one replica alone p50 "
        f"{cluster['one_replica_alone_p50_ms']:.3f} ms; start-up {cluster['startup_s']:.2f} s, "
        f"compact {cluster['compact_s']:.2f} s, recovery {cluster['recovery_s']:.2f} s "
        f"({json.dumps(cluster['recovery'])}), snapshots (s) "
        f"{json.dumps([round(x, 3) for x in cluster['snapshot_s']])}, router "
        f"{json.dumps(cluster['router'])}")
    # -- cluster_process: the same traffic over one worker process a replica --
    process, p_launches = cluster_process_phase(ops, cfg, serve_cfg, data, queries,
                                                inserted, deleted, check_drain)
    for name, row in process["drains"].items():
        log(f"phase {name}: batches {row['batches']}, p50 {row['p50_ms']:.3f} ms, "
            f"p99 {row['p99_ms']:.3f} ms, first {row['first_ms']:.3f} ms, worker engines' "
            f"p50 {json.dumps(row['engine_p50_ms'])}, {row['queries_per_s']:.1f} queries/s, "
            f"recall@10 {row['recall']:.4f}, self-hits {row['self_hits']}/{inserted_rows.size}")
    log(f"phase cluster_process: {process['seconds']:.1f} s; start-up "
        f"{process['startup_s']:.2f} s (worker boots, s: {json.dumps(process['boot_s'])}), "
        f"compact {process['compact_s']:.2f} s, recovery {process['recovery_s']:.2f} s "
        f"(respawned boot {process['recovered_boot_s']:.2f} s, "
        f"{json.dumps(process['recovery'])}), snapshots (s) "
        f"{json.dumps([round(x, 3) for x in process['snapshot_s']])}, router "
        f"{json.dumps(process['router'])}, wire {json.dumps(process['wire'])}")
    for a, b in (("cluster_compacted", "cluster_process_compacted"),
                 ("cluster_recovered", "cluster_process_recovered")):
        log(f"dispatch p50/p99 (ms) in this run: inproc {a} "
            f"{cluster['drains'][a]['p50_ms']:.3f}/{cluster['drains'][a]['p99_ms']:.3f}, "
            f"process {b} {process['drains'][b]['p50_ms']:.3f}/"
            f"{process['drains'][b]['p99_ms']:.3f}")
    oracle, o_launches = cluster_oracle_phase(ops, spec, data)
    log(f"phase cluster_oracle: {oracle['seconds']:.1f} s, {oracle['cut']}, matches "
        f"{oracle['cluster_matches_flat']}, after recovery "
        f"{oracle['cluster_recovery_matches_flat']}, oracle cap {oracle['cluster_oracle_cap']}; "
        + ", ".join(f"{t}: matches {oracle[t]['cluster_matches_flat']}, after recovery "
                    f"{oracle[t]['cluster_recovery_matches_flat']} in "
                    f"{oracle[t]['seconds']:.1f} s" for t in ("process", "tcp")))
    log(json.dumps({"cluster": {**cluster, "process": process, "oracle": oracle,
                                "walk_range": walk_range}}))

    # -- dist: the distributed index over rank processes on the card ---------
    dist, d_launches = dist_phase(ops, kl1.l1_distance_rows_plain, recall, cfg, data,
                                  queries, gt_i0.cpu().numpy())
    for name, row in dist["runs"].items():
        log(f"phase dist {name}: {row['shape']} {row['merge']} ({row['config']}), "
            f"query {row['query_ms']} ms (max over ranks, median of {DIST_REPS}), build "
            f"{json.dumps([round(x, 3) for x in row['build_s']])} s, sent "
            f"{json.dumps(row['sent_bytes'])} B, recall@10 {row['recall_at_10']}")
    log(f"phase dist: {dist['seconds']:.1f} s; rank boots (s) "
        f"{json.dumps([round(x, 2) for x in dist['boot_s']])}, CPU ranks "
        f"{dist['cpu_ranks_s']:.1f} s, checks {dist['checks_s']:.1f} s")
    log(json.dumps({"dist": dist}))

    # -- one served batch: kernels against plain, and their times -------------
    idx = engine.index
    idx.insert(inserted[:N_INSERT // 2])     # a delta again, for the fold
    batch = q_c[:serve_cfg.batch_size].contiguous()
    seg = idx.segments[0]
    st = seg.state
    idx._ensure_caps(seg)
    pk, lo, occ, counts = probe_index(cfg, st, batch)
    cb, c_cap, _ = pipe.pick_rung(int(counts.max()), seg.ctot_cap,
                                  serve_cfg.cand_bucket_min, seg.ctot_norm,
                                  seg.c_norm, serve_cfg.cand_overflow)
    cap = cfg.candidate_cap if c_cap is None else min(cfg.candidate_cap, c_cap)
    p = cfg.probes_per_table
    tomb = idx._tombstone_array()
    ext_k = lambda: kfp.probe_extents_cuda(st.sorted_keys, pk, cfg.candidate_cap, st.occ_from)
    ext_p = lambda: kfp.probe_extents(st.sorted_keys, pk, cfg.candidate_cap, st.occ_from)
    ext_got, ext_want = ext_k(), ext_p()
    check(all(equal(a, b) for a, b in zip(ext_got, ext_want)) and equal(ext_got[0], lo),
          "fused_probe extents kernel == plain on the served batch")
    gat_k = lambda: kfp.compact_gather_cuda(st.sorted_ids, lo, occ, p, cb, cap)
    gat_p = lambda: kfp.compact_gather(st.sorted_ids, lo, occ, p, cb, cap)
    got, want = gat_k(), gat_p()
    check(equal(got[0], want[0]) and equal(got[1], want[1]),
          "fused_probe gather kernel == plain on the served batch")
    probe_k = lambda: kfp.fused_probe_cuda(st.sorted_keys, st.sorted_ids, pk, cap, cb,
                                           occ_from=st.occ_from)
    probe_p = lambda: kfp.fused_probe_plain(st.sorted_keys, st.sorted_ids, pk, cap, cb,
                                            occ_from=st.occ_from)
    one_got = probe_k()
    check(all(equal(a, b) for a, b in zip(one_got, want)),
          "fused_probe one-pass kernels == plain on the served batch")
    # the library yardstick: the staged probe at the same cap, two
    # torch.searchsorted calls a table and a gather of the (Q, L*P*C) slab
    staged_cfg = dataclasses.replace(cfg, candidate_cap=cap, probe_impl="staged")
    n_rows = st.dataset.shape[0]
    look = lambda: pipe.stage_bucket_lookup(st.sorted_keys, pk)
    s_lo, s_hi = look()
    check(equal(s_lo.reshape(lo.shape), lo) and equal((s_hi - s_lo).reshape(occ.shape), occ),
          "the staged lookup's extents == the extents kernel's on the served batch")
    sgat = lambda: pipe.stage_candidate_gather(staged_cfg, st.sorted_ids, s_lo, s_hi, n_rows)
    staged_lib = lambda: pipe.stage_candidate_gather(staged_cfg, st.sorted_ids, *look(), n_rows)
    slab = sgat()
    front = torch.sort((slab == n_rows).to(torch.int8), dim=1, stable=True).indices
    check(equal(torch.gather(slab, 1, front)[:, :cb], got[0]),
          "the staged slab's valid candidates == the gather's, in order")
    del slab, front
    gat_slices = kfr.plan_slices(pk.shape[0], cb, kfp.gather_resident_blocks(
        torch.cuda.current_device(), lo.shape[1]))
    ids = pipe.stage_tombstone(got[0], seg.gids, tomb, st.dataset.shape[0])
    # the windowed path reorders ids in place (same answer, same work): the
    # plain version, and the sliced path's timings, take a copy in the
    # gather's order, as served
    ids_fresh = ids.clone()
    rr_k = lambda: kfr.fused_rerank_cuda(st.dataset, batch, ids, K)
    rr_p = lambda: kfr.fused_rerank_plain(st.dataset, batch, ids_fresh, K,
                                          chunk=cfg.rerank_chunk)
    _build.take_path("fused_rerank")
    sd, si = rr_k()
    rr_path = _build.take_path("fused_rerank")
    wd, wi = rr_p()
    check(equal(sd, wd) and equal(si, wi), "fused_rerank kernel == plain on the served batch")
    in_rows = lambda x: torch.sort(torch.where((x >= 0) & (x < st.dataset.shape[0]), x, -1),
                                   dim=1).values
    check(equal(in_rows(ids), in_rows(ids_fresh)),
          f"fused_rerank's {rr_path[0]} path keeps each row's valid ids on the served batch")
    rr_slices = kfr.plan_slices(ids.shape[0], ids.shape[1], kfr.resident_blocks(
        torch.cuda.current_device(), st.dataset.dtype, DIM, K,
        int(st.dataset.data_ptr() % 16 == 0)))
    delta_pts, delta_gids = idx._delta_arrays()
    cap_d = delta_pts.shape[0]
    slots = torch.arange(cap_d, dtype=torch.int32, device=card)
    dids = torch.where(slots < idx._delta_count, slots, cap_d).expand(
        batch.shape[0], cap_d).contiguous()
    dids = pipe.stage_tombstone(dids, delta_gids, tomb, cap_d)
    dd, di = kfr.fused_rerank_cuda(delta_pts, batch, dids, K)
    pd, pi = kfr.fused_rerank_plain(delta_pts, batch, dids, K)
    check(equal(dd, pd) and equal(di, pi), "fused_rerank kernel == plain on the delta scan")
    da, ia = sd, _gid_map(si, seg.gids, st.dataset.shape[0])
    db, ib = dd, _gid_map(di, delta_gids, cap_d)
    tm_k = lambda: ktm.topk_merge_cuda(da, ia, db, ib)
    tm_p = lambda: ktm.topk_merge_plain(da, ia, db, ib)
    mk, mp = tm_k(), tm_p()
    check(equal(mk[0], mp[0]) and equal(mk[1], mp[1]), "topk_merge kernel == plain")
    packed = torch.cat([(da.long() << 32) | (ia.long() & 0xFFFFFFFF),
                        (db.long() << 32) | (ib.long() & 0xFFFFFFFF)], dim=1)
    tm_lib = lambda: torch.topk(packed, K, dim=1, largest=False)

    # bounds from this batch's inputs: each input byte read once, each output
    # byte written once; the rerank reads each distinct candidate row once.
    q_rows, lp = pk.shape[0], pk.shape[1] * pk.shape[2]
    gathered = int(torch.minimum(got[1], torch.tensor(cb, device=card)).sum())
    # the one-pass route, counted as for the single-launch design: each
    # probe key, the key and the run length at its lower bound, the
    # gathered ids, the output row
    probe_bytes = q_rows * lp * (8 + 8 + 4) + gathered * 4 + q_rows * (cb + 1) * 4
    probe_ops = q_rows * lp * math.ceil(math.log2(max(2, st.dataset.shape[0])))
    # extents: those reads, lo and occ written; gather: lo and occ read
    ext_bytes = q_rows * lp * (8 + 8 + 4 + 4 + 4) + q_rows * 4
    gat_bytes = q_rows * lp * (4 + 4) + gathered * 4 + q_rows * (cb + 1) * 4
    valid = ids_fresh[(ids_fresh >= 0) & (ids_fresh < st.dataset.shape[0])]
    uniq_rows = int(torch.unique(valid).numel())
    pairs = sum(int(torch.unique(r[(r >= 0) & (r < st.dataset.shape[0])]).numel())
                for r in ids_fresh)
    rr_bytes = (ids_fresh.numel() * 4 + uniq_rows * DIM * st.dataset.element_size()
                + batch.numel() * 4 + 2 * q_rows * K * 4)
    rr_ops = pairs * DIM * 3
    # the per-pair bound: each valid (query, slot) row read once, as a kernel
    # that does not invert the candidates across the batch must
    n_slots = valid.numel()
    rr_pair_bytes = rr_bytes + (n_slots - uniq_rows) * DIM * st.dataset.element_size()
    rr_pair_ops = n_slots * DIM * 3
    tm_bytes = 6 * q_rows * K * 4
    tm_ops = q_rows * 2 * K * math.ceil(math.log2(2 * K))

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def timed(kfn, pfn, lib, nbytes, nops, errs, what=""):
        """The measured numbers of one kernel row; kernel == plain already
        held.  A reading under the row's bound is a measurement fault to
        explain: it is logged and the row says ``below_bound``."""
        b_ms, b_by = bound(nbytes, nops)
        # event times first, the kernel and the library call in turns; the
        # amortised time; the profiler's device times after them
        ms, lib_ms = (cuda_ms(kfn), None) if lib is None else cuda_ms_pair(kfn, lib)
        row = {"max_abs_err": max_abs_err(errs), "ms": ms,
               "amortised_ms": amortised_ms(kfn),
               "plain_ms": cuda_ms(pfn, reps=5), "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms}
        row["device_ms"], row["device_events_per_call"] = device_profile(kfn)
        row["library_device_ms"] = None if lib is None else device_ms(lib)
        below = [k for k in ("ms", "amortised_ms", "device_ms") if row[k] < b_ms]
        row["below_bound"] = bool(below)
        if below:
            log(f"below the bound {what}: {', '.join(f'{k} {row[k]:.6f}' for k in below)} "
                f"< bound_ms {b_ms:.6f} ({b_by}); device events a call "
                f"{row['device_events_per_call']}")
        return row

    rows = []
    for name, kfn, pfn, lib, nbytes, nops, errs, src, repl in [
        ("fused_probe", probe_k, probe_p, staged_lib, probe_bytes, probe_ops,
         [(one_got[0], want[0]), (one_got[1], want[1])], "fused_probe.cu",
         "src/repro/kernels/fused_probe.py:158"),
        ("fused_rerank", rr_k, rr_p, None, rr_bytes, rr_ops,
         [(sd, wd), (si, wi)], "fused_rerank.cu",
         "src/repro/kernels/fused_rerank.py:140"),
        ("topk_merge", tm_k, tm_p, tm_lib, tm_bytes, tm_ops,
         [(mk[0], mp[0]), (mk[1], mp[1])], "topk_merge.cu",
         "src/repro/kernels/topk_merge.py:122"),
    ]:
        rows.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
            "replaces": repl, "equal_to_plain": True,
            "launches": sum(launches[k] for k in PROBE) if name == "fused_probe" else
            launches[name], **timed(kfn, pfn, lib, nbytes, nops, errs, name)})
    # the probe's row holds the one-pass route (the extents, then the
    # gather) and, apart, its two launches: the served route runs the
    # extents in phase A and the gather alone in phase B
    for key, kfn, pfn, lib, nbytes, nops, errs in [
            ("extents", ext_k, ext_p, look, ext_bytes, probe_ops,
             list(zip(ext_got, ext_want))),
            ("gather", gat_k, gat_p, sgat, gat_bytes, q_rows * lp,
             [(got[0], want[0]), (got[1], want[1])])]:
        rows[0][key] = {"launches": launches[f"fused_probe_{key}"],
                        **timed(kfn, pfn, lib, nbytes, nops, errs, f"fused_probe {key}")}
    rows[0]["gather"]["slices"] = gat_slices
    rows[1]["pair_bound_ms"] = bound(rr_pair_bytes, rr_pair_ops)[0]
    rows[1]["slices"] = rr_slices
    rows[1]["path"], rows[1]["windows"] = rr_path
    rows[1]["ms_by_slices"] = {
        s: cuda_ms(lambda: kfr.fused_rerank_cuda(st.dataset, batch, ids_fresh, K, slices=s))
        for s in (rr_slices, 4, 8, 12, 16, 24, 32)}
    rows[1]["delta_scan_ms"] = cuda_ms(lambda: kfr.fused_rerank_cuda(delta_pts, batch, dids, K))
    rows[1]["delta_scan_device_ms"] = device_ms(
        lambda: kfr.fused_rerank_cuda(delta_pts, batch, dids, K))
    log(f"phase batch: Q {q_rows}, rung cbucket {cb} c_cap {c_cap}, gathered "
        f"{gathered}, valid slots {n_slots}, distinct rows {uniq_rows}, delta rows "
        f"{idx._delta_count}, rerank slices {rr_slices}, gather slices {gat_slices}")

    # rw_hash at the build's shape (every point) and at one served batch;
    # plain on a subset, the prefix-gather hash on every point; the table
    # kernel alone
    walk_tab = idx.params.walks
    wp = walk_tab.pairs
    n_fns, _, u2 = wp.shape
    n_pts = data_c.shape[0]
    fp = krw.padded_fns(n_fns)
    rw_k = lambda: krw.rw_hash_cuda(wp, data_c)
    rw_p = lambda: krw.rw_hash_plain(wp, data_c[:RW_PLAIN_ROWS])
    rw_out, rw_plain = rw_k(), rw_p()
    check(equal(rw_out, walks.eval_prefix(walk_tab, data_c)),
          "rw_hash kernel == eval_prefix on every point")
    check(equal(rw_out[:RW_PLAIN_ROWS], rw_plain),
          f"rw_hash kernel == plain on {RW_PLAIN_ROWS} rows")
    tab_k = lambda: krw.rw_prefix_table_cuda(wp)
    tab_p = lambda: krw.rw_prefix_table_plain(wp, fp)
    tab_got, tab_want = tab_k(), tab_p()
    check(equal(tab_got, tab_want), "rw_hash table kernel == plain at the served steps")
    rw_bk = lambda: krw.rw_hash_cuda(wp, batch)
    rw_bp = lambda: krw.rw_hash_plain(wp, batch)
    rw_batch, rw_batch_plain = rw_bk(), rw_bp()
    check(equal(rw_batch, rw_batch_plain), "rw_hash kernel == plain on the served batch")
    rw_row = timed(rw_k, rw_p, None, n_pts * DIM * 4 + wp.numel() + n_pts * n_fns * 4,
                   n_pts * n_fns * DIM, [(rw_out[:RW_PLAIN_ROWS], rw_plain)], "rw_hash")
    rw_batch_row = timed(rw_bk, rw_bp, None, batch.numel() * 4 + wp.numel()
                         + batch.shape[0] * n_fns * 4, batch.shape[0] * n_fns * DIM,
                         [(rw_batch, rw_batch_plain)], "rw_hash batch")
    # the table: the steps read once, the table written once, an add a step
    tab_row = timed(tab_k, tab_p, None, wp.numel() + tab_want.numel() * 4, wp.numel(),
                    [(tab_got, tab_want)], "rw_hash table")
    resident = krw.resident_blocks(torch.cuda.current_device(), u2)
    rows.append({
        "name": "rw_hash", "route": "cuda", "source": "src/repro_torch/csrc/rw_hash.cu",
        "replaces": "src/repro/kernels/rw_hash.py:55",
        "launches": rw_launches["rw_hash"], "launches_by_rows": rw_by_rows,
        "equal_to_plain": True, **rw_row, "rows": n_pts, "plain_rows": RW_PLAIN_ROWS,
        "gather_ms": cuda_ms(lambda: walks.eval_prefix(walk_tab, data_c), reps=5),
        "thermo_int8_mma_bound_ms": 2 * n_pts * n_fns * DIM * u2 / INT8_TENSOR_OPS_PER_S * 1e3,
        "resident_blocks": resident,
        "slices": krw.plan_rw_hash(n_pts, n_fns, DIM, resident),
        "batch_rows": batch.shape[0],
        "batch_slices": krw.plan_rw_hash(batch.shape[0], n_fns, DIM, resident),
        **{f"batch_{k}": v for k, v in rw_batch_row.items() if not k.startswith("library")},
        "table": {"launches": rw_launches["rw_prefix_table"], "shape": list(tab_want.shape),
                  **tab_row}})
    del rw_out, rw_plain, tab_got, tab_want
    # the windowed passes (U2 above the one-pass limit; no dataset spec
    # reaches it): 96 functions x 128 dimensions at U2 8,192, a served batch
    # and 65,536 rows of the points, plain on the batch and 1,024 rows
    wide_u2 = 8192
    gen_w = np.random.default_rng(23)
    wpairs = torch.from_numpy((2 * gen_w.integers(0, 2, (n_fns, DIM, wide_u2, 2), dtype=np.int8)
                               - 1).sum(-1, dtype=np.int8)).to(card)
    w_span, w_win = krw.plan_rw_windows(wide_u2, krw.max_u2())
    windowed = {"u2": wide_u2, "span": w_span, "windows": w_win}
    for rows_w in (batch.shape[0], 65_536):
        wpts = data_c[:rows_w] * (wide_u2 // (UNIVERSE // 2))   # spread over [0, 2 U2]
        wk = lambda: krw.rw_hash_cuda(wpairs, wpts)
        plain_rows = min(rows_w, 1024)
        wp = lambda: krw.rw_hash_plain(wpairs, wpts[:plain_rows])
        w_out, w_plain = wk(), wp()
        check(equal(w_out[:plain_rows], w_plain),
              f"rw_hash kernel == plain at U2 {wide_u2} on {plain_rows} of {rows_w} rows")
        windowed[f"rows_{rows_w}"] = {
            "plain_rows": plain_rows,
            **timed(wk, wp, None, rows_w * DIM * 4 + wpairs.numel() + rows_w * n_fns * 4,
                    rows_w * n_fns * DIM, [(w_out[:plain_rows], w_plain)],
                    f"rw_hash windowed {rows_w} rows")}
    rows[-1]["windowed"] = windowed
    del wpairs, wpts, w_out, w_plain

    # l1_distance at the ground truth's shape: one batch against every point;
    # then the same shape with every coordinate
    # drawn in +-2^30 (every stage of every block runs the int32 loop), and
    # in int16
    l1_k = lambda: kl1.l1_distance_cuda(batch, data_c)
    l1_p = lambda: kl1.l1_distance_plain(batch, data_c)
    l1_out, l1_plain = l1_k(), l1_p()
    check(equal(l1_out, l1_plain), "l1_distance kernel == plain at 64 x 1 M x 128")
    qf, xf = batch.to(torch.float32), data_c.to(torch.float32)
    l1_lib = lambda: torch.cdist(qf, xf, p=1)
    check(equal(l1_lib().to(torch.int32), l1_out), "torch.cdist(p=1) agrees (exact)")
    l1_updates = batch.shape[0] * n_pts * DIM
    l1_row = timed(l1_k, l1_p, l1_lib, batch.numel() * 4 + data_c.numel() * 4
                   + batch.shape[0] * n_pts * 4, l1_updates * 3, [(l1_out, l1_plain)],
                   "l1_distance")
    del l1_out, l1_plain, xf
    gen = torch.Generator(device=card).manual_seed(18)
    wq, wx = (torch.randint(-2 ** 30, 2 ** 30, t.shape, generator=gen, device=card,
                            dtype=torch.int32) for t in (batch, data_c))
    w_k = lambda: kl1.l1_distance_cuda(wq, wx)
    w_out, w_plain = w_k(), kl1.l1_distance_plain(wq, wx)
    check(equal(w_out, w_plain), "l1_distance kernel == plain on the wide input (int32 loop)")
    l1_row.update(wide_max_abs_err=max_abs_err([(w_out, w_plain)]), wide_ms=cuda_ms(w_k),
                  wide_amortised_ms=amortised_ms(w_k), wide_device_ms=device_ms(w_k))
    del w_out, w_plain, wq, wx
    hq, hx = batch.to(torch.int16), data_c.to(torch.int16)
    h_k = lambda: kl1.l1_distance_cuda(hq, hx)
    h_out, h_plain = h_k(), kl1.l1_distance_plain(hq, hx)
    check(equal(h_out, h_plain), "l1_distance kernel == plain in int16 at 64 x 1 M x 128")
    l1_row.update(int16_max_abs_err=max_abs_err([(h_out, h_plain)]), int16_ms=cuda_ms(h_k),
                  int16_amortised_ms=amortised_ms(h_k), int16_device_ms=device_ms(h_k))
    del h_out, h_plain, hq, hx
    # instruction issue floor: the inner loops' SASS instructions per update
    # x updates / lane-instructions a second
    # at the highest SM clock the card reports in this run
    issue_clock_hz = float(nvidia_smi_line("clocks.max.sm").split()[0]) * 1e6
    issue_rate = torch.cuda.get_device_properties(0).multi_processor_count \
        * LANES_PER_SM_CLOCK * issue_clock_hz
    lib = libs["l1_distance"]
    per_lds128 = lambda op: 32 / 3 if ".128" in op else 0   # 3 LDS.128: 32 updates
    sass = {"float32_loop_int32_input": None, "int32_loop": None,
            "float32_loop_int16_input": None}
    found = sass_loops(lib, "l1_pairwise_kernelIiE", per_lds128)
    if found is None:
        log("l1_distance SASS: cuobjdump is not on this machine; no issue floor")
    else:
        for loop in found:
            sass["float32_loop_int32_input" if loop["fadd"] else "int32_loop"] = loop
        sass["float32_loop_int16_input"] = next(iter(
            sass_loops(lib, "l1_pairwise_kernelIsE", per_lds128)), None)
        log(f"l1_distance SASS inner loops: {json.dumps(sass)}")
    floor = lambda key: None if sass[key] is None else \
        sass[key]["per_update"] * l1_updates / issue_rate * 1e3
    rows.append({
        "name": "l1_distance", "route": "cuda",
        "source": "src/repro_torch/csrc/l1_distance.cu",
        "replaces": "src/repro/kernels/l1_distance.py:59",
        "launches": gt_launches["l1_distance"], "equal_to_plain": True, **l1_row,
        "updates": l1_updates, "sass": sass, "issue_clock_ghz": issue_clock_hz / 1e9,
        "issue_lane_rate": issue_rate, "issue_floor_ms": floor("float32_loop_int32_input"),
        "wide_issue_floor_ms": floor("int32_loop"),
        "int16_issue_floor_ms": floor("float32_loop_int16_input"),
        "sm_clocks_max_now": nvidia_smi_line("clocks.max.sm,clocks.sm")})

    # l1_distance_rows at one served batch's first 4,096 candidates a query
    # (int32 and int16: the rows exceed the L2 cache) and at SRS's shape
    # (QUALITY_QUERIES queries x its 512-row chunk, int32).  At each shape the
    # kernel equals its plain version in all four input types through the
    # vector path; SRS's rows one element into their storage (not 16-byte
    # aligned) take the scalar path.  ``launch_amortised_ms`` times the C
    # entry point alone (plan and output made once): no wrapper host work.
    def rows_path(qd, rd):
        before = dict(kl1.ROWS_PATHS)
        got = kl1.l1_distance_rows_cuda(qd, rd)
        path = [k for k, v in kl1.ROWS_PATHS.items() if v != before[k]]
        check(len(path) == 1, "one l1_distance_rows launch, on one path")
        return got, path[0]

    def rows_launch_only(qd, rd, want):
        q_n, c_n, m_n = rd.shape
        plan = kl1.plan_rows(qd.dtype, m_n, c_n, q_n, rd.data_ptr(), qd.data_ptr())
        out = torch.empty((q_n, c_n), dtype=want.dtype, device=card)
        args = (qd.data_ptr(), rd.data_ptr(), out.data_ptr(), q_n, c_n, m_n, plan.slots,
                plan.seg, plan.tile, plan.stage, torch.cuda.current_stream().cuda_stream)
        fn = kl1._fn("rows", qd.dtype)
        ms = amortised_ms(lambda: fn(*args))
        check(fn(*args) == 0 and equal(out, want),
              "l1_distance_rows C entry point == plain after its timed launches")
        return ms

    def rows_timed(qd, rd, what, path):
        got, took = rows_path(qd, rd)
        want = kl1.l1_distance_rows_plain(qd, rd)
        check(equal(got, want) and took == path,
              f"l1_distance_rows kernel == plain {what}, on the {path} path (took {took})")
        qf_r, rf_r = qd.to(torch.float32), rd.to(torch.float32)
        lib_r = lambda: torch.cdist(qf_r[:, None], rf_r, p=1)
        check(equal(lib_r()[:, 0].to(got.dtype), got), f"batched cdist agrees {what} (exact)")
        return {"shape": list(rd.shape), "path": took,
                **timed(lambda: kl1.l1_distance_rows_cuda(qd, rd),
                        lambda: kl1.l1_distance_rows_plain(qd, rd), lib_r,
                        rd.numel() * rd.element_size() + qd.numel() * qd.element_size()
                        + got.numel() * 4, rd.numel() * 3, [(got, want)],
                        f"l1_distance_rows {what}"),
                "launch_amortised_ms": rows_launch_only(qd, rd, want)}

    cand = ids[:, :4096].clamp(0, st.dataset.shape[0] - 1).long()
    srs_cand = torch.randint(0, st.dataset.shape[0], (QUALITY_QUERIES, SRS_ROWS_CHUNK),
                             generator=torch.Generator(device=card).manual_seed(28),
                             device=card)
    rows_at = {"served": (batch, st.dataset[cand]),
               "srs": (q_c[:QUALITY_QUERIES].contiguous(), st.dataset[srs_cand])}
    for qd, rd in rows_at.values():
        for dtype in (torch.int32, torch.int16, torch.float32, torch.bfloat16):
            qt, rt = qd.to(dtype), rd.to(dtype).contiguous()
            got, took = rows_path(qt, rt)
            check(equal(got, kl1.l1_distance_rows_plain(qt, rt)) and took == "vector",
                  f"l1_distance_rows kernel == plain in {dtype} at {list(rt.shape)}, "
                  f"on the vector path (took {took})")
    del qt, rt, got
    l1r = {dtype: rows_timed(batch.to(dtype), rows_at["served"][1].to(dtype).contiguous(),
                             f"in {dtype} at the served batch", "vector")
           for dtype in (torch.int32, torch.int16)}
    qs_srs, rs_srs = (t.to(torch.int32).contiguous() for t in rows_at["srs"])
    srs_row = rows_timed(qs_srs, rs_srs, "at SRS's shape", "vector")
    flat = torch.empty(rs_srs.numel() + 1, dtype=torch.int32, device=card)
    mis = flat[1:].view(rs_srs.shape).copy_(rs_srs)
    mis_row = rows_timed(qs_srs, mis, "at SRS's shape one element into its storage",
                         "scalar")
    del rows_at, flat, mis, qs_srs, rs_srs
    rows.append({
        "name": "l1_distance_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/l1_distance.cu",
        "replaces": "src/repro/kernels/l1_distance.py:103",
        "launches": check_launches["l1_distance_rows"], "equal_to_plain": True,
        **l1r[torch.int32], "int16": l1r[torch.int16], "srs": srs_row,
        "misaligned": mis_row})
    for path, counts in (("quality", q_launches), ("tuned", t_launches),
                         ("cluster", c_launches), ("cluster_process", p_launches),
                         *o_launches.items(), ("dist", d_launches), *s_launches.items(),
                         ("examples", e_launches), ("lm_retrieval", r_launches),
                         ("train", tr_launches), ("shard", sh_launches)):
        for row in rows:
            row[f"{path}_launches"] = (sum(counts[k] for k in PROBE)
                                       if row["name"] == "fused_probe" else counts[row["name"]])
        for key in ("extents", "gather"):
            rows[0][key][f"{path}_launches"] = counts[f"fused_probe_{key}"]
        next(r for r in rows if r["name"] == "rw_hash")["table"][f"{path}_launches"] = \
            counts["rw_prefix_table"]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"device times from CUDA events, the profiler having recorded nothing: "
        f"{len(DEVICE_MS_FROM_EVENTS)} {DEVICE_MS_FROM_EVENTS}")
    log(json.dumps({"kernels": rows}))
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
