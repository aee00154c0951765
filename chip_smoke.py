#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: serve a SIFT1M-shaped segmented
MP-RW-LSH index on one NVIDIA card through the port's own entry points, and
hold every CUDA kernel of that path against its plain-torch version.

  python3 chip_smoke.py          # from the repository root; needs one card

Phases:
  build    compile csrc/*.cu with nvcc (sm_90a), one process per source;
  kernels  each kernel against its plain version at small adversarial shapes
           (ties, duplicate ids, uint32 extremes, truncating buckets, tighter
           caps, n in {0, 1}, Ctot < k, int16), bit for bit;
  serve    the main path with launch counters zeroed just before it: build
           the engine on the card, insert 512 points, delete 64 gids, drain
           1024 queries, compact, drain again — every result checked against
           exact L1 ground truth;
  batch    the kernels against their plain versions on the tensors of one
           served batch, and their times (CUDA events) beside the least time
           the card could take (bytes over 3.35 TB/s, or integer operations
           over 67 T/s, the larger).

Prints one ``{"kernels": [...]}`` line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the exit code is not 0.  Exits 2 with no result when no card is present
or the port's sources are missing.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12     # the data sheet's 32-bit non-tensor rate
N_POINTS, DIM, UNIVERSE = 1_000_000, 128, 510
N_QUERIES, N_INSERT, N_DELETE, K = 1024, 512, 64, 10


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


def cuda_ms(fn, reps: int = 20, warm: int = 2) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Ground truth (a yardstick of this script only, never called by the port):
# float32 cdist is exact here, every partial sum is an integer below 2^24.
# --------------------------------------------------------------------------

def exact_knn(points: torch.Tensor, queries: torch.Tensor, k: int,
              dead: torch.Tensor = None, chunk: int = 250_000):
    best_d = best_i = None
    qf = queries.to(torch.float32)
    for lo in range(0, points.shape[0], chunk):
        d = torch.cdist(qf, points[lo:lo + chunk].to(torch.float32), p=1)
        if dead is not None:
            d[:, dead[lo:lo + chunk]] = float("inf")
        cd, ci = torch.topk(d, k, dim=1, largest=False)
        ci = ci + lo
        if best_d is not None:
            cd, sel = torch.topk(torch.cat([best_d, cd], 1), k, dim=1, largest=False)
            ci = torch.gather(torch.cat([best_i, ci], 1), 1, sel)
        best_d, best_i = cd, ci
    return best_d, best_i


def check_results(phase, d, i, queries, points, deleted, inserted_rows, gt_ids,
                  big, recall_fn, exact_delta):
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
    exact = (rows - queries[:, None, :]).abs().sum(-1, dtype=torch.int32)
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


def log_profile(engine, batch) -> None:
    """Where one served batch's time goes: torch.profiler device time by
    operator, and the device's idle share of the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile
    engine.query_batch(batch)                       # steady state first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            engine.query_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    rows = []
    for e in prof.key_averages():
        # device-side events only: an aten op's row repeats its kernels' time
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3 / 3, e.key))
    rows.sort(reverse=True)
    if not rows:
        log("profile of one served batch: the profiler recorded no device time")
        return
    busy = sum(ms for ms, _ in rows)
    log(f"profile of one served batch: wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for ms, key in rows[:10]:
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
    from repro_torch.core import pipeline as pipe
    from repro_torch.core.baselines import recall
    from repro_torch.core.index import IndexConfig, probe_index
    from repro_torch.core.segments import _gid_map
    from repro_torch.data import ann_synthetic as ds
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_probe as kfp
    from repro_torch.kernels import fused_rerank as kfr
    from repro_torch.kernels import topk_merge as ktm
    from repro_torch.serve.engine import AnnServingEngine, ServeConfig
    from test_torch_cases import MERGE_CASES, PROBE_CASES, RERANK_CASES

    t_start = time.perf_counter()
    card = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.library(name)
    log(f"phase build: {time.perf_counter() - t0:.1f} s for {sorted(libs)}")
    for name, path in libs.items():
        regs = [ln.strip() for ln in (path.parent / f"{name}.log").read_text().splitlines()
                if "Used" in ln and "registers" in ln]
        log(f"  ptxas {name}: {' | '.join(regs)}")

    # -- kernels at adversarial shapes ---------------------------------------
    t0 = time.perf_counter()
    n_cases = 0
    for name, (keys, ids, pk, cap, cbucket) in sorted(PROBE_CASES.items()):
        tk = torch.from_numpy(keys.astype(np.int64)).to(card)
        tids = torch.from_numpy(ids).to(card)
        tpk = torch.from_numpy(pk.astype(np.int64)).to(card)
        occ = (torch.searchsorted(tk, tk, right=True)
               - torch.arange(tk.shape[1], device=card)).to(torch.int32)
        lo, raw, _ = kfp.probe_extents(tk, tpk, cap, occ)
        for c in sorted({cap, 1, 3}):               # the full and tighter caps
            want = kfp.compact_gather(tids, lo, raw, pk.shape[2], cbucket, c)
            for occ_from in (None, occ):
                got = ops.fused_probe(tk, tids, tpk, c, cbucket, occ_from=occ_from)
                check(equal(got[0], want[0]) and equal(got[1], want[1]),
                      f"fused_probe kernel == plain on {name} cap={c}")
                n_cases += 1
    for name, (data, queries, ids, k) in sorted(RERANK_CASES.items()):
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(card)
                for x in (data, queries, ids)]
        got, want = ops.fused_rerank(*args, k), kfr.fused_rerank_plain(*args, k)
        check(equal(got[0], want[0]) and equal(got[1], want[1]),
              f"fused_rerank kernel == plain on {name}")
        n_cases += 1
    for name, arrays in sorted(MERGE_CASES.items()):
        args = [torch.from_numpy(x).to(card) for x in arrays]
        got, want = ops.topk_merge(*args), ktm.topk_merge_plain(*args)
        check(equal(got[0], want[0]) and equal(got[1], want[1]),
              f"topk_merge kernel == plain on {name}")
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
    gt_d0, gt_i0 = exact_knn(data_c, q_c, K)
    dbar = float(gt_d0.mean())
    width = max(8, int(3.0 * math.sqrt(dbar)) & ~1)
    cfg = IndexConfig(num_tables=8, num_hashes=12, width=width, num_probes=200,
                      candidate_cap=128, universe=UNIVERSE, k=K, rerank_chunk=1024)
    # delete the exact 1-NN of 64 queries, so the tombstones bite
    deleted = np.unique(gt_i0[32:32 + N_DELETE, 0].cpu().numpy()).astype(np.int32)
    points = torch.cat([data_c, torch.from_numpy(inserted).to(card)])
    dead = torch.zeros(points.shape[0], dtype=torch.bool, device=card)
    dead[torch.from_numpy(deleted).long().to(card)] = True
    _, gt_i = exact_knn(points, q_c, K, dead=dead)
    gt_ids = gt_i.cpu().numpy()
    deleted_c = torch.from_numpy(deleted).to(card)
    log(f"phase data: {time.perf_counter() - t0:.1f} s; dbar {dbar:.1f} -> W {width}; "
        f"L 8 M 12 T 200 C 128 k {K} batch 64")

    # -- serve: the main path, launch counts zeroed just before ---------------
    serve_cfg = ServeConfig(batch_size=64, delta_cap=2048)
    phases = []
    ops.reset_launches()
    t0 = time.perf_counter()
    engine = AnnServingEngine(cfg, serve_cfg, data, device="cuda")
    build_s = time.perf_counter() - t0
    gids_new = engine.insert(inserted)
    check(list(gids_new[:2]) == [N_POINTS, N_POINTS + 1], "insert assigns fresh gids")
    check(engine.delete(deleted) == len(deleted), "delete tombstones every gid")
    check(engine.index.num_segments == 1 and engine.index.delta_fill > 0,
          "one segment plus a delta buffer: the fold runs topk_merge")
    lat0 = len(engine._lat_ms)
    engine.submit(queries)
    d1, i1 = engine.drain()
    phases.append(("serve_delta", build_s, engine._lat_ms[lat0:], d1, i1))
    t0 = time.perf_counter()
    engine.compact()
    compact_s = time.perf_counter() - t0
    lat0 = len(engine._lat_ms)
    engine.submit(queries)
    d2, i2 = engine.drain()
    phases.append(("serve_compacted", compact_s, engine._lat_ms[lat0:], d2, i2))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    log(f"main path launches: {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} launched on the main path")

    big = pipe.BIG_DIST
    for name, setup_s, lat, d, i in phases:
        r, hits = check_results(name, d, i, q_c, points, deleted_c,
                                torch.from_numpy(inserted_rows).to(card), gt_ids,
                                big, recall, exact_delta=name == "serve_delta")
        lat = np.asarray(lat)
        log(f"phase {name}: build {setup_s:.2f} s, batches {lat.size}, "
            f"p50 {np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
            f"{N_QUERIES / (lat.sum() / 1e3):.1f} queries/s, recall@10 {r:.4f}, "
            f"self-hits {hits}/{inserted_rows.size}")
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
    probe_k = lambda: kfp.fused_probe_cuda(st.sorted_keys, st.sorted_ids, pk, cap, cb,
                                           occ_from=st.occ_from)
    probe_p = lambda: kfp.compact_gather(st.sorted_ids, lo, occ, p, cb, cap)
    got, want = probe_k(), probe_p()
    check(equal(got[0], want[0]) and equal(got[1], want[1]),
          "fused_probe kernel == plain on the served batch")
    ids = pipe.stage_tombstone(got[0], seg.gids, tomb, st.dataset.shape[0])
    rr_k = lambda: kfr.fused_rerank_cuda(st.dataset, batch, ids, K)
    rr_p = lambda: kfr.fused_rerank_plain(st.dataset, batch, ids, K, chunk=cfg.rerank_chunk)
    sd, si = rr_k()
    wd, wi = rr_p()
    check(equal(sd, wd) and equal(si, wi), "fused_rerank kernel == plain on the served batch")
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
    probe_bytes = q_rows * lp * (8 + 8 + 4) + gathered * 4 + q_rows * (cb + 1) * 4
    probe_ops = q_rows * lp * math.ceil(math.log2(max(2, st.dataset.shape[0])))
    valid = ids[(ids >= 0) & (ids < st.dataset.shape[0])]
    uniq_rows = int(torch.unique(valid).numel())
    pairs = sum(int(torch.unique(r[(r >= 0) & (r < st.dataset.shape[0])]).numel())
                for r in ids)
    rr_bytes = (ids.numel() * 4 + uniq_rows * DIM * st.dataset.element_size()
                + batch.numel() * 4 + 2 * q_rows * K * 4)
    rr_ops = pairs * DIM * 3
    tm_bytes = 6 * q_rows * K * 4
    tm_ops = q_rows * 2 * K * math.ceil(math.log2(2 * K))

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    rows = []
    for name, kfn, pfn, lib, nbytes, nops, errs, src, repl in [
        ("fused_probe", probe_k, probe_p, None, probe_bytes, probe_ops,
         [(got[0], want[0]), (got[1], want[1])], "fused_probe.cu",
         "src/repro/kernels/fused_probe.py:158"),
        ("fused_rerank", rr_k, rr_p, None, rr_bytes, rr_ops,
         [(sd, wd), (si, wi)], "fused_rerank.cu",
         "src/repro/kernels/fused_rerank.py:140"),
        ("topk_merge", tm_k, tm_p, tm_lib, tm_bytes, tm_ops,
         [(mk[0], mp[0]), (mk[1], mp[1])], "topk_merge.cu",
         "src/repro/kernels/topk_merge.py:122"),
    ]:
        b_ms, b_by = bound(nbytes, nops)
        rows.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
            "replaces": repl, "launches": launches[name], "equal_to_plain": True,
            "max_abs_err": max_abs_err(errs), "ms": cuda_ms(kfn),
            "plain_ms": cuda_ms(pfn, reps=5), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None if lib is None else cuda_ms(lib),
        })
    log(f"phase batch: Q {q_rows}, rung cbucket {cb} c_cap {c_cap}, gathered "
        f"{gathered}, distinct rows {uniq_rows}, delta rows {idx._delta_count}")
    log_profile(engine, queries[:serve_cfg.batch_size])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
