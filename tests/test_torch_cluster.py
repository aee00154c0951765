"""The port's in-process cluster (``repro_torch.cluster``) on the CPU: the
router/replica/WAL contracts of tests/test_cluster.py, and parity with the
JAX package — the WAL's bytes, the router's (d, i) bit for bit before and
after mutations, a kill, WAL replay and recovery, a WAL written by either
package replaying in the other, and ``QualityRun.check_cluster``.

The load-bearing claims pinned here:
  * S>=2 shards x R>=2 replicas return BIT-identical results to the flat
    single-engine ``query_index`` path — fresh, after interleaved
    insert/delete/compact (vs a single-engine mirror of the same mutation
    sequence), and after a replica kill + WAL-replay recovery;
  * a replica killed mid-traffic never drops a query (failover);
  * a *slow* replica triggers a real hedged re-issue and the fast peer's
    answer is returned;
  * WAL: torn tails are dropped, replay is deterministic, truncation at
    snapshot keeps recovery exact;
  * admission control: queue bound + deadline shedding with explicit stats;
  * the result cache hits on repeats and is invalidated by any mutation.
"""
import os
import tempfile
import time

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import cluster as jcl
from repro.core import index as jidx
from repro.serve.engine import ServeConfig as JServe
from repro_torch.cluster import (ClusterConfig, ClusterRouter, ClusterUnavailable,
                                 OP_DELETE, OP_INSERT, ShardReplica, WalRecord,
                                 WriteAheadLog)
from repro_torch.cluster.wal import _scan
from repro_torch.core.index import IndexConfig, build_index, make_params, query_index
from repro_torch.data import ann_synthetic as ds
from repro_torch.serve.engine import AnnServingEngine, ServeConfig
from test_torch_bridge import bridged

torch.set_num_threads(1)

SEED = 0
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def cfg():
    # candidate_cap is deliberately non-truncating at this n so the flat,
    # segmented, and sharded candidate sets coincide -> bit-identity holds
    return IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=20,
                       candidate_cap=256, universe=64, k=8, rerank_chunk=128)


@pytest.fixture(scope="module")
def small():
    spec = ds.DatasetSpec("cluster-t", n=900, dim=16, universe=64,
                          num_clusters=8)
    data = np.asarray(ds.make_dataset(spec))
    queries = np.asarray(ds.make_queries(spec, data, 24))
    return data, queries


def serve_cfg(**kw):
    kw.setdefault("batch_size", 16)
    kw.setdefault("delta_cap", 128)
    return ServeConfig(**kw)


def make_router(cfg, data, root, shards=2, replicas=2, **ckw):
    ckw.setdefault("hedge_ms", 30000)   # consistency tests: never hedge on
    ckw.setdefault("wal_fsync", False)  # a cold compile; fsync off for speed
    return ClusterRouter(
        cfg, serve_cfg(), ClusterConfig(num_shards=shards,
                                        num_replicas=replicas, **ckw),
        data, str(root), seed=SEED, device="cpu")


def make_mirror(cfg, data):
    """The single engine the cluster must match, with the same parameters."""
    return AnnServingEngine(cfg, serve_cfg(), dataset=data, seed=SEED, device="cpu")


# ---------------------------------------------------------------- WAL


def test_wal_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = WriteAheadLog(path, fsync=False)
    pts = np.arange(12, dtype=np.int32).reshape(3, 4)
    s1 = wal.append(OP_INSERT, [0, 1, 2], pts)
    s2 = wal.append(OP_DELETE, [1])
    assert (s1, s2) == (1, 2)
    recs = wal.records()
    assert [r.op for r in recs] == [OP_INSERT, OP_DELETE]
    np.testing.assert_array_equal(recs[0].points, pts)
    wal.close()

    # torn tail: a crash mid-append leaves garbage after the last record
    with open(path, "ab") as f:
        f.write(b"\x31\x4c\x41\x57" + b"\x00" * 7)  # magic + short header
    wal2 = WriteAheadLog(path, fsync=False)
    assert wal2.torn_bytes_dropped > 0
    assert [r.seq for r in wal2.records()] == [1, 2]
    # appends after the truncated tail stay on record boundaries
    wal2.append(OP_DELETE, [2])
    assert [r.seq for r in wal2.records()] == [1, 2, 3]
    wal2.close()


def test_wal_truncate_and_monotone_seq(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "w.log"), fsync=False)
    for g in range(4):
        wal.append(OP_DELETE, [g])
    assert wal.truncate_upto(2) == 2
    assert [r.seq for r in wal.records()] == [3, 4]
    with pytest.raises(ValueError, match="non-monotone"):
        wal.append_record(WalRecord(seq=2, op=OP_DELETE,
                                    gids=np.zeros(1, np.int32)))
    wal.close()


# ------------------------------------------------- consistency oracle


def test_cluster_bit_identical_to_flat(cfg, small, tmp_path):
    data, queries = small
    state = build_index(cfg, torch.from_numpy(data),
                        params=make_params(cfg, data.shape[1], SEED))
    fd, fi = (x.numpy() for x in query_index(cfg, state, torch.from_numpy(queries)))

    router = make_router(cfg, data, tmp_path, shards=2, replicas=2)
    cd, ci = router.query(queries)
    np.testing.assert_array_equal(cd, fd)
    np.testing.assert_array_equal(ci, fi)
    # gid partitioning: every returned gid is a valid global id
    assert int(ci.max()) < data.shape[0]
    router.close()


def test_cluster_matches_mirror_after_interleaved_mutations(
        cfg, small, tmp_path):
    data, queries = small
    router = make_router(cfg, data, tmp_path)
    mirror = make_mirror(cfg, data)

    rng = np.random.default_rng(3)
    new = (rng.integers(0, 32, (40, data.shape[1])) * 2).astype(np.int32)
    g_r = router.insert(new)
    g_m = mirror.insert(new)
    np.testing.assert_array_equal(g_r, g_m)   # identical gid allocation

    router.delete(g_r[:10])
    mirror.delete(g_m[:10])
    router.compact()
    mirror.compact()
    more = (rng.integers(0, 32, (15, data.shape[1])) * 2).astype(np.int32)
    np.testing.assert_array_equal(router.insert(more), mirror.insert(more))
    router.delete([int(g_r[20]), 5, 7])
    mirror.delete([int(g_m[20]), 5, 7])

    cd, ci = router.query(queries)
    md, mi = mirror.query_batch(queries)
    np.testing.assert_array_equal(cd, md)
    np.testing.assert_array_equal(ci, mi)
    router.close()


def test_kill_recover_wal_replay_bit_identical(cfg, small, tmp_path):
    data, queries = small
    router = make_router(cfg, data, tmp_path, cache_capacity=0)
    mirror = make_mirror(cfg, data)
    # mutations BEFORE the kill land in the victim's WAL
    pts = (queries[:12] + 2).astype(np.int32)
    router.insert(pts)
    mirror.insert(pts)

    router.kill_replica(0, 0)
    # queries keep answering while the replica is down (failover to peer)
    cd, ci = router.query(queries)
    md, mi = mirror.query_batch(queries)
    np.testing.assert_array_equal(cd, md)
    np.testing.assert_array_equal(ci, mi)

    # mutations WHILE down never reach the victim's WAL -> catch-up path
    router.delete([0, 3, 5])
    mirror.delete([0, 3, 5])

    info = router.recover_replica(0, 0)
    assert info["replayed"] >= 1 or info["caught_up"] >= 1
    # force the recovered replica to serve: kill its peer
    router.kill_replica(0, 1)
    cd2, ci2 = router.query(queries)
    md2, mi2 = mirror.query_batch(queries)
    np.testing.assert_array_equal(cd2, md2)
    np.testing.assert_array_equal(ci2, mi2)
    router.close()


def test_restart_from_disk_reconstructs_state(cfg, small, tmp_path):
    """Full-cluster restart: replicas rebuilt purely from snapshot + WAL."""
    data, queries = small
    router = make_router(cfg, data, tmp_path)
    pts = (queries[:8] + 4).astype(np.int32)
    gids = router.insert(pts)
    router.delete(gids[:3])
    cd, ci = router.query(queries)
    router.close()

    router2 = make_router(cfg, data, tmp_path)  # same root: recovers from disk
    assert router2._shard_seq == [2, 2]         # adopted from replica WALs
    assert router2.next_gid == data.shape[0] + 8  # dense gids re-derived
    cd2, ci2 = router2.query(queries)
    np.testing.assert_array_equal(cd2, cd)
    np.testing.assert_array_equal(ci2, ci)
    router2.close()


# ------------------------------------------------- hedging + health


def test_slow_replica_hedged_reissue_fast_peer_wins(cfg, small, tmp_path):
    data, queries = small
    router = make_router(cfg, data, tmp_path, hedge_ms=150)
    base_d, base_i = router.query(queries)          # warm both paths

    victim = router.replicas[0][0]
    victim.slow_ms = 1500.0                         # straggler, not dead
    router._rr[0] = 0                               # victim is preferred
    cd, ci = router.query(queries[:8] + 2)          # fresh rows: no cache
    s = router.summary()
    assert s["hedged_batches"] >= 1, s
    assert s["hedge_wins"] >= 1, s                  # fast peer's answer won
    # and the answer is the same bits the healthy cluster would return
    victim.slow_ms = 0.0
    router._cache.clear()
    cd2, ci2 = router.query(queries[:8] + 2)
    np.testing.assert_array_equal(cd, cd2)
    np.testing.assert_array_equal(ci, ci2)
    router.close()


def test_killed_replica_mid_traffic_zero_dropped(cfg, small, tmp_path):
    """An UNANNOUNCED replica death (queries start failing, the router only
    finds out by hitting it) mid-traffic: every query still answers."""
    data, queries = small
    router = make_router(cfg, data, tmp_path, cache_capacity=0)
    served = 0
    for wave in range(4):
        if wave == 2:  # crash without telling the router (vs kill_replica,
            # which marks the replica dead and routes around it upfront)
            router.replicas[1][0].fail_next_queries = 10 ** 6
        q = queries + wave                          # distinct rows per wave
        d, i = router.query(q)
        assert d.shape[0] == q.shape[0]
        assert (i >= 0).all(), "dropped/shed rows would be -1"
        served += d.shape[0]
    s = router.summary()
    assert served == 4 * queries.shape[0]
    assert s["failovers"] >= 1                      # the crash was survived
    router.close()


def test_repeated_failures_mark_replica_dead(cfg, small, tmp_path):
    data, queries = small
    router = make_router(cfg, data, tmp_path, health_failures=2,
                         cache_capacity=0)
    flaky = router.replicas[0][0]
    flaky.fail_next_queries = 99                    # fails every query
    for wave in range(3):
        router.query(queries[:4] + wave)
    s = router.summary()
    assert not flaky.alive
    assert s["replicas_marked_dead"] == 1
    assert s["failovers"] >= 2
    router.close()


def test_all_replicas_dead_raises(cfg, small, tmp_path):
    data, queries = small
    router = make_router(cfg, data, tmp_path, replicas=1)
    router.kill_replica(0, 0)
    with pytest.raises(ClusterUnavailable):
        router.query(queries[:4])
    with pytest.raises(ClusterUnavailable):
        router.insert(queries[:2])
    router.close()


# ------------------------------------------ admission control + cache


def test_admission_queue_bound_and_deadline_shedding(cfg, small, tmp_path):
    data, queries = small
    router = make_router(cfg, data, tmp_path, max_queue_depth=10)
    admitted = router.submit(queries)               # 24 rows, room for 10
    assert admitted == 10
    assert router.summary()["rejected_queue_full"] == queries.shape[0] - 10
    d, i = router.drain()
    assert d.shape[0] == 10 and (i >= 0).all()

    # expired deadline -> shed at dispatch with -1 rows, explicit stat
    assert router.submit(queries[:6], deadline_ms=-1.0) == 6
    d, i = router.drain()
    assert d.shape == (6, cfg.k)
    assert (d == -1).all() and (i == -1).all()
    assert router.summary()["rejected_deadline"] == 6
    router.close()


def test_result_cache_hits_and_mutation_invalidation(cfg, small, tmp_path):
    data, queries = small
    router = make_router(cfg, data, tmp_path, cache_capacity=64)
    d1, i1 = router.query(queries[:8])
    miss1 = router.summary()["cache_misses"]
    d2, i2 = router.query(queries[:8])              # identical -> all hits
    s = router.summary()
    assert s["cache_hits"] >= 8
    assert s["cache_misses"] == miss1               # no new dispatches
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)

    # a mutation flips the signature: stale entries must not be served
    gids = router.insert(queries[:1].astype(np.int32))
    d3, i3 = router.query(queries[:8])
    s2 = router.summary()
    assert s2["cache_misses"] > miss1               # re-dispatched
    # the inserted point (an exact query duplicate) must now be returned
    assert int(gids[0]) in set(i3[0].tolist())
    router.close()


def test_submit_validates_dim_and_dtype(cfg, small, tmp_path):
    data, queries = small
    router = make_router(cfg, data, tmp_path)
    with pytest.raises(ValueError, match="dim"):
        router.submit(np.zeros((2, data.shape[1] + 3), np.int32))
    with pytest.raises(TypeError, match="int"):
        router.submit(np.zeros((2, data.shape[1]), np.float32))
    # engine-level too (satellite: clear error at submit, not np.stack time)
    eng = make_mirror(cfg, data)
    with pytest.raises(ValueError, match="dim"):
        eng.submit(np.zeros((1, 3), np.int32))
    with pytest.raises(TypeError, match="int"):
        eng.submit(np.zeros((1, data.shape[1]), np.float64))
    eng.submit(np.zeros((1, data.shape[1]), np.int64))  # castable: accepted
    d, i = eng.drain()
    assert d.shape == (1, cfg.k)
    router.close()


def test_mutation_failure_on_one_replica_does_not_poison_shard(
        cfg, small, tmp_path, monkeypatch):
    """A replica failing mid-mutation is marked dead and the shard seq still
    advances with the healthy peer — later mutations must not be rejected
    as non-monotone WAL seqs, and the dead replica must recover cleanly."""
    data, queries = small
    router = make_router(cfg, data, tmp_path)
    sick = router.replicas[0][0]

    def boom(record):
        raise OSError("disk full")

    monkeypatch.setattr(sick, "log_and_apply", boom)
    pts = (queries[:4] + 1).astype(np.int32)
    gids = router.insert(pts)                       # acked by the peer
    assert not sick.alive
    assert router.summary()["replicas_marked_dead"] == 1
    monkeypatch.undo()
    router.insert((queries[4:8] + 1).astype(np.int32))  # seq still monotone
    router.delete(gids[:2])
    info = router.recover_replica(0, 0)             # resyncs from the peer
    assert sick.alive and sick.last_seq == router._shard_seq[0]
    assert info["replayed"] + info["caught_up"] >= 1
    router.close()


def test_emptied_shard_replica_can_still_recover(cfg, small, tmp_path):
    """Recovery via full state transfer from a peer whose shard emptied out
    (delete-all + compact leaves nothing to checkpoint) must not crash."""
    data, queries = small
    router = make_router(cfg, data, tmp_path)
    router.kill_replica(0, 0)
    shard0_gids = np.arange(0, data.shape[0], 2)    # every gid on shard 0
    router.delete(shard0_gids)
    router.compact()              # peer snapshots + truncates its WAL ->
    router.recover_replica(0, 0)  # catch-up must take the full-transfer path
    router.kill_replica(0, 1)     # recovered replica serves the empty shard
    d, i = router.query(queries)
    assert d.shape == (queries.shape[0], cfg.k)
    assert not np.isin(i, shard0_gids).any()        # shard 0 contributes none
    assert (i % 2 == 1).all()                       # only shard-1 gids remain
    router.close()


def test_wholly_failed_shard_mutation_parks_and_replays(
        cfg, small, tmp_path, monkeypatch):
    """Every replica of one shard fails a mutation: the record is parked
    (the dense gid arithmetic cannot skip a slice), the healthy shard still
    applies its slice, and recovery replays the parked record — after
    which the points exist, gid allocation continues cleanly, and the
    cluster matches a mirror that applied the same logical mutations."""
    data, queries = small
    router = make_router(cfg, data, tmp_path)
    mirror = make_mirror(cfg, data)

    def boom(record):
        raise OSError("disk full")

    for rep in router.replicas[0]:
        monkeypatch.setattr(rep, "log_and_apply", boom)
    pts = (queries[:6] + 3).astype(np.int32)
    with pytest.raises(ClusterUnavailable, match="parked"):
        router.insert(pts)
    mirror.insert(pts)                               # the eventual outcome
    assert router.next_gid == data.shape[0] + 6      # gids burned, not reused
    monkeypatch.undo()

    # shard 0's replicas were marked dead; recovery replays the parked slice
    info = router.recover_replica(0, 0)
    assert info["parked_applied"] == 1
    router.recover_replica(0, 1)
    gids2 = router.insert((queries[6:10] + 3).astype(np.int32))
    np.testing.assert_array_equal(
        gids2, mirror.insert((queries[6:10] + 3).astype(np.int32)))
    cd, ci = router.query(queries)
    md, mi = mirror.query_batch(queries)
    np.testing.assert_array_equal(cd, md)
    np.testing.assert_array_equal(ci, mi)
    router.close()


def test_drain_degrades_failed_batches_without_orphaning_queue(
        cfg, small, tmp_path):
    """A shard losing its last replica mid-drain -1-fills that batch's rows
    but keeps draining — later callers' rows stay aligned with their own
    submissions."""
    data, queries = small
    router = make_router(cfg, data, tmp_path, replicas=1, cache_capacity=0)
    router.submit(queries)                           # 24 rows = 2 batches
    router.kill_replica(0, 0)                        # last replica of shard 0
    d, i = router.drain()
    assert d.shape[0] == queries.shape[0]            # alignment preserved
    assert (d == -1).all() and (i == -1).all()
    s = router.summary()
    assert s["dispatch_failures"] >= 2
    assert s["queue_depth"] == 0                     # nothing orphaned
    router.recover_replica(0, 0)
    d2, i2 = router.query(queries[:4])               # router fully usable
    assert (i2 >= 0).all()
    router.close()


def test_query_overflow_is_all_or_nothing(cfg, small, tmp_path):
    data, queries = small
    router = make_router(cfg, data, tmp_path, max_queue_depth=4)
    with pytest.raises(ClusterUnavailable, match="queue full"):
        router.query(queries[:6])
    assert router.summary()["queue_depth"] == 0     # nothing orphaned
    d, i = router.query(queries[:3])                # router still usable,
    assert d.shape[0] == 3                          # rows stay aligned
    router.close()


# ------------------------------------------------- durability details


def test_snapshot_truncates_wal_and_survives(cfg, small, tmp_path):
    data, queries = small
    router = make_router(cfg, data, tmp_path, shards=1, replicas=1)
    rep = router.replicas[0][0]
    for wave in range(3):
        router.insert((queries[:4] + wave).astype(np.int32))
    assert rep.last_seq == 3
    rep.snapshot()
    assert rep.wal.records() == []                  # truncated into snapshot
    rep.kill()
    rep.recover()
    assert rep.last_seq == 3                        # position survived
    d, i = router.query(queries[:4])
    assert (i >= 0).all()
    router.close()


def test_wal_replay_is_deterministic_and_checked(cfg, small, tmp_path):
    """Replaying the same WAL twice yields the same engine; a diverging
    replay (wrong gids) is detected, not silently accepted."""
    from repro_torch.cluster.replica import ReplicaDiverged, ShardReplica

    data, queries = small
    rep = ShardReplica(0, 0, cfg, serve_cfg(), SEED, str(tmp_path / "r"),
                       data, wal_fsync=False, device="cpu")
    n0 = rep.engine.index.next_gid
    rec = WalRecord(seq=1, op=OP_INSERT,
                    gids=np.arange(n0, n0 + 4, dtype=np.int32),
                    points=queries[:4].astype(np.int32))
    rep.log_and_apply(rec)
    d1, i1 = rep.query(queries[:8], 8)
    rep.kill()
    rep.recover()
    d2, i2 = rep.query(queries[:8], 8)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)

    bad = WalRecord(seq=2, op=OP_INSERT,
                    gids=np.array([999999], np.int32),
                    points=queries[:1].astype(np.int32))
    with pytest.raises(ReplicaDiverged):
        rep.log_and_apply(bad)
    rep.close()


# --------------------------------------------- WAL corruption properties


def _build_log(path):
    """A three-record log (insert/delete/insert) + its frame boundaries."""
    wal = WriteAheadLog(path, fsync=False)
    wal.append(OP_INSERT, [0, 1], np.arange(8, dtype=np.int32).reshape(2, 4))
    wal.append(OP_DELETE, [0])
    wal.append(OP_INSERT, [2], np.arange(4, dtype=np.int32).reshape(1, 4))
    wal.close()
    with open(path, "rb") as f:
        blob = f.read()
    return blob, [end for _, end in _scan(path)]


def test_wal_torn_tail_truncated_at_every_byte_offset(tmp_path):
    """Crash-at-ANY-point: for every prefix length of a multi-record log,
    reopening yields exactly the records whose frames fit the prefix,
    reports the dropped byte count, and appends resume on a boundary."""
    blob, ends = _build_log(str(tmp_path / "full.log"))
    path = str(tmp_path / "cut.log")
    for cut in range(len(blob) + 1):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        wal = WriteAheadLog(path, fsync=False)
        good = [e for e in ends if e <= cut]
        assert [r.seq for r in wal.records()] == \
            list(range(1, len(good) + 1)), cut
        assert wal.torn_bytes_dropped == cut - (good[-1] if good else 0), cut
        wal.append(OP_DELETE, [9])          # append-ready after truncation
        assert wal.records()[-1].seq == len(good) + 1
        wal.close()


def test_wal_corruption_mid_log_truncates_at_last_valid(tmp_path):
    """Flipping ANY single byte truncates at the last record before the
    flip: replay never resyncs past garbage (CRC/magic/op checks), later
    records are dropped with the corrupt one, and appends still work."""
    blob, ends = _build_log(str(tmp_path / "full.log"))
    path = str(tmp_path / "bad.log")
    for off in range(len(blob)):
        corrupt = bytearray(blob)
        corrupt[off] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(corrupt))
        wal = WriteAheadLog(path, fsync=False)
        hit = next(i for i, e in enumerate(ends) if off < e)
        assert [r.seq for r in wal.records()] == \
            list(range(1, hit + 1)), off
        assert wal.torn_bytes_dropped == \
            len(blob) - (ends[hit - 1] if hit else 0), off
        wal.append(OP_DELETE, [9])
        assert len(wal.records()) == hit + 1
        wal.close()


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_wal_corruption_property(data):
    """Random logs x random truncation/flip: survivors are always a clean
    seq prefix and the reopened log always accepts appends."""
    seed = data.draw(st.integers(0, 2 ** 31 - 1), label="seed")
    n_recs = data.draw(st.integers(1, 6), label="records")
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "w.log")
        wal = WriteAheadLog(path, fsync=False)
        for _ in range(n_recs):
            n = int(rng.integers(1, 5))
            if rng.random() < 0.5:
                wal.append(OP_INSERT, np.arange(n, dtype=np.int32),
                           rng.integers(0, 64, (n, 4)).astype(np.int32))
            else:
                wal.append(OP_DELETE,
                           rng.integers(0, 99, n).astype(np.int32))
        wal.close()
        with open(path, "rb") as f:
            blob = f.read()
        ends = [e for _, e in _scan(path)]
        if data.draw(st.booleans(), label="truncate"):
            cut = data.draw(st.integers(0, len(blob)), label="cut")
            blob = blob[:cut]
            expect = sum(1 for e in ends if e <= cut)
        else:
            off = data.draw(st.integers(0, len(blob) - 1), label="off")
            b = bytearray(blob)
            b[off] ^= 0xFF
            blob = bytes(b)
            expect = next(i for i, e in enumerate(ends) if off < e)
        with open(path, "wb") as f:
            f.write(blob)
        wal2 = WriteAheadLog(path, fsync=False)
        assert [r.seq for r in wal2.records()] == list(range(1, expect + 1))
        wal2.append(OP_DELETE, [0])
        assert len(wal2.records()) == expect + 1
        wal2.close()


# --------------------------------------------- snapshot cadence policy


def _insert_rec(rep, seq, pts):
    gids = np.arange(rep.next_gid, rep.next_gid + pts.shape[0],
                     dtype=np.int32)
    rep.log_and_apply(WalRecord(seq=seq, op=OP_INSERT, gids=gids,
                                points=pts))


def test_snapshot_cadence_bytes_bounds_recovery(cfg, small, tmp_path):
    """``snapshot_every_bytes`` caps the WAL: the log never holds more
    than one cadence interval of records, so kill+recover replay work is
    bounded by policy no matter how many mutations ran (and no matter
    that compaction never fired)."""
    data, _ = small
    # one 4-row insert record at dim=16: 21B header + 16B gids +
    # 256B points + 4B crc
    rec_bytes = 297
    rep = ShardReplica(0, 0, cfg, serve_cfg(), SEED, str(tmp_path / "r"),
                       data[:200], wal_fsync=False,
                       snapshot_every_bytes=2 * rec_bytes + 1, device="cpu")
    base = rep.snapshots_taken
    rng = np.random.default_rng(7)
    for seq in range(1, 14):
        pts = (rng.integers(0, 32, (4, data.shape[1])) * 2).astype(np.int32)
        _insert_rec(rep, seq, pts)
        # every third record trips the trigger -> at most 2 at rest
        assert rep.wal.size_bytes <= 2 * rec_bytes, seq
    assert rep.snapshots_taken >= base + 4
    rep.kill()
    assert rep.recover() <= 2               # replay <= one cadence interval
    assert rep.last_seq == 13
    rep.close()


def test_snapshot_cadence_time_trigger(cfg, small, tmp_path):
    """``snapshot_every_s``: a mutation arriving after the age deadline
    snapshots + truncates; one arriving inside it does not."""
    data, _ = small
    rep = ShardReplica(0, 0, cfg, serve_cfg(), SEED, str(tmp_path / "r"),
                       data[:200], wal_fsync=False, device="cpu")
    pts = data[:4].astype(np.int32)
    _insert_rec(rep, 1, pts)                # pay the insert compile up front
    rep.snapshot()                          # known-fresh snapshot clock
    rep.snapshot_every_s = 0.25
    base = rep.snapshots_taken
    _insert_rec(rep, 2, pts + 2)            # young snapshot: no trigger
    assert rep.snapshots_taken == base
    assert rep.wal.size_bytes > 0
    time.sleep(0.3)
    _insert_rec(rep, 3, pts + 4)            # stale snapshot: trigger
    assert rep.snapshots_taken == base + 1
    assert rep.wal.size_bytes == 0          # truncated into the snapshot
    rep.close()


# ------------------------------------------- hedging vs mutation quiesce


def test_hedged_straggler_quiesced_before_mutation(cfg, small, tmp_path):
    """A hedged batch leaves the
    straggler's future running after the fast peer's answer returns; a
    mutation issued right then must wait it out (``_quiesce``) —
    ``log_and_apply`` overlapping an in-flight query on the same replica
    would race the engine's segment state."""
    data, queries = small
    router = make_router(cfg, data, tmp_path, hedge_ms=150,
                         cache_capacity=0)
    router.query(queries)                   # warm every compile path
    victim = router.replicas[0][0]
    state = {"in_query": 0, "overlap": False}
    orig_query, orig_apply = victim.query, victim.log_and_apply

    def slow_query(batch, n_real):
        state["in_query"] += 1
        try:
            time.sleep(0.6)                 # straggle well past hedge_ms
            return orig_query(batch, n_real)
        finally:
            state["in_query"] -= 1

    def checked_apply(record):
        if state["in_query"]:
            state["overlap"] = True
        return orig_apply(record)

    victim.query = slow_query
    victim.log_and_apply = checked_apply
    router._rr[0] = 0                       # victim is the preferred replica
    d, i = router.query(queries[:8] + 2)
    assert (i >= 0).all()
    s = router.summary()
    assert s["hedged_batches"] >= 1 and s["hedge_wins"] >= 1, s
    # the straggler future is STILL in flight right now; the insert must
    # quiesce it before appending/applying anywhere
    router.insert((queries[:4] + 5).astype(np.int32))
    assert not state["overlap"], \
        "mutation applied while a hedged query was still in flight"
    victim.query, victim.log_and_apply = orig_query, orig_apply
    router.close()


# --------------------------------------------- parity with the JAX package


def _records():
    rng = np.random.default_rng(11)
    return [WalRecord(seq=1, op=OP_INSERT, gids=np.arange(3, dtype=np.int32),
                      points=rng.integers(-5, 70, (3, 16)).astype(np.int32)),
            WalRecord(seq=2, op=OP_DELETE, gids=np.array([1, 7], np.int32)),
            WalRecord(seq=5, op=OP_INSERT, gids=np.array([9], np.int32),
                      points=np.full((1, 16), 2 ** 31 - 1, np.int32))]


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_wal_bytes_and_logs_cross_the_packages(tmp_path, writer):
    """Each record encodes to the JAX package's bytes; a log written by
    either package is the same file and replays in the other."""
    recs = _records()
    for rec in recs:
        jrec = jcl.WalRecord(seq=rec.seq, op=rec.op, gids=rec.gids, points=rec.points)
        assert rec.encode() == jrec.encode()
    paths = {}
    for pkg, log_cls, rec_cls in (("repro", jcl.WriteAheadLog, jcl.WalRecord),
                                  ("repro_torch", WriteAheadLog, WalRecord)):
        paths[pkg] = str(tmp_path / f"{pkg}.log")
        wal = log_cls(paths[pkg], fsync=False)
        for rec in recs:
            wal.append_record(rec_cls(seq=rec.seq, op=rec.op, gids=rec.gids,
                                      points=rec.points))
        wal.close()
    with open(paths["repro"], "rb") as a, open(paths["repro_torch"], "rb") as b:
        assert a.read() == b.read()
    reader = jcl.WriteAheadLog if writer == "repro_torch" else WriteAheadLog
    back = reader(paths[writer], fsync=False)
    got = back.records(after_seq=1)
    assert [(r.seq, r.op) for r in got] == [(2, OP_DELETE), (5, OP_INSERT)]
    np.testing.assert_array_equal(got[1].points, recs[2].points)
    assert back.last_seq == 5
    back.close()


def test_router_matches_the_jax_router(cfg, small, tmp_path):
    """The port's router and the JAX package's, with the JAX parameters
    bridged, give the same (d, i) bit for bit: fresh, after interleaved
    inserts and deletes, and after a kill, mutations while down, WAL replay
    and recovery with the recovered replica serving."""
    data, queries = small
    jcfg = jidx.IndexConfig(**dataclasses.asdict(cfg))
    params = bridged(jidx.make_params(jcfg, KEY, data.shape[1]))
    ccfg = dict(hedge_ms=30000, wal_fsync=False, cache_capacity=0)
    jr = jcl.ClusterRouter(jcfg, JServe(batch_size=16, delta_cap=128),
                           jcl.ClusterConfig(**ccfg), data, str(tmp_path / "j"), key=KEY)
    tr = ClusterRouter(cfg, serve_cfg(), ClusterConfig(**ccfg), data, str(tmp_path / "t"),
                       params_fn=lambda c, d: params, device="cpu")

    def same(stage):
        (jd, ji), (td, ti) = jr.query(queries), tr.query(queries)
        np.testing.assert_array_equal(jd, td, err_msg=stage)
        np.testing.assert_array_equal(ji, ti, err_msg=stage)

    same("fresh")
    rng = np.random.default_rng(3)
    new = (rng.integers(0, 32, (40, data.shape[1])) * 2).astype(np.int32)
    for r in (jr, tr):
        g = r.insert(new)
        r.delete([int(g[3]), 5, 8])
        r.insert((queries[:6] + 2).astype(np.int32))
    np.testing.assert_array_equal(jr.next_gid, tr.next_gid)
    same("interleaved mutations")
    for r in (jr, tr):
        r.kill_replica(0, 0)
        r.delete([0, 2, int(g[10])])
    same("replica down")
    infos = [r.recover_replica(0, 0) for r in (jr, tr)]
    assert infos[0] == infos[1] and infos[1]["replayed"] + infos[1]["caught_up"] >= 1
    for r in (jr, tr):
        r.kill_replica(0, 1)
    same("recovered replica serving")
    assert tr.summary()["recoveries"] == jr.summary()["recoveries"] == 1
    jr.close()
    tr.close()


def test_check_cluster_matches_the_jax_package(small):
    """``QualityRun.check_cluster`` on the port: both flags hold, and every
    field equals the JAX package's (the raised oracle cap included)."""
    from repro.eval import QualityRun as JRun
    from repro.eval import QualitySpec as JSpec
    from repro_torch.eval import QualityRun, QualitySpec
    from test_torch_bridge import params_source
    data, queries = small
    qkw = dict(k=8, candidate_cap=32, num_hashes_rw=8, rerank_chunk=128)
    jrun = JRun(data, queries, 64, JSpec(**qkw))
    trun = QualityRun(data, queries, 64, QualitySpec(**qkw), device="cpu",
                      params_fn=params_source(jrun.key))
    cfg = trun.scheme_config("mp-rw-lsh", 4, 20)
    got = trun.check_cluster(cfg)
    assert got["cluster_matches_flat"] and got["cluster_recovery_matches_flat"]
    assert got == jrun.check_cluster(jrun.scheme_config("mp-rw-lsh", 4, 20))
    with pytest.raises(ValueError, match="unknown transport"):
        trun.check_cluster(cfg, transport="carrier")
