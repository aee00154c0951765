"""The port's process transport (``repro_torch.cluster``: ``shm``,
``transport``, ``worker``, ``remote`` and the router's ``'process'`` and
``'tcp'`` transports) on the CPU, with every worker's engine on the CPU.

The cases of tests/test_transport.py and tests/test_shm.py on the port,
under the same names, and parity with the JAX package:
  * frames are byte for byte the JAX package's: a frame either package
    sends is read by the other, and ``pack_records`` gives the same arrays;
  * a ``RemoteReplica`` equals a ``ShardReplica``, before and after an
    insert and through a SIGKILL and respawn;
  * a 2 x 2 router over worker processes ('process' and 'tcp') equals the
    JAX router under bridged parameters and the flat index, through a
    SIGKILL, failover, mutations and recovery;
  * the SIGKILL-under-shm drill leaves no slab with the port's prefix, and
    the port never creates a slab under the JAX package's prefix;
  * ``QualityRun.check_cluster(transport='process')`` and the
    ``cluster_serve`` launcher.

Every test of the port that spawns workers or creates slabs is in this file,
so that they run one after the other (``--dist loadfile``) and the /dev/shm
baseline checks see only this file's slabs under the port's prefix.
"""
import dataclasses
import gc
import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import cluster as jcl
from repro.cluster import shm as jshm
from repro.cluster import transport as jtr
from repro.cluster import worker as jworker
from repro.core import index as jidx
from repro.serve.engine import ServeConfig as JServe
from repro_torch.analysis.racecheck import RaceViolation
from repro_torch.cluster import (ClusterConfig, ClusterRouter, OP_DELETE, OP_INSERT,
                                 RemoteReplica, ShardReplica, WalRecord)
from repro_torch.cluster import shm
from repro_torch.cluster.replica import ReplicaDiverged, ReplicaKilled
from repro_torch.cluster.transport import (KIND_ERROR, KIND_REQUEST, KIND_RESPONSE,
                                           REL_SENDER, SHM_META_KEY, WIRE_DTYPES,
                                           Connection, RemoteError, connect_tcp,
                                           listen_tcp, recv_frame, send_frame)
from repro_torch.cluster.worker import (pack_params, pack_records, unpack_params,
                                        unpack_records)
from repro_torch.core import hashes as th
from repro_torch.core.index import IndexConfig, build_index, make_params, query_index
from repro_torch.data import ann_synthetic as ds
from repro_torch.serve.engine import AnnServingEngine, ServeConfig
from test_torch_bridge import bridged

torch.set_num_threads(1)

SEED = 0
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    # each worker process is a torch of its own: one intra-op thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def cfg():
    # non-truncating candidate_cap at this n: flat == sharded, bit for bit
    return IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=20,
                       candidate_cap=256, universe=64, k=8, rerank_chunk=128)


@pytest.fixture(scope="module")
def small():
    spec = ds.DatasetSpec("transport-t", n=400, dim=16, universe=64,
                          num_clusters=8)
    data = np.asarray(ds.make_dataset(spec))
    queries = np.asarray(ds.make_queries(spec, data, 16))
    return data, queries


def serve_cfg(**kw):
    kw.setdefault("batch_size", 16)
    kw.setdefault("delta_cap", 128)
    return ServeConfig(**kw)


# ----------------------------------------------------------- frame codec


def _roundtrip(meta, arrays, send=send_frame, recv=recv_frame):
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    # send from a thread: a frame larger than the socketpair buffer would
    # deadlock a synchronous send with nobody draining the other end
    t = threading.Thread(target=send, args=(a, KIND_REQUEST, 7, meta, arrays))
    t.start()
    try:
        kind, rid, rmeta, rarrays = recv(b)
    finally:
        t.join()
        a.close()
        b.close()
    assert (kind, rid) == (KIND_REQUEST, 7)
    return rmeta, rarrays


def test_frame_roundtrip_small_coalesced():
    meta = {"method": "query", "n_real": 3, "nested": {"x": [1, 2]}}
    arrays = [np.arange(12, dtype=np.int32).reshape(3, 4),
              np.array([1.5, -2.5], np.float64),
              np.zeros((0, 5), np.int64),            # empty is legal
              np.array([True, False]),
              np.arange(6, dtype=np.uint8)]
    rmeta, rarrays = _roundtrip(meta, arrays)
    assert rmeta == meta
    assert len(rarrays) == len(arrays)
    for sent, got in zip(arrays, rarrays):
        assert got.dtype == sent.dtype and got.shape == sent.shape
        assert not got.flags.owndata                # a view of the receive buffer
        np.testing.assert_array_equal(got, sent)


def test_frame_roundtrip_large_vectored():
    # well past _COALESCE_BYTES: the vectored sendall path
    big = np.arange(300 * 300, dtype=np.int64).reshape(300, 300)
    rmeta, (got,) = _roundtrip({"seq": 9}, [big])
    assert rmeta == {"seq": 9}
    np.testing.assert_array_equal(got, big)


def test_frame_rejects_off_whitelist_dtype():
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        with pytest.raises(TypeError, match="whitelist"):
            send_frame(a, KIND_REQUEST, 1, {}, [np.zeros(3, np.float16)])
    finally:
        a.close()
        b.close()


def test_codec_accepts_exactly_the_wire_whitelist():
    """Every whitelisted dtype round-trips, every other numpy scalar dtype
    is refused at encode time, and the whitelist is the JAX package's, in
    its order (codes are tuple positions)."""
    assert WIRE_DTYPES == jtr.WIRE_DTYPES == tuple(np.dtype(t) for t in (
        np.int32, np.int64, np.uint32, np.uint64, np.float32, np.float64,
        np.uint8, np.int8, np.int16, np.uint16, np.bool_))
    for dt in WIRE_DTYPES:
        arr = np.ones((3,), dt)
        _, (got,) = _roundtrip({}, [arr])
        assert got.dtype == dt
        np.testing.assert_array_equal(got, arr)
    complement = {np.dtype(t) for t in np.sctypeDict.values()
                  if np.dtype(t).kind not in "OMm"} - set(WIRE_DTYPES)
    assert np.dtype(np.float16) in complement
    for dt in sorted(complement, key=str):
        a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            with pytest.raises(TypeError, match="whitelist"):
                send_frame(a, KIND_REQUEST, 1, {}, [np.zeros(2, dt)])
        finally:
            a.close()
            b.close()


def _garbage_cases(pair):
    """Bad magic, an implausible length and a peer dying mid-frame, each
    over a fresh connected pair; every one surfaces as ConnectionError."""
    for blob, match in ((np.uint64(14).tobytes() + b"\x00" * 14, "magic"),
                        (np.uint64(1 << 60).tobytes(), "implausible"),
                        (np.uint64(100).tobytes() + b"\x01" * 10, "mid-frame")):
        a, b = pair()
        a.sendall(blob)
        if match == "mid-frame":
            a.close()
        with pytest.raises(ConnectionError, match=match):
            recv_frame(b)
        a.close()
        b.close()


def test_frame_rejects_garbage_and_truncation():
    _garbage_cases(lambda: socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM))


# ------------------------------------------------ frame codec over TCP


def _tcp_pair():
    """A connected (client, server) AF_INET loopback socket pair."""
    srv = listen_tcp("127.0.0.1", 0)
    host, port = srv.getsockname()[:2]
    client = connect_tcp(host, port, timeout_s=10.0)
    peer, _ = srv.accept()
    srv.close()
    return client, peer


def _capture_frame(meta, arrays, kind=KIND_REQUEST, rid=5, send=send_frame):
    """The exact wire bytes of one frame, through a drained socketpair."""
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    t = threading.Thread(target=send, args=(a, kind, rid, meta, arrays))
    t.start()
    try:
        hdr = bytearray()
        while len(hdr) < 8:
            hdr += b.recv(8 - len(hdr))
        n = int(np.frombuffer(bytes(hdr), np.uint64)[0])
        body = bytearray()
        while len(body) < n:
            body += b.recv(min(1 << 16, n - len(body)))
    finally:
        t.join()
        a.close()
        b.close()
    return bytes(hdr) + bytes(body)


def test_tcp_partial_recv_at_every_split_point():
    """``recv_frame`` reassembles a frame wherever the stream splits: the
    same frame over loopback TCP once per byte boundary, in two halves."""
    meta = {"method": "query", "n_real": 3}
    arrays = [np.arange(10, dtype=np.int32), np.array([True, False, True])]
    blob = _capture_frame(meta, arrays)
    cuts = range(1, len(blob))
    client, peer = _tcp_pair()
    got, errs = [], []

    def reader():
        try:
            for _ in cuts:
                got.append(recv_frame(peer))
        except Exception as exc:            # surfaced on the main thread
            errs.append(exc)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for cut in cuts:
            client.sendall(blob[:cut])
            time.sleep(0.001)               # let the first half land alone
            client.sendall(blob[cut:])
        t.join(timeout=60)
    finally:
        client.close()
        peer.close()
    assert not errs, errs
    assert len(got) == len(cuts)
    for kind, rid, rmeta, rarrays in got:
        assert (kind, rid, rmeta) == (KIND_REQUEST, 5, meta)
        np.testing.assert_array_equal(rarrays[0], arrays[0])
        np.testing.assert_array_equal(rarrays[1], arrays[1])


def test_tcp_large_vectored_frame():
    big = np.arange(300 * 300, dtype=np.int64).reshape(300, 300)
    client, peer = _tcp_pair()
    t = threading.Thread(target=send_frame,
                         args=(client, KIND_REQUEST, 3, {"seq": 1}, [big]))
    t.start()
    try:
        kind, rid, rmeta, (got,) = recv_frame(peer)
    finally:
        t.join()
        client.close()
        peer.close()
    assert (kind, rid, rmeta) == (KIND_REQUEST, 3, {"seq": 1})
    np.testing.assert_array_equal(got, big)


def test_tcp_rejects_garbage_and_truncation():
    _garbage_cases(_tcp_pair)


def _serve_one(sock, reply):
    """Minimal single-request server half."""
    conn = Connection(sock)
    rid, method, meta, arrays = conn.recv_request()
    reply(conn, rid, method, meta, arrays)


def _error_and_echo(pair, cases):
    for exc, expect in cases:
        client, peer = pair()
        t = threading.Thread(target=_serve_one, args=(
            peer, lambda c, rid, *_: c.respond_error(rid, exc)))
        t.start()
        conn = Connection(client, timeout_s=10.0)
        with pytest.raises(expect, match=r"\[worker\]"):
            conn.request("boom")
        t.join()
        conn.close()
        peer.close()
    client, peer = pair()
    t = threading.Thread(target=_serve_one, args=(
        peer, lambda c, rid, method, meta, arrays: c.respond(
            rid, {"method_seen": method, **meta}, arrays)))
    t.start()
    conn = Connection(client, timeout_s=10.0)
    sent = np.arange(5, dtype=np.int32)
    meta, (got,) = conn.request("echo", {"x": 3}, [sent])
    assert meta == {"method_seen": "echo", "x": 3}
    np.testing.assert_array_equal(got, sent)
    t.join()
    conn.close()
    peer.close()


def test_tcp_typed_error_and_echo_roundtrip():
    _error_and_echo(_tcp_pair, [(ReplicaKilled("gone"), ReplicaKilled),
                                (ValueError("bad dim"), ValueError),
                                (ArithmeticError("weird"), RemoteError)])


def test_tcp_connect_retries_until_listener_binds():
    """Connection refused at connect time means the worker has not bound
    yet: ``connect_tcp`` retries past it."""
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()                           # port free: refused until bound
    accepted = []

    def late_listener():
        time.sleep(0.4)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(1)
        peer, _ = srv.accept()
        accepted.append(peer)
        srv.close()

    t = threading.Thread(target=late_listener)
    t.start()
    client = connect_tcp("127.0.0.1", port, timeout_s=10.0)
    t.join()
    assert accepted
    client.close()
    accepted[0].close()


# ------------------------------------------------- request/response pairing


def test_connection_roundtrip_and_error_mapping():
    """The worker's exceptions re-raise as the port's classes (the race
    sanitizer's ``RaceViolation`` included); an unknown class as
    ``RemoteError``."""
    _error_and_echo(lambda: socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM),
                    [(ReplicaKilled("gone"), ReplicaKilled),
                     (ReplicaDiverged("fork"), ReplicaDiverged),
                     (RaceViolation("overlap"), RaceViolation),
                     (ValueError("bad dim"), ValueError),
                     (ArithmeticError("weird"), RemoteError)])


def test_connection_detects_mispaired_response_id():
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    t = threading.Thread(target=_serve_one, args=(
        b, lambda c, rid, *_: send_frame(c.sock, KIND_RESPONSE, rid + 99, {})))
    t.start()
    client = Connection(a, timeout_s=10.0)
    with pytest.raises(ConnectionError, match="response id"):
        client.request("ping")
    t.join()
    client.close()
    b.close()


def _records():
    return [WalRecord(seq=3, op=OP_INSERT, gids=np.array([4, 5], np.int32),
                      points=np.arange(8, dtype=np.int32).reshape(2, 4)),
            WalRecord(seq=4, op=OP_DELETE, gids=np.array([4], np.int32))]


def test_pack_unpack_records_roundtrip():
    recs = _records()
    meta, arrays = pack_records(recs)
    out = unpack_records(meta, [a.copy() for a in arrays])
    assert [(r.seq, r.op) for r in out] == [(3, OP_INSERT), (4, OP_DELETE)]
    np.testing.assert_array_equal(out[0].gids, recs[0].gids)
    np.testing.assert_array_equal(out[0].points, recs[0].points)
    np.testing.assert_array_equal(out[1].gids, recs[1].gids)
    assert out[1].points is None
    # unpacked arrays are the process's own, not views of a wire buffer
    _, (view,) = _roundtrip({}, [arrays[1]])
    (rec,) = unpack_records({"records": [{"seq": 1, "op": OP_DELETE, "pts": False}]},
                            [view])
    assert rec.gids.flags.writeable and rec.gids.base is None


# ------------------------------------------------ parity with the JAX package


FRAMES = {
    "request": (KIND_REQUEST, {"method": "query", "n_real": 3,
                               "trace": {"tid": "ab12", "sid": 7}},
                [np.arange(12, dtype=np.int32).reshape(3, 4),
                 np.array([True, False]), np.zeros((0, 2), np.int8)]),
    "response": (KIND_RESPONSE, {}, [np.arange(64, dtype=np.int32).reshape(8, 8),
                                     np.full((8, 8), -1, np.int32)]),
    "large": (KIND_REQUEST, {"seq": 2},
              [np.arange(300 * 300, dtype=np.int64).reshape(300, 300)]),
    "error": (KIND_ERROR, {"etype": "ReplicaKilled", "emsg": "gone"}, []),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_are_the_jax_packages_byte_for_byte(name):
    """Both packages put the same bytes on the wire for the same frame."""
    kind, meta, arrays = FRAMES[name]
    assert (_capture_frame(meta, arrays, kind=kind, send=send_frame)
            == _capture_frame(meta, arrays, kind=kind, send=jtr.send_frame))


@pytest.mark.parametrize("sender", ["repro", "repro_torch"])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_cross_the_packages(sender, name):
    """A frame one package sends, the other reads: the same kind, id, meta
    and arrays."""
    kind, meta, arrays = FRAMES[name]
    send, recv = ((jtr.send_frame, recv_frame) if sender == "repro"
                  else (send_frame, jtr.recv_frame))
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    t = threading.Thread(target=send, args=(a, kind, 11, meta, arrays))
    t.start()
    try:
        rkind, rid, rmeta, rarrays = recv(b)
    finally:
        t.join()
        a.close()
        b.close()
    assert (rkind, rid, rmeta) == (kind, 11, meta)
    assert len(rarrays) == len(arrays)
    for sent, got in zip(arrays, rarrays):
        assert got.dtype == sent.dtype
        np.testing.assert_array_equal(got, sent)


@pytest.mark.parametrize("sender", ["repro", "repro_torch"])
def test_slab_frames_cross_the_packages(sender):
    """The slab descriptors under ``shmv`` are the same too: a request one
    package stages in a ring maps back through the other's reader.  The
    ring is the port's either way (no ``rwshm-`` slab is made here)."""
    send, recv, reader = (
        (jtr.send_frame, recv_frame, shm.SlabReader()) if sender == "repro"
        else (send_frame, jtr.recv_frame, jshm.SlabReader()))
    ring = shm.SlabRing(slots=2, slot_bytes=1 << 16, tag="x")
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    big = np.arange(512, dtype=np.int32).reshape(8, 64)
    try:
        t = threading.Thread(target=send, args=(a, KIND_REQUEST, 2, {"m": 1}, [big]),
                             kwargs={"shm_tx": ring, "shm_threshold": 256})
        t.start()
        kind, rid, meta, (got,) = recv(b, reader)
        t.join()
        assert (kind, rid, meta) == (KIND_REQUEST, 2, {"m": 1})
        np.testing.assert_array_equal(got, big)
        del got
    finally:
        reader.close()
        a.close()
        b.close()
        ring.close()


def test_pack_records_equal_across_the_packages():
    """``pack_records`` gives the JAX package's meta and arrays, and each
    package unpacks the other's."""
    recs = _records()
    meta, arrays = pack_records(recs)
    jmeta, jarrays = jworker.pack_records(recs)
    assert meta == jmeta and len(arrays) == len(jarrays)
    for a, b in zip(arrays, jarrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for out in (unpack_records(jmeta, jarrays), jworker.unpack_records(meta, arrays)):
        assert [(r.seq, r.op) for r in out] == [(r.seq, r.op) for r in recs]
        np.testing.assert_array_equal(out[0].points, recs[0].points)


@pytest.mark.parametrize("family", ["rw", "cauchy", "gaussian"])
def test_params_cross_the_wire(family):
    """``pack_params`` / ``unpack_params`` carry every leaf: the rebuilt
    parameters fingerprint as the sent ones, through a real frame."""
    cfg = IndexConfig(num_tables=3, num_hashes=5, width=24, universe=32, family=family)
    params = make_params(cfg, 6, seed=3)
    meta, arrays = pack_params(params)
    rmeta, rarrays = _roundtrip({"params": meta}, arrays)
    back = unpack_params(rmeta["params"], rarrays, "cpu")
    assert back.family == family and back.width == params.width
    assert th.params_fingerprint(back) == th.params_fingerprint(params)
    assert back.offsets.numpy().flags.writeable     # the worker's own copy


# ------------------------------------------------------------- SlabRing


def test_slab_ring_claim_release_cycle():
    ring = shm.SlabRing(slots=3, slot_bytes=64, tag="t")
    try:
        assert ring.free_slots() == 3
        slot0, off0, view0 = ring.stage(16)
        slot1, off1, view1 = ring.stage(64)
        assert slot0 != slot1
        assert len(view0) == 16 and len(view1) == 64
        view0[:] = b"a" * 16
        view1[:] = b"b" * 64
        view0.release()
        view1.release()
        assert ring.free_slots() == 1
        assert ring.stage(65) is None       # oversize: fall back, no raise
        s2 = ring.stage(1)
        assert s2 is not None
        s2[2].release()
        assert ring.stage(1) is None        # full: fall back, no raise
        assert ring.free_slots() == 0
        ring.release(slot0)
        again = ring.stage(8)
        assert again is not None and again[0] == slot0
        again[2].release()
        ring.reset()                        # vanished-peer recovery
        assert ring.free_slots() == 3
    finally:
        ring.close()
    assert ring.name not in shm.list_slabs()
    assert ring.stage(1) is None            # closed ring: still no raise


def test_slab_ring_rejects_bad_slot_counts():
    with pytest.raises(ValueError, match="slots"):
        shm.SlabRing(slots=0)
    with pytest.raises(ValueError, match="slots"):
        shm.SlabRing(slots=256)


def test_staged_payload_refcount_retires_once():
    ring = shm.SlabRing(slots=2, slot_bytes=64, tag="t")
    try:
        slot, off, view = ring.stage(8)
        view.release()
        sp = shm.StagedPayload(ring, slot, {"seg": ring.name, "slot": slot})
        assert sp.acquire()["slot"] == slot  # send #1
        assert sp.acquire()["slot"] == slot  # send #2 (fan-out peer)
        sp.release()
        sp.release()
        assert ring.free_slots() == 1        # the stager's own ref still held
        sp.release()                         # stager retires: slot frees
        assert ring.free_slots() == 2
        with pytest.raises(RuntimeError, match="retired"):
            sp.acquire()                     # late hedge loser: fails safe
    finally:
        ring.close()


def test_slab_reader_attach_and_receiver_release():
    ring = shm.SlabRing(slots=2, slot_bytes=64, tag="t")
    reader = shm.SlabReader()
    try:
        slot, off, view = ring.stage(8)
        view[:] = bytes(range(8))
        view.release()
        got = reader.view(ring.name, off, 8)
        assert bytes(got) == bytes(range(8))
        got.release()
        assert ring.free_slots() == 1
        reader.release_slot(ring.name, slot)  # rel='r': receiver frees
        assert ring.free_slots() == 2
        reader.release_slot(shm.SHM_PREFIX + "1-gone-x", 0)  # dead owner: no raise
    finally:
        reader.close()
        ring.close()


def test_frame_shm_staging_roundtrip_and_sender_release():
    """Request direction (rel='s'): arrays over the threshold cross as
    descriptors, map back equal, and the slot frees only when the sender
    runs the returned release callbacks."""
    ring = shm.SlabRing(slots=4, slot_bytes=1 << 16, tag="t")
    reader = shm.SlabReader()
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        big = np.arange(512, dtype=np.int64).reshape(8, 64)   # staged
        tiny = np.arange(4, dtype=np.int32)                   # inline
        before = shm.wire_counters()
        releases = []
        t = threading.Thread(target=lambda: releases.extend(send_frame(
            a, KIND_REQUEST, 9, {"m": "q"}, [big, tiny],
            shm_tx=ring, shm_threshold=256)))
        t.start()
        kind, rid, meta, arrays = recv_frame(b, shm_reader=reader)
        t.join()
        assert (kind, rid, meta) == (KIND_REQUEST, 9, {"m": "q"})
        np.testing.assert_array_equal(arrays[0], big)
        np.testing.assert_array_equal(arrays[1], tiny)
        delta = {k: shm.wire_counters().get(k, 0) - before.get(k, 0)
                 for k in ("shm_payload_tx_bytes", "socket_payload_tx_bytes")}
        assert delta == {"shm_payload_tx_bytes": big.nbytes,
                         "socket_payload_tx_bytes": tiny.nbytes}
        del arrays
        gc.collect()
        assert ring.free_slots() == 3
        assert len(releases) == 1
        releases[0]()
        assert ring.free_slots() == 4
    finally:
        reader.close()
        a.close()
        b.close()
        ring.close()


def test_frame_shm_receiver_release_on_view_death():
    """Response direction (rel='r'): the borrowed view frees its slot when
    the last reference dies."""
    ring = shm.SlabRing(slots=2, slot_bytes=1 << 16, tag="t")
    reader = shm.SlabReader()
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        payload = np.arange(1024, dtype=np.float64)
        t = threading.Thread(target=send_frame, args=(a, KIND_RESPONSE, 1, {}, [payload]),
                             kwargs={"shm_tx": ring, "shm_threshold": 64})
        t.start()
        kind, rid, meta, (got,) = recv_frame(b, shm_reader=reader)
        t.join()
        np.testing.assert_array_equal(got, payload)
        assert ring.free_slots() == 1        # borrowed
        result = got.sum()
        del got
        gc.collect()
        assert ring.free_slots() == 2        # the finalizer freed the slot
        assert result == payload.sum()
    finally:
        reader.close()
        a.close()
        b.close()
        ring.close()


def test_frame_shm_full_ring_falls_back_to_socket():
    ring = shm.SlabRing(slots=1, slot_bytes=1 << 12, tag="t")
    reader = shm.SlabReader()
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        claimed = ring.stage(8)              # occupy the only slot
        claimed[2].release()
        payload = np.arange(256, dtype=np.int64)
        before = shm.wire_counters()
        t = threading.Thread(target=send_frame, args=(a, KIND_REQUEST, 2, {}, [payload]),
                             kwargs={"shm_tx": ring, "shm_threshold": 64})
        t.start()
        kind, rid, meta, (got,) = recv_frame(b, shm_reader=reader)
        t.join()
        np.testing.assert_array_equal(got, payload)
        after = shm.wire_counters()
        assert (after.get("shm_stage_fallbacks", 0)
                - before.get("shm_stage_fallbacks", 0)) == 1
        assert (after.get("socket_payload_tx_bytes", 0)
                - before.get("socket_payload_tx_bytes", 0)) == payload.nbytes
    finally:
        reader.close()
        a.close()
        b.close()
        ring.close()


def test_frame_shm_missing_segment_raises_connection_error():
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    reader = shm.SlabReader()
    try:
        meta = {SHM_META_KEY: [{"i": 0, "seg": shm.SHM_PREFIX + "1-gone-dead",
                                "slot": 0, "off": 1, "dt": 0, "sh": [4],
                                "rel": REL_SENDER}]}
        t = threading.Thread(target=send_frame, args=(a, KIND_REQUEST, 3, meta, []))
        t.start()
        with pytest.raises(ConnectionError):
            recv_frame(b, shm_reader=reader)
        t.join()
    finally:
        reader.close()
        a.close()
        b.close()


def _dead_pid() -> int:
    """The pid of a process that has already exited."""
    probe = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                           capture_output=True, text=True, check=True)
    return int(probe.stdout)


def test_slab_prefix_is_the_ports_own():
    """The port's slabs are ``rwtshm-``, which the JAX package neither lists
    nor reaps (the JAX package's tests, running beside the port's, hold the
    ``rwshm-`` population to a baseline, so this test makes no slab under
    that prefix)."""
    assert shm.SHM_PREFIX == "rwtshm-" and not shm.SHM_PREFIX.startswith(jshm.SHM_PREFIX)
    ring = shm.SlabRing(slots=1, slot_bytes=64, tag="p")
    orphan = os.path.join(shm.SHM_DIR, f"{shm.SHM_PREFIX}{_dead_pid()}-wtx-0badf00d")
    try:
        assert ring.name.startswith(shm.SHM_PREFIX)
        assert ring.name in shm.list_slabs() and ring.name not in jshm.list_slabs()
        with open(orphan, "wb") as f:
            f.write(b"\x00" * 64)
        assert os.path.basename(orphan) not in jshm.reap_orphan_slabs()
        assert os.path.exists(orphan)
        assert os.path.basename(orphan) in shm.reap_orphan_slabs()
        assert not os.path.exists(orphan)
    finally:
        ring.close()
        if os.path.exists(orphan):
            os.unlink(orphan)


def test_reap_orphan_slabs_spares_live_owners(tmp_path):
    """The reaper unlinks dead-owner segments only."""
    ours = shm.SlabRing(slots=2, slot_bytes=64, tag="keep")
    orphan = f"{shm.SHM_PREFIX}{_dead_pid()}-wtx-deadbeef"
    path = os.path.join(shm.SHM_DIR, orphan)
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    try:
        reaped = shm.reap_orphan_slabs()
        assert orphan in reaped
        assert not os.path.exists(path)
        assert ours.name in shm.list_slabs()
        assert ours.free_slots() == 2
    finally:
        ours.close()
        if os.path.exists(path):
            os.unlink(path)
    assert ours.name not in shm.list_slabs()


# --------------------------------------------- worker process integration


def test_remote_replica_bit_identical_and_sigkill_recovery(cfg, small, tmp_path):
    """One worker process == one in-process replica, bit for bit: the same
    answers and the same mutation; a SIGKILL and respawn recovers the
    acknowledged state from its own snapshot and WAL; typed errors cross
    the wire; the telemetry reports the worker's device and launches."""
    data, queries = small
    local = ShardReplica(0, 0, cfg, serve_cfg(), SEED, str(tmp_path / "local"), data,
                         wal_fsync=False, device="cpu")
    remote = RemoteReplica(0, 0, cfg, serve_cfg(), SEED, str(tmp_path / "remote"), data,
                           wal_fsync=False, device="cpu")

    def same():
        ld, li = local.query(queries, queries.shape[0])
        rd, ri = remote.query(queries, queries.shape[0])
        assert rd.dtype == ri.dtype == np.int32
        np.testing.assert_array_equal(ld.numpy(), rd)
        np.testing.assert_array_equal(li.numpy(), ri)

    try:
        same()
        rec = WalRecord(seq=1, op=OP_INSERT,
                        gids=np.arange(local.next_gid, local.next_gid + 4, dtype=np.int32),
                        points=(queries[:4] + 1).astype(np.int32))
        local.log_and_apply(rec)
        remote.log_and_apply(rec)
        assert remote.last_seq == local.last_seq == 1
        assert remote.next_gid == local.next_gid
        assert remote.num_live == local.num_live
        same()
        tel = remote.telemetry()
        assert tel["device"] == "cpu" and set(tel["launches"]) >= {"fused_rerank"}
        assert len(tel["engine_batch_ms"]) >= 1

        remote.handle.sigkill()             # an unannounced process death
        with pytest.raises(ReplicaKilled):
            remote.query(queries, queries.shape[0])
        assert remote.recover() >= 1        # respawn + WAL replay from disk
        same()

        bad = WalRecord(seq=2, op=OP_INSERT, gids=np.array([999999], np.int32),
                        points=queries[:1].astype(np.int32))
        with pytest.raises(ReplicaDiverged):
            remote.log_and_apply(bad)
    finally:
        local.close()
        remote.close()


def test_worker_asked_for_the_card_without_one_raises(cfg, small, tmp_path, monkeypatch):
    """A worker whose ``device`` is ``cuda`` where no card is visible
    fails its ``init``; the proxy raises with the worker's log tail (the
    worker's own traceback) and stops the process."""
    data, _ = small
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    spawned = []
    orig = subprocess.Popen

    def popen(*a, **kw):
        spawned.append(orig(*a, **kw))
        return spawned[-1]

    monkeypatch.setattr(subprocess, "Popen", popen)
    with pytest.raises(RuntimeError, match="failed to init") as err:
        RemoteReplica(0, 0, cfg, serve_cfg(), SEED, str(tmp_path / "r"), data,
                      wal_fsync=False, device="cuda")
    assert "--- worker log ---" in str(err.value)
    assert "no CUDA device is available" in str(err.value).split("--- worker log ---")[1]
    assert len(spawned) == 1 and spawned[0].wait(timeout=30) is not None


def _jax_router(cfg, data, root, **ccfg):
    jcfg = jidx.IndexConfig(**dataclasses.asdict(cfg))
    params = bridged(jidx.make_params(jcfg, KEY, data.shape[1]))
    router = jcl.ClusterRouter(jcfg, JServe(batch_size=16, delta_cap=128),
                               jcl.ClusterConfig(**ccfg), data, root, key=KEY)
    return router, (lambda c, d: params)


def _pids(router):
    return {rep.handle.proc.pid for g in router.replicas for rep in g
            if rep.handle.proc is not None}


@pytest.mark.parametrize("transport", ["process", "tcp"])
def test_process_router_matches_flat_and_survives_sigkill(transport, cfg, small, tmp_path):
    """2 x 2 worker processes answer as the flat index and as the JAX
    router under bridged parameters, bit for bit: fresh; after an
    unannounced SIGKILL (failover, no drop); after mutations while the
    worker is dead; and after its respawn, recovery and peer catch-up, with
    the recovered worker serving (its peer killed)."""
    data, queries = small
    ccfg = dict(hedge_ms=60000, wal_fsync=False, cache_capacity=0)
    jr, params_fn = _jax_router(cfg, data, str(tmp_path / "j"), **ccfg)
    tr = ClusterRouter(cfg, serve_cfg(),
                       ClusterConfig(transport=transport, pipeline_depth=2, **ccfg),
                       data, str(tmp_path / "t"), params_fn=params_fn, device="cpu")
    flat_cfg_state = build_index(cfg, torch.from_numpy(data), params=params_fn(cfg, 16))
    fd, fi = (t.numpy() for t in query_index(cfg, flat_cfg_state, torch.from_numpy(queries)))

    def same(stage):
        (jd, ji), (td, ti) = jr.query(queries), tr.query(queries)
        np.testing.assert_array_equal(jd, td, err_msg=stage)
        np.testing.assert_array_equal(ji, ti, err_msg=stage)

    try:
        td, ti = tr.query(queries)
        np.testing.assert_array_equal(td, fd)
        np.testing.assert_array_equal(ti, fi)
        same("fresh")
        assert all(isinstance(rep, RemoteReplica) for g in tr.replicas for rep in g)
        assert tr.summary()["wire"]["socket_payload_rx_bytes"] > 0

        tr.replicas[0][0].handle.sigkill()  # crash without telling the router
        tr._rr[0] = 0                       # the dead worker is preferred next
        jr.kill_replica(0, 0)
        same("worker SIGKILL'd, failover")
        assert tr.summary()["failovers"] >= 1

        rng = np.random.default_rng(3)
        new = (rng.integers(0, 32, (12, data.shape[1])) * 2).astype(np.int32)
        for r in (jr, tr):
            g = r.insert(new)
            r.delete([int(g[3]), 1, 3])
        assert jr.next_gid == tr.next_gid
        same("mutations while the worker is dead")

        infos = [r.recover_replica(0, 0) for r in (jr, tr)]
        assert infos[0] == infos[1] and infos[1]["caught_up"] >= 1
        for r in (jr, tr):
            r.kill_replica(0, 1)
        same("recovered worker serving")
        assert tr.summary()["recoveries"] == jr.summary()["recoveries"] == 1
    finally:
        jr.close()
        tr.close()


def _foreign_slabs(mod, baseline, pids=None):
    """Slabs under ``mod``'s prefix that appeared since ``baseline`` and
    belong to a dead owner (or, with ``pids``, to one of those pids)."""
    out = []
    for fn in set(mod.list_slabs()) - baseline:
        try:
            pid = int(fn[len(mod.SHM_PREFIX):].split("-")[0])
        except ValueError:
            continue
        if pids is not None:
            if pid in pids:
                out.append(fn)
            continue
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            out.append(fn)
    return out


def test_sigkill_under_shm_reaps_slab_and_stays_identical(cfg, small, tmp_path):
    """A worker SIGKILL'd while slow mid-query, its request slot claimed and
    its response never coming, leaks nothing: the hedged re-issue answers
    bit for bit, the recovery reaps the dead worker's ring, after
    ``close()`` the port's /dev/shm population is the baseline again, and
    no slab under the JAX package's prefix was ever made by this process or
    its workers."""
    data, queries = small
    shm.reap_orphan_slabs()                 # start from a clean room
    baseline = set(shm.list_slabs())
    jax_baseline = set(jshm.list_slabs())
    pids = {os.getpid()}
    router = ClusterRouter(
        cfg, serve_cfg(),
        ClusterConfig(num_shards=2, num_replicas=2, transport="process",
                      hedge_ms=200.0, wal_fsync=False, cache_capacity=0,
                      shm_threshold_bytes=64),
        data, str(tmp_path), device="cpu")
    try:
        d0, i0 = router.query(queries)      # warm: slabs mapped both ways
        pids |= _pids(router)
        ours = _foreign_slabs(shm, baseline, pids)
        assert len(ours) == 5               # the router's ring + one a worker
        assert router.summary()["wire"]["shm_payload_tx_bytes"] > 0

        victim = router.replicas[0][0]
        victim.slow_ms = 30000.0
        router._rr[0] = 0                   # the victim is preferred next
        done = threading.Event()

        def kill_mid_query():
            time.sleep(0.6)                 # while the victim sleeps in its handler
            victim.handle.sigkill()
            done.set()

        killer = threading.Thread(target=kill_mid_query)
        killer.start()
        d1, i1 = router.query(queries)      # the hedge fires at 200 ms
        killer.join()
        assert done.is_set()
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(i1, i0)
        assert router.summary()["hedged_batches"] >= 1

        router.recover_replica(0, 0)        # respawn + reap the orphan ring
        pids |= _pids(router)
        assert _foreign_slabs(shm, baseline) == []
        d2, i2 = router.query(queries)
        np.testing.assert_array_equal(d2, d0)
        np.testing.assert_array_equal(i2, i0)
    finally:
        router.close()
    shm.reap_orphan_slabs()
    assert set(shm.list_slabs()) == baseline
    assert _foreign_slabs(jshm, jax_baseline, pids) == []


def test_check_cluster_process_matches_the_jax_package(small):
    """``QualityRun.check_cluster(transport='process')`` on the port: both
    flags hold and the dict is the JAX package's (the JAX package's own
    tests hold its process oracle to its in-process one), transport field
    included."""
    from repro.eval import QualityRun as JRun
    from repro.eval import QualitySpec as JSpec
    from repro_torch.eval import QualityRun, QualitySpec
    from test_torch_bridge import params_source
    data, queries = small
    qkw = dict(k=8, candidate_cap=32, num_hashes_rw=8, rerank_chunk=128)
    jrun = JRun(data, queries, 64, JSpec(**qkw))
    trun = QualityRun(data, queries, 64, QualitySpec(**qkw), device="cpu",
                      params_fn=params_source(jrun.key))
    got = trun.check_cluster(trun.scheme_config("mp-rw-lsh", 4, 20), transport="process")
    assert got["cluster_matches_flat"] and got["cluster_recovery_matches_flat"]
    want = jrun.check_cluster(jrun.scheme_config("mp-rw-lsh", 4, 20))
    assert got == {**want, "cluster_transport": "process"}


def test_cluster_serve_launcher_prints_its_json(capsys):
    """``launch.cluster_serve --device cpu --workers 2 --chaos`` at a small
    size: the SIGKILL'd worker's queries fail over bit for bit, the
    supervisor restarts it, and the summary carries the wire counters."""
    from repro_torch.launch import cluster_serve
    cluster_serve.main(["--device", "cpu", "--n", "2000", "--dim", "16",
                        "--queries", "32", "--batch", "16", "--workers", "2",
                        "--chaos"])
    out = json.loads(capsys.readouterr().out)
    assert out["transport"] == "process" and out["device"] == "cpu"
    assert out["chaos_identical"] is True
    assert out["supervisor_restarted"] == [[0, 0]]
    assert out["recall"] > 0.5 and out["failovers"] >= 1 and out["recoveries"] == 1
    assert out["wire"]["shm_payload_tx_bytes"] > 0
