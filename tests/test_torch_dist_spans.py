"""The distributed index's spans and exchange counters on four gloo rank
processes on the CPU, at tests/test_torch_dist.py's data and config, for
each merge: every ``dist_*`` span under ``dist_query`` (or ``dist_build``),
the ``dist_exchange`` spans' bytes summing to what ``Exchange.sent_bytes``
gained, one span a collective made, the slab's slots, the shard's index
bytes, the same spans as ``repro.*`` profiler ranges with tracing off, and
the answers bit for bit alike with tracing off and on and equal to the JAX
package's."""
import jax
import numpy as np
import pytest
import torch

from repro.core import index as jidx
from repro.data import ann_synthetic as ds
from repro_torch.core.index import IndexConfig
from repro_torch.launch import dist_index as di
from test_torch_bridge import bridged
from test_torch_dist import CFG, SPEC, _jax_process
from torch_dist_span_cases import traced_merges

torch.set_num_threads(1)

JAX_RUNS = {f"rows4_{m}": ((4, 1), m, None, None) for m in di.MERGES}
QUERIES = 16
Q_LOCAL = QUERIES           # a (4, 1) mesh: every rank answers the whole batch
SLAB = CFG["num_tables"] * (CFG["num_probes"] + 1) * CFG["candidate_cap"]
# per merge: (collective, calls) on the query path, and the fold's steps
EXCHANGES = {"allgather": ("all_gather", 1), "ring": ("shift", 3), "tree": ("shift", 2)}
CHILDREN = {"dist_probe", "dist_rerank", "dist_exchange", "dist_fold"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the JAX package's npz, each rank's records)."""
    tmp = tmp_path_factory.mktemp("dist_spans")
    proc = _jax_process(tmp / "rows4.npz", JAX_RUNS, False)
    try:
        data = ds.make_dataset(SPEC)
        queries = ds.make_queries(SPEC, data, QUERIES)
        params = bridged(jidx.make_params(jidx.IndexConfig(**CFG), jax.random.PRNGKey(0),
                                          SPEC.dim))
        reports = di.spawn_ranks(4, traced_merges, data, queries, IndexConfig(**CFG), params,
                                 str(tmp / "spans"), backend="gloo", device="cpu",
                                 timeout_s=120)
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return dict(np.load(tmp / "rows4.npz")), [rep["result"] for rep in reports]


def _by_id(spans):
    return {s["sid"]: s for s in spans}


@pytest.mark.parametrize("merge", di.MERGES)
def test_every_dist_span_sits_under_dist_query(ranks, merge):
    _, recs = ranks
    collective, calls = EXCHANGES[merge]
    for rec in recs:
        spans = rec[merge]["spans"]
        roots = [s for s in spans if s["psid"] is None]
        assert [s["name"] for s in roots] == ["dist_query"]
        ids = _by_id(spans)
        kids = [s for s in spans if s["psid"] is not None]
        assert {s["name"] for s in kids} == CHILDREN
        assert all(ids[s["psid"]]["name"] == "dist_query" for s in kids)
        assert len({s["tid"] for s in spans}) == 1
        names = [s["name"] for s in kids]
        assert names.count("dist_exchange") == calls
        assert names.count("dist_fold") == (1 if merge == "allgather" else calls)
        assert names.count("dist_probe") == names.count("dist_rerank") == 1
        assert all(s["args"]["collective"] == collective
                   for s in kids if s["name"] == "dist_exchange")


@pytest.mark.parametrize("merge", di.MERGES)
def test_exchange_bytes_and_counts_match_the_counters(ranks, merge):
    _, recs = ranks
    calls = EXCHANGES[merge][1]
    for rec in recs:
        r = rec[merge]
        b0, b1 = r["before"], r["after"]
        sent = [s["args"]["bytes"] for s in r["spans"] if s["name"] == "dist_exchange"]
        assert sum(sent) == b1 - b0 > 0
        # the untraced call before the traced one sent as much
        assert b0 == b1 - b0
        assert len(sent) == calls
        # every payload is a (2, Q, k) int32 stack of (dists, ids)
        each = 2 * Q_LOCAL * CFG["k"] * 4
        want = [3 * each] if merge == "allgather" else [each] * calls     # 3 peers
        assert sent == want


@pytest.mark.parametrize("merge", di.MERGES)
def test_slots_are_queries_times_the_slab(ranks, merge):
    _, recs = ranks
    for rec in recs:
        args = {s["name"]: s["args"] for s in rec[merge]["spans"]
                if s["name"] in ("dist_probe", "dist_rerank")}
        assert args == {"dist_probe": {},
                        "dist_rerank": {"slots": Q_LOCAL * SLAB, "queries": Q_LOCAL}}


@pytest.mark.parametrize("merge", di.MERGES)
def test_the_query_span_holds_the_shards_index_bytes(ranks, merge):
    _, recs = ranks
    # 1,024 rows x 16 int32 a shard, (L, n) int64 keys, int32 ids and runs; the
    # (L, 32) histogram and (T+1, 2M) template under 4 KiB
    rows = SPEC.n // 4 * SPEC.dim * 4
    tables = CFG["num_tables"] * SPEC.n // 4 * (8 + 4 + 4)
    for rec in recs:
        query = next(s for s in rec[merge]["spans"] if s["name"] == "dist_query")
        assert query["args"] == {"index_bytes": rec["index_bytes"]}
        assert rows + tables < rec["index_bytes"] < rows + tables + 4096


def test_the_build_span_holds_its_histograms_all_reduce(ranks):
    _, recs = ranks
    for rec in recs:
        spans, sent = rec["build"]["spans"], rec["build"]["sent"]
        ids = _by_id(spans)
        assert sorted(s["name"] for s in spans) == ["dist_build", "dist_exchange"]
        ex = next(s for s in spans if s["name"] == "dist_exchange")
        assert ids[ex["psid"]]["name"] == "dist_build"
        assert ex["args"] == {"collective": "all_reduce", "bytes": sent}
        assert sent > 0


@pytest.mark.parametrize("merge", di.MERGES)
def test_profiler_ranges_nest_as_the_spans_with_tracing_off(ranks, merge):
    _, recs = ranks
    for rec in recs:
        got = rec[merge]["ranges"]
        tops = [name for name, parent in got if parent is None]
        assert tops == ["dist_query"]
        dist_kids = {(n, p) for n, p in got if n in CHILDREN}
        assert {n for n, _ in dist_kids} == CHILDREN
        assert {p for _, p in dist_kids} == {"dist_query"}


@pytest.mark.parametrize("merge", di.MERGES)
def test_answers_are_the_same_traced_and_equal_jax(ranks, merge):
    jax_out, recs = ranks
    for rec in recs:
        off, on = rec[merge]["off"], rec[merge]["on"]
        np.testing.assert_array_equal(on[0], off[0])
        np.testing.assert_array_equal(on[1], off[1])
        np.testing.assert_array_equal(off[0], jax_out[f"rows4_{merge}_d"])
        np.testing.assert_array_equal(off[1], jax_out[f"rows4_{merge}_i"])
