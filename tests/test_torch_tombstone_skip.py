"""The tombstone mask is skipped while nothing is deleted: ``stage_tombstone``
with ``None`` returns its ids, ``SegmentedIndex`` passes ``None`` while its
tombstone set is empty and counts each pass in ``tombstone_passes``, and the
served results stay bit for bit with the JAX package through deletes in a
sealed segment, deletes in the delta and a compaction."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jidx
from repro.core.segments import SegmentedIndex as JSeg
from repro.data import ann_synthetic as jds
from repro_torch import bridge
from repro_torch.core import index as tidx
from repro_torch.core import pipeline as pipe
from repro_torch.core.segments import SegmentedIndex as TSeg

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
JCFG = jidx.IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=30,
                        candidate_cap=32, universe=64, k=8, rerank_chunk=128)
TCFG = tidx.IndexConfig(**dataclasses.asdict(JCFG))
INT32_MAX = np.iinfo(np.int32).max


@pytest.mark.parametrize("q,c,n", [(1, 1, 1), (3, 17, 40), (8, 256, 1000), (4, 9, 0)])
def test_stage_tombstone_none_returns_ids(q, c, n):
    """``None`` hands back ``ids`` itself, equal to the mask over the padded
    single ``INT32_MAX`` (no gid matches it); ids include the sentinel n."""
    g = torch.Generator().manual_seed(1000 * q + c + n)
    ids = torch.randint(0, n + 1, (q, c), generator=g, dtype=torch.int32)
    gids = torch.randperm(4 * n + 1, generator=g)[:n].to(torch.int32)
    pad = torch.tensor([INT32_MAX], dtype=torch.int32)
    assert pipe.stage_tombstone(ids, gids, None, n) is ids
    padded = pipe.stage_tombstone(ids, gids, pad, n)
    assert padded.dtype == ids.dtype and padded.shape == ids.shape
    assert torch.equal(padded, ids)


@pytest.fixture(scope="module")
def setup():
    spec = jds.DatasetSpec("tomb", n=2000, dim=16, universe=64, num_clusters=8)
    data = jds.make_dataset(spec)
    queries = jds.make_queries(spec, data, 12)
    jparams = jidx.make_params(JCFG, KEY, 16)
    tparams = bridge.params_from_numpy(
        jparams.width, np.asarray(jparams.offsets), np.asarray(jparams.mix_a),
        np.asarray(jparams.mix_c), np.asarray(jparams.walks.pairs),
        np.asarray(jparams.walks.prefix))
    return data, queries, jparams, tparams


# Each case is a stream of steps on an index seeded with data[:1000] and a
# delta of 128: ("insert", lo, hi) inserts data[lo:hi] (1000..1200 seals a
# segment of 128 gids 1000..1127 and leaves 72 in the delta, gids
# 1128..1199); ("delete", gids); ("compact",); ("query", passes) serves the
# queries through ``query_compact`` and then ``query``, and ``passes`` is
# what each of the two adds to ``tombstone_passes``.
CASES = {
    "no_deletes": [("query", {"skipped": 1}),
                   ("insert", 1000, 1200), ("query", {"skipped": 3})],
    "sealed_segment": [("insert", 1000, 1200), ("query", {"skipped": 3}),
                       ("delete", [3, 1001, 1127, 5]), ("query", {"masked": 3}),
                       ("query", {"masked": 3})],
    "delta": [("insert", 1000, 1200), ("query", {"skipped": 3}),
              ("delete", [1128, 1199]), ("query", {"masked": 3})],
    "compacted": [("insert", 1000, 1200), ("delete", [0, 1050, 1150]),
                  ("query", {"masked": 3}), ("compact",), ("query", {"skipped": 1}),
                  ("delete", [7]), ("query", {"masked": 1})],
}


def _eq(a, b, msg):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_skip_is_exact_and_counted(setup, case):
    """At every query step ``query_compact`` and ``query`` equal the JAX
    package bit for bit, and ``tombstone_passes`` grows by the passes that
    masked (a tombstone held) or skipped (none held): the first batch after
    the first delete masks, and a compaction that clears the set skips."""
    data, queries, jparams, tparams = setup
    jx = JSeg.from_dataset(JCFG, KEY, jnp.asarray(data[:1000]), delta_cap=128,
                           params=jparams)
    tx = TSeg.from_dataset(TCFG, data[:1000], delta_cap=128, params=tparams,
                           device="cpu")
    jq, tq = jnp.asarray(queries), torch.from_numpy(queries)
    assert tx.tombstone_passes == {"masked": 0, "skipped": 0}
    for n_step, step in enumerate(CASES[case]):
        if step[0] == "insert":
            for idx in (jx, tx):
                idx.insert(data[step[1]:step[2]])
        elif step[0] == "delete":
            for idx in (jx, tx):
                idx.delete(step[1])
        elif step[0] == "compact":
            for idx in (jx, tx):
                idx.compact()
        else:
            want = {"masked": 0, "skipped": 0, **step[1]}
            at = f"{case}, step {n_step}"
            assert (tx._tombstone_array() is None) == bool(want["skipped"])
            before = dict(tx.tombstone_passes)
            jd, ji, jused = jx.query_compact(jq)
            td, ti, tused = tx.query_compact(tq)
            _eq(jd, td, f"query_compact dists, {at}")
            _eq(ji, ti, f"query_compact gids, {at}")
            assert tused == jused
            mid = dict(tx.tombstone_passes)
            assert {k: mid[k] - before[k] for k in mid} == want, at
            jwd, jwi = jx.query(jq)
            wd, wi = tx.query(tq)
            _eq(jwd, wd, f"query dists, {at}")
            _eq(jwi, wi, f"query gids, {at}")
            after = tx.tombstone_passes
            assert {k: after[k] - mid[k] for k in after} == want, at
    dead = set(int(g) for s in CASES[case] if s[0] == "delete" for g in s[1])
    if case != "compacted":
        assert tx.num_tombstones == len(dead)
        served = set(np.asarray(tx.query_compact(tq)[1]).ravel().tolist())
        assert not served & dead
