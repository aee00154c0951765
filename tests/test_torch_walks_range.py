"""Port parity of the gather hash outside its domain: ``walks.eval_prefix``
on negative, odd and above-universe coordinates, and a served batch and a
compaction that hold such points, against ``repro`` bit for bit on the CPU.

The reference reads the prefix table with ``jnp.take``: an index in
[-(U2+1), -1] wraps, any other index outside [0, U2] reads INT32_MIN, and
the int32 sum wraps.  The card's side of the same inputs is
``tests/test_torch_cuda.py::test_walk_range_on_the_card``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jidx
from repro.core import walks as jw
from repro.core.segments import SegmentedIndex as JSeg
from repro_torch import bridge
from repro_torch.core import index as tidx
from repro_torch.core import walks as tw
from repro_torch.core.segments import SegmentedIndex as TSeg
from test_torch_cases import WALK_RANGE_U, walk_range_case

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(4)
JCFG = jidx.IndexConfig(num_tables=3, num_hashes=6, width=8, num_probes=12,
                        candidate_cap=16, universe=WALK_RANGE_U, k=5, rerank_chunk=64)
TCFG = tidx.IndexConfig(**dataclasses.asdict(JCFG))


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


@pytest.fixture(scope="module")
def setup():
    jparams = jidx.make_params(JCFG, KEY, 8)
    tparams = bridge.params_from_numpy(
        jparams.width, np.asarray(jparams.offsets), np.asarray(jparams.mix_a),
        np.asarray(jparams.mix_c), np.asarray(jparams.walks.pairs),
        np.asarray(jparams.walks.prefix))
    return walk_range_case(), jparams, tparams


def test_eval_prefix_outside_the_universe(setup):
    (coords, _, _, _), jparams, tparams = setup
    want = np.asarray(jw.eval_prefix(jparams.walks, jnp.asarray(coords)))
    got = tw.eval_prefix(tparams.walks, torch.from_numpy(coords))
    _eq(want, got)
    # the fill reaches the sum: a row of one fill and zeros elsewhere
    one = np.zeros((2, coords.shape[1]), np.int32)
    one[0, 0] = 40
    one[1, 0] = -2 * (WALK_RANGE_U // 2 + 1)        # wraps to row 0
    got = tw.eval_prefix(tparams.walks, torch.from_numpy(one)).numpy()
    zero = tw.eval_prefix(tparams.walks, torch.zeros((1, coords.shape[1]), dtype=torch.int32))
    _eq(got[0], np.iinfo(np.int32).min + zero[0].numpy())
    _eq(got[1], zero[0])


def test_eval_prefix_in_range_is_unchanged(setup):
    """Inside [0, U] the result is the plain prefix sum it always was."""
    (_, data, _, _), _, tparams = setup
    t = torch.from_numpy(data >> 1).long()
    pre = tparams.walks.prefix                                   # (F, m, U2+1)
    want = pre[:, torch.arange(data.shape[1])[None, :], t].sum(-1, dtype=torch.int32).T
    _eq(want, tw.eval_prefix(tparams.walks, torch.from_numpy(data)))


def test_served_batch_and_compaction_with_an_out_of_range_point(setup):
    """A batch with one out-of-range query over a segment and a delta that
    holds an out-of-range insert; then a compaction that hashes that insert
    into a segment.  Every stage equals the JAX package's, bit for bit."""
    (_, data, inserts, queries), jparams, tparams = setup
    jx = JSeg.from_dataset(JCFG, KEY, jnp.asarray(data), delta_cap=64, params=jparams)
    tx = TSeg.from_dataset(TCFG, data, delta_cap=64, params=tparams, device="cpu")
    for idx in (jx, tx):
        idx.insert(inserts)
        idx.delete([5, 257])
    for stage in ("delta", "compacted"):
        jd, ji, jused = jx.query_compact(jnp.asarray(queries))
        td, ti, tused = tx.query_compact(torch.from_numpy(queries))
        _eq(jd, td, f"dists, {stage}")
        _eq(ji, ti, f"gids, {stage}")
        assert tused == jused
        wd, wi = tx.query(torch.from_numpy(queries))
        _eq(jd, wd, f"worst-case slab dists, {stage}")
        _eq(ji, wi, f"worst-case slab gids, {stage}")
        # the insert equal to query 0 is found; the out-of-range insert
        # (query 2) is found exactly while it sits in the delta
        assert int(ti[0, 0]) == 256 and int(td[0, 0]) == 0
        if stage == "delta":
            assert int(ti[2, 0]) == 259 and int(td[2, 0]) == 0
        for idx in (jx, tx):
            idx.compact()
    js, ts = jx.segments[0].state, tx.segments[0].state
    for what in ("sorted_keys", "sorted_ids", "occ_from", "occ_hist"):
        _eq(np.asarray(getattr(js, what)).astype(np.int64),
            getattr(ts, what).numpy().astype(np.int64), what)
