"""Port parity, thermometer hashing: the plain ``rw_hash`` and
``walks.eval_pairs_thermo`` against the JAX package's ``ref.rw_hash`` and
``ops.rw_hash`` (the Pallas kernel in interpret mode), and
``hash_impl='thermo'``/``'pallas'`` through build, the segmented index and
the engine against the JAX package with ``hash_impl='pallas'`` — all on the
CPU, bit for bit, at the tests/test_torch_serving.py config.  The CUDA
kernel is held against the plain version in tests/test_torch_cuda.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashes as jh
from repro.core import index as jidx
from repro.core.segments import SegmentedIndex as JSeg
from repro.data import ann_synthetic as jds
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.serve.engine import AnnServingEngine as JEngine
from repro.serve.engine import ServeConfig as JServe
from repro_torch import bridge
from repro_torch.core import hashes as th
from repro_torch.core import index as tidx
from repro_torch.core import walks as tw
from repro_torch.core.segments import SegmentedIndex as TSeg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rw_hash as trw
from repro_torch.kernels.rw_hash import rw_hash_plain
from repro_torch.serve.engine import AnnServingEngine as TEngine
from repro_torch.serve.engine import ServeConfig as TServe
from test_torch_cases import RW_HASH_CASES

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
JCFG = jidx.IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=30,
                        candidate_cap=32, universe=64, k=8, rerank_chunk=128,
                        hash_impl="pallas")
IMPLS = ("thermo", "pallas")


def tcfg(impl):
    return tidx.IndexConfig(**dict(dataclasses.asdict(JCFG), hash_impl=impl))


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def setup():
    spec = jds.DatasetSpec("seg", n=3000, dim=16, universe=64, num_clusters=8)
    data = jds.make_dataset(spec)
    queries = jds.make_queries(spec, data, 16)
    jparams = jidx.make_params(JCFG, KEY, 16)
    tparams = bridge.params_from_numpy(
        jparams.width, np.asarray(jparams.offsets), np.asarray(jparams.mix_a),
        np.asarray(jparams.mix_c), np.asarray(jparams.walks.pairs),
        np.asarray(jparams.walks.prefix))
    return data, queries, jparams, tparams


@functools.lru_cache(maxsize=None)
def _jax_hash(name):
    """(ref.rw_hash, the Pallas kernel in interpret mode or None for n = 0)
    of a case, as numpy, computed once for the tests of this module."""
    pairs, pts = RW_HASH_CASES[name]
    jp, jx = jnp.asarray(pairs), jnp.asarray(pts)
    pallas = None
    if pts.shape[0]:        # the Pallas wrapper cannot slice an empty row block
        bn = 128 if pts.shape[0] <= 4096 else 8192  # few interpreted grid steps
        pallas = np.asarray(jops.rw_hash(jp, jx, bn=bn))
    return np.asarray(ref.rw_hash(jp, jx)), pallas


def _eq_jax(name, got):
    want_ref, want_pallas = _jax_hash(name)
    _eq(want_ref, got, "ref")
    if want_pallas is not None:
        _eq(want_pallas, got, "pallas interpret")


@pytest.mark.parametrize("name", sorted(RW_HASH_CASES))
def test_rw_hash_plain_matches_jax(name):
    """(a) plain == ref == the Pallas kernel (interpret) == the thermo form,
    on in-range and on odd, negative and above-universe coordinates."""
    pairs, pts = RW_HASH_CASES[name]
    got = rw_hash_plain(_t(pairs), _t(pts))
    assert got.dtype == torch.int32 and got.shape == (pts.shape[0], pairs.shape[0])
    _eq_jax(name, got)
    _eq(tops.rw_hash(_t(pairs), _t(pts)), got, "ops dispatch on the CPU")
    walks = tw.WalkTable(_t(pairs), tw.prefix_from_pairs(_t(pairs)))
    _eq(tw.eval_pairs_thermo(walks, _t(pts)), got, "eval_pairs_thermo")


@pytest.mark.parametrize("name", sorted(RW_HASH_CASES))
def test_prefix_table_plain_sums_to_the_hash(name):
    """The table kernel's plain version, summed as the hash kernel sums it
    (row ``clamp(p >> 1, 0, U2)`` of each dimension's table, columns :F),
    equals ref and the Pallas kernel (interpret); row 0 and the padding
    columns are zero."""
    pairs, pts = RW_HASH_CASES[name]
    f, m, u2 = pairs.shape
    fp = trw.padded_fns(f)
    assert fp % trw.FN_TILE == 0 and f <= fp < f + trw.FN_TILE
    tab = trw.rw_prefix_table_plain(_t(pairs), fp)
    assert tab.dtype == torch.int32 and tab.shape == (m, u2 + 1, fp)
    assert not tab[:, 0].any() and not tab[:, :, f:].any()
    at = (_t(pts) >> 1).clamp(0, u2).long()
    got = tab[torch.arange(m)[None, :], at].sum(dim=1, dtype=torch.int32)[:, :f]
    _eq_jax(name, got)


def test_raw_hash_impls_agree(setup):
    """(b) 'gather' == 'thermo' == 'pallas' in range, in both packages."""
    data, queries, jparams, tparams = setup
    pts = np.concatenate([data[:500], queries])
    want = th.raw_hash(tparams, _t(pts), impl="gather")
    for impl in ("gather",) + IMPLS:
        _eq(want, th.raw_hash(tparams, _t(pts), impl=impl), impl)
        _eq(jh.raw_hash(jparams, jnp.asarray(pts), impl=impl), want, f"jax {impl}")
    with pytest.raises(ValueError, match="unknown rw impl"):
        th.raw_hash(tparams, _t(pts), impl="bogus")


@pytest.fixture(scope="module")
def jax_build(setup):
    data, _, jparams, _ = setup
    return jidx.build_index(JCFG, KEY, jnp.asarray(data), params=jparams)


@pytest.mark.parametrize("impl", IMPLS)
def test_build_index(setup, jax_build, impl):
    """(c) sorted tables, run lengths and histograms of the port's build with
    ``impl`` equal the JAX build with hash_impl='pallas'."""
    data, _, _, tparams = setup
    ts = tidx.build_index(tcfg(impl), _t(data), params=tparams)
    _eq(np.asarray(jax_build.sorted_keys).astype(np.int64), ts.sorted_keys, "keys")
    _eq(jax_build.sorted_ids, ts.sorted_ids, "ids")
    _eq(jax_build.occ_from, ts.occ_from, "occ_from")
    _eq(jax_build.occ_hist, ts.occ_hist, "occ_hist")


@pytest.fixture(scope="module")
def jax_drains(setup):
    data, queries, jparams, _ = setup
    return _drains(JEngine(JCFG, JServe(persistent_cache=False, **SERVE),
                           index=JSeg.from_dataset(JCFG, KEY, jnp.asarray(data),
                                                   delta_cap=512, params=jparams)),
                   queries)


SERVE = dict(batch_size=8, bucket_min=8, delta_cap=512, cand_bucket_min=512)


def _drains(engine, queries):
    """insert -> delete -> drain -> compact -> drain."""
    gids = engine.insert(queries[:5] + 2)
    engine.delete([3, 7, int(gids[1])])
    engine.submit(queries[:11])
    first = engine.drain()
    engine.compact()
    engine.submit(queries)
    return first, engine.drain()


@pytest.mark.parametrize("impl", IMPLS)
def test_engine_drain(setup, jax_drains, impl):
    """(d) the engine drains the JAX engine's bits with hash_impl='pallas'."""
    data, queries, _, tparams = setup
    cfg = tcfg(impl)
    index = TSeg.from_dataset(cfg, data, delta_cap=512, params=tparams, device="cpu")
    got = _drains(TEngine(cfg, TServe(**SERVE), index=index), queries)
    for (jd, ji), (td, ti), when in zip(jax_drains, got, ("first", "after compact")):
        _eq(jd, td, f"dists, {when}")
        _eq(ji, ti, f"gids, {when}")


def test_chunking_changes_no_bit(monkeypatch):
    """The plain thermometer product gives the same bits at any row chunk,
    through ``rw_hash_plain`` and through ``eval_pairs_thermo``."""
    pairs, pts = RW_HASH_CASES["out_of_range"]
    walks = tw.WalkTable(_t(pairs), tw.prefix_from_pairs(_t(pairs)))
    whole = trw.rw_hash_plain(_t(pairs), _t(pts))
    monkeypatch.setattr(trw, "PLAIN_CHUNK_BYTES", 4 * 7 * pairs[0].size)
    _eq(whole, trw.rw_hash_plain(_t(pairs), _t(pts)))
    _eq(whole, tw.eval_pairs_thermo(walks, _t(pts)))


@pytest.mark.parametrize("n,f,m,resident,slices,want", [
    (1_000_000, 96, 128, 264, None, 1),  # the build: 5,862 blocks, no split
    (1_000_512, 96, 128, 264, None, 1),  # the compaction's rebuild
    (64, 96, 128, 264, None, 64),        # a served batch, 2 blocks an SM: 2 dims a slice
    (64, 96, 128, 132, None, 43),        # ... at 1 block an SM: 3 dims a slice
    (512, 96, 128, 264, None, 64),       # the delta's inserts, one row tile
    (8, 96, 128, 264, None, 64),
    (1, 9, 4, 264, None, 4),             # at most one dimension a slice
    (100_000, 65, 2, 264, None, 1),
    (64, 96, 128, 0, 7, 7), (64, 96, 17, 0, 7, 6), (5, 3, 2, 0, 7, 2),
    (64, 96, 128, 0, 128, 128), (64, 96, 128, 0, 0, 1)])
def test_plan_rw_hash(n, f, m, resident, slices, want):
    """Planned, the grid fills the resident blocks; given, the count is cut
    to 1..m; and the slices of ceil(m / S) dimensions cover the m
    dimensions with none empty, as the kernel takes them."""
    got = trw.plan_rw_hash(n, f, m, resident, slices)
    assert got == want
    width = -(-m // got)
    dims = [range(s * width, min(m, (s + 1) * width)) for s in range(got)]
    assert all(len(d) for d in dims) and sum(len(d) for d in dims) == m


H100_SPAN = 1559   # what rw_hash_setup returns on an H100 (227 KB of shared memory a block)


def _windows(u2, span, n_win):
    """The hash kernel's windows: window w holds the table rows
    [w (span + 1), min((w + 1)(span + 1), U2 + 1))."""
    return [(w * (span + 1), min((w + 1) * (span + 1), u2 + 1)) for w in range(n_win)]


@pytest.mark.parametrize("limit", [H100_SPAN, 7])
@pytest.mark.parametrize("u2", [1, H100_SPAN - 1, H100_SPAN, H100_SPAN + 1, 4096, 20_000])
def test_plan_rw_windows(u2, limit):
    """The planned windows, as the hash kernel lays them out from (span,
    n_win), cover the table rows [0, U2] in order, disjoint, none empty,
    each at most span + 1 rows; U2 up to the limit takes one window; the
    table kernel's chunks of span steps cover [0, U2)."""
    span, n_win = trw.plan_rw_windows(u2, limit)
    assert span == min(u2, limit)
    wins = _windows(u2, span, n_win)
    assert wins[0][0] == 0 and wins[-1][1] == u2 + 1
    assert all(a[1] == b[0] for a, b in zip(wins, wins[1:]))
    assert all(0 < u1 - u0 <= span + 1 for u0, u1 in wins)
    assert (len(wins) == 1) == (u2 <= limit)
    chunks = [(v0, min(v0 + span, u2)) for v0 in range(0, u2, span)]
    assert chunks[0][0] == 0 and chunks[-1][1] == u2
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))


@pytest.mark.parametrize("limit", [1, 3, 31])
@pytest.mark.parametrize("name", ["out_of_range", "int32_extremes", "m17"])
def test_windowed_passes_sum_to_the_hash(name, limit):
    """The kernels' windowed arithmetic on the CPU: the table scanned in
    chunks of span steps with a running sum carried over, and each
    dimension's rows added window by window where the offset falls in the
    window, equal ``rw_hash_plain`` on every int32 coordinate."""
    pairs, pts = (torch.from_numpy(x) for x in RW_HASH_CASES[name])
    f, m, u2 = pairs.shape
    span, n_win = trw.plan_rw_windows(u2, limit)
    wins = _windows(u2, span, n_win)
    tab = torch.zeros((m, u2 + 1, f), dtype=torch.int32)
    base = torch.zeros((m, f), dtype=torch.int32)
    for v0 in range(0, u2, span):
        chunk = pairs[:, :, v0:v0 + span].permute(1, 2, 0).to(torch.int32)
        tab[:, v0 + 1:v0 + 1 + chunk.shape[1]] = base[:, None] + torch.cumsum(
            chunk, dim=1, dtype=torch.int32)
        base += chunk.sum(dim=1, dtype=torch.int32)
    off = (pts >> 1).clamp(0, u2).long()
    acc = torch.zeros((pts.shape[0], f), dtype=torch.int32)
    for i in range(m):
        for u0, u1 in wins:
            inside = (off[:, i] >= u0) & (off[:, i] < u1)
            rows = tab[i, u0:u1][(off[:, i] - u0).clamp(0, u1 - u0 - 1)]
            acc += torch.where(inside[:, None], rows, 0)
    _eq(rw_hash_plain(pairs, pts), acc)
    _eq(trw.rw_prefix_table_plain(pairs, f), tab)
