"""Port parity, baselines: the scheme configs, SRS, the overall ratio and
the chunked brute force of ``repro_torch.core.baselines`` against
``repro.core.baselines`` on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import index as jidx
from repro.data import ann_synthetic as jds
from repro_torch.core import baselines as tbl
from repro_torch.core import index as tidx

torch.set_num_threads(1)

JCFG = jidx.IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=30,
                        candidate_cap=32, universe=64, k=8, rerank_chunk=128,
                        hash_impl="thermo")
TCFG = tidx.IndexConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def data():
    spec = jds.DatasetSpec("base", n=3000, dim=16, universe=64, num_clusters=8)
    pts = jds.make_dataset(spec)
    return pts, jds.make_queries(spec, pts, 16)


@pytest.mark.parametrize("which", ["single", "cp", "mp_cp"])
def test_scheme_configs_field_for_field(which):
    jfn = {"single": lambda c: jbl.single_probe_config(c),
           "cp": lambda c: jbl.cp_lsh_config(c, 320),
           "mp_cp": lambda c: jbl.mp_cp_lsh_config(c, 320)}[which]
    tfn = {"single": lambda c: tbl.single_probe_config(c),
           "cp": lambda c: tbl.cp_lsh_config(c, 320),
           "mp_cp": lambda c: tbl.mp_cp_lsh_config(c, 320)}[which]
    assert dataclasses.asdict(tfn(TCFG)) == dataclasses.asdict(jfn(JCFG))


def test_overall_ratio_exact():
    rng = np.random.default_rng(0)
    true_d = rng.integers(0, 50, (12, 8)).astype(np.int32)
    true_d[0, 0] = 0                                  # a zero true distance
    res_d = true_d + rng.integers(0, 9, (12, 8)).astype(np.int32)
    res_d[3, 5:] = np.iinfo(np.int32).max // 2        # sentinel entries
    res_d[4, :] = np.iinfo(np.int32).max // 4         # at the cut-off itself
    got = tbl.overall_ratio(res_d, true_d)
    assert got == jbl.overall_ratio(res_d, true_d)
    assert tbl.overall_ratio(torch.from_numpy(res_d), true_d) == got
    assert tbl.overall_ratio(true_d + 1, true_d + 1) == 1.0


@pytest.mark.parametrize("res, true", [
    ([[1, 2, 99, 98]], [[1, 2, 3, 4]]), ([[1, 1, 1, 1]], [[1, 2, 3, 4]]),
    ([[1, -1, -1]], [[1, 2]]), ([[1]], [[1, 2, 3, 4]]), ([[-1, -1]], [[-1, -1]]),
    ([[1, 2], [5, 6]], [[1, 2], [7, 8]])])
def test_recall_matches_jax(res, true):
    assert tbl.recall(np.array(res), np.array(true)) == jbl.recall(np.array(res),
                                                                   np.array(true))


@pytest.mark.parametrize("t", [64, 300])
def test_query_srs_on_a_bridged_projection(data, t):
    """The same Cauchy projection in both packages: recall and ratio within
    one result of each other; the rerank of the t candidates is exact."""
    pts, qs = data
    k = 8
    jsrs = jbl.build_srs(jax.random.PRNGKey(4), jnp.asarray(pts), 10)
    tsrs = tbl.build_srs(torch.from_numpy(pts), 10,
                         proj=torch.from_numpy(np.array(jsrs.proj)))
    np.testing.assert_allclose(tsrs.projected.numpy(), np.asarray(jsrs.projected),
                               rtol=1e-5, atol=1e-2)
    jd, ji = map(np.asarray, jbl.query_srs(jsrs, jnp.asarray(qs), t, k))
    td, ti = (x.numpy() for x in tbl.query_srs(tsrs, torch.from_numpy(qs), t, k))
    gd, gi = (x.numpy() for x in tbl.brute_force_l1(torch.from_numpy(pts),
                                                    torch.from_numpy(qs), k))
    tol = 1.0 / (qs.shape[0] * k)
    assert abs(tbl.recall(ti, gi) - jbl.recall(ji, gi)) <= tol
    assert abs(tbl.overall_ratio(td, gd) - jbl.overall_ratio(jd, gd)) <= 1e-3
    # every returned distance is the exact L1 of its id
    exact = np.abs(pts[ti].astype(np.int64) - qs[:, None, :]).sum(-1)
    np.testing.assert_array_equal(td, exact)
    # a projection of its own from a generator
    own = tbl.build_srs(torch.from_numpy(pts), 10,
                        generator=torch.Generator().manual_seed(1))
    assert own.proj.shape == (10, 16) and own.projected.shape == (3000, 10)


@pytest.mark.parametrize("t", [3, 5, 12])
def test_query_srs_tie_at_t_keeps_lower_rows(t):
    """Four points, each repeated ten times (row i is point i % 4), so the
    ten copies of the query's own point tie at projected distance 0: the t
    candidates are the lowest rows of the tie, as ``lax.top_k`` keeps them,
    and the result equals the JAX package's bit for bit."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 64, (4, 16)).astype(np.int32)
    pts = base[np.arange(40) % 4]
    qs = base[:1].copy()
    jsrs = jbl.build_srs(jax.random.PRNGKey(4), jnp.asarray(pts), 10)
    tsrs = tbl.build_srs(torch.from_numpy(pts), 10,
                         proj=torch.from_numpy(np.array(jsrs.proj)))
    jd, ji = map(np.asarray, jbl.query_srs(jsrs, jnp.asarray(qs), t, t))
    td, ti = (x.numpy() for x in tbl.query_srs(tsrs, torch.from_numpy(qs), t, t))
    np.testing.assert_array_equal(ti[0, :min(t, 10)], 4 * np.arange(min(t, 10)))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


def _brute_force_reference(dataset, queries, k, chunk=2048):
    """The port's brute force before it went through ``l1_distance``."""
    n, q = dataset.shape[0], queries.shape[0]
    big = np.iinfo(np.int64).max
    qs = queries.to(torch.int32)
    best = torch.full((q, k), big, dtype=torch.int64)
    for lo in range(0, n, chunk):
        rows = dataset[lo:lo + chunk].to(torch.int32)
        d = (qs[:, None, :] - rows[None, :, :]).abs().sum(dim=-1, dtype=torch.int32)
        keys = (d.to(torch.int64) << 32) | torch.arange(lo, lo + rows.shape[0])[None, :]
        both = torch.cat([best, keys], dim=-1)
        best = torch.topk(both, min(k, both.shape[1]), dim=-1, largest=False).values
    bad = best == big
    return (torch.where(bad, np.iinfo(np.int32).max // 2, best >> 32).to(torch.int32),
            torch.where(bad, -1, best & 0xFFFFFFFF).to(torch.int32))


@pytest.mark.parametrize("n, k, chunk", [(3000, 8, 2048), (3000, 8, 333), (5, 8, 2048),
                                         (700, 16, 64)])
def test_brute_force_unchanged(data, n, k, chunk):
    pts, qs = data
    tp, tq = torch.from_numpy(pts[:n]), torch.from_numpy(qs)
    got = tbl.brute_force_l1(tp, tq, k, chunk=chunk)
    want = _brute_force_reference(tp, tq, k, chunk)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    jd, ji = jbl.brute_force_l1(jnp.asarray(pts[:n]), jnp.asarray(qs), k)
    np.testing.assert_array_equal(np.asarray(jd), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(ji), got[1].numpy())
