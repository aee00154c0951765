"""Port parity, the Cauchy and Gaussian families: ``repro_torch`` against
``repro`` on the CPU with the JAX package's parameters bridged.

The projection hash is a float32 product whose sum order differs by
backend (the port rounds a float64 sum once), so raw hashes are held to the
float32 dot-product error bound, buckets by agreement rate, and the query
bit for bit wherever every bucket agrees (else by recall and ratio)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import hashes as jh
from repro.core import index as jidx
from repro.data import ann_synthetic as jds
from repro_torch.core import baselines as tbl
from repro_torch.core import hashes as th
from repro_torch.core import index as tidx
from repro_torch.core.segments import SegmentedIndex
from test_torch_bridge import bridged

torch.set_num_threads(1)

FAMILIES = ("cauchy", "gaussian")
INT32_MIN, INT32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def jcfg(family, **kw):
    base = dict(num_tables=4, num_hashes=8, width=256 if family == "cauchy" else 64,
                num_probes=30, candidate_cap=32, universe=64, k=8,
                rerank_chunk=128, family=family)
    base.update(kw)
    return jidx.IndexConfig(**base)


def tcfg(cfg):
    return tidx.IndexConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def data():
    spec = jds.DatasetSpec("fam", n=3000, dim=16, universe=64, num_clusters=8)
    pts = jds.make_dataset(spec)
    return pts, jds.make_queries(spec, pts, 16)


def _params(family, dim=16, **kw):
    cfg = jcfg(family, **kw)
    jp = jidx.make_params(cfg, jax.random.PRNGKey(0), dim)
    return cfg, jp, bridged(jp)


@pytest.mark.parametrize("family", FAMILIES)
def test_raw_hash_and_buckets(data, family):
    pts, _ = data
    _, jp, tp = _params(family)
    jf = np.array(jh.raw_hash(jp, jnp.asarray(pts)))
    tf = th.raw_hash(tp, torch.from_numpy(pts)).numpy()
    assert tf.dtype == np.float32 and tf.shape == jf.shape
    # the float32 dot-product bound: |error| <= m u sum_d |x_d eta_d| per sum
    scale = np.einsum("nd,lmd->nlm", np.abs(pts.astype(np.float64)),
                      np.abs(np.asarray(jp.proj, np.float64)))
    assert (np.abs(tf - jf) <= 1e-5 * np.maximum(1.0, scale)).all()
    jb, jx = jh.bucket_and_offsets(jp, jnp.asarray(jf))
    tb, tx = th.bucket_and_offsets(tp, torch.from_numpy(jf))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())  # same f: same bits
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    jb = np.asarray(jh.bucket_and_offsets(jp, jnp.asarray(jf))[0])
    tb = th.bucket_and_offsets(tp, torch.from_numpy(tf))[0].numpy()
    assert (jb == tb).mean() >= 0.9999
    # keys equal wherever a table's M buckets are equal
    jk = np.asarray(jh.mix_keys(jp, jnp.asarray(jb))).astype(np.int64)
    tk = th.mix_keys(tp, torch.from_numpy(tb)).numpy()
    same = (jb == tb).all(axis=-1)
    np.testing.assert_array_equal(jk[same], tk[same])


@pytest.mark.parametrize("family", FAMILIES)
def test_bucket_saturates_as_xla(family):
    """Projections of +-1e30 and a NaN coordinate: buckets beyond int32
    saturate to INT32_MAX / INT32_MIN and NaN becomes 0, as XLA converts."""
    _, jp, tp = _params(family, num_tables=2, num_hashes=3, dim=4)
    proj = np.zeros((2, 3, 4), np.float32)
    proj[0, 0, 0], proj[0, 1, 0] = 1e30, -1e30
    proj[1, :, 1] = 1.0
    jp = dataclasses.replace(jp, proj=jnp.asarray(proj))
    tp = dataclasses.replace(tp, proj=torch.from_numpy(proj))
    pts = np.array([[2, 0, 0, 0], [4, 6, 8, 10], [np.nan, 3, 0, 0]], np.float32)
    jb = np.asarray(jh.bucket_and_offsets(jp, jh.raw_hash(jp, jnp.asarray(pts)))[0])
    tb = th.bucket_and_offsets(tp, th.raw_hash(tp, torch.from_numpy(pts)))[0].numpy()
    np.testing.assert_array_equal(jb, tb)
    assert jb[0, 0, 0] == INT32_MAX and jb[0, 0, 1] == INT32_MIN
    assert (jb[2, 0] == 0).all()                          # NaN -> 0
    assert jb[1, 1, 0] == int(np.floor((6 + jp.offsets[1, 0]) / jp.width))
    # the conversion alone, on the values that decide it
    x = torch.tensor([2.0 ** 31, -2.0 ** 31, 2147483520.0, -2.0 ** 31 - 256,
                      float("inf"), float("-inf"), float("nan"), -3.0])
    np.testing.assert_array_equal(
        th.to_int32_saturating(x).numpy(),
        np.asarray(jnp.asarray(x.numpy()).astype(jnp.int32)))


@pytest.mark.parametrize("family", FAMILIES)
def test_params_fingerprint_across_packages(family):
    _, jp, tp = _params(family)
    assert th.params_fingerprint(tp) == jh.params_fingerprint(jp)
    other = dataclasses.replace(tp, proj=tp.proj + 1)
    assert th.params_fingerprint(other) != th.params_fingerprint(tp)


@pytest.mark.parametrize("family", FAMILIES)
def test_query_index_matches_jax(data, family):
    """Bit for bit when every bucket of every point and query agrees, else
    within one result of recall and the matching ratio."""
    pts, qs = data
    cfg, jp, tp = _params(family)
    js = jidx.build_index(cfg, jax.random.PRNGKey(0), jnp.asarray(pts), params=jp)
    ts = tidx.build_index(tcfg(cfg), torch.from_numpy(pts), params=tp)
    jd, ji = map(np.asarray, jidx.query_index(cfg, js, jnp.asarray(qs)))
    td, ti = (x.numpy() for x in tidx.query_index(tcfg(cfg), ts, torch.from_numpy(qs)))
    both = np.concatenate([pts, qs])
    jb = np.asarray(jh.bucket_and_offsets(jp, jh.raw_hash(jp, jnp.asarray(both)))[0])
    tb = th.bucket_and_offsets(tp, th.raw_hash(tp, torch.from_numpy(both)))[0].numpy()
    if (jb == tb).all():
        np.testing.assert_array_equal(np.asarray(js.sorted_keys).astype(np.int64),
                                      ts.sorted_keys.numpy())
        np.testing.assert_array_equal(jd, td)
        np.testing.assert_array_equal(ji, ti)
    gd, gi = (x.numpy() for x in tbl.brute_force_l1(torch.from_numpy(pts),
                                                    torch.from_numpy(qs), cfg.k))
    tol = 1.0 / (qs.shape[0] * cfg.k)
    assert abs(tbl.recall(ti, gi) - jbl.recall(ji, gi)) <= tol
    assert abs(tbl.overall_ratio(td, gd) - jbl.overall_ratio(jd, gd)) <= 1e-3


@pytest.mark.parametrize("family", FAMILIES)
def test_entry_points_take_the_family(data, family):
    """make_params, build_index, query_index and SegmentedIndex take the
    family with the port's own parameters; the segmented query equals the
    flat one."""
    pts, qs = data
    cfg = tcfg(jcfg(family))
    params = tidx.make_params(cfg, 16, seed=3)
    again = tidx.make_params(cfg, 16, seed=3)
    assert params.family == family and params.walks is None
    assert params.proj.shape == (4, 8, 16) and params.proj.dtype == torch.float32
    assert th.params_fingerprint(params) == th.params_fingerprint(again)
    assert (params.mix_a.numpy() % 2 == 1).all()
    state = tidx.build_index(cfg, torch.from_numpy(pts), params=params)
    d, i = tidx.query_index(cfg, state, torch.from_numpy(qs))
    idx = SegmentedIndex.from_dataset(cfg, pts, params=params, device="cpu")
    sd, si = idx.query(qs)
    np.testing.assert_array_equal(d.numpy(), sd.numpy())
    np.testing.assert_array_equal(i.numpy(), si.numpy())
    gd, gi = tbl.brute_force_l1(torch.from_numpy(pts), torch.from_numpy(qs), cfg.k)
    assert tbl.recall(i.numpy(), gi.numpy()) > 0.3
    assert tbl.overall_ratio(d.numpy(), gd.numpy()) >= 1.0 - 1e-9


def test_cauchy_draw_is_heavy_tailed():
    gen = torch.Generator().manual_seed(0)
    p = th.make_cp_params(64, 8, 32, 100, gen).proj.abs()
    g = th.make_gp_params(64, 8, 32, 100, torch.Generator().manual_seed(0)).proj.abs()
    assert abs(float(p.median()) - 1.0) < 0.05         # |Cauchy| median is 1
    assert abs(float(g.median()) - 0.6745) < 0.03      # |N(0,1)| median
    assert float(p.max()) > 1e3 and float(g.max()) < 10
