"""Port parity, hash and probe stages: ``repro_torch`` against ``repro`` on
the CPU, bit for bit, at the tests/test_segments.py config.  Also the
port's isolation from jax and its refusal to run without a card unasked."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashes as jh
from repro.core import index as jidx
from repro.core import multiprobe as jmp
from repro.core import pipeline as jpipe
from repro.core import walks as jw
from repro.data import ann_synthetic as jds
from repro_torch import bridge
from repro_torch.core import hashes as th
from repro_torch.core import index as tidx
from repro_torch.core import multiprobe as tmp
from repro_torch.core import pipeline as tpipe
from repro_torch.core import walks as tw
from repro_torch.data import ann_synthetic as tds

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
JCFG = jidx.IndexConfig(num_tables=4, num_hashes=8, width=24, num_probes=30,
                        candidate_cap=32, universe=64, k=8, rerank_chunk=128)
TCFG = tidx.IndexConfig(**dataclasses.asdict(JCFG))


def bridged(jparams):
    return bridge.params_from_numpy(
        jparams.width, np.asarray(jparams.offsets), np.asarray(jparams.mix_a),
        np.asarray(jparams.mix_c), np.asarray(jparams.walks.pairs),
        np.asarray(jparams.walks.prefix))


@pytest.fixture(scope="module")
def setup():
    spec = jds.DatasetSpec("seg", n=3000, dim=16, universe=64, num_clusters=8)
    data = jds.make_dataset(spec)
    queries = jds.make_queries(spec, data, 16)
    jparams = jidx.make_params(JCFG, jax.random.PRNGKey(0), 16)
    return data, queries, jparams, bridged(jparams)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def test_synthetic_data_same_bits():
    spec = jds.DatasetSpec("x", n=500, dim=12, universe=64, num_clusters=4)
    tspec = tds.DatasetSpec("x", n=500, dim=12, universe=64, num_clusters=4)
    _eq(jds.make_dataset(spec), tds.make_dataset(tspec))
    _eq(jds.make_queries(spec, jds.make_dataset(spec), 9),
        tds.make_queries(tspec, tds.make_dataset(tspec), 9))


def test_template_and_fingerprint(setup):
    _, _, jparams, tparams = setup
    _eq(jidx.make_template(JCFG), tidx.make_template(TCFG))
    assert th.params_fingerprint(tparams) == jh.params_fingerprint(jparams)


def test_eval_prefix(setup):
    data, _, jparams, tparams = setup
    _eq(jw.eval_prefix(jparams.walks, jnp.asarray(data)),
        tw.eval_prefix(tparams.walks, torch.from_numpy(data)))


def test_bucket_offsets_and_mix_keys(setup):
    data, _, jparams, tparams = setup
    jf = jh.raw_hash(jparams, jnp.asarray(data))
    tf = th.raw_hash(tparams, torch.from_numpy(data))
    _eq(jf, tf, "raw hash")
    jb, jx = jh.bucket_and_offsets(jparams, jf)
    tb, tx = th.bucket_and_offsets(tparams, tf)
    _eq(jb, tb, "bucket")
    _eq(jx, tx, "x_neg")        # float32, bit for bit
    _eq(np.asarray(jh.mix_keys(jparams, jb)).astype(np.int64),
        th.mix_keys(tparams, tb), "keys")


def test_mix_keys_uint32_extremes(setup):
    _, _, jparams, tparams = setup
    rng = np.random.default_rng(5)
    b = rng.integers(-2**31, 2**31 - 1, (7, 4, 8)).astype(np.int32)
    b[0] = np.iinfo(np.int32).min
    b[1] = -1
    b[2] = np.iinfo(np.int32).max
    _eq(np.asarray(jh.mix_keys(jparams, jnp.asarray(b))).astype(np.int64),
        th.mix_keys(tparams, torch.from_numpy(b)))


def test_instantiate_template_with_ties():
    tmpl = jidx.make_template(JCFG)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 24, (5, 4, 8)).astype(np.float32)
    x[0, 0] = 12.0                      # every x_neg == W/2: all ranks tie
    x[1, 2, :4] = 12.0
    x[2, 1, 3] = x[2, 1, 5]             # a tie between two dimensions
    _eq(jmp.instantiate_template(jnp.asarray(tmpl), jnp.asarray(x), 24.0),
        tmp.instantiate_template(torch.from_numpy(tmpl), torch.from_numpy(x), 24.0))


def test_probe_keys_and_extents(setup):
    data, queries, jparams, tparams = setup
    jstate = jidx.build_index(JCFG, jax.random.PRNGKey(0), jnp.asarray(data),
                              params=jparams)
    tstate = tidx.build_index(TCFG, torch.from_numpy(data), params=tparams)
    jpk, jlo, jocc, jcnt = jidx.probe_index(JCFG, jstate, jnp.asarray(queries))
    tpk, tlo, tocc, tcnt = tidx.probe_index(TCFG, tstate, torch.from_numpy(queries))
    _eq(np.asarray(jpk).astype(np.int64), tpk, "probe keys")
    for name, a, b in (("lo", jlo, tlo), ("occ", jocc, tocc), ("counts", jcnt, tcnt)):
        _eq(a, b, name)
    # the same extents without the run-length shortcut
    for a, b in zip((jlo, jocc, jcnt),
                    tpipe.stage_probe_extents(TCFG, tstate.sorted_keys, tpk)):
        _eq(a, b)


@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_build_index(setup, dtype):
    data, _, jparams, tparams = setup
    jcfg = dataclasses.replace(JCFG, dataset_dtype=dtype)
    tcfg = dataclasses.replace(TCFG, dataset_dtype=dtype)
    js = jidx.build_index(jcfg, jax.random.PRNGKey(0), jnp.asarray(data),
                          params=jparams)
    ts = tidx.build_index(tcfg, torch.from_numpy(data), params=tparams)
    _eq(np.asarray(js.sorted_keys).astype(np.int64), ts.sorted_keys, "keys")
    _eq(js.sorted_ids, ts.sorted_ids, "ids")
    _eq(js.occ_from, ts.occ_from, "occ_from")
    _eq(js.occ_hist, ts.occ_hist, "occ_hist")
    _eq(js.dataset, ts.dataset, "dataset")
    assert str(ts.dataset.dtype) == f"torch.{dtype}"


def test_host_rung_helpers(setup):
    data, _, jparams, tparams = setup
    ts = tidx.build_index(TCFG, torch.from_numpy(data), params=tparams)
    js = jidx.build_index(JCFG, jax.random.PRNGKey(0), jnp.asarray(data),
                          params=jparams)
    assert (tpipe.max_bucket_occupancy(ts.sorted_keys)
            == tpipe.max_bucket_occupancy(ts.sorted_keys, ts.occ_from)
            == jpipe.max_bucket_occupancy(js.sorted_keys, js.occ_from))
    for q in (0.5, 0.99, 0.999):
        assert (tpipe.occupancy_quantile(ts.occ_hist, q)
                == jpipe.occupancy_quantile(js.occ_hist, q))
    for args in ((1000, 64), (40, 64), (1, 64), (4096, 64, 512, 8, "escalate"),
                 (4096, 64, 512, 8, "truncate")):
        assert tpipe.rung_ladder(*args) == jpipe.rung_ladder(*args)
        for count in (0, 63, 64, 500, 513, 9999):
            assert (tpipe.pick_rung(count, *args)
                    == jpipe.pick_rung(count, *args))
    assert tpipe.BIG_DIST == jpipe.BIG_DIST


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tidx.IndexConfig(probe_impl="staged")
    with pytest.raises(NotImplementedError):
        tidx.IndexConfig(rerank_impl="scan")
    with pytest.raises(NotImplementedError):
        tidx.make_params(tidx.IndexConfig(family="cauchy"), 4)


def test_own_params_are_deterministic():
    a = tidx.make_params(TCFG, 16, seed=3)
    b = tidx.make_params(TCFG, 16, seed=3)
    assert th.params_fingerprint(a) == th.params_fingerprint(b)
    assert set(np.unique(a.walks.pairs.numpy())) <= {-2, 0, 2}
    assert (a.mix_a.numpy() % 2 == 1).all()
    assert (0 <= a.offsets.numpy()).all() and (a.offsets.numpy() < 24).all()


def test_isolation_from_jax_and_repro():
    """The port imports neither jax nor anything of the JAX package."""
    code = f"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(SRC)!r})
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):
    importlib.import_module(m.name)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]
assert not bad, bad
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for path in (SRC / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from repro." not in text and "import repro." not in text, path
        assert "from repro " not in text and "import repro\n" not in text, path


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card, an entry point given no device raises instead of
    carrying on on the CPU."""
    from repro_torch.core.segments import SegmentedIndex
    from repro_torch.serve.engine import AnnServingEngine, ServeConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.zeros((10, 4), np.int32)
    cfg = tidx.IndexConfig(num_tables=2, num_hashes=2, num_probes=2, universe=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegmentedIndex.from_dataset(cfg, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnnServingEngine(cfg, ServeConfig(), data)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--n", "10", "--dim", "4"])
