"""Port parity, the distributed index: ``repro_torch.launch.dist_index`` on
four gloo rank processes on the CPU against ``repro.launch.dist_index`` on
four forced host devices, at tests/test_distributed.py's data and config,
with the JAX package's parameters bridged.  Bit for bit: every mesh's
(d, i), the row-reduced ``occ_hist``, the three merges against each other,
and the model-sharded mesh against the flat ``query_index``.

The JAX side runs in two subprocesses (the XLA flag must precede the jax
import) while the port's ranks run, all once a module."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import index as jidx
from repro.launch import dist_index as jdi
from repro.data import ann_synthetic as ds
from repro_torch.core import pipeline as pipe
from repro_torch.core.index import IndexConfig, build_index, query_index
from repro_torch.launch import dist_index as di
from test_torch_bridge import bridged

torch.set_num_threads(1)

SPEC = ds.DatasetSpec("t", n=4096, dim=16, universe=64, num_clusters=8)
CFG = dict(num_tables=4, num_hashes=8, width=24, num_probes=30, candidate_cap=32,
           universe=64, k=8, rerank_chunk=128)
BUCKET, CAP = 256, 8            # the compacted, capped run's slab and clamp
# name: (mesh shape, merge, cand_bucket, cand_cap), run by both packages
RUNS = {"rows4_allgather": ((4, 1), "allgather", None, None),
        "rows4_ring": ((4, 1), "ring", None, None),
        "rows4_tree": ((4, 1), "tree", None, None),
        "rows4_ring_capped": ((4, 1), "ring", BUCKET, CAP),
        "rows2_model2_allgather": ((2, 2), "allgather", None, None),
        "model4_allgather": ((1, 4), "allgather", None, None)}
# the port's own runs besides: the (2, 2) folds, and the cap and bucket
# derived on the ranks (an occ_hist quantile, a bucket covering the counts)
PORT_RUNS = {**RUNS,
             "rows2_model2_ring": ((2, 2), "ring", None, None),
             "rows2_model2_tree": ((2, 2), "tree", None, None),
             **{f"rows4_{m}_derived": ((4, 1), m, "cover", 0.5) for m in di.MERGES},
             "rows4_tree_derived_again": ((4, 1), "tree", "cover", 0.5)}

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core.index import IndexConfig, build_index, query_index, make_params
    from repro.data import ann_synthetic as ds
    from repro.launch import dist_index as di

    spec = ds.DatasetSpec("t", n=4096, dim=16, universe=64, num_clusters=8)
    data = ds.make_dataset(spec)
    queries = ds.make_queries(spec, data, 16)
    cfg = IndexConfig(**{cfg!r})
    params = make_params(cfg, jax.random.PRNGKey(0), 16)
    out = {{"data": data, "queries": queries, "offsets": params.offsets,
           "mix_a": params.mix_a, "mix_c": params.mix_c, "prefix": params.walks.prefix}}
    if {flat!r}:
        state = build_index(cfg, jax.random.PRNGKey(0), jnp.asarray(data), params=params)
        out["flat_d"], out["flat_i"] = query_index(cfg, state, jnp.asarray(queries))
    built = None
    for name, (shape, merge, bucket, cap) in {runs!r}.items():
        mesh = jax.make_mesh(shape, ("data", "model"))
        with mesh:
            dj = jax.device_put(jnp.asarray(data), NamedSharding(mesh, P("data", None)))
            qj = jax.device_put(jnp.asarray(queries), NamedSharding(mesh, P("model", None)))
            if built is None or built[0] != shape:      # one build a mesh
                built = (shape, di.dist_build_fn(cfg, mesh)(dj, params))
            st = built[1]
            d, i = di.dist_query_fn(cfg, mesh, merge=merge, cand_bucket=bucket,
                                    cand_cap=cap)(st, qj)
            out[name + "_d"], out[name + "_i"] = d, i
            out[name + "_occ_hist"] = st.occ_hist
    np.savez(sys.argv[1], **{{k: np.asarray(v) for k, v in out.items()}})
""")


def _jax_process(path, runs, flat):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src")))
    script = JAX_SCRIPT.format(cfg=CFG, runs=runs, flat=flat)
    return subprocess.Popen([sys.executable, "-c", script, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _port_runs(params):
    cfg = IndexConfig(**CFG)
    runs = []
    for shape, merge, bucket, cap in PORT_RUNS.values():
        run = {"shape": shape, "cfg": cfg, "params": params, "merge": merge,
               "cand_bucket": bucket}
        run["cap_quantile" if bucket == "cover" else "cand_cap"] = cap
        runs.append(run)
    return runs


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX package's npz, the port's global (d, i) and records a run,
    the data, the queries, the bridged parameters)."""
    tmp = tmp_path_factory.mktemp("dist")
    # two JAX processes (the (4, 1) mesh's runs, then the others with the
    # flat query), both running while the port's ranks run
    rows4 = {k: v for k, v in RUNS.items() if v[0] == (4, 1)}
    rest = {k: v for k, v in RUNS.items() if k not in rows4}
    procs = [_jax_process(tmp / "rows4.npz", rows4, False),
             _jax_process(tmp / "rest.npz", rest, True)]
    try:
        data = ds.make_dataset(SPEC)
        queries = ds.make_queries(SPEC, data, 16)
        jcfg = jidx.IndexConfig(**CFG)
        params = bridged(jidx.make_params(jcfg, jax.random.PRNGKey(0), SPEC.dim))
        reports = di.spawn_ranks(4, di.run_meshes, data, queries, _port_runs(params),
                                 backend="gloo", device="cpu", timeout_s=120)
        for proc in procs:
            out, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-3000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    jax_out = {**np.load(tmp / "rows4.npz"), **np.load(tmp / "rest.npz")}
    recs = [rep["result"] for rep in reports]
    port = {name: (*di.assemble(recs, k), [r[k] for r in recs])
            for k, name in enumerate(PORT_RUNS)}
    return jax_out, port, data, queries, params, reports


def test_jax_side_drew_the_same_data_and_parameters(both):
    jax_out, _, data, queries, params, reports = both
    np.testing.assert_array_equal(jax_out["data"], data)
    np.testing.assert_array_equal(jax_out["queries"], queries)
    for leaf in ("offsets", "mix_a", "mix_c"):
        got = getattr(params, leaf).numpy()
        np.testing.assert_array_equal(got, jax_out[leaf].astype(got.dtype))
    np.testing.assert_array_equal(params.walks.prefix.numpy(), jax_out["prefix"])
    assert [rep["device"] for rep in reports] == ["cpu"] * 4
    assert all(rep["launches"]["fused_rerank"] == 0 for rep in reports)   # plain versions


@pytest.mark.parametrize("name", sorted(RUNS))
def test_dist_query_matches_jax(both, name):
    jax_out, port, *_ = both
    d, i, recs = port[name]
    np.testing.assert_array_equal(d, jax_out[name + "_d"])
    np.testing.assert_array_equal(i, jax_out[name + "_i"])
    # the exchange ran wherever there is more than one row shard
    shape = RUNS[name][0]
    assert all((r["sent_bytes"] > 0) == (shape[0] > 1) for r in recs)
    assert {(r["row_index"], r["model_index"]) for r in recs} == {
        (a, b) for a in range(shape[0]) for b in range(shape[1])}


@pytest.mark.parametrize("name", ["rows4_allgather", "rows2_model2_allgather",
                                  "model4_allgather"])
def test_row_reduced_occ_hist_matches_jax(both, name):
    jax_out, port, data, _, params, _ = both
    for rec in port[name][2]:
        np.testing.assert_array_equal(rec["occ_hist"], jax_out[name + "_occ_hist"])
    # every rank counts its own buckets; the sum is not the flat index's
    flat = build_index(IndexConfig(**CFG), torch.from_numpy(data), params=params)
    assert int(port[name][2][0]["occ_hist"].sum()) >= int(flat.occ_hist.sum())


@pytest.mark.parametrize("rows", [4, 2])
def test_ring_and_tree_equal_allgather(both, rows):
    _, port, *_ = both
    prefix = "rows4" if rows == 4 else "rows2_model2"
    d, i, _ = port[f"{prefix}_allgather"]
    for merge in ("ring", "tree"):
        np.testing.assert_array_equal(port[f"{prefix}_{merge}"][0], d)
        np.testing.assert_array_equal(port[f"{prefix}_{merge}"][1], i)


def test_model_sharded_equals_flat(both):
    jax_out, port, data, queries, params, _ = both
    cfg = IndexConfig(**CFG)
    fd, fi = query_index(cfg, build_index(cfg, torch.from_numpy(data), params=params),
                         torch.from_numpy(queries))
    d, i, _ = port["model4_allgather"]
    np.testing.assert_array_equal(d, fd.numpy())
    np.testing.assert_array_equal(i, fi.numpy())
    np.testing.assert_array_equal(d, jax_out["flat_d"])
    np.testing.assert_array_equal(i, jax_out["flat_i"])


def test_row_sharded_never_worse_than_flat_and_ids_verify(both):
    """Sharded probing sees a superset of the flat candidates (the cap
    clamps each shard's bucket apart), so no distance grows; each id's
    distance is exact (tests/test_distributed.py's claims)."""
    jax_out, port, data, queries, *_ = both
    for name in ("rows4_allgather", "rows2_model2_allgather"):
        d, i, _ = port[name]
        assert (d <= jax_out["flat_d"]).all()
        ok = i >= 0
        true = np.abs(data[np.where(ok, i, 0)].astype(np.int64)
                      - queries[:, None].astype(np.int64)).sum(-1)
        np.testing.assert_array_equal(np.where(ok, true, 0), np.where(ok, d, 0))
        assert (d[~ok] == pipe.BIG_DIST).all()


def test_derived_cap_and_bucket_are_deterministic(both):
    """The JAX docstring's contract for cand_cap and cand_bucket: the cap
    from the built occ_hist's quantile, a bucket covering every rank's
    counts, and the result the same twice and under all three merges."""
    _, port, *_ = both
    d, i, recs = port["rows4_allgather_derived"]
    cap = pipe.occupancy_quantile(recs[0]["occ_hist"], 0.5)
    assert 1 <= cap < CFG["candidate_cap"]
    lp = CFG["num_tables"] * (CFG["num_probes"] + 1)
    for name in [f"rows4_{m}_derived" for m in di.MERGES] + ["rows4_tree_derived_again"]:
        got = port[name]
        assert {(r["cand_cap"], r["cand_bucket"]) for r in got[2]} == {
            (cap, recs[0]["cand_bucket"])}
        np.testing.assert_array_equal(got[0], d)
        np.testing.assert_array_equal(got[1], i)
    assert recs[0]["cand_bucket"] in pipe.candidate_ladder(lp * cap)
    # the cap truncates: this is not the uncapped result
    assert not np.array_equal(port["rows4_allgather"][0], d)


def test_state_specs_match_jax():
    """The port's sharded dimension (or replication) of each field, against
    the reference's PartitionSpecs."""
    jcfg = jidx.IndexConfig(**CFG)

    def dims(spec):
        if spec == jax.sharding.PartitionSpec():
            return di.REPLICATED
        return next(d for d, axes in enumerate(spec) if axes is not None)

    for names in (("data", "model"), ("pod", "data", "model")):
        jspecs = jdi.state_specs(jax.make_mesh((1,) * len(names), names), jcfg)
        with di.single_process_group("gloo"):
            mesh = di.make_mesh((1,) * len(names), names, device="cpu")
            got = di.state_specs(mesh, IndexConfig(**CFG))
        want = {f.name: dims(getattr(jspecs, f.name)) for f in dataclasses.fields(jspecs)
                if f.name != "params"}
        assert jax.tree.leaves(jspecs.params) == [jax.sharding.PartitionSpec()] * len(
            jax.tree.leaves(jspecs.params))
        assert got == {"params": di.REPLICATED, **want}


def test_mesh_layout_and_world_one_exchanges_nothing():
    """At world 1 every merge runs no exchange (no P2P to itself), and the
    mesh's axes, blocks and slices follow the reference's layout."""
    data = ds.make_dataset(SPEC)
    queries = ds.make_queries(SPEC, data, 16)
    cfg = IndexConfig(**CFG)
    with di.single_process_group("gloo"):
        mesh = di.make_mesh((1, 1), ("data", "model"), device="cpu")
        assert (mesh.row_index, mesh.model_index, mesh.exchange) == (0, 0, "device")
        assert mesh.row_slice(4096) == slice(0, 4096)
        build = di.dist_build_fn(cfg, mesh)
        state = build(data, build_index(cfg, torch.from_numpy(data[:8])).params)
        out = []
        for merge in di.MERGES:
            query = di.dist_query_fn(cfg, mesh, merge)
            out.append(query(state, queries))
            assert query.exchange.sent_bytes == 0
        assert build.exchange.sent_bytes == 0
        with pytest.raises(ValueError, match="names from"):
            di.make_mesh((1, 1), ("rows", "model"), device="cpu")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            di.make_mesh((2, 1), device="cpu")
        with pytest.raises(RuntimeError, match="exists already"):
            with di.single_process_group("gloo"):
                pass
    assert not dist.is_initialized()
    for d, i in out[1:]:
        np.testing.assert_array_equal(d.numpy(), out[0][0].numpy())
        np.testing.assert_array_equal(i.numpy(), out[0][1].numpy())


def test_nccl_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="nccl' needs a CUDA card"):
        di.spawn_ranks(2, di.run_meshes, None, None, [], backend="nccl")
    with pytest.raises(RuntimeError, match="nccl' needs a CUDA card"):
        di.rank_device("nccl", "cpu", 0, 1)
    with pytest.raises(ValueError, match="unknown backend"):
        di.rank_device("mpi", "cpu", 0, 1)


def _fail_on_rank0(device):
    """Rank 0 raises before a collective that the others enter."""
    mesh = di.make_mesh((3, 1), device=device, timeout_s=60)
    if dist.get_rank() == 0:
        raise RuntimeError("rank 0 fails on purpose")
    di.Exchange(mesh).all_reduce(torch.ones(1))


def _hang(device):
    time.sleep(600)


@pytest.mark.parametrize("case", ["tree_on_three_rows", "rows_not_dividing",
                                  "one_rank_raises", "a_rank_hangs"])
def test_a_failing_rank_fails_the_spawn_in_time(case):
    """Three ranks; every failure reaches the caller as an error within the
    spawn's limit, and no rank is left running."""
    data = ds.make_dataset(SPEC)
    cfg = IndexConfig(**CFG)
    params = build_index(cfg, torch.from_numpy(data[:8])).params
    run = {"shape": (3, 1), "cfg": cfg, "params": params, "merge": "tree"}
    fn, args, want, limit = {
        "tree_on_three_rows": (di.run_meshes, (data[:4095], data[:3], [run]),
                               "power-of-two number of row shards, got 3", 60),
        "rows_not_dividing": (di.run_meshes, (data, data[:3], [run]),
                              "4096 rows do not divide over 3 row shards", 60),
        "one_rank_raises": (_fail_on_rank0, (), "rank 0 fails on purpose", 60),
        "a_rank_hangs": (_hang, (), "did not finish within 5 s", 5)}[case]
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError), match=want):
        di.spawn_ranks(3, fn, *args, backend="gloo", device="cpu", timeout_s=limit)
    assert time.monotonic() - t0 < limit + 15
