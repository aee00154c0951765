"""The port's checkpoint manager (``repro_torch.ckpt``): the crash-recovery
and async-failure contracts of tests/test_ckpt_recovery.py on the port, and
round trips across the packages — a directory written by either one
restores in the other to equal arrays, its files byte for byte the same."""
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro_torch.ckpt import CheckpointManager, restore_flat, restore_pytree, save_pytree
from repro_torch.ckpt import manager as manager_mod

TREE = {"w": torch.arange(6, dtype=torch.float32), "step": torch.tensor(1, dtype=torch.int32)}


def _simulate_mid_write_crash(mgr, step):
    """A save that died between writing files and the atomic rename."""
    tmp = mgr._step_dir(step) + ".tmp"
    os.makedirs(tmp)
    np.save(os.path.join(tmp, "w.npy"), np.zeros(3))  # partial, no manifest


def test_leftover_tmp_ignored_and_cleaned_by_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, TREE)
    _simulate_mid_write_crash(mgr, 2)
    assert mgr.all_steps() == [1]
    assert mgr.latest_step() == 1
    _, back = mgr.restore_latest(TREE, device="cpu")
    assert torch.equal(back["w"], TREE["w"]) and torch.equal(back["step"], TREE["step"])
    mgr.save(3, TREE)
    assert not any(n.endswith(".tmp") for n in os.listdir(str(tmp_path)))
    assert mgr.all_steps() == [1, 3]


def test_crashed_step_can_be_resaved_over_its_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    _simulate_mid_write_crash(mgr, 5)
    mgr.save(5, TREE)                    # same step: tmp replaced, not fatal
    assert mgr.all_steps() == [5]
    step, back = mgr.restore_latest(TREE, device="cpu")
    assert step == 5
    assert torch.equal(back["w"], TREE["w"])


def test_all_steps_tolerates_stray_entries(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(7, TREE)
    os.makedirs(str(tmp_path / "step_junk"))
    os.makedirs(str(tmp_path / "step_"))
    (tmp_path / "step_notes.txt").write_text("operator scribbles")
    (tmp_path / "README").write_text("not a checkpoint")
    assert mgr.all_steps() == [7]
    assert mgr.latest_step() == 7


def test_retention_keeps_exactly_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, TREE)
    assert mgr.all_steps() == [4, 5]
    assert len([n for n in os.listdir(str(tmp_path)) if n.startswith("step_")]) == 2


def _boom(tree, directory, chunk_bytes=1 << 30):
    raise OSError("disk full")


@pytest.mark.parametrize("surfaces_on", ["wait", "next_save"])
def test_async_save_failure_surfaces(tmp_path, monkeypatch, surfaces_on):
    """A failed async save surfaces at the next ``wait()`` (after which the
    manager works again) or at the next ``save()``."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    monkeypatch.setattr(manager_mod, "save_pytree", _boom)
    mgr.save(1, TREE, blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait() if surfaces_on == "wait" else mgr.save(2, TREE)
    if surfaces_on == "wait":
        monkeypatch.undo()
        mgr.save(2, TREE, blocking=False)
        mgr.wait()
        assert mgr.all_steps() == [2]


def test_crash_between_same_step_renames_promotes_old(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(4, TREE)
    os.rename(mgr._step_dir(4), mgr._step_dir(4) + ".old")
    assert CheckpointManager(str(tmp_path), keep=3).latest_step() == 4
    _, back = CheckpointManager(str(tmp_path), keep=3).restore_latest(TREE, device="cpu")
    assert torch.equal(back["w"], TREE["w"])


def test_restore_flat_roundtrip(tmp_path):
    tree = {"dataset": torch.arange(12, dtype=torch.int32).reshape(4, 3),
            "meta": {"next_gid": torch.tensor(17, dtype=torch.int32)}}
    d = str(tmp_path / "snap")
    save_pytree(tree, d)
    flat = restore_flat(d)               # no template needed
    np.testing.assert_array_equal(flat["dataset"], tree["dataset"].numpy())
    assert int(flat["meta/next_gid"]) == 17
    assert flat["dataset"].dtype == np.int32


def test_restore_to_a_device_and_structure(tmp_path):
    """``restore`` puts every leaf on ``device`` in the template's nesting
    (dicts, lists, tuples, None kept); a wrong shape raises."""
    tree = {"a": [torch.ones(2, 3), (np.arange(4, dtype=np.int16), None)],
            "b": np.float32(2.5)}
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, tree)
    back = mgr.restore(1, tree, device="cpu")
    assert isinstance(back["a"], list) and isinstance(back["a"][1], tuple)
    assert back["a"][1][1] is None and back["a"][0].device.type == "cpu"
    assert back["a"][1][0].dtype == torch.int16 and float(back["b"]) == 2.5
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"a": [torch.ones(3, 3), (np.arange(4), None)], "b": 1.0},
                    device="cpu")


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    """With no ``device`` the restore resolves to the card, as every entry
    point of the port does: with no card it raises rather than answer on
    the CPU."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, TREE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(1, TREE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore_latest(TREE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_pytree(TREE, mgr._step_dir(1))


# ------------------------------------------- across the two packages

def _host_tree():
    """One tree in both packages' leaf types: nested dicts, a list, a
    tuple, a leaf chunked at ``chunk_bytes=64``, scalars and a bfloat16."""
    rng = np.random.default_rng(3)
    big = rng.integers(-9, 9, (40, 3)).astype(np.int32)
    return {"dataset": big, "meta": {"next_gid": np.int32(17), "wal_seq": np.int64(4)},
            "list": [np.arange(5, dtype=np.int16), np.float32(1.5)],
            "tup": (np.ones((2, 2), np.float64),)}


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_directories_cross_the_packages(tmp_path, writer):
    """The same tree saved by both packages gives the same files, byte for
    byte (manifest included, chunks at 64 bytes), and each package restores
    the other's directory to equal arrays."""
    tree = _host_tree()
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_pytree({k: v for k, v in tree.items()}, jdir, chunk_bytes=64)
    save_pytree({k: v for k, v in tree.items()}, tdir, chunk_bytes=64)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    assert len([n for n in os.listdir(tdir) if n.startswith("dataset.c")]) > 1
    for name in os.listdir(jdir):
        assert filecmp.cmp(os.path.join(jdir, name), os.path.join(tdir, name), shallow=False)
    src = jdir if writer == "repro" else tdir
    got_t, got_j = restore_flat(src), jckpt.restore_flat(src)
    assert sorted(got_t) == sorted(got_j)
    for key in got_t:
        np.testing.assert_array_equal(got_t[key], got_j[key])
        assert got_t[key].dtype == got_j[key].dtype
    back = restore_pytree(tree, src, device="cpu")
    np.testing.assert_array_equal(back["dataset"].numpy(), tree["dataset"])
    jback = jckpt.restore_pytree(tree, src)
    np.testing.assert_array_equal(np.asarray(jback["list"][0]), tree["list"][0])


def test_bfloat16_crosses_the_packages(tmp_path):
    """A bfloat16 leaf written by the JAX package restores in the port as a
    bfloat16 tensor of the same values, and the port's back in JAX."""
    vals = [0.0, 1.5, -2.25, 98304.0]              # exact in bfloat16
    jckpt.save_pytree({"w": jnp.asarray(vals, jnp.bfloat16)}, str(tmp_path / "j"))
    got = restore_flat(str(tmp_path / "j"))["w"]
    assert got.dtype == torch.bfloat16 and got.float().tolist() == vals
    save_pytree({"w": torch.tensor(vals, dtype=torch.bfloat16)}, str(tmp_path / "t"))
    back = jckpt.restore_flat(str(tmp_path / "t"))["w"]
    assert np.asarray(back, np.float32).tolist() == vals


def test_index_payload_round_trips_with_the_jax_leaf_paths(tmp_path):
    """A serving index's ``checkpoint_payload()`` (IndexState, gids,
    next_gid) saves and restores through the port's manager: the same leaf
    paths and shapes as the JAX manager writes for the JAX index's payload
    at the same config (the dataclasses flatten in the JAX ``tree_flatten``
    order, ``family`` and ``width`` static), every leaf equal after the
    restore, ``next_gid`` a Python int, and the restored node answers as
    the saved one."""
    import jax
    from repro.core import index as jidx
    from repro.core.segments import SegmentedIndex as JSegmented
    from repro_torch.core.index import IndexConfig
    from repro_torch.core.segments import SegmentedIndex
    from test_torch_bridge import bridged
    rng = np.random.default_rng(5)
    data = (rng.integers(0, 16, (300, 8)) * 2).astype(np.int32)
    queries = data[:12] + 2
    kw = dict(num_tables=3, num_hashes=6, width=16, num_probes=8,
              candidate_cap=32, universe=32, k=5)
    jcfg, cfg = jidx.IndexConfig(**kw), IndexConfig(**kw)
    key = jax.random.PRNGKey(1)
    jnode = JSegmented.from_dataset(jcfg, key, jnp.asarray(data))
    node = SegmentedIndex.from_dataset(
        cfg, data, params=bridged(jidx.make_params(jcfg, key, 8)), device="cpu")
    for n in (jnode, node):
        n.delete([4, 9])
        n.insert(data[20:30] + 2)
    payload = node.checkpoint_payload()
    jmgr = jckpt.CheckpointManager(str(tmp_path / "j"), keep=1)
    jmgr.save(1, jnode.checkpoint_payload())
    mgr = CheckpointManager(str(tmp_path / "t"), keep=1)
    mgr.save(1, payload)
    jflat, flat = jmgr.restore_flat_step(1), mgr.restore_flat_step(1)
    assert sorted(flat) == sorted(jflat)
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in jflat.items()}
    state, gids, next_gid = mgr.restore(1, payload, device="cpu")
    for want, got in zip(manager_mod._flatten(payload).values(),
                         manager_mod._flatten((state, gids, next_gid)).values()):
        assert torch.equal(torch.as_tensor(want), torch.as_tensor(got))
    assert type(next_gid) is int and next_gid == payload[2] == int(jnode.checkpoint_payload()[2])
    assert state.params.family == "rw" and state.params.width == payload[0].params.width
    d, i = node.query(torch.from_numpy(queries))
    d2, i2 = SegmentedIndex.from_checkpoint(cfg, state, gids, next_gid).query(
        torch.from_numpy(queries))
    assert torch.equal(d, d2) and torch.equal(i, i2)
