"""LM training in the port (``repro_torch.train``, ``repro_torch.data.
lm_synthetic``, ``repro_torch.launch.train``, ``repro_torch.examples.
train_smollm``) against the JAX package on the CPU.

AdamW on identical trees and gradients over several steps (clipping,
warm-up, weight decay, bf16 moments, the gradient-precision reduction at
its edge values) within OPT_RTOL; ``batch_at_step`` bit for bit; the train
step against the jitted reference step by its per-step losses and grad
norms (an AdamW step turns a gradient's rounding into a sign, so
parameters are not compared element by element); the launcher's
``improved=yes``, a resumed run equal to an uninterrupted one bit for bit,
and the checkpoint of ``(params, opt_state)`` equal to the JAX manager's
file for file.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import CheckpointManager as JaxManager
from repro.data import lm_synthetic as jdata
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train.train_loop import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import lm_synthetic as data
from repro_torch.examples import train_smollm
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import make_train_step

torch.set_num_threads(1)
# float32 AdamW on the same inputs: a leaf's moments within 1e-6 of the
# leaf's max |value| (measured up to 2.4e-7: XLA rounds the moments' sums
# an ulp apart), scalars within OPT_RTOL
OPT_SHARE, OPT_RTOL, OPT_ATOL = 1e-6, 1e-6, 1e-9
# the train step: the losses and grad norms of 3 steps (measured within
# 4e-6 relative)
STEP_RTOL = 1e-5


# ---------------------------------------------------------------- optimizer

def _tree(rng, dtype=np.float32):
    return {"w": rng.normal(0, 1, (4, 6)).astype(dtype),
            "b": {"c": rng.normal(0, 0.1, (5,)).astype(dtype),
                  "a": rng.normal(0, 2, (2, 3, 2)).astype(dtype)}}


def _torch_tree(tree, dtype=None):
    return tf.tree_map(lambda a: torch.from_numpy(a).to(dtype or torch.float32), tree)


OPT_CASES = {
    "default": dict(),
    "clipped": dict(clip_norm=0.05, warmup_steps=1),
    "warmup": dict(warmup_steps=3, lr=1e-2),
    "no_decay": dict(weight_decay=0.0, b2=0.999),
    "bf16_moments": dict(moment_dtype="bfloat16", warmup_steps=2),
    "grad_precision": dict(grad_precision="bfloat16", clip_norm=1e9),
}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_adamw_equals_the_reference(name):
    """Five steps on the same parameters and gradients: parameters, both
    moments, step, grad norm and learning rate."""
    jcfg, cfg = JO.OptConfig(**OPT_CASES[name]), O.OptConfig(**OPT_CASES[name])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    rng = np.random.default_rng(0)
    p = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p), _torch_tree(p)
    js, ts = JO.init_opt_state(jp, jcfg), O.init_opt_state(tp, cfg)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    update = jax.jit(lambda p, g, s: JO.adamw_update(p, g, s, jcfg))
    for _ in range(5):
        g = _tree(rng)
        jp, js, jm = update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = O.adamw_update(tp, _torch_tree(g), ts, cfg)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=OPT_RTOL)
        assert int(ts["step"]) == int(js["step"])
        for want, got in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
            for w, t in zip(jax.tree.leaves(want), tf.tree_leaves(got)):
                assert str(t.dtype).removeprefix("torch.") == w.dtype.name
                w = np.asarray(w, np.float32)
                err = np.abs(t.float().numpy() - w).max()
                assert err <= OPT_SHARE * np.abs(w).max(), (name, err)


def test_adamw_bf16_parameters_equal_the_reference():
    """bf16 parameters and gradients: the float32 update cast back to bf16,
    within one bf16 rounding of the reference's."""
    cfg = dict(warmup_steps=2, lr=1e-2)
    jcfg, tcfg = JO.OptConfig(**cfg), O.OptConfig(**cfg)
    rng = np.random.default_rng(1)
    p = _tree(rng)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tp = _torch_tree(p, torch.bfloat16)
    js, ts = JO.init_opt_state(jp, jcfg), O.init_opt_state(tp, tcfg)
    for _ in range(3):
        g = _tree(rng)
        jp, js, _ = JO.adamw_update(jp, jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g),
                                    js, jcfg)
        tp, ts, _ = O.adamw_update(tp, _torch_tree(g, torch.bfloat16), ts, tcfg)
    for w, t in zip(jax.tree.leaves(jp), tf.tree_leaves(tp)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(), np.asarray(w, np.float32),
                                   rtol=2 ** -7, atol=1e-6)


def _edge_values():
    """Ties to even at bf16's last mantissa bit, subnormals, +-inf, NaN,
    values at and above bf16's largest finite, signed zeros, and 4,096
    random bit patterns."""
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -9 + 2 ** -20,
                  1.0 + 3 * 2 ** -9, -(1.0 + 2 ** -8),
                  1e-40, -3e-39, 2 ** -149, 1.17e-38, 9.18e-41,
                  np.inf, -np.inf, np.nan, -np.nan,
                  3.3895314e38, 3.39e38, 3.4028235e38, -3.4e38, 0.0, -0.0], np.float32)
    bits = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.uint32)
    return np.concatenate([x, bits.view(np.float32)])


def test_grad_precision_is_reduce_precision():
    """``reduce_to_bf16`` against ``lax.reduce_precision(g, 8, 7)``: the same
    bits wherever the reference gives a number, NaN where it gives NaN."""
    x = _edge_values()
    want = np.asarray(jax.jit(lambda a: jax.lax.reduce_precision(
        a, exponent_bits=8, mantissa_bits=7))(jnp.asarray(x)))
    got = O.reduce_to_bf16(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()
    nan = np.isnan(want)
    assert nan.sum() >= 2 and np.array_equal(nan, np.isnan(got))
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    assert np.isinf(got[x.view(np.uint32) == np.float32(3.4028235e38).view(np.uint32)]).all()
    b = torch.from_numpy(x).to(torch.bfloat16)
    assert O.reduce_to_bf16(b).view(torch.int16).equal(b.view(torch.int16))


def test_adamw_grad_precision_at_edge_values():
    """A step whose gradients hold ties and subnormals (finite), and one
    whose gradients hold inf and NaN: the same parameters as the
    reference's, NaN in the same places."""
    x = _edge_values()
    cfg = dict(grad_precision="bfloat16", clip_norm=1e9, warmup_steps=1)
    jcfg, tcfg = JO.OptConfig(**cfg), O.OptConfig(**cfg)
    for g in (x[np.isfinite(x) & (np.abs(x) < 1e30)][:64], x[:24]):
        p = np.linspace(-1, 1, g.size, dtype=np.float32)
        jp = {"w": jnp.asarray(p)}
        want, _, jm = JO.adamw_update(jp, {"w": jnp.asarray(g)}, JO.init_opt_state(jp, jcfg),
                                      jcfg)
        tp = {"w": torch.from_numpy(p)}
        got, _, tm = O.adamw_update(tp, {"w": torch.from_numpy(g.copy())},
                                    O.init_opt_state(tp, tcfg), tcfg)
        want, got = np.asarray(want["w"]), got["w"].numpy()
        assert np.array_equal(np.isnan(want), np.isnan(got))
        np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=OPT_ATOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=OPT_RTOL)


def test_global_norm_takes_every_leaf():
    tree = {"b": torch.full((4,), 3.0), "a": {"c": torch.full((2,), 4.0,
                                                              dtype=torch.bfloat16)}}
    assert float(O.global_norm(tree)) == pytest.approx(np.sqrt(4 * 9 + 2 * 16))


# --------------------------------------------------------------------- data

@pytest.mark.parametrize("seed", [0, 3])
def test_batch_at_step_is_the_reference(seed):
    for vocab, batch, seq in ((512, 8, 16), (49152, 4, 33)):
        jcfg = jdata.LmDataConfig(vocab=vocab, global_batch=batch, seq_len=seq, seed=seed)
        cfg = data.LmDataConfig(vocab=vocab, global_batch=batch, seq_len=seq, seed=seed)
        for step in (0, 1, 17):
            for shards in (1, 2, 4):
                parts = []
                for shard in range(shards):
                    want = jdata.batch_at_step(jcfg, step, shard, shards)
                    got = data.batch_at_step(cfg, step, shard, shards)
                    for w, g in zip(want, got):
                        assert g.dtype == np.int32 and g.shape == (batch // shards, seq)
                        np.testing.assert_array_equal(g, w)
                    parts.append(got)
                whole = data.batch_at_step(cfg, step)
                np.testing.assert_array_equal(np.concatenate([t for t, _ in parts]), whole[0])
    with pytest.raises(ValueError):
        data.batch_at_step(data.LmDataConfig(vocab=9, global_batch=3, seq_len=4), 0, 0, 2)


# --------------------------------------------------------------- train step

@pytest.mark.parametrize("arch,microbatches", [("smollm_360m", 1), ("granite_moe_3b_a800m", 1),
                                               ("smollm_360m", 2), ("zamba2_1_2b", 2)])
def test_train_step_follows_the_reference(arch, microbatches):
    """Three steps from the same bridged parameters on the same batches:
    each step's loss, grad norm and lr, aux and tokens (0 when
    microbatched)."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = bridge.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    jo, to = JO.OptConfig(lr=5e-3, warmup_steps=5), O.OptConfig(lr=5e-3, warmup_steps=5)
    js, ts = JO.init_opt_state(jp, jo), O.init_opt_state(tp, to)
    jstep = jax.jit(jax_make_train_step(jcfg, jo, microbatches))
    tstep = make_train_step(cfg, to, microbatches)
    dcfg = data.LmDataConfig(vocab=cfg.vocab, global_batch=4, seq_len=32)
    for step in range(3):
        t, l = data.batch_at_step(dcfg, step)
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(t), "labels": jnp.asarray(l)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(t), "labels": torch.from_numpy(l)})
        assert sorted(tm) == sorted(jm)
        for key in ("loss", "grad_norm", "lr", "aux"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=STEP_RTOL,
                                       atol=1e-7, err_msg=f"step {step} {key}")
        assert float(tm["tokens"]) == float(jm["tokens"]) == (0 if microbatches > 1 else 128)
        assert int(ts["step"]) == step + 1
    assert all(not t.requires_grad for t in tf.tree_leaves(tp))


def test_microbatch_gradients_accumulate_in_float32(monkeypatch):
    """bf16 parameters, two microbatches: the step's gradients reach AdamW
    in float32 (the moments see the float32 mean); one microbatch keeps
    the parameters' dtype."""
    import repro_torch.train.train_loop as loop
    cfg = dataclasses.replace(configs.get_reduced("smollm_360m"), dtype="bfloat16")
    params = tf.init_params(cfg, device="cpu")
    opt, seen = O.OptConfig(), []

    def spy(p, g, s, c):
        seen.append({t.dtype for t in tf.tree_leaves(g)})
        return O.adamw_update(p, g, s, c)

    monkeypatch.setattr(loop, "adamw_update", spy)
    t, l = data.batch_at_step(data.LmDataConfig(vocab=cfg.vocab, global_batch=4,
                                                seq_len=16), 0)
    batch = {"tokens": torch.from_numpy(t), "labels": torch.from_numpy(l)}
    for n in (1, 2):
        out, _, _ = make_train_step(cfg, opt, n)(params, O.init_opt_state(params, opt), batch)
        assert all(a.dtype == b.dtype for a, b in zip(tf.tree_leaves(out),
                                                      tf.tree_leaves(params)))
    assert seen == [{torch.bfloat16}, {torch.float32}]


# ----------------------------------------------------------------- launcher

def _launch(steps, *extra):
    return launch_train.main(["--arch", "smollm-360m", "--reduced", "--steps", str(steps),
                              "--batch", "4", "--seq", "32", "--device", "cpu",
                              "--log-every", "5", *extra])


def test_launcher_improves(capsys):
    losses = _launch(30)
    out = capsys.readouterr().out
    assert out.startswith("arch=smollm-360m-reduced params=")
    assert out.strip().splitlines()[-1].endswith("improved=yes")
    assert len(losses) == 30 and np.isfinite(losses).all()


def test_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """6 steps with a checkpoint every 3, then a resume to 12, against 12
    steps straight: the same losses and the same final checkpoint, bit for
    bit."""
    straight = _launch(12, "--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "3")
    first = _launch(6, "--ckpt-dir", str(tmp_path / "b"), "--ckpt-every", "3")
    resumed = _launch(12, "--ckpt-dir", str(tmp_path / "b"), "--ckpt-every", "3",
                      "--resume")
    assert "resumed from step 6" in capsys.readouterr().out
    assert first + resumed == straight
    a, b = CheckpointManager(str(tmp_path / "a")), CheckpointManager(str(tmp_path / "b"))
    assert a.all_steps() == b.all_steps() == [9, 12]
    want, got = a.restore_flat_step(12), b.restore_flat_step(12)
    assert sorted(want) == sorted(got) and "1/step" in got
    for key in want:
        w, g = want[key], got[key]
        w = w.view(torch.int16) if torch.is_tensor(w) else w
        g = g.view(torch.int16) if torch.is_tensor(g) else g
        assert np.array_equal(np.asarray(w), np.asarray(g)), key
    assert int(got["1/step"]) == 12


def test_checkpoint_is_the_jax_managers(tmp_path):
    """(params, opt_state) of the same tree saved by both managers: the
    same manifest (leaf paths, files, shapes, dtypes) and the same data
    bytes in every leaf file; the port restores the JAX manager's
    directory."""
    arch = "granite_moe_3b_a800m"
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="bfloat16")
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = bridge.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    opt = dict(moment_dtype="bfloat16")
    jtree = (jp, JO.init_opt_state(jp, JO.OptConfig(**opt)))
    ttree = (tp, O.init_opt_state(tp, O.OptConfig(**opt)))
    JaxManager(str(tmp_path / "jax")).save(3, jtree)
    CheckpointManager(str(tmp_path / "port")).save(3, ttree)
    dirs = [tmp_path / name / "step_00000003" for name in ("jax", "port")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    assert manifests[0] == manifests[1]
    leaves = manifests[0]["leaves"]
    assert "0/embed" in leaves and "1/m/blocks/sub0/moe/router" in leaves
    assert leaves["1/step"]["dtype"] == "int32" and leaves["0/embed"]["dtype"] == "bfloat16"
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    for name in os.listdir(dirs[0]):
        if name.endswith(".npy"):       # bf16: JAX's void words, the port's uint16
            a, b = (np.load(d / name) for d in dirs)
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), name
    step, (params, state) = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        ttree, device="cpu")
    assert step == 3
    for a, b in zip(tf.tree_leaves(params), tf.tree_leaves(tp)):
        assert a.dtype == b.dtype and a.equal(b)
    assert state["step"].dtype == torch.int32


def test_example_runs_the_launcher(tmp_path, capsys):
    """``train_smollm.main`` on the CPU: the reduced smollm-360m at B 8 x S
    128, its checkpoints in the directory it is given."""
    losses = train_smollm.main(device="cpu", steps=4, ckpt_dir=str(tmp_path), resume=False)
    out = capsys.readouterr().out
    assert out.startswith("arch=smollm-360m-reduced params=") and len(losses) == 4
    assert CheckpointManager(str(tmp_path)).all_steps() == [4]
    assert train_smollm.CKPT_DIR.endswith("repro_torch_train_ckpt")


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card the launcher and the example raise rather than fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    for fn in (lambda: launch_train.main(["--reduced", "--steps", "1"]),
               lambda: train_smollm.main(steps=1, ckpt_dir=str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
