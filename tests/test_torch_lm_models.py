"""The port's language models (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's on the CPU: every architecture's ``reduced()``
with the JAX ``init_params(PRNGKey(0))`` parameters (jitted) bridged across;
``prefill`` logits, eight teacher-forced ``decode_step``s and the caches
they return, and ``train_loss`` with its metrics, within float32
atol = rtol = 1e-4.  Also the configs, cache shapes, the port's own init and
the module's ``state_dict`` layout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models import transformer as tf

torch.set_num_threads(1)
ARCHS = configs.ARCHS
TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_STEPS = 8


def _batch(cfg, b=2, s=16):
    """tests/test_models.py's batch."""
    out = {"tokens": np.random.default_rng(0).integers(1, cfg.vocab, (b, s)).astype(np.int32),
           "labels": np.random.default_rng(1).integers(1, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend or cfg.kind == "encdec":
        out["frontend"] = np.full((b, cfg.frontend_len, cfg.d_model), 0.02, np.float32)
    return out


def _jax_params(jcfg, key=0):
    return jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(key), jcfg)


def _bridged(cfg, jparams):
    return bridge.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               **(tol or TOL))


def _paths(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_paths(v, path) if isinstance(v, dict) else {path: v})
    return out


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(p.key for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_equals_the_reference(arch):
    """prefill logits, 8 teacher-forced decode steps (logits and the caches
    they return) and train_loss with its metrics, against the reference
    with the same parameters."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = _jax_params(jcfg)
    tp = _bridged(cfg, jp)
    bt = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in bt.items()}
    tb = {k: torch.from_numpy(v) for k, v in bt.items()}

    want_total, want_m = jax.jit(lambda p, b: JM.train_loss(p, jcfg, b))(jp, jb)
    got_total, got_m = M.train_loss(tp, cfg, tb)
    _close(want_total, got_total)
    for key in ("loss", "aux"):
        _close(want_m[key], got_m[key])
    assert int(got_m["tokens"]) == int(want_m["tokens"])

    want = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(jp, jb)
    got = M.prefill(tp, cfg, tb)
    assert got.shape == (2, 1, cfg.vocab_padded)
    _close(want, got)

    jekv = tekv = None
    if cfg.kind == "encdec":
        jekv = jtf.encode_cross_kv(jp, jcfg, jtf.encoder_stack(jp, jcfg, jb["frontend"]))
        tekv = tf.encode_cross_kv(tp, cfg, tf.encoder_stack(tp, cfg, tb["frontend"]))
        for key in ("ck", "cv"):
            _close(jekv[key], tekv[key])
    step = jax.jit(lambda p, c, t, i, e: JM.decode_step(p, jcfg, c, t, i, enc_kv=e))
    jc = JM.make_caches(jcfg, 2, 12, jnp.float32)
    tc = M.make_caches(cfg, 2, 12, torch.float32, device="cpu")
    for i in range(DECODE_STEPS):
        want, jc = step(jp, jc, jb["tokens"][:, i:i + 1], jnp.int32(i), jekv)
        got, tc = M.decode_step(tp, cfg, tc, tb["tokens"][:, i:i + 1], i, enc_kv=tekv)
        _close(want, got)
        if cfg.vocab_padded > cfg.vocab:
            assert (got[..., cfg.vocab:] == -1e9).all()
    want_c, got_c = _jax_paths(jc), _paths(tc)
    assert sorted(want_c) == sorted(got_c)
    for path, leaf in want_c.items():
        assert got_c[path].dtype == torch.float32, path
        _close(leaf, got_c[path])


@pytest.mark.parametrize("arch", ["smollm_360m", "gemma2_27b", "zamba2_1_2b"])
def test_multi_token_decode_step_follows_the_reference(arch):
    """A decode step of several tokens gives each of them position pos0, as
    the reference does (``model.py``'s positions broadcast): not a prefill.
    The port holds that, and the step after it, to the reference."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jp = _jax_params(jcfg)
    tp = _bridged(cfg, jp)
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (2, 9)).astype(np.int32)
    step = jax.jit(lambda p, c, t, i: JM.decode_step(p, jcfg, c, t, i))
    jc = JM.make_caches(jcfg, 2, 12, jnp.float32)
    tc = M.make_caches(cfg, 2, 12, torch.float32, device="cpu")
    for lo, hi in ((0, 8), (8, 9)):
        want, jc = step(jp, jc, jnp.asarray(toks[:, lo:hi]), jnp.int32(lo))
        got, tc = M.decode_step(tp, cfg, tc, torch.from_numpy(toks[:, lo:hi]), lo)
        _close(want, got)
    for path, leaf in _jax_paths(jc).items():
        _close(leaf, _paths(tc)[path])
    prefill = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :8])})
    one_step, _ = M.decode_step(tp, cfg, M.make_caches(cfg, 2, 12, torch.float32, "cpu"),
                                torch.from_numpy(toks[:, :8]), 0)
    if cfg.kind != "ssm":
        assert not torch.allclose(one_step[:, -1:], prefill, **TOL)


@pytest.mark.parametrize("arch", ["smollm_360m", "gemma2_27b"])
def test_bf16_forward(arch):
    """The bf16 model: the embedding scale cast to bf16 (31.0 at d 960, as
    ``model.py`` casts it) equals the reference's bit for bit, and prefill
    logits agree within a sanity bound of 0.1 x max |logit| (bf16 rounding
    of every intermediate, in another order)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="bfloat16")
    jp = _jax_params(jcfg)
    tp = _bridged(cfg, jp)
    assert tp["embed"].dtype == torch.bfloat16 and tp["final_norm"].dtype == torch.bfloat16
    toks = np.random.default_rng(4).integers(1, cfg.vocab, (2, 16)).astype(np.int32)
    want_x = JM._embed(jp, jcfg, jnp.asarray(toks))
    got_x = M._embed(tp, cfg, torch.from_numpy(toks))
    assert got_x.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_x.float().numpy(), np.asarray(want_x, np.float32))
    full = configs.get_config("smollm_360m")
    assert torch.full((), float(np.sqrt(np.float32(full.d_model))),
                      dtype=torch.bfloat16).item() == 31.0
    want = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(jp, {"tokens": jnp.asarray(toks)})
    got = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)[..., :cfg.vocab]
    err = np.abs(got.float().numpy()[..., :cfg.vocab] - want).max()
    assert err <= 0.1 * np.abs(want).max(), err


@pytest.mark.parametrize("arch", ARCHS)
def test_make_caches_shapes(arch):
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    want = _jax_paths(jax.eval_shape(lambda: JM.make_caches(jcfg, 3, 10, jnp.bfloat16)))
    got = _paths(M.make_caches(cfg, 3, 10, torch.bfloat16, device="cpu"))
    assert sorted(want) == sorted(got)
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).removeprefix("torch.") == leaf.dtype.name, path
        assert not got[path].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    """Full and reduced: every field, the derived properties, the sub-block
    kinds and param_count."""
    for jcfg, cfg in ((jconfigs.get_config(arch), configs.get_config(arch)),
                      (jconfigs.get_reduced(arch), configs.get_reduced(arch))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.sub_block_kinds() == jcfg.sub_block_kinds()
        for prop in ("resolved_loss_dtype", "vocab_padded", "n_experts_padded", "d_inner",
                     "ssm_heads", "group_size", "n_groups"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert configs.canonical("smollm-360m") == "smollm_360m"
    assert configs.ARCHS == jconfigs.ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_tree_and_spread(arch):
    """The port's own init: the JAX tree paths, shapes and dtypes; dense
    leaves with std 1/sqrt(fan_in) (within 10% where a leaf holds 4,096 or
    more draws), zero norm scales, d_skip ones, softplus(dt_bias) in
    [1e-3, 1e-1] and a_log in [0, log 16]."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    want = _jax_paths(jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)))
    got = _paths(tf.init_params(cfg, device="cpu"))
    assert sorted(want) == sorted(got)
    spec_leaves = _paths(tf.param_specs(cfg))
    for path, leaf in want.items():
        t = got[path]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == leaf.dtype.name, path
        shape, _, init = spec_leaves[path]
        name = path.rsplit(".", 1)[-1]
        if init == "zeros":
            assert not t.any(), path
        elif name == "d_skip":
            assert (t == 1).all()
        elif name == "dt_bias":
            dt = torch.nn.functional.softplus(t)
            assert (dt >= 1e-3 * 0.999).all() and (dt <= 1e-1 * 1.001).all()
        elif name == "a_log":
            assert (t >= 0).all() and (t <= np.log(16.0)).all()
        else:
            std = 1.0 / np.sqrt(init[1])
            if t.numel() >= 4096:
                assert abs(float(t.float().std()) / std - 1) < 0.1, (path, float(t.std()), std)
                assert abs(float(t.float().mean())) < 0.1 * std, path
    # one generator state, the same draws
    again = _paths(tf.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                  device="cpu"))
    assert all(again[p].equal(got[p]) for p in got)


def test_language_model_state_dict_is_the_jax_layout():
    """``LanguageModel``'s state_dict keys are the JAX leaf paths joined by
    '.', with the JAX shapes (stacked blocks keep their leading axis); its
    methods equal the functions over its tree."""
    for arch in ("llama4_maverick_400b_a17b", "seamless_m4t_medium", "zamba2_1_2b"):
        jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
        want = _jax_paths(jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)))
        lm = M.LanguageModel(cfg, device="cpu")
        sd = lm.state_dict()
        assert sorted(sd) == sorted(want)
        assert all(tuple(sd[k].shape) == want[k].shape for k in sd)
        assert not any(p.requires_grad for p in lm.parameters())
    cfg = configs.get_reduced("smollm_360m")
    params = _bridged(cfg, _jax_params(jconfigs.get_reduced("smollm_360m")))
    lm = M.LanguageModel(cfg, params=params)
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    assert lm.prefill({"tokens": toks}).equal(M.prefill(params, cfg, {"tokens": toks}))
    caches = lm.make_caches(2, 4, torch.float32)
    a, _ = lm.decode_step(caches, toks[:, :1], 0)
    b, _ = M.decode_step(params, cfg, caches, toks[:, :1], 0)
    assert a.equal(b)
    lm2 = M.LanguageModel(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    lm2.load_state_dict(lm.state_dict())
    assert lm2.prefill({"tokens": toks}).equal(lm.prefill({"tokens": toks}))


def test_entry_points_default_to_the_card():
    """Without a card, the entry points raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    cfg = configs.get_reduced("smollm_360m")
    for fn in (lambda: M.LanguageModel(cfg), lambda: M.init_params(cfg),
               lambda: M.make_caches(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_bridge_refuses_a_mismatched_tree():
    cfg = configs.get_reduced("gemma_2b")
    tree = jax.tree.map(np.asarray, _jax_params(jconfigs.get_reduced("gemma_2b")))
    bridge.lm_params_from_numpy(cfg, tree)
    bad = dict(tree, final_norm=tree["final_norm"][:-1])
    with pytest.raises(ValueError, match="final_norm"):
        bridge.lm_params_from_numpy(cfg, bad)
    with pytest.raises(ValueError, match="keys"):
        bridge.lm_params_from_numpy(cfg, dict(tree, extra=tree["final_norm"]))
    with pytest.raises(ValueError, match="embed"):
        bridge.lm_params_from_numpy(dataclasses.replace(cfg, dtype="bfloat16"), tree)
