"""The gradient of the port's ``train_loss`` against the JAX package's on the
CPU: every architecture's ``reduced()`` (and smollm and gemma2 through the
chunked attention, gemma2's window inside the sequence) with the JAX
``init_params(PRNGKey(0))`` parameters bridged across, the port's
``train.value_and_grad`` against a jitted ``jax.value_and_grad`` of
``repro.models.model.train_loss``.  Float32: total, loss and aux within
1e-5 relative, every leaf's gradient within GRAD_SHARE of that leaf's max
|g|.  Also: ``remat`` off, ``'full'`` and ``'dots'`` give the same
gradients bit for bit; ``'dots'`` keeps the activation x weight products;
the forward's values do not depend on the grad mode; bf16 within
BF16_SHARE."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.train.train_loop import value_and_grad

torch.set_num_threads(1)
# float32, the same parameters: the per-leaf error measured 1.0e-6 to
# 3.6e-6 of max |g| (summation order); bf16 rounds every intermediate
GRAD_SHARE, BF16_SHARE = 1e-4, 0.05
VALUE_RTOL = 1e-5
# (arch, overrides of both configs, sequence length)
CASES = {arch: (arch, {}, 16) for arch in configs.ARCHS}
CASES["smollm_360m_chunked"] = ("smollm_360m", {"attn_chunk": 8}, 16)
CASES["gemma2_27b_window_chunked"] = ("gemma2_27b", {"attn_chunk": 8}, 32)


def _configs(arch, **over):
    return (dataclasses.replace(jconfigs.get_reduced(arch), **over),
            dataclasses.replace(configs.get_reduced(arch), **over))


def _batch(cfg, s=16, b=2):
    out = {"tokens": np.random.default_rng(0).integers(1, cfg.vocab, (b, s)).astype(np.int32),
           "labels": np.random.default_rng(1).integers(1, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend or cfg.kind == "encdec":
        out["frontend"] = np.random.default_rng(2).normal(
            0, 0.02, (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return out


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_paths(v, path) if isinstance(v, dict) else {path: v})
    return out


def _reference(jcfg, cfg, bt):
    """The JAX value and gradient, and the bridged parameters."""
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = bridge.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    grad = jax.jit(jax.value_and_grad(lambda p, b: JM.train_loss(p, jcfg, b), has_aux=True))
    (total, metrics), grads = grad(jp, {k: jnp.asarray(v) for k, v in bt.items()})
    return tp, (total, metrics), _paths(jax.tree.map(np.asarray, grads))


def _assert_grads_near(want, got, share):
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        bound = share * float(np.abs(w).max()) + 1e-12
        err = float(np.abs(g - w).max())
        assert err <= bound, (path, err, bound)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_equals_the_reference(case):
    arch, over, s = CASES[case]
    jcfg, cfg = _configs(arch, **over)
    bt = _batch(cfg, s)
    tp, (want_total, want_m), want_g = _reference(jcfg, cfg, bt)
    (total, metrics), grads = value_and_grad(cfg)(tp, {k: torch.from_numpy(v)
                                                       for k, v in bt.items()})
    np.testing.assert_allclose(float(total), float(want_total), rtol=VALUE_RTOL)
    for key in ("loss", "aux"):
        np.testing.assert_allclose(float(metrics[key]), float(want_m[key]), rtol=VALUE_RTOL,
                                   atol=1e-7)
    assert int(metrics["tokens"]) == int(want_m["tokens"])
    assert not total.requires_grad and all(
        not g.requires_grad and g.dtype == p.dtype
        for g, p in zip(tf.tree_leaves(grads), tf.tree_leaves(tp)))
    _assert_grads_near(want_g, _paths(grads), GRAD_SHARE)


def test_bf16_gradient_near_the_reference():
    """smollm reduced in bf16: the gradients in bf16, each leaf within
    BF16_SHARE of its max |g| of the reference's."""
    jcfg, cfg = _configs("smollm_360m", dtype="bfloat16")
    bt = _batch(cfg)
    tp, (want_total, _), want_g = _reference(jcfg, cfg, bt)
    (total, _), grads = value_and_grad(cfg)(tp, {k: torch.from_numpy(v) for k, v in bt.items()})
    assert all(g.dtype == torch.bfloat16 for g in tf.tree_leaves(grads))
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-2)
    _assert_grads_near(want_g, _paths(grads), BF16_SHARE)


def _port_inputs(arch, seed=0):
    cfg = configs.get_reduced(arch)
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return cfg, params, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_remat_gradients_are_bit_for_bit(arch):
    """remat off, 'full' and 'dots' checkpointing give the same total and
    gradients, bit for bit (the recomputation repeats the same ops)."""
    cfg, params, batch = _port_inputs(arch)
    runs = {}
    for name, over in (("off", dict(remat=False)), ("full", dict(remat=True)),
                       ("dots", dict(remat=True, remat_policy="dots"))):
        (total, _), grads = value_and_grad(dataclasses.replace(cfg, **over))(params, batch)
        runs[name] = [total, *tf.tree_leaves(grads)]
    for name in ("full", "dots"):
        assert all(a.equal(b) for a, b in zip(runs["off"], runs[name])), name


class _CountProducts(TorchDispatchMode):
    """Counts the activation x weight products (``mm``, or ``bmm`` over a
    batch of one) that run under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default or (
                func is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_370m"])
def test_dots_policy_saves_the_weight_products(arch):
    """Under 'full' the backward recomputes every forward product; under
    'dots' none: its backward runs as many products as without remat."""
    cfg, params, batch = _port_inputs(arch)
    counts = {}
    for name, over in (("off", dict(remat=False)), ("full", dict(remat=True)),
                       ("dots", dict(remat=True, remat_policy="dots"))):
        c = dataclasses.replace(cfg, **over)
        leaves = tf.tree_map(lambda p: p.detach().requires_grad_(True), params)
        with _CountProducts() as fwd:
            total, _ = M.train_loss(leaves, c, batch)
        with _CountProducts() as bwd:
            torch.autograd.grad(total, list(tf.tree_leaves(leaves)), allow_unused=True)
        counts[name] = (fwd.n, bwd.n)
    forward_in_stack = counts["full"][1] - counts["off"][1]
    assert forward_in_stack > 0
    assert counts["dots"][1] == counts["off"][1]
    assert counts["off"][0] == counts["full"][0] == counts["dots"][0]


@pytest.mark.parametrize("arch", ["smollm_360m", "seamless_m4t_medium", "zamba2_1_2b"])
def test_forward_values_do_not_depend_on_grad_mode(arch):
    """With remat on, train_loss and prefill give the same values bit for
    bit with grad enabled (checkpointed) and under no_grad (serving)."""
    cfg, params, batch = _port_inputs(arch)
    cfg = dataclasses.replace(cfg, remat=True)
    with torch.no_grad():
        want = [M.train_loss(params, cfg, batch)[0], M.prefill(params, cfg, batch)]
    leaves = tf.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        got = [M.train_loss(leaves, cfg, batch)[0], M.prefill(leaves, cfg, batch)]
    assert all(g.requires_grad for g in got)
    assert all(w.equal(g.detach()) for w, g in zip(want, got))


def test_tree_unbind_slices_views():
    """``tree_unbind``: every leaf's slices along its leading axis, views of
    the stack, and n Nones for None."""
    tree = {"a": torch.arange(6.0).reshape(3, 2), "b": {"c": torch.arange(3)}}
    parts = tf.tree_unbind(tree, 3)
    assert len(parts) == 3
    for i, part in enumerate(parts):
        assert part["a"].equal(tree["a"][i]) and part["b"]["c"].equal(tree["b"]["c"][i])
        assert part["a"].data_ptr() == tree["a"][i].data_ptr()
    assert tf.tree_unbind(None, 2) == [None, None]
