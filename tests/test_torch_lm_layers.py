"""The port's LM layers (``repro_torch.models.layers`` and ``ssm``) against
the JAX package's on the CPU: the same inputs, made from a seed with numpy,
through both.  Float32, atol = rtol = 1e-4 unless a case states another
bound; MoE routing (experts, slots, kept claims) equal exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import layers as jl
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro.models.transformer import init_mamba_params, init_moe_params
from repro_torch.configs import get_reduced
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(want, got, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **(tol or TOL))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(tree)


# --------------------------------------------------------------------------
# norms, rope
# --------------------------------------------------------------------------

def test_rms_norm_f32():
    rng = _rng(0)
    x, scale = _normal(rng, (2, 5, 16), 3.0), _normal(rng, (16,), 0.5)
    _close(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
           tl.rms_norm(_t(x), _t(scale), 1e-6))


def test_rms_norm_bf16_scales_by_one_plus_scale_in_f32():
    """bfloat16 in and out, the arithmetic in float32: equal after the one
    rounding to bfloat16 (bound: one bfloat16 ulp, rtol 2^-7)."""
    rng = _rng(1)
    x, scale = _normal(rng, (2, 5, 64), 3.0), _normal(rng, (64,), 0.5)
    want = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16), 1e-6)
    got = tl.rms_norm(_t(x).bfloat16(), _t(scale).bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    _close(np.asarray(want.astype(jnp.float32)), got.float(), atol=0, rtol=2 ** -7)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_rotates_the_two_halves(theta):
    rng = _rng(2)
    x = _normal(rng, (2, 6, 3, 8))
    pos = rng.integers(0, 48, (2, 6)).astype(np.int32)
    _close(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta), tl.rope(_t(x), _t(pos), theta))


def test_softcap():
    x = _normal(_rng(3), (4, 9), 80.0)
    _close(jl.softcap(jnp.asarray(x), 30.0), tl.softcap(_t(x), 30.0))
    assert tl.softcap(_t(x), 0.0).equal(_t(x))


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

ATTN_CASES = {
    # name: (S, T, NH, KV, causal, window, cap, valid)
    "mha_causal": (6, 6, 4, 4, True, 0, 0.0, None),
    "gqa_causal": (6, 6, 4, 2, True, 0, 0.0, None),
    "mqa_window_softcap": (8, 8, 4, 1, True, 3, 5.0, None),
    "cross_noncausal_valid": (5, 7, 4, 2, False, 0, 0.0, "some"),
    "row_fully_masked": (4, 6, 2, 1, True, 0, 0.0, "none_row0"),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention(case):
    """GQA attention: masks, windows, softcaps and a fully masked row (the
    finite NEG_INF: uniform over the keys, not NaN)."""
    s, t, nh, kv, causal, window, cap, valid = ATTN_CASES[case]
    rng = _rng(4)
    q, k, v = _normal(rng, (2, s, nh, 8)), _normal(rng, (2, t, kv, 8)), _normal(rng, (2, t, kv, 8))
    q_pos = np.broadcast_to(np.arange(s, dtype=np.int32) + (t - s), (2, s)).copy()
    kv_pos = np.broadcast_to(np.arange(t, dtype=np.int32), (2, t)).copy()
    kv_valid = None
    if valid == "some":
        kv_valid = rng.random((2, t)) < 0.7
    elif valid == "none_row0":
        kv_valid = np.ones((2, t), bool)
        kv_valid[0] = False
    kw = dict(causal=causal, window=window, cap=cap)
    want = jax.jit(lambda q, k, v, qp, kp, valid: jl.attention(
        q, k, v, q_pos=qp, kv_pos=kp, kv_valid=valid, **kw))(
            *map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
            None if kv_valid is None else jnp.asarray(kv_valid))
    got = tl.attention(_t(q), _t(k), _t(v), q_pos=_t(q_pos), kv_pos=_t(kv_pos),
                       kv_valid=None if kv_valid is None else _t(kv_valid), **kw)
    _close(want, got)
    assert torch.isfinite(got).all()
    if valid == "none_row0":
        mean_v = _t(v)[0].repeat_interleave(nh // kv, dim=1).mean(dim=0)
        _close(mean_v.expand(s, nh, 8), got[0])


@pytest.mark.parametrize("s,chunk,window,cap", [(12, 4, 0, 0.0), (12, 5, 0, 0.0),
                                                (16, 4, 6, 20.0), (9, 3, 2, 0.0)])
def test_attention_chunked(s, chunk, window, cap):
    rng = _rng(5)
    q, k, v = _normal(rng, (2, s, 4, 8)), _normal(rng, (2, s, 2, 8)), _normal(rng, (2, s, 2, 8))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want = jax.jit(lambda q, k, v, pos: jl.attention_chunked(
        q, k, v, q_pos=pos, window=window, cap=cap, chunk=chunk))(
            *map(jnp.asarray, (q, k, v, pos)))
    got = tl.attention_chunked(_t(q), _t(k), _t(v), q_pos=_t(pos), window=window, cap=cap,
                               chunk=chunk)
    _close(want, got)
    # and the unchunked attention gives the same
    full = tl.attention(_t(q), _t(k), _t(v), q_pos=_t(pos), kv_pos=_t(pos), kv_valid=None,
                        causal=True, window=window, cap=cap)
    _close(full, got)


def _attn_cfg(**kw):
    base = dict(name="t", n_layers=1, d_model=16, n_heads=4, n_kv=2, head_dim=8,
                d_ff=32, vocab=64, dtype="float32")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _attn_params(rng, cfg, cross=False):
    d, nh, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"ln": _normal(rng, (d,), 0.1), "wq": _normal(rng, (d, nh, hd), 0.25),
         "wk": _normal(rng, (d, kv, hd), 0.25), "wv": _normal(rng, (d, kv, hd), 0.25),
         "wo": _normal(rng, (nh, hd, d), 0.18)}
    if cross:
        p.update({"xln": _normal(rng, (d,), 0.1), "cwq": _normal(rng, (d, nh, hd), 0.25),
                  "cwk": _normal(rng, (d, kv, hd), 0.25), "cwv": _normal(rng, (d, kv, hd), 0.25),
                  "cwo": _normal(rng, (nh, hd, d), 0.18)})
    return p


# (l, pos0) against an Smax of 8: inside, ending at the last slot, and past
# the end (dynamic_update_slice clamps the start to Smax - l)
CACHE_WRITES = [(1, 0), (1, 5), (3, 2), (3, 5), (1, 7), (3, 6), (3, 8), (1, 9)]


@pytest.mark.parametrize("l,pos0", CACHE_WRITES)
def test_attn_block_cache_write(l, pos0):
    """The cache write at, and past, the end lands where the reference puts
    it; the valid slots follow the unclamped pos0."""
    jcfg, cfg = _attn_cfg(sliding_window=4)
    rng = _rng(6 + l + pos0)
    p = _attn_params(rng, cfg)
    x = _normal(rng, (2, l, cfg.d_model))
    cache = {"k": _normal(rng, (2, 8, 2, 8)), "v": _normal(rng, (2, 8, 2, 8))}
    pos = np.broadcast_to(pos0 + np.arange(l, dtype=np.int32), (2, l)).copy()
    for window in (0, 4):
        want, wc = jax.jit(lambda p, x, pos, c, pos0: jl.attn_block(
            p, x, jcfg, positions=pos, cache=c, cache_pos0=pos0, window=window))(
                _tree_np(p), jnp.asarray(x), jnp.asarray(pos), cache, jnp.int32(pos0))
        got, gc = tl.attn_block(_tree_t(p), _t(x), cfg, positions=_t(pos), cache=_tree_t(cache),
                                cache_pos0=pos0, window=window)
        _close(want, got)
        for key in ("k", "v"):
            _close(wc[key], gc[key], atol=1e-6, rtol=1e-6)


def test_cache_write_allocates_one_layer():
    """A layer's cache write, on its view of a stacked cache, allocates that
    layer's slots alone: 983,040 bytes at smollm-360m's B 8 x 192 slots x
    5 KV heads x 64 in bf16, where ``slice_scatter`` would clone the whole
    32-layer stack (31,457,280 bytes)."""
    stack = torch.zeros((32, 8, 192, 5, 64), dtype=torch.bfloat16)
    upd = torch.ones((8, 1, 5, 64))
    out = tl._cache_write(stack[3], upd, 5)
    assert out.untyped_storage().nbytes() == 8 * 192 * 5 * 64 * 2 == 983_040
    assert torch.slice_scatter(stack[3], upd.bfloat16(), dim=1, start=5, end=6
                               ).untyped_storage().nbytes() == 31_457_280
    assert (out[:, 5] == 1).all() and not out[:, :5].any() and not out[:, 6:].any()
    assert not stack.any()


def test_attn_block_cross_attention_and_no_cache():
    jcfg, cfg = _attn_cfg()
    rng = _rng(7)
    p = _attn_params(rng, cfg, cross=True)
    x, enc = _normal(rng, (2, 5, cfg.d_model)), _normal(rng, (2, 7, cfg.d_model))
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    valid = _rng(8).random((2, 7)) < 0.6
    jkv = jl.cross_kv(_tree_np(p), jnp.asarray(enc))
    tkv = tl.cross_kv(_tree_t(p), _t(enc))
    for a, b in zip(jkv, tkv):
        _close(a, b)
    want, _ = jax.jit(lambda p, x, pos, kv, valid: jl.attn_block(
        p, x, jcfg, positions=pos, cache=None, cache_pos0=None, window=0, xattn_kv=kv,
        xattn_valid=valid))(_tree_np(p), jnp.asarray(x), jnp.asarray(pos), jkv,
                            jnp.asarray(valid))
    got, nc = tl.attn_block(_tree_t(p), _t(x), cfg, positions=_t(pos), cache=None,
                            cache_pos0=None, window=0, xattn_kv=tkv, xattn_valid=_t(valid))
    assert nc is None
    _close(want, got)


def test_attn_block_chunked_training_path():
    jcfg, cfg = _attn_cfg(attn_chunk=4)
    rng = _rng(9)
    p = _attn_params(rng, cfg)
    x = _normal(rng, (2, 12, cfg.d_model))
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want, _ = jax.jit(lambda p, x, pos: jl.attn_block(
        p, x, jcfg, positions=pos, cache=None, cache_pos0=None, window=0))(
            _tree_np(p), jnp.asarray(x), jnp.asarray(pos))
    got, _ = tl.attn_block(_tree_t(p), _t(x), cfg, positions=_t(pos), cache=None,
                           cache_pos0=None, window=0)
    _close(want, got)


# --------------------------------------------------------------------------
# MLP and MoE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_mlp_block(act):
    jcfg, cfg = _attn_cfg(act=act)
    rng = _rng(10)
    p = {"ln": _normal(rng, (16,), 0.1), "wi": _normal(rng, (16, 2, 32), 0.25),
         "wo": _normal(rng, (32, 16), 0.18)}
    x = _normal(rng, (2, 5, 16))
    _close(jl.mlp_block(_tree_np(p), jnp.asarray(x), jcfg),
           tl.mlp_block(_tree_t(p), _t(x), cfg))


def _moe_cfgs(**kw):
    """tests/test_moe.py's config, with overrides."""
    base = dict(name="t", n_layers=1, d_model=16, n_heads=2, n_kv=2, head_dim=8,
                d_ff=32, vocab=64, n_experts=4, top_k=1, d_ff_expert=32, moe_group=64,
                capacity_factor=2.0, dtype="float32")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _reduced_moe(arch):
    jc = jax_reduced(arch)
    return jc, get_reduced(arch)


# name: (cfgs, x shape, router override, positive x)
MOE_CASES = {
    "default": (lambda: _moe_cfgs(), (2, 8, 16), None, False),
    "padding_expert_vetoed": (lambda: _moe_cfgs(n_experts=3), (1, 8, 16), "pad5", False),
    "single_expert_dense": (lambda: _moe_cfgs(n_experts=1, capacity_factor=100.0,
                                              moe_group=1024), (2, 16, 16), None, False),
    "capacity_drops": (lambda: _moe_cfgs(capacity_factor=0.25), (1, 64, 16), "all0", True),
    "top2_normalized": (lambda: _moe_cfgs(top_k=2, n_experts=8), (1, 8, 16), None, False),
    "router_ties": (lambda: _moe_cfgs(top_k=2, n_experts=8), (2, 8, 16), "zeros", False),
    "group_divisor": (lambda: _moe_cfgs(moe_group=5), (2, 6, 16), None, False),
    "decode_b2": (lambda: _moe_cfgs(top_k=2, n_experts=8), (2, 1, 16), None, False),
    "granite_reduced": (lambda: _reduced_moe("granite_moe_3b_a800m"), (2, 16, 64), None, False),
    "llama4_reduced": (lambda: _reduced_moe("llama4_maverick_400b_a17b"), (2, 12, 64),
                       None, False),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block(case, monkeypatch):
    """Routing (top_e, slot, keep) equal exactly to the reference's, read from
    its calls of ``lax.top_k`` and ``jax.nn.one_hot``; output and aux within
    tolerance."""
    make, shape, router, positive = MOE_CASES[case]
    jcfg, cfg = make()
    p = _tree_np(init_moe_params(jax.random.PRNGKey(3), jcfg))
    if router is not None:
        r = np.zeros(p["router"].shape, np.float32)
        if router == "pad5":
            r[:, 5] = 100.0     # a padding expert the mask must veto
        elif router == "all0":
            r[:, 0] = 10.0
        p["router"] = r
    x = _normal(_rng(11), shape)
    if positive:
        x = np.abs(x) + 0.1

    seen = {"top_k": [], "one_hot": []}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot
    monkeypatch.setattr(jax.lax, "top_k",
                        lambda *a, **k: seen["top_k"].append(top_k(*a, **k)) or seen["top_k"][-1])
    monkeypatch.setattr(jax.nn, "one_hot",
                        lambda idx, n, **k: seen["one_hot"].append((idx, n)) or one_hot(idx, n, **k))

    @jax.jit
    def reference(p, x):        # the calls' operands come out beside the result
        y, aux = jl.moe_block(p, x, jcfg)
        (top_w, top_e), = seen["top_k"]
        return y, aux, top_w, top_e, seen["one_hot"][1][0]

    want_y, want_aux, j_top_w, j_top_e, j_slot = reference(p, jnp.asarray(x))
    monkeypatch.undo()
    ep, cap = seen["one_hot"][0][1], seen["one_hot"][1][1]
    j_keep = (np.asarray(j_slot) < cap) & (np.asarray(jax.nn.softmax(j_top_w, axis=-1)) > 0)

    route = tl.moe_route(_tree_t(p), _t(x), cfg)
    assert ep == cfg.n_experts_padded and cap == route["cap"]
    np.testing.assert_array_equal(route["top_e"].numpy(), np.asarray(j_top_e))
    np.testing.assert_array_equal(route["slot"].numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(route["keep"].numpy(), j_keep)
    assert (route["top_e"] < cfg.n_experts).all()
    got_y, got_aux = tl.moe_block(_tree_t(p), _t(x), cfg)
    _close(want_y, got_y)
    _close(want_aux, got_aux)
    if case == "capacity_drops":
        assert int((~route["keep"]).sum()) == shape[1] - route["cap"]
    if case == "router_ties":
        assert (route["top_e"] == torch.tensor([0, 1])).all()


def test_moe_capacity_and_group_of_a_decode_step():
    """A decode step with B 2: a group of 2 tokens, capacity at least 4."""
    _, cfg = _reduced_moe("granite_moe_3b_a800m")
    for group in (1, 2, 64, 100):
        assert tl.moe_capacity(cfg, group) == jl.moe_capacity(jax_reduced(
            "granite_moe_3b_a800m"), group)
    assert tl.moe_capacity(cfg, 2) >= 4
    p = _tree_t(_tree_np(init_moe_params(jax.random.PRNGKey(0), jax_reduced(
        "granite_moe_3b_a800m"))))
    route = tl.moe_route(p, _t(_normal(_rng(12), (2, 1, cfg.d_model))), cfg)
    assert route["xt"].shape == (1, 2, cfg.d_model) and route["cap"] == 4


# --------------------------------------------------------------------------
# Mamba-2
# --------------------------------------------------------------------------

def test_segsum():
    a = _normal(_rng(13), (2, 3, 6))
    want, got = np.asarray(jssm._segsum(jnp.asarray(a))), tssm._segsum(_t(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(want), np.isneginf(got))
    fin = np.isfinite(want)
    _close(want[fin], got[fin])


@pytest.mark.parametrize("l,chunk,g", [(8, 4, 1), (16, 8, 1), (12, 4, 2), (16, 16, 1)])
def test_ssd_chunked(l, chunk, g):
    rng = _rng(l)
    bs, h, p, n = 2, 4, 8, 16
    x = _normal(rng, (bs, l, h, p))
    dt_a = -np.abs(_normal(rng, (bs, l, h))) * 0.5
    b, c = _normal(rng, (bs, l, g, n)), _normal(rng, (bs, l, g, n))
    wy, ws = jax.jit(jssm.ssd_chunked, static_argnums=4)(*map(jnp.asarray, (x, dt_a, b, c)),
                                                         chunk)
    gy, gs = tssm.ssd_chunked(*map(_t, (x, dt_a, b, c)), chunk)
    _close(wy, gy)
    _close(ws, gs)
    assert gs.dtype == torch.float32


def test_ssd_chunked_refuses_a_ragged_length():
    rng = _rng(14)
    args = (_normal(rng, (1, 6, 2, 4)), -np.abs(_normal(rng, (1, 6, 2))),
            _normal(rng, (1, 6, 1, 4)), _normal(rng, (1, 6, 1, 4)))
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*map(jnp.asarray, args), 4)
    with pytest.raises(ValueError):
        tssm.ssd_chunked(*map(_t, args), 4)


@pytest.mark.parametrize("with_cache", [False, True])
def test_conv1d_causal(with_cache):
    rng = _rng(15)
    x, w = _normal(rng, (2, 5, 6)), _normal(rng, (4, 6))
    cache = _normal(rng, (2, 3, 6)) if with_cache else None
    wy, wc = jssm._conv1d_causal(jnp.asarray(x), jnp.asarray(w),
                                 None if cache is None else jnp.asarray(cache))
    gy, gc = tssm._conv1d_causal(_t(x), _t(w), None if cache is None else _t(cache))
    _close(wy, gy)
    if with_cache:
        _close(wc, gc)
    else:
        assert gc is None


def _mamba(arch="mamba2_370m"):
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    p = _tree_np(init_mamba_params(jax.random.PRNGKey(1), jcfg))
    return jcfg, cfg, p


def _mamba_cache(cfg, bs, rng=None):
    shapes = {"conv": (bs, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state),
              "ssm": (bs, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim)}
    return {k: (np.zeros(s, np.float32) if rng is None else _normal(rng, s, 0.3))
            for k, s in shapes.items()}


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_1_2b"])
def test_mamba_block_prefill_and_decode(arch):
    """The prefill form and each O(1) decode step against the reference's,
    and the port's decode against its own prefill (tests/test_ssm.py's
    bound: atol 1e-4, rtol 1e-3)."""
    jcfg, cfg, p = _mamba(arch)
    bs, l = 2, 8
    x = _normal(_rng(16), (bs, l, cfg.d_model), 0.1)
    block = jax.jit(lambda p, x, c: jssm.mamba_block(p, x, jcfg, cache=c))
    wy, _ = block(p, jnp.asarray(x), None)
    gy, gc = tssm.mamba_block(_tree_t(p), _t(x), cfg, cache=None)
    assert gc is None
    _close(wy, gy)
    jc, tc = _mamba_cache(cfg, bs), _tree_t(_mamba_cache(cfg, bs))
    outs = []
    for t in range(l):
        wt, jc = block(p, jnp.asarray(x[:, t:t + 1]), jc)
        gt, tc = tssm.mamba_block(_tree_t(p), _t(x[:, t:t + 1]), cfg, cache=tc)
        _close(wt, gt)
        for key in ("conv", "ssm"):
            _close(jc[key], tc[key])
        outs.append(gt[:, 0])
    _close(gy, torch.stack(outs, dim=1), atol=1e-4, rtol=1e-3)


def test_mamba_block_prefill_into_a_cache_ignores_its_state():
    """A cache with l > 1 takes the chunked path from a zero state, as the
    reference does: the given SSM state changes nothing, the conv window
    does."""
    jcfg, cfg, p = _mamba()
    bs, l = 2, 8
    x = _normal(_rng(17), (bs, l, cfg.d_model), 0.1)
    cache = _mamba_cache(cfg, bs, _rng(18))
    zero_ssm = dict(cache, ssm=np.zeros_like(cache["ssm"]))
    wy, wc = jax.jit(lambda p, x, c: jssm.mamba_block(p, x, jcfg, cache=c))(
        p, jnp.asarray(x), cache)
    gy, gc = tssm.mamba_block(_tree_t(p), _t(x), cfg, cache=_tree_t(cache))
    gy0, gc0 = tssm.mamba_block(_tree_t(p), _t(x), cfg, cache=_tree_t(zero_ssm))
    _close(wy, gy)
    for key in ("conv", "ssm"):
        _close(wc[key], gc[key])
        assert gc[key].equal(gc0[key])
    assert gy.equal(gy0)
    # a length that is not a multiple of min(ssm_chunk, l) raises in both
    x12 = _normal(_rng(19), (bs, 12, cfg.d_model), 0.1)
    with pytest.raises(AssertionError):
        jssm.mamba_block(p, jnp.asarray(x12), jcfg, cache=None)
    with pytest.raises(ValueError):
        tssm.mamba_block(_tree_t(p), _t(x12), dataclasses.replace(cfg), cache=None)
