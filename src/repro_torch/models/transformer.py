"""Stacks: decoder-only / encoder-decoder / hybrid / pure-SSM, the JAX
package's ``models/transformer.py`` in torch.

Layers are *grouped*: a group is ``cfg.group_size`` consecutive layers with
(possibly) different static kinds — e.g. llama4 interleaves [dense, moe],
gemma2 alternates [local, global].  Every group shares one stacked param
tree (leading axis = n_groups), which the JAX package scans over; here a
Python loop walks the groups, each stacked leaf unbound once a walk (its
gradient is one ``stack`` of the per-layer gradients, where indexing each
layer would write a zero-filled copy of the whole stack per layer).

While grad is enabled, ``cfg.remat`` checkpoints each scanned body as the
reference's ``jax.checkpoint`` does: ``'full'`` keeps only the body's
inputs, ``'dots'`` also keeps its activation x weight products (the
products with no batch dimension).  Without grad (serving) it takes no
part; ``scan_unroll`` takes none either.

Caches are trees stacked the same way.  The zamba2 hybrid applies a single
*weight-shared* attention block every ``hybrid_attn_period`` layers, each
invocation with its own KV cache slice.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import resolve_device

from .config import ModelConfig
from .layers import attn_block, mlp_block, moe_block, rms_norm, softcap
from .sharding import hold_to_batch, weight_einsum
from .ssm import mamba_block

__all__ = ["param_specs", "init_params", "decoder_stack", "hybrid_stack",
           "encoder_stack", "encdec_decoder_stack", "encode_cross_kv",
           "logits_from_hidden", "tree_map", "tree_leaves", "tree_unbind",
           "tree_stack"]


# --------------------------------------------------------------------------
# Trees of tensors (nested dicts, the JAX package's pytrees)
# --------------------------------------------------------------------------

def tree_map(fn, *trees):
    """``fn`` over the leaves of one tree, or of same-structured trees."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_unbind(tree, n: int) -> List[Any]:
    """The ``n`` slices of a tree along every leaf's stacked leading axis,
    each leaf unbound once (views; ``None`` gives ``n`` Nones)."""
    if tree is None:
        return [None] * n
    flat = tree_map(torch.unbind, tree)
    return [tree_map(lambda parts: parts[i], flat) for i in range(n)]


def tree_stack(trees):
    """Stack a list of same-structured trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# --------------------------------------------------------------------------
# Parameter specs and init
# --------------------------------------------------------------------------
# A leaf spec is (shape, dtype, init): init is "zeros", "ones", "dt_bias",
# "a_log", or ("dense", fan_in) for normal / sqrt(fan_in), as the JAX
# package draws them.  Stacked leaves carry the leading (n, ...) axis.

def _dense(shape, fan_in, dtype):
    return (tuple(shape), dtype, ("dense", fan_in))


def _zeros(shape, dtype):
    return (tuple(shape), dtype, "zeros")


def _attn_spec(cfg: ModelConfig, lead, dtype, cross: bool = False):
    d, nh, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {
        "ln": _zeros(lead + (d,), dtype),
        "wq": _dense(lead + (d, nh, hd), d, dtype),
        "wk": _dense(lead + (d, kv, hd), d, dtype),
        "wv": _dense(lead + (d, kv, hd), d, dtype),
        "wo": _dense(lead + (nh, hd, d), nh * hd, dtype),
    }
    if cross:
        p.update({
            "xln": _zeros(lead + (d,), dtype),
            "cwq": _dense(lead + (d, nh, hd), d, dtype),
            "cwk": _dense(lead + (d, kv, hd), d, dtype),
            "cwv": _dense(lead + (d, kv, hd), d, dtype),
            "cwo": _dense(lead + (nh, hd, d), nh * hd, dtype),
        })
    return p


def _mlp_spec(cfg: ModelConfig, lead, dtype):
    d, f = cfg.d_model, cfg.d_ff
    return {"ln": _zeros(lead + (d,), dtype),
            "wi": _dense(lead + (d, 2, f), d, dtype),
            "wo": _dense(lead + (f, d), f, dtype)}


def _moe_spec(cfg: ModelConfig, lead, dtype):
    d, ep = cfg.d_model, cfg.n_experts_padded
    fe = cfg.d_ff_expert or cfg.d_ff
    return {"ln": _zeros(lead + (d,), dtype),
            "router": _dense(lead + (d, ep), d, "float32"),
            "wi": _dense(lead + (ep, d, 2, fe), d, dtype),
            "wo": _dense(lead + (ep, fe, d), fe, dtype)}


def _mamba_spec(cfg: ModelConfig, lead, dtype):
    d, din = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return {
        "ln": _zeros(lead + (d,), dtype),
        "wxz": _dense(lead + (d, 2 * din), d, dtype),
        "wbcdt": _dense(lead + (d, 2 * g * n + h), d, dtype),
        "conv_w": _dense(lead + (cfg.ssm_conv, din + 2 * g * n), cfg.ssm_conv, dtype),
        "dt_bias": (lead + (h,), "float32", "dt_bias"),
        "a_log": (lead + (h,), "float32", "a_log"),
        "d_skip": (lead + (h,), "float32", "ones"),
        "gate_norm": _zeros(lead + (din,), dtype),
        "wout": _dense(lead + (din, d), din, dtype),
    }


def _sub_spec(cfg: ModelConfig, kind: str, lead, dtype, cross: bool = False):
    if kind == "mamba":
        return {"mamba": _mamba_spec(cfg, lead, dtype)}
    p = {"attn": _attn_spec(cfg, lead, dtype, cross=cross)}
    if kind == "moe":
        p["moe"] = _moe_spec(cfg, lead, dtype)
    else:
        p["mlp"] = _mlp_spec(cfg, lead, dtype)
    return p


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's leaves as (shape, dtype, init), in the JAX
    package's tree paths and shapes."""
    dtype = cfg.dtype
    specs: Dict[str, Any] = {
        "embed": _dense((cfg.vocab_padded, cfg.d_model), cfg.d_model, dtype),
        "final_norm": _zeros((cfg.d_model,), dtype),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = _dense((cfg.d_model, cfg.vocab_padded), cfg.d_model, dtype)
    if cfg.kind == "encdec":
        specs["enc_blocks"] = _sub_spec(cfg, "attn", (cfg.n_enc_layers,), dtype)
        specs["dec_blocks"] = _sub_spec(cfg, "attn", (cfg.n_layers,), dtype, cross=True)
        specs["enc_norm"] = _zeros((cfg.d_model,), dtype)
    elif cfg.kind == "hybrid":
        specs["blocks"] = _sub_spec(cfg, "mamba", (cfg.n_layers,), dtype)
        specs["shared_attn"] = _sub_spec(cfg, "attn", (), dtype)
    else:
        specs["blocks"] = {f"sub{j}": _sub_spec(cfg, kind, (cfg.n_groups,), dtype)
                           for j, kind in enumerate(cfg.sub_block_kinds())}
    return specs


def is_leaf_spec(spec) -> bool:
    return isinstance(spec, tuple)


def _spec_map(fn, specs):
    if is_leaf_spec(specs):
        return fn(specs)
    return {k: _spec_map(fn, v) for k, v in specs.items()}


def _draw(spec, gen: torch.Generator) -> torch.Tensor:
    shape, dtype, init = spec
    if init == "zeros":
        out = torch.zeros(shape)
    elif init == "ones":
        out = torch.ones(shape)
    elif init == "dt_bias":     # dt ~ exp(U(log 1e-3, log 1e-1)), inverse softplus
        lo, hi = float(np.log(np.float32(1e-3))), float(np.log(np.float32(1e-1)))
        dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen))
        out = dt + torch.log(-torch.expm1(-dt))
    elif init == "a_log":       # log U(1, 16)
        out = torch.log(1.0 + 15.0 * torch.rand(shape, generator=gen))
    else:
        _, fan_in = init
        out = torch.randn(shape, generator=gen) / float(np.sqrt(np.float32(fan_in)))
    return out.to(getattr(torch, dtype))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Full parameter tree, drawn from ``generator`` (a CPU generator; seed 0
    by default) with the JAX package's distributions and shapes, then moved
    to ``device`` (the card unless asked for the CPU).  The same generator
    state gives the same numbers on every device."""
    device = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return _spec_map(lambda s: _draw(s, gen).to(device), param_specs(cfg))


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def _apply_sub(kind: str, p: dict, x, cfg: ModelConfig, *, positions, cache,
               cache_pos0, causal=True, xkv=None, xvalid=None):
    """Returns (x, new_cache, aux_loss); a sharded x comes back held to the
    batch spec after each block."""
    if kind == "mamba":
        x, nc = mamba_block(p["mamba"], x, cfg, cache=cache)
        return hold_to_batch(x), nc, 0.0
    window = cfg.sliding_window if kind == "attn_local" else 0
    x, nc = attn_block(p["attn"], x, cfg, positions=positions, cache=cache,
                       cache_pos0=cache_pos0, window=window, causal=causal,
                       xattn_kv=xkv, xattn_valid=xvalid)
    x = hold_to_batch(x)
    if kind == "moe":
        x, aux = moe_block(p["moe"], x, cfg)
        return hold_to_batch(x), nc, aux
    return hold_to_batch(mlp_block(p["mlp"], x, cfg)), nc, 0.0


def _save_dots(ctx, op, *args, **kwargs):
    """The ``'dots'`` policy: keep the products with no batch dimension
    (einsum runs an activation x weight product as ``mm`` or as ``bmm``
    over a batch of one), recompute the rest."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` checkpointed by the configured policy while grad is enabled
    (the reference's ``_remat``); otherwise ``fn`` itself."""
    grad = torch.is_grad_enabled()  # repro: allow[r1-host-sync] autograd's mode, a host bool
    if not (cfg.remat and grad):
        return fn
    context_fn = _ckpt.noop_context_fn
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                       _save_dots)
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


def decoder_stack(params, cfg: ModelConfig, x, *, positions, caches=None,
                  cache_pos0=None):
    """Loop over layer groups.  caches: tree stacked (n_groups, ...) or None.
    Returns (x, new_caches, aux)."""
    kinds = cfg.sub_block_kinds()

    def group_fn(x, aux, gp, gcache):
        new_cache = {}
        for j, kind in enumerate(kinds):
            sub_cache = None if gcache is None else gcache.get(f"sub{j}")
            x, nc, a = _apply_sub(kind, gp[f"sub{j}"], x, cfg, positions=positions,
                                  cache=sub_cache, cache_pos0=cache_pos0)
            if nc is not None:
                new_cache[f"sub{j}"] = nc
            aux = aux + a
        return x, aux, new_cache

    fn = _remat(group_fn, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for gp, gcache in zip(tree_unbind(params["blocks"], cfg.n_groups),
                          tree_unbind(caches, cfg.n_groups)):
        x, aux, new_cache = fn(x, aux, gp, gcache)
        new_caches.append(new_cache)
    return x, (tree_stack(new_caches) if new_caches[0] else None), aux


def hybrid_stack(params, cfg: ModelConfig, x, *, positions, caches=None,
                 cache_pos0=None):
    """Zamba2: mamba backbone + weight-shared attention block every k layers.

    caches = {'mamba': stacked (n_layers, ...) or None,
              'shared': {'k': (n_shared, B, S, KV, hd), 'v': ...} or None}
    """
    period = cfg.hybrid_attn_period
    starts = range(0, cfg.n_layers, period)
    new_shared_k, new_shared_v, new_mamba = [], [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = tree_unbind(params["blocks"], cfg.n_layers)
    mamba_caches = tree_unbind(None if caches is None else caches.get("mamba"), cfg.n_layers)
    shared = tree_unbind(None if caches is None else caches.get("shared"), len(starts))

    def layer_fn(x, lp, lc):
        x, nc, _ = _apply_sub("mamba", lp, x, cfg, positions=positions, cache=lc,
                              cache_pos0=cache_pos0)
        return x, nc

    fn = _remat(layer_fn, cfg)
    for si, start in enumerate(starts):
        # shared attention block (weights shared; per-invocation KV cache)
        x, nc, _ = _apply_sub("attn", params["shared_attn"], x, cfg, positions=positions,
                              cache=shared[si], cache_pos0=cache_pos0)
        if nc is not None:
            new_shared_k.append(nc["k"])
            new_shared_v.append(nc["v"])
        for layer in range(start, min(start + period, cfg.n_layers)):
            x, nc = fn(x, layers[layer], mamba_caches[layer])
            if nc is not None:
                new_mamba.append(nc)
    new_caches = None
    if caches is not None:
        new_caches = {
            "mamba": tree_stack(new_mamba) if new_mamba else None,
            "shared": {"k": torch.stack(new_shared_k), "v": torch.stack(new_shared_v)}
            if new_shared_k else None,
        }
    return x, new_caches, aux


def _positions(b: int, s: int, device, offset: int = 0) -> torch.Tensor:
    return (offset + torch.arange(s, dtype=torch.int32, device=device))[None].expand(b, s)


def encoder_stack(params, cfg: ModelConfig, x):
    positions = _positions(x.shape[0], x.shape[1], x.device)

    def layer_fn(x, lp):
        x, _, _ = _apply_sub("attn", lp, x, cfg, positions=positions, cache=None,
                             cache_pos0=None, causal=False)
        return x

    fn = _remat(layer_fn, cfg)
    for lp in tree_unbind(params["enc_blocks"], cfg.n_enc_layers):
        x = fn(x, lp)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def encdec_decoder_stack(params, cfg: ModelConfig, x, *, positions, enc_kv,
                         enc_valid, caches=None, cache_pos0=None):
    """Decoder with cross-attention.  enc_kv: stacked per-layer (ck, cv)."""
    def layer_fn(x, lp, lc, ekv):
        x, nc, _ = _apply_sub("attn", lp, x, cfg, positions=positions, cache=lc,
                              cache_pos0=cache_pos0, xkv=(ekv["ck"], ekv["cv"]),
                              xvalid=enc_valid)
        return x, nc

    fn = _remat(layer_fn, cfg)
    n = cfg.n_layers
    new_caches = []
    for lp, lc, ekv in zip(tree_unbind(params["dec_blocks"], n), tree_unbind(caches, n),
                           tree_unbind(enc_kv, n)):
        x, nc = fn(x, lp, lc, ekv)
        new_caches.append(nc)
    out = None if caches is None else tree_stack(new_caches)
    return x, out, torch.zeros((), dtype=torch.float32, device=x.device)


def encode_cross_kv(params, cfg: ModelConfig, enc_out):
    """Precompute stacked per-decoder-layer cross K/V from encoder output."""
    attn = params["dec_blocks"]["attn"]
    return {"ck": weight_einsum("bsd,ldnh->lbsnh", enc_out, attn["cwk"]),
            "cv": weight_einsum("bsd,ldnh->lbsnh", enc_out, attn["cwv"])}


def logits_from_hidden(params, cfg: ModelConfig, x):
    """Logits in cfg.loss_dtype (cfg.dtype by default); padded vocab entries
    at -1e9 in that dtype."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = weight_einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = weight_einsum("bsd,dv->bsv", x, params["unembed"])
    out_dtype = getattr(torch, cfg.resolved_loss_dtype)
    logits = softcap(logits.to(out_dtype), cfg.final_softcap)
    pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
    return torch.where(pad[None, None, :], -1e9, logits)
