"""Stacks: decoder-only / encoder-decoder / hybrid / pure-SSM, the JAX
package's ``models/transformer.py`` in torch.

Layers are *grouped*: a group is ``cfg.group_size`` consecutive layers with
(possibly) different static kinds — e.g. llama4 interleaves [dense, moe],
gemma2 alternates [local, global].  Every group shares one stacked param
tree (leading axis = n_groups), which the JAX package scans over; here a
Python loop walks the groups.  ``remat``, ``remat_policy`` and
``scan_unroll`` shape the reference's compiled scan and take no part in
this forward.

Caches are trees stacked the same way.  The zamba2 hybrid applies a single
*weight-shared* attention block every ``hybrid_attn_period`` layers, each
invocation with its own KV cache slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device

from .config import ModelConfig
from .layers import attn_block, mlp_block, moe_block, rms_norm, softcap
from .ssm import mamba_block

__all__ = ["param_specs", "init_params", "decoder_stack", "hybrid_stack",
           "encoder_stack", "encdec_decoder_stack", "encode_cross_kv",
           "logits_from_hidden", "tree_map", "tree_index", "tree_stack"]


# --------------------------------------------------------------------------
# Trees of tensors (nested dicts, the JAX package's pytrees)
# --------------------------------------------------------------------------

def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_index(tree, i):
    """Every leaf's slice ``[i]`` along its stacked leading axis."""
    return tree_map(lambda a: a[i], tree)


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
    """Returns (x, new_cache, aux_loss)."""
    if kind == "mamba":
        x, nc = mamba_block(p["mamba"], x, cfg, cache=cache)
        return x, nc, 0.0
    window = cfg.sliding_window if kind == "attn_local" else 0
    x, nc = attn_block(p["attn"], x, cfg, positions=positions, cache=cache,
                       cache_pos0=cache_pos0, window=window, causal=causal,
                       xattn_kv=xkv, xattn_valid=xvalid)
    if kind == "moe":
        x, aux = moe_block(p["moe"], x, cfg)
        return x, nc, aux
    return mlp_block(p["mlp"], x, cfg), nc, 0.0


def decoder_stack(params, cfg: ModelConfig, x, *, positions, caches=None,
                  cache_pos0=None):
    """Loop over layer groups.  caches: tree stacked (n_groups, ...) or None.
    Returns (x, new_caches, aux)."""
    kinds = cfg.sub_block_kinds()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for gi in range(cfg.n_groups):
        gp = tree_index(params["blocks"], gi)
        gcache = None if caches is None else tree_index(caches, gi)
        new_cache = {}
        for j, kind in enumerate(kinds):
            sub_cache = None if gcache is None else gcache.get(f"sub{j}")
            x, nc, a = _apply_sub(kind, gp[f"sub{j}"], x, cfg, positions=positions,
                                  cache=sub_cache, cache_pos0=cache_pos0)
            if nc is not None:
                new_cache[f"sub{j}"] = nc
            aux = aux + a
        new_caches.append(new_cache)
    return x, (tree_stack(new_caches) if new_caches[0] else None), aux


def hybrid_stack(params, cfg: ModelConfig, x, *, positions, caches=None,
                 cache_pos0=None):
    """Zamba2: mamba backbone + weight-shared attention block every k layers.

    caches = {'mamba': stacked (n_layers, ...) or None,
              'shared': {'k': (n_shared, B, S, KV, hd), 'v': ...} or None}
    """
    period = cfg.hybrid_attn_period
    new_shared_k, new_shared_v, new_mamba = [], [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mamba_caches = None if caches is None else caches.get("mamba")
    shared = None if caches is None else caches.get("shared")
    for si, start in enumerate(range(0, cfg.n_layers, period)):
        # shared attention block (weights shared; per-invocation KV cache)
        sc = None if shared is None else {"k": shared["k"][si], "v": shared["v"][si]}
        x, nc, _ = _apply_sub("attn", params["shared_attn"], x, cfg,
                              positions=positions, cache=sc, cache_pos0=cache_pos0)
        if nc is not None:
            new_shared_k.append(nc["k"])
            new_shared_v.append(nc["v"])
        for layer in range(start, min(start + period, cfg.n_layers)):
            lc = None if mamba_caches is None else tree_index(mamba_caches, layer)
            x, nc, _ = _apply_sub("mamba", tree_index(params["blocks"], layer), x, cfg,
                                  positions=positions, cache=lc, cache_pos0=cache_pos0)
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
    for layer in range(cfg.n_enc_layers):
        x, _, _ = _apply_sub("attn", tree_index(params["enc_blocks"], layer), x, cfg,
                             positions=positions, cache=None, cache_pos0=None,
                             causal=False)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def encdec_decoder_stack(params, cfg: ModelConfig, x, *, positions, enc_kv,
                         enc_valid, caches=None, cache_pos0=None):
    """Decoder with cross-attention.  enc_kv: stacked per-layer (ck, cv)."""
    new_caches = []
    for layer in range(cfg.n_layers):
        gc = None if caches is None else tree_index(caches, layer)
        x, nc, _ = _apply_sub("attn", tree_index(params["dec_blocks"], layer), x, cfg,
                              positions=positions, cache=gc, cache_pos0=cache_pos0,
                              xkv=(enc_kv["ck"][layer], enc_kv["cv"][layer]),
                              xvalid=enc_valid)
        new_caches.append(nc)
    out = None if caches is None else tree_stack(new_caches)
    return x, out, torch.zeros((), dtype=torch.float32, device=x.device)


def encode_cross_kv(params, cfg: ModelConfig, enc_out):
    """Precompute stacked per-decoder-layer cross K/V from encoder output."""
    attn = params["dec_blocks"]["attn"]
    return {"ck": torch.einsum("bsd,ldnh->lbsnh", enc_out, attn["cwk"]),
            "cv": torch.einsum("bsd,ldnh->lbsnh", enc_out, attn["cwv"])}


def logits_from_hidden(params, cfg: ModelConfig, x):
    """Logits in cfg.loss_dtype (cfg.dtype by default); padded vocab entries
    at -1e9 in that dtype."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
    out_dtype = getattr(torch, cfg.resolved_loss_dtype)
    logits = softcap(logits.to(out_dtype), cfg.final_softcap)
    pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
    return torch.where(pad[None, None, :], -1e9, logits)
