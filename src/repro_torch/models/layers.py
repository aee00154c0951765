"""Transformer building blocks (plain functions over tensors): the JAX
package's ``models/layers.py`` in torch.

Covers every variant the assigned architectures need: RMSNorm, RoPE,
GQA/MQA/MHA attention with sliding-window masks + logit softcapping +
cross-attention, SwiGLU/GeGLU MLPs, and GShard-style group-limited MoE
with capacity dropping (dispatch/combine einsums).

Where torch and XLA part ways the reference's answer is kept:

* the attention's score and value products take the operands in float32
  (XLA's ``preferred_element_type=float32``: the same products, summed in
  float32), and the masks use the finite ``NEG_INF``, so a fully masked row
  softmaxes to uniform;
* a cache write past the end lands where ``lax.dynamic_update_slice`` puts
  it (the start clamped so that the update fits), while the valid slots
  are counted from the unclamped start;
* the router's top-k breaks ties by the lower expert index
  (``lax.top_k``), through a stable sort;
* the capacity one-hot of a dropped token (slot >= capacity) is a zero row,
  as ``jax.nn.one_hot`` gives, built by comparison.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .sharding import is_dtensor, run_on_shards, weight_einsum, whole_unless_divides

__all__ = ["NEG_INF", "rms_norm", "rope", "softcap", "attention",
           "attention_chunked", "attn_block", "cross_kv", "mlp_block",
           "moe_capacity", "moe_route", "moe_block"]

NEG_INF = -1e9


def _f32_sqrt(n: int) -> float:
    """``jnp.sqrt(n)`` of a Python int: the float32 square root."""
    return float(np.sqrt(np.float32(n)))


# --------------------------------------------------------------------------
# Norms / embeddings / positional
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S) -> rotated x (the two halves)."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = float(np.log(np.float32(theta)))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32,
                                                device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def attention_chunked(q, k, v, *, q_pos, window: int, cap: float,
                      chunk: int) -> torch.Tensor:
    """Block-causal chunked attention for training (flash-style).

    Skips every fully-masked (above-diagonal) KV block and, with a window,
    every block entirely outside it; online softmax over the visible KV
    blocks with float32 statistics.
    """
    if is_dtensor(q):
        # by batch and head, each rank on its shards (heads whole where the
        # KV heads do not divide over the ranks)
        return run_on_shards(
            lambda q, k, v, p: attention_chunked(q, k, v, q_pos=p, window=window, cap=cap,
                                                 chunk=chunk),
            whole_unless_divides(q, 2, k.shape[2]), k, v, q_pos, dims=(0, 2))
    b, s, nh, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if s != t:
        raise ValueError("chunked path is for self-attention training")
    c = min(chunk, s)
    while s % c:
        c -= 1
    nq = s // c
    g = nh // kv
    scale = 1.0 / float(hd) ** 0.5
    qg = q.reshape(b, nq, c, kv, g, hd).float()
    kb = k.reshape(b, nq, c, kv, hd)
    vb = v.reshape(b, nq, c, kv, hd)
    pos_b = q_pos.reshape(b, nq, c)

    out_blocks = []
    for qi in range(nq):
        qs = qg[:, qi]                                   # (b, c, kv, g, hd)
        qp = pos_b[:, qi]                                # (b, c)
        lo = 0
        if window > 0:  # first KV block that can still be inside the window
            lo = max(0, (qi * c - (window - 1) - (c - 1)) // c)
        m = torch.full((b, kv, g, c), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kv, g, c), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kv, g, c, hd), dtype=torch.float32, device=q.device)
        for ki in range(lo, qi + 1):
            kc, vc, kp = kb[:, ki], vb[:, ki], pos_b[:, ki]
            sc = torch.einsum("bikgh,bjkh->bkgij", qs, kc.float()) * scale
            sc = softcap(sc, cap)
            msk = qp[:, :, None] >= kp[:, None, :]
            if window > 0:
                msk &= (qp[:, :, None] - kp[:, None, :]) < window
            sc = torch.where(msk[:, None, None, :, :], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgij,bjkh->bkgih", p.to(vc.dtype).float(), vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-37)  # (b,kv,g,c,hd)
        out_blocks.append(o.permute(0, 3, 1, 2, 4).reshape(b, c, nh, hd))
    return torch.cat(out_blocks, dim=1).to(q.dtype)


def attention(q, k, v, *, q_pos, kv_pos, kv_valid: Optional[torch.Tensor],
              causal: bool, window: int, cap: float) -> torch.Tensor:
    """Grouped-query attention.

    q (B, S, NH, hd); k, v (B, T, KV, hd); q_pos (B, S); kv_pos (B, T);
    kv_valid optional (B, T) bool (cache slots written so far).  Scores in
    float32 divided by sqrt(hd), the softcap before the mask, probabilities
    cast to v's dtype.
    """
    if is_dtensor(q):
        # by batch and head, each rank on its shards (heads whole where the
        # KV heads do not divide over the ranks)
        return run_on_shards(
            lambda q, k, v, qp, kp, valid: attention(
                q, k, v, q_pos=qp, kv_pos=kp, kv_valid=valid, causal=causal,
                window=window, cap=cap),
            whole_unless_divides(q, 2, k.shape[2]), k, v, q_pos, kv_pos, kv_valid,
            dims=(0, 2))
    b, s, nh, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = nh // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    scores = scores / _f32_sqrt(hd)
    scores = softcap(scores, cap)
    mask = torch.ones((b, s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if window > 0:
        mask = mask & ((q_pos[:, :, None] - kv_pos[:, None, :]) < window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs.float(), v.float())
    return out.reshape(b, s, nh, hd).to(q.dtype)


def _cache_write(buf: torch.Tensor, upd: torch.Tensor, pos0: int) -> torch.Tensor:
    """``lax.dynamic_update_slice(buf, upd, (0, pos0, 0, 0))``: a new buffer,
    the start clamped to [0, Smax - l] so that the update fits.  Built by
    ``cat`` (``slice_scatter`` on a layer's view of a stacked cache would
    copy the whole stack)."""
    start = min(max(pos0, 0), buf.shape[1] - upd.shape[1])
    return torch.cat([buf[:, :start], upd.to(buf.dtype), buf[:, start + upd.shape[1]:]],
                     dim=1)


def attn_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions,
               cache: Optional[dict], cache_pos0: Optional[int], window: int,
               causal: bool = True, xattn_kv=None, xattn_valid=None
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention (+ optional KV cache update) with pre-norm residual.

    cache: {'k': (B, Smax, KV, hd), 'v': ...} or None (training: keys/values
    are the in-sequence projections).  cache_pos0: the write offset, a
    Python int.
    """
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = weight_einsum("bsd,dnh->bsnh", h, p["wq"])
    k = weight_einsum("bsd,dnh->bsnh", h, p["wk"])
    v = weight_einsum("bsd,dnh->bsnh", h, p["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    new_cache = None
    if cache is None:
        if causal and cfg.attn_chunk > 0 and x.shape[1] > cfg.attn_chunk:
            out = attention_chunked(q, k, v, q_pos=positions, window=window,
                                    cap=cfg.attn_softcap, chunk=cfg.attn_chunk)
            y = weight_einsum("bsnh,nhd->bsd", out, p["wo"])
            x = x + y
            if xattn_kv is not None:
                raise NotImplementedError("chunked path: no cross-attn")
            return x, None
        kv_pos, kv_valid, kk, vv = positions, None, k, v
    else:
        pos0 = cache_pos0
        kk = _cache_write(cache["k"], k, pos0)
        vv = _cache_write(cache["v"], v, pos0)
        smax = kk.shape[1]
        kv_pos = torch.arange(smax, dtype=torch.int32,
                              device=x.device)[None].expand(x.shape[0], smax)
        kv_valid = kv_pos < (pos0 + x.shape[1])
        new_cache = {"k": kk, "v": vv}
    out = attention(q, kk, vv, q_pos=positions, kv_pos=kv_pos, kv_valid=kv_valid,
                    causal=causal, window=window, cap=cfg.attn_softcap)
    y = weight_einsum("bsnh,nhd->bsd", out, p["wo"])
    x = x + y
    if xattn_kv is not None:
        h = rms_norm(x, p["xln"], cfg.norm_eps)
        cq = weight_einsum("bsd,dnh->bsnh", h, p["cwq"])
        ck, cv = xattn_kv
        xpos = torch.arange(ck.shape[1], dtype=torch.int32,
                            device=x.device)[None].expand(x.shape[0], ck.shape[1])
        out = attention(cq, ck, cv, q_pos=positions, kv_pos=xpos,
                        kv_valid=xattn_valid, causal=False, window=0, cap=0.0)
        x = x + weight_einsum("bsnh,nhd->bsd", out, p["cwo"])
    return x, new_cache


def cross_kv(p: dict, enc_out: torch.Tensor):
    """Project encoder output to cross-attention K/V once per sequence."""
    ck = weight_einsum("bsd,dnh->bsnh", enc_out, p["cwk"])
    cv = weight_einsum("bsd,dnh->bsnh", enc_out, p["cwv"])
    return ck, cv


# --------------------------------------------------------------------------
# Dense MLPs
# --------------------------------------------------------------------------

def _act(gate: torch.Tensor, up: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(kind)


def mlp_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    gu = weight_einsum("bsd,dcf->bscf", h, p["wi"])         # (B, S, 2, F)
    act = _act(gu[..., 0, :], gu[..., 1, :], cfg.act)
    return x + weight_einsum("bsf,fd->bsd", act, p["wo"])


# --------------------------------------------------------------------------
# MoE (GShard-style, group-limited, capacity-dropped)
# --------------------------------------------------------------------------

def moe_capacity(cfg: ModelConfig, group: int) -> int:
    """Slots per (group, expert), rounded up to a multiple of 2, at least 4."""
    cap = -(-group * cfg.top_k * cfg.capacity_factor // max(cfg.n_experts, 1))
    cap = int(cap)
    return max(4, cap + (cap & 1))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)`` in float32: an index outside [0, n) gives
    a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_route(p: dict, x: torch.Tensor, cfg: ModelConfig) -> dict:
    """The router of ``moe_block``: groups, top-k experts and capacity slots.

    Returns the normed tokens ``xt`` (N, g, D), the router ``logits``
    (N, g, E) float32 (padded experts at NEG_INF), ``top_w`` (softmaxed) and
    ``top_e`` (N, g, K), the ``onehot`` (N, g, K, E), each claim's ``slot``
    (N, g, K) int32, ``keep`` and the capacity ``cap``.
    """
    b, s, d = x.shape
    ep, k = cfg.n_experts_padded, cfg.top_k
    tokens = b * s
    g = min(cfg.moe_group, tokens)
    while tokens % g:       # largest divisor <= moe_group
        g -= 1
    ng = tokens // g
    cap = moe_capacity(cfg, g)

    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xt = whole_unless_divides(h, 0, ng).reshape(ng, g, d)
    logits = weight_einsum("ntd,de->nte", xt.float(), p["router"].float())
    pad_mask = torch.arange(ep, device=x.device) >= cfg.n_experts
    logits = torch.where(pad_mask[None, None, :], NEG_INF, logits)
    # lax.top_k: ties go to the lower index (a stable descending sort)
    top_w, top_e = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    top_w = torch.softmax(top_w, dim=-1)

    # slot assignment: position of each (token, k) among claims on expert e,
    # k-index major, token minor (greedy like GShard)
    onehot = _one_hot(top_e, ep)                              # (N, g, K, E)
    claims = onehot.permute(0, 2, 1, 3).reshape(ng, k * g, ep)
    pos = torch.cumsum(claims, dim=1) - claims                # (N, K*g, E)
    pos = pos.reshape(ng, k, g, ep).permute(0, 2, 1, 3)       # (N, g, K, E)
    slot = (pos * onehot).sum(dim=-1).to(torch.int32)         # (N, g, K)
    keep = (slot < cap) & (top_w > 0)
    return {"xt": xt, "logits": logits, "top_w": top_w, "top_e": top_e,
            "onehot": onehot, "slot": slot, "keep": keep, "cap": cap}


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Mixture-of-experts FFN.  Returns (output, aux_loss).

    Tokens are processed in routing groups of cfg.moe_group; each expert
    accepts at most C tokens per group (excess dropped — GShard semantics).
    """
    b, s, d = x.shape
    r = moe_route(p, x, cfg)
    xt, onehot, top_w = r["xt"], r["onehot"], r["top_w"]
    slot_oh = _one_hot(r["slot"], r["cap"]) * r["keep"][..., None]
    # dispatch (N, g, E, C); combine adds routing weights
    dispatch = torch.einsum("ntke,ntkc->ntec", onehot, slot_oh)
    combine = torch.einsum("ntke,ntkc,ntk->ntec", onehot, slot_oh, top_w)

    xe = torch.einsum("ntec,ntd->necd", dispatch.to(xt.dtype), xt)   # (N,E,C,D)
    gu = weight_einsum("necd,eduf->necuf", xe, p["wi"])        # (N,E,C,2,F)
    act = _act(gu[..., 0, :], gu[..., 1, :], cfg.act)
    ye = weight_einsum("necf,efd->necd", act, p["wo"])
    if is_dtensor(ye):  # repro: allow[r1-host-sync] a type test, no device read
        # the (E, C) contraction flattened expert-major: the einsum's own
        # (C, E) order makes E on 'model' a strided shard, whose sizes
        # DTensor cannot take on fake tensors
        n, e, c, _ = ye.shape
        y = torch.bmm(combine.to(xt.dtype).reshape(n, -1, e * c), ye.reshape(n, e * c, d))
    else:
        y = torch.einsum("necd,ntec->ntd", ye, combine.to(xt.dtype))

    # load-balance aux loss (Switch/GShard): E * sum(frac_tokens * frac_prob)
    probs = torch.softmax(r["logits"], dim=-1)
    frac_prob = probs.mean(dim=(0, 1))
    frac_tok = onehot.mean(dim=(0, 1, 2)) * cfg.top_k
    aux = cfg.n_experts * torch.sum(frac_prob * frac_tok)
    return x + y.reshape(b, s, d).to(x.dtype), aux
