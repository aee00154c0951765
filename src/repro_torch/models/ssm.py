"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060) in torch: the JAX
package's ``models/ssm.py``.

Used by ``mamba2-370m`` (pure SSM stack) and ``zamba2-1.2b`` (hybrid).

Training / prefill use the chunked dual form: quadratic attention-like
compute inside chunks of Q tokens, linear state passing between chunks (a
Python loop over chunks, where the reference scans).  Decode uses the O(1)
recurrent update.

Layout notes: x is headed (B, L, H, P) with P = headdim; B/C are shared
across heads within ``ssm_groups`` groups, shape (B, L, G, N).

As in the reference, a block given a cache and more than one token takes
the chunked path from a zero state: it ignores ``cache["ssm"]`` (a prefill
into a fresh cache), and the sequence length must be a multiple of
``min(ssm_chunk, L)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .sharding import is_dtensor, run_on_shards, weight_einsum
from .layers import rms_norm

__all__ = ["ssd_chunked", "mamba_block"]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q) lower-tri cumulative sums:
    out[..., i, j] = sum_{k in (j, i]} a[..., k]; -inf above the diagonal."""
    q = a.shape[-1]
    csum = torch.cumsum(a, dim=-1)
    diff = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def _repeat(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, rep, axis=dim)``: each group's entry ``rep`` times."""
    shape = t.shape
    t = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep, *shape[dim + 1:])
    return t.reshape(*shape[:dim], shape[dim] * rep, *shape[dim + 1:])


def _recurrence(chunk_decay, states):
    """The inter-chunk state recurrence from a zero state: (the state entering
    each chunk (B,nc,H,N,P), the final state (B,H,N,P))."""
    bsz, nc, h, n, p = states.shape
    s = torch.zeros((bsz, h, n, p), dtype=states.dtype, device=states.device)
    prev = []
    for ci in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, ci, :, None, None].to(s.dtype) + states[:, ci]
    return torch.stack(prev, dim=1), s


def _step(b1, c1, s, decay, x1):
    """One token of the recurrence: s' = exp(dt*A) s + B dt x; y = C s'.
    b1, c1 (B,H,N), s (B,H,N,P) float32, decay (B,H), x1 (B,H,P);
    returns (y (B,H,P), s')."""
    upd = torch.einsum("bhn,bhp->bhnp", b1.float(), x1.float())
    s = s * decay[:, :, None, None] + upd
    return torch.einsum("bhn,bhnp->bhp", c1.float(), s), s


def ssd_chunked(x, dt_a, b, c, chunk: int):
    """SSD dual-form forward.

    x    : (B, L, H, P)  pre-scaled by dt (i.e. dt[...,None] * x)
    dt_a : (B, L, H)     log-decay increments (negative)
    b, c : (B, L, G, N)  input/output projections (G groups broadcast to H)
    Returns (y (B, L, H, P), final_state (B, H, N, P) float32).
    """
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the chunk {chunk}")
    nc = l // chunk
    rep = h // g

    xc = x.reshape(bsz, nc, chunk, h, p)
    ac = dt_a.reshape(bsz, nc, chunk, h).float()                # (B,nc,Q,H)
    bc = _repeat(b.reshape(bsz, nc, chunk, g, n), rep, 3)      # (B,nc,Q,H,N)
    cc = _repeat(c.reshape(bsz, nc, chunk, g, n), rep, 3)

    a_cum = torch.cumsum(ac, dim=2)                             # (B,nc,Q,H)
    # ---- intra-chunk (quadratic within chunk) ----
    lmat = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))           # (B,nc,H,Q,Q)
    scores = torch.einsum("bcihn,bcjhn->bchij", cc, bc)         # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bchij,bchij,bcjhp->bcihp",
                          scores, lmat.to(scores.dtype), xc.to(scores.dtype))
    # ---- chunk states ----
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)       # (B,nc,Q,H)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchnp",
                          bc, decay_to_end.to(bc.dtype), xc.to(bc.dtype))
    # ---- inter-chunk recurrence ----
    chunk_decay = torch.exp(a_cum[:, :, -1, :])                 # (B,nc,H)
    if is_dtensor(states):  # repro: allow[r1-host-sync] a type test, no device read
        # elementwise over the batch and the heads: each rank on its shards
        prev_states, s = run_on_shards(_recurrence, chunk_decay, states, dims=(0, 2), ref=1)
    else:
        prev_states, s = _recurrence(chunk_decay, states)
    decay_from_start = torch.exp(a_cum)                         # (B,nc,Q,H)
    y_off = torch.einsum("bcihn,bcih,bchnp->bcihp",
                         cc, decay_from_start.to(cc.dtype), prev_states)
    y = (y_diag + y_off).reshape(bsz, l, h, p)
    return y, s.float()


def _conv1d_causal(x, w, cache: Optional[torch.Tensor]):
    """Depthwise causal conv.  x (B, L, C), w (K, C).  cache (B, K-1, C)."""
    k = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                             # (B, L+K-1, C)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    new_cache = xp[:, -(k - 1):, :] if cache is not None else None
    return F.silu(out), new_cache


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[dict]) -> Tuple[torch.Tensor, Optional[dict]]:
    """One Mamba-2 block with pre-norm residual.

    cache (decode): {'conv': (B, K-1, d_conv_ch), 'ssm': (B, H, N, P)}.
    Training/prefill: cache is None (states start at zero).
    """
    bsz, l, d = x.shape
    h_heads, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    g = cfg.ssm_groups
    din = cfg.d_inner

    hin = rms_norm(x, p["ln"], cfg.norm_eps)
    xz = weight_einsum("bld,de->ble", hin, p["wxz"])             # (B,L,2*din)
    xin, z = xz[..., :din], xz[..., din:]
    bcd = weight_einsum("bld,de->ble", hin, p["wbcdt"])          # (B,L,2GN+H)
    bproj = bcd[..., : g * n]
    cproj = bcd[..., g * n: 2 * g * n]
    dt = bcd[..., 2 * g * n:]                                   # (B,L,H)

    conv_in = torch.cat([xin, bproj, cproj], dim=-1)
    conv_out, new_conv = _conv1d_causal(
        conv_in, p["conv_w"], None if cache is None else cache["conv"])
    xin = conv_out[..., :din]
    bproj = conv_out[..., din: din + g * n].reshape(bsz, l, g, n)
    cproj = conv_out[..., din + g * n:].reshape(bsz, l, g, n)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())                          # (H,)
    dt_a = dt * a[None, None, :]                                # (B,L,H)
    xh = xin.reshape(bsz, l, h_heads, pdim)
    xdt = xh * dt[..., None].to(xh.dtype)

    if cache is None or l > 1:
        # training (cache None) or prefill-into-cache (cache given, l > 1)
        y, final_state = ssd_chunked(xdt, dt_a, bproj, cproj, min(cfg.ssm_chunk, l))
        new_ssm = None if cache is None else final_state
    else:
        # O(1) recurrence (l == 1): s' = exp(dt*A) s + B dt x; y = C s'
        rep = h_heads // g
        b1 = _repeat(bproj[:, 0], rep, 1)                       # (B,H,N)
        c1 = _repeat(cproj[:, 0], rep, 1)
        decay = torch.exp(dt_a[:, 0])                           # (B,H)
        if is_dtensor(x):
            # elementwise over the batch and the heads: each rank on its shards
            y, new_ssm = run_on_shards(_step, b1, c1, cache["ssm"], decay, xdt[:, 0],
                                       dims=(0, 1), ref=2)
        else:
            y, new_ssm = _step(b1, c1, cache["ssm"], decay, xdt[:, 0])
        y = y[:, None].to(x.dtype)                              # (B,1,H,P)

    y = y + xh * p["d_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, l, din)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"], cfg.norm_eps)
    out = x + weight_einsum("ble,ed->bld", y, p["wout"])
    new_cache = None if cache is None else {"conv": new_conv, "ssm": new_ssm}
    return out, new_cache
