"""Top-level model API: loss / prefill / decode across all families, the JAX
package's ``models/model.py`` in torch.

  * train    : tokens (B, S) -> next-token CE loss and its metrics,
               differentiable (``repro_torch.train`` takes its gradient)
  * prefill  : tokens (B, S) -> last-position logits
  * decode   : new tokens against a KV/SSM cache of length S_max

Modality frontends ('patch' for phi-3-vision, 'frames' for seamless) are
stubs: callers supply precomputed embeddings at d_model.

The functions take a parameter tree (nested dicts of tensors, the JAX
package's tree paths and shapes) and run on the device its tensors are on.
``LanguageModel`` owns such a tree as an ``nn.Module`` whose ``state_dict``
keys are the JAX leaf paths joined by ``.``.
"""
from __future__ import annotations

import operator
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device

from . import transformer as tf
from .config import ModelConfig
from .sharding import hold_to_batch, is_dtensor

__all__ = ["init_params", "train_loss", "make_caches", "prefill", "decode_step",
           "LanguageModel"]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None):
    return tf.init_params(cfg, generator=generator, device=device)


def _embed(params, cfg: ModelConfig, tokens):
    """Embedding rows times sqrt(d_model) cast to the embedding dtype.
    Sharded, the rows come from ``F.embedding`` (DTensor gathers a
    vocab-sharded table's rows where they lie and sums them; indexing
    would all-gather the table) and the result is held to the batch spec."""
    emb = params["embed"]
    scale = torch.full((), float(np.sqrt(np.float32(cfg.d_model))), dtype=emb.dtype,
                       device=emb.device)
    if is_dtensor(emb):
        return hold_to_batch(F.embedding(tokens, emb)) * scale
    return emb[tokens] * scale


def _stack_forward(params, cfg: ModelConfig, x, positions, caches=None,
                   cache_pos0=None, enc_kv=None, enc_valid=None):
    if cfg.kind == "hybrid":
        return tf.hybrid_stack(params, cfg, x, positions=positions,
                               caches=caches, cache_pos0=cache_pos0)
    if cfg.kind == "encdec":
        return tf.encdec_decoder_stack(params, cfg, x, positions=positions,
                                       enc_kv=enc_kv, enc_valid=enc_valid,
                                       caches=caches, cache_pos0=cache_pos0)
    return tf.decoder_stack(params, cfg, x, positions=positions,
                            caches=caches, cache_pos0=cache_pos0)


def _prompt(params, cfg: ModelConfig, batch):
    """Embeddings, positions and the encoder's cross K/V of a prompt batch;
    a 'patch' frontend's embeddings go in front of the tokens'."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    enc_kv = None
    if cfg.kind == "encdec":
        enc_out = tf.encoder_stack(params, cfg, batch["frontend"].to(x.dtype))
        enc_kv = tf.encode_cross_kv(params, cfg, enc_out)
    elif cfg.frontend:
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    return x, tf._positions(b, x.shape[1], x.device), enc_kv


# --------------------------------------------------------------------------
# Training loss
# --------------------------------------------------------------------------

def train_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Next-token cross-entropy (+ MoE aux).  batch keys: 'tokens', 'labels'
    (B, S) int; optional 'frontend' (B, P, D) embeds.  Returns (total,
    {'loss', 'aux', 'tokens'})."""
    labels = batch["labels"]
    b = labels.shape[0]
    x, positions, enc_kv = _prompt(params, cfg, batch)
    valid = torch.ones_like(labels, dtype=torch.bool)
    if cfg.kind != "encdec" and cfg.frontend:
        p = x.shape[1] - labels.shape[1]
        labels = torch.cat([torch.zeros((b, p), dtype=labels.dtype,
                                        device=labels.device), labels], dim=1)
        valid = torch.cat([torch.zeros((b, p), dtype=torch.bool,
                                       device=labels.device), valid], dim=1)

    x, _, aux = _stack_forward(params, cfg, x, positions, enc_kv=enc_kv)
    logits = tf.logits_from_hidden(params, cfg, x)
    # stable logsumexp with f32 accumulation (logits may be bf16)
    lmax = logits.amax(dim=-1, keepdim=True).detach()
    expsum = hold_to_batch(torch.exp((logits - lmax).float()).sum(dim=-1))
    logz = torch.log(expsum) + lmax[..., 0].float()
    # the label logit by a masked reduction over the vocab axis, as the
    # reference computes it
    vocab_iota = torch.arange(cfg.vocab_padded, dtype=torch.int32, device=x.device)
    label_mask = vocab_iota[None, None, :] == labels[..., None].to(torch.int32)
    lab_logit = hold_to_batch(torch.where(label_mask, logits, 0.0).sum(dim=-1).float())
    nll = (logz - lab_logit) * valid
    n_valid = valid.sum()
    loss = nll.sum() / torch.clamp(n_valid, min=1)
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": n_valid}


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

def make_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None):
    """Zeroed caches, stacked as the parameter blocks are (the card unless
    asked for the CPU); the SSM states are float32."""
    device = resolve_device(device)
    kv, hd = cfg.n_kv, cfg.head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn_cache(n):
        return {"k": zeros(n, batch, max_len, kv, hd), "v": zeros(n, batch, max_len, kv, hd)}

    def mamba_cache(n):
        return {"conv": zeros(n, batch, cfg.ssm_conv - 1,
                              cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state),
                "ssm": zeros(n, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim,
                             dt=torch.float32)}

    if cfg.kind == "hybrid":
        n_shared = (cfg.n_layers + cfg.hybrid_attn_period - 1) // cfg.hybrid_attn_period
        return {"mamba": mamba_cache(cfg.n_layers), "shared": attn_cache(n_shared)}
    if cfg.kind == "encdec":
        return attn_cache(cfg.n_layers)
    return {f"sub{j}": mamba_cache(cfg.n_groups) if kind == "mamba"
            else attn_cache(cfg.n_groups)
            for j, kind in enumerate(cfg.sub_block_kinds())}


# --------------------------------------------------------------------------
# Prefill & decode
# --------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Forward over the prompt; returns the last position's logits (B, 1, V)."""
    x, positions, enc_kv = _prompt(params, cfg, batch)
    x, _, _ = _stack_forward(params, cfg, x, positions, enc_kv=enc_kv)
    return tf.logits_from_hidden(params, cfg, x[:, -1:, :])


def decode_step(params, cfg: ModelConfig, caches, tokens, pos0: int, enc_kv=None):
    """One decode step.  tokens (B, l); pos0, a Python int, = tokens so far.

    As in the reference, every token of the step gets position ``pos0`` (a
    step of l > 1 tokens is not a prefill: each one sees slot 0 alone under
    the causal mask at pos0 = 0).  Returns (logits (B, l, V), new_caches).
    """
    pos0 = operator.index(pos0)
    b = tokens.shape[0]
    x = _embed(params, cfg, tokens)
    positions = torch.full((b, 1), pos0, dtype=torch.int32, device=x.device)
    x, new_caches, _ = _stack_forward(params, cfg, x, positions, caches=caches,
                                      cache_pos0=pos0, enc_kv=enc_kv)
    return tf.logits_from_hidden(params, cfg, x), new_caches


# --------------------------------------------------------------------------
# The parameter tree as a module
# --------------------------------------------------------------------------

class _Node(nn.Module):
    """One inner node of the parameter tree: its keys are attributes."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, _Node(val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class LanguageModel(_Node):
    """A parameter tree of ``cfg`` (drawn by ``init_params`` from
    ``generator`` on ``device``, the card unless asked for the CPU, or the
    given ``params``) and the model API over it.  ``state_dict()`` keys are
    the JAX leaf paths joined by ``.``, with the JAX leaves' shapes (stacked
    blocks keep their leading axis).  The parameters take no gradient."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None, params=None):
        if params is None:
            params = init_params(cfg, generator=generator, device=device)
        super().__init__(params)
        self.cfg = cfg

    def params(self) -> Dict[str, Any]:
        """The parameter tree (nested dicts of the module's parameters)."""
        return self.tree()

    @torch.no_grad()
    def train_loss(self, batch):
        return train_loss(self.params(), self.cfg, batch)

    @torch.no_grad()
    def prefill(self, batch):
        return prefill(self.params(), self.cfg, batch)

    @torch.no_grad()
    def decode_step(self, caches, tokens, pos0: int, enc_kv=None):
        return decode_step(self.params(), self.cfg, caches, tokens, pos0, enc_kv=enc_kv)

    def make_caches(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return make_caches(self.cfg, batch, max_len, dtype=dtype,
                           device=self.embed.device)
