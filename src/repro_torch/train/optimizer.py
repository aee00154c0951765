"""AdamW with global-norm clipping, a configurable moment dtype (bf16
moments for the 400B config) and optional gradient-precision reduction:
the JAX package's ``train/optimizer.py`` in torch.

Plain functions over parameter trees (nested dicts of tensors), written as
the reference writes them rather than as ``torch.optim.AdamW``: the weight
decay joins the update before the learning rate multiplies it, ``eps``
follows ``sqrt(vhat)``, the warm-up is taken at the incremented step, and
every leaf's update is float32 maths cast back to the leaf's dtype (the
moments to ``moment_dtype``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.transformer import tree_leaves, tree_map

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "global_norm",
           "reduce_to_bf16"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    # Round grads to bf16's mantissa (kept in their dtype) ahead of a
    # data-parallel reduction, as the reference's reduce-precision does.
    grad_precision: str = ""      # '' | 'bfloat16'
    warmup_steps: int = 100


def init_opt_state(params: Any, cfg: OptConfig) -> Dict[str, Any]:
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    leaf = next(tree_leaves(params))
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree)))


def reduce_to_bf16(g: torch.Tensor) -> torch.Tensor:
    """``lax.reduce_precision(g, exponent_bits=8, mantissa_bits=7)``: g
    rounded to bf16's mantissa (nearest, ties to even; past bf16's largest
    finite to inf; NaN stays NaN), in g's dtype."""
    return g.to(torch.bfloat16).to(g.dtype)


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step.float() + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any], cfg: OptConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    if cfg.grad_precision == "bfloat16":
        grads = tree_map(reduce_to_bf16, grads)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * torch.square(g)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    flat = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], flat)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, {"grad_norm": gnorm, "lr": lr}
