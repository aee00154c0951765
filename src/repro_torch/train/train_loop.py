"""train_step builder: gradients (optionally accumulated over microbatches)
-> clip -> AdamW, the JAX package's ``train/train_loop.py`` in torch.  Used
by the launcher and the end-to-end training example.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import is_dtensor
from repro_torch.models.transformer import tree_leaves, tree_map

from .optimizer import OptConfig, adamw_update

__all__ = ["make_train_step", "value_and_grad"]


def _placed_as(g, leaf):
    """A sharded leaf's gradient on the leaf's own placements (DTensor hands
    it back on whatever the backward's last op chose; the reference's
    gradients take their parameters' shardings); ``g`` itself otherwise."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(leaf.placements):
        return g
    return g.redistribute(leaf.device_mesh, leaf.placements)


def value_and_grad(cfg: ModelConfig):
    """``jax.value_and_grad(train_loss, has_aux=True)``: returns
    fn(params, batch) -> ((total, metrics), grads), with the gradients
    taken by ``torch.autograd.grad`` over detached copies of the leaves (in
    each leaf's dtype; a leaf the loss does not reach gets zeros; a sharded
    leaf's on its placements).  The values come back detached."""

    def fn(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = list(tree_leaves(leaves))
        with torch.enable_grad():
            total, metrics = model_lib.train_loss(leaves, cfg, batch)
            grads = torch.autograd.grad(total, flat, allow_unused=True,
                                        materialize_grads=True)
        by_leaf = dict(zip(map(id, flat), map(_placed_as, grads, flat)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (total.detach(), metrics), tree_map(lambda p: by_leaf[id(p)], leaves)

    return fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, num_microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) on parameter trees.

    With num_microbatches > 1 the batch is split along dim 0 and the
    gradients are summed into float32 zeros, one microbatch after another,
    then averaged; the metrics ``aux`` and ``tokens`` are then 0.0.
    """
    grad_fn = value_and_grad(cfg)

    def train_step(params, opt_state, batch: Dict[str, Any]):
        if num_microbatches <= 1:
            (_, metrics), grads = grad_fn(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            assert b % num_microbatches == 0, (b, num_microbatches)
            size = b // num_microbatches
            device = next(tree_leaves(params)).device
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=device), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(num_microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                (_, m), g = grad_fn(params, mb)
                grads = tree_map(torch.add, grads, g)
                loss_sum = loss_sum + m["loss"]
            grads = tree_map(lambda g: g / num_microbatches, grads)
            zero = torch.zeros((), dtype=torch.float32, device=device)
            metrics = {"loss": loss_sum / num_microbatches, "aux": zero, "tokens": zero}
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step
