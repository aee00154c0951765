"""MP-RW-LSH in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The port of the JAX package ``repro``; it imports ``torch`` and numpy and
nothing of ``jax`` or ``repro``.  Layout mirrors the JAX package:

  core/     hashing, multi-probe template, index build, staged query
            pipeline, segmented mutable index, baselines
  kernels/  the three kernels of the serving path (fused_probe,
            fused_rerank, topk_merge): a CUDA source under ``csrc/`` and a
            plain-torch version of the same function each; ``ops`` dispatches
            by the tensors' device
  serve/    the batched serving engine
  data/     seeded synthetic datasets (numpy, same bits as ``repro``)
  launch/   ``python -m repro_torch.launch.serve``

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); with no card they raise.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain-torch path on the CPU")
    return dev
