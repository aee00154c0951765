"""Hand the JAX package's hash and language-model parameters to the port.

``jax.random`` (``repro.core.hashes._common``, ``repro.core.walks.make_walks``,
``repro.models.transformer.init_params``) cannot be reproduced with a
``torch.Generator``, so a parity check draws the parameters once in JAX and
feeds the same numbers to both packages.  The caller converts each leaf
with ``np.asarray``; this module imports no jax.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.hashes import LshParams
from .core.walks import WalkTable
from .models import transformer as tf

__all__ = ["params_from_numpy", "lm_params_from_numpy"]


def params_from_numpy(width, offsets, mix_a, mix_c, pairs=None, prefix=None,
                      device="cpu", family="rw", proj=None) -> LshParams:
    """Build the port's ``LshParams`` from the JAX ``LshParams`` leaves.

    offsets (L, M) float32, mix_a (L, M) uint32, mix_c (L,) uint32, as numpy
    arrays; for 'rw' pairs (L*M, m, U2) int8 and prefix (L*M, m, U2+1)
    int32, for 'cauchy' and 'gaussian' proj (L, M, m) float32.
    """

    def t(arr, dtype):
        return torch.from_numpy(np.ascontiguousarray(arr).astype(dtype)).to(device)

    walks = None
    if family == "rw":
        walks = WalkTable(pairs=t(pairs, np.int8), prefix=t(prefix, np.int32))
    return LshParams(family, float(width), t(offsets, np.float32),
                     t(mix_a, np.int64), t(mix_c, np.int64), walks=walks,
                     proj=None if proj is None else t(proj, np.float32))


def _leaf_to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")      # a writable copy of the caller's leaf
    if arr.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: the same bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def lm_params_from_numpy(cfg, tree, device="cpu"):
    """Build the port's language-model parameter tree from the JAX
    ``init_params(key, cfg)`` tree with every leaf already a numpy array:
    the same tree paths, shapes and dtypes as ``param_specs(cfg)``, checked
    leaf by leaf (a missing, extra or mis-shaped leaf raises ValueError)."""

    def walk(spec, node, path):
        if tf.is_leaf_spec(spec):
            shape, dtype, _ = spec
            if not isinstance(node, np.ndarray) or node.shape != shape \
                    or node.dtype.name != dtype:
                got = (getattr(node, "shape", None), getattr(getattr(node, "dtype", None),
                                                             "name", type(node).__name__))
                raise ValueError(f"{path}: expected {shape} {dtype}, got {got}")
            return _leaf_to_torch(node).to(device)
        if not isinstance(node, dict) or set(node) != set(spec):
            raise ValueError(f"{path or 'tree'}: expected keys {sorted(spec)}, got "
                             f"{sorted(node) if isinstance(node, dict) else type(node)}")
        return {k: walk(spec[k], node[k], f"{path}.{k}" if path else k) for k in spec}

    return walk(tf.param_specs(cfg), tree, "")
