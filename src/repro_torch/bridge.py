"""Hand the JAX package's hash parameters to the port.

``jax.random`` (``repro.core.hashes._common``, ``repro.core.walks.make_walks``)
cannot be reproduced with a ``torch.Generator``, so a parity check draws the
parameters once in JAX and feeds the same numbers to both packages.  The
caller converts each leaf with ``np.asarray``; this module imports no jax.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.hashes import LshParams
from .core.walks import WalkTable

__all__ = ["params_from_numpy"]


def params_from_numpy(width, offsets, mix_a, mix_c, pairs, prefix,
                      device="cpu") -> LshParams:
    """Build the port's ``LshParams`` from the JAX ``LshParams`` leaves.

    offsets (L, M) float32, mix_a (L, M) uint32, mix_c (L,) uint32,
    pairs (L*M, m, U2) int8, prefix (L*M, m, U2+1) int32, as numpy arrays
    (the 'rw' family, the only one ported).
    """

    def t(arr, dtype):
        return torch.from_numpy(np.ascontiguousarray(arr).astype(dtype)).to(device)

    walks = WalkTable(pairs=t(pairs, np.int8), prefix=t(prefix, np.int32))
    return LshParams("rw", float(width), t(offsets, np.float32),
                     t(mix_a, np.int64), t(mix_c, np.int64), walks=walks)
