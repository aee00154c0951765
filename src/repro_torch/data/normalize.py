"""Dataset normalization to nonnegative even integers (paper Sect. 3.2), a
numpy copy of the JAX package's ``data/normalize.py``.

Shift each coordinate so it is nonnegative, scale by an integer factor c, and
round to the nearest even integer.  Shift and scale preserve the L1 ranking
exactly; rounding perturbs it by at most m/c per point, made negligible by
choosing c so the target universe is hit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Normalizer", "fit_normalizer", "normalize_even"]


@dataclasses.dataclass(frozen=True)
class Normalizer:
    shift: np.ndarray   # (m,) per-dim additive shift (>= 0 after applying)
    scale: float        # multiplicative factor
    universe: int       # resulting max even coordinate U

    def apply(self, x: np.ndarray) -> np.ndarray:
        y = (np.asarray(x, np.float64) + self.shift) * self.scale
        even = 2 * np.round(y / 2.0)
        return np.clip(even, 0, self.universe).astype(np.int32)


def fit_normalizer(x: np.ndarray, target_universe: int = 256) -> Normalizer:
    """Choose shift/scale so coordinates land in even ints [0, U]."""
    x = np.asarray(x, np.float64)
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    shift = -lo
    spread = float((hi - lo).max())
    scale = (target_universe - 2) / max(spread, 1e-12)
    return Normalizer(shift=shift, scale=scale, universe=int(target_universe))


def normalize_even(x: np.ndarray, target_universe: int = 256) -> np.ndarray:
    return fit_normalizer(x, target_universe).apply(x)
