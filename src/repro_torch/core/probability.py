"""Exact probability machinery for RW-LSH / CP-LSH / GP-LSH.

Everything the paper derives analytically lives here:

  * ``Y_d`` — the d-step random-walk displacement distribution
    (paper Sect. 3.1): Pr[Y_d = l] = C(d, (d+l)/2) / 2^d for even l (d even).
  * ``collision_prob`` — p(d) = sum_l (1 - |l|/W) Pr[Y_d = l]
    (paper Sect. 3.1) and its monotonicity (paper Sect. 8.1).
  * per-coordinate bucket-landing probabilities for each LSH family, used by
    the multi-probe success-probability computations (paper Sect. 4, Table 1).
  * ``expected_zj_sq`` — E[z_j^2] closed forms for the universal template
    (paper Sect. 2.2, third refinement).
  * ``rho`` — LSH quality log(1/p1)/log(1/p2).

All host-side (NumPy): these are build-time / analysis-time quantities.
A copy of ``repro.core.probability`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

from functools import lru_cache
from math import comb, erf, sqrt, atan, pi, log

import numpy as np

__all__ = [
    "rw_pmf",
    "rw_cdf",
    "rw_interval_prob",
    "cauchy_interval_prob",
    "gaussian_interval_prob",
    "interval_prob",
    "collision_prob_rw",
    "collision_prob_cauchy",
    "collision_prob_gaussian",
    "rho",
    "expected_zj_sq",
]


@lru_cache(maxsize=4096)
def _rw_pmf_tuple(d: int) -> tuple:
    """pmf of Y_d on support {-d, -d+2, ..., d} (exact, float64)."""
    if d < 0:
        raise ValueError("d must be >= 0")
    # Pr[Y_d = l] = C(d, (d+l)/2) / 2^d
    if d < 1024:
        return tuple(comb(d, k) / (2.0**d) for k in range(d + 1))
    # 2.0**d overflows from d = 1024 (the JAX package raises OverflowError
    # there): the row of binomials as exact integers, each divided by the
    # integer 2^d, which Python rounds correctly
    row, denom = [1], 1 << d
    for k in range(d):
        row.append(row[-1] * (d - k) // (k + 1))
    return tuple(c / denom for c in row)


def rw_pmf(d: int) -> np.ndarray:
    """Return (support, pmf) as arrays; support = -d..d step 2."""
    pmf = np.asarray(_rw_pmf_tuple(d))
    support = np.arange(-d, d + 1, 2)
    return support, pmf


def _rw_cdf_int(d: int, t: np.ndarray) -> np.ndarray:
    """Pr[Y_d <= t] for *integer-valued* t (vectorized, exact)."""
    _, pmf = rw_pmf(d)
    cdf = np.concatenate([[0.0], np.cumsum(pmf)])
    idx = np.clip(np.floor((np.asarray(t, np.float64) + d) / 2.0) + 1, 0, d + 1)
    return cdf[idx.astype(np.int64)]


def rw_cdf(d: int, x: np.ndarray) -> np.ndarray:
    """Pr[Y_d <= x] for real x (vectorized, exact: support is integer)."""
    return _rw_cdf_int(d, np.floor(np.asarray(x, np.float64)))


def rw_interval_prob(d: int, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Pr[Y_d in [lo, hi)) for real bounds, exact.

    Counts integer support points in [ceil(lo), ceil(hi)-1]."""
    lo_i = np.ceil(np.asarray(lo, np.float64))
    hi_i = np.ceil(np.asarray(hi, np.float64)) - 1.0
    return np.maximum(_rw_cdf_int(d, hi_i) - _rw_cdf_int(d, lo_i - 1.0), 0.0)


def gaussian_interval_prob(scale: float, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Pr[N(0, scale^2) in [lo, hi))  (GP-LSH: scale = d_2)."""
    lo = np.asarray(lo, np.float64) / (scale * sqrt(2.0))
    hi = np.asarray(hi, np.float64) / (scale * sqrt(2.0))
    verf = np.vectorize(erf)
    return 0.5 * (verf(hi) - verf(lo))


def cauchy_interval_prob(scale: float, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Pr[Cauchy(0, scale) in [lo, hi))  (CP-LSH: scale = d_1)."""
    vat = np.vectorize(atan)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    return (vat(hi / scale) - vat(lo / scale)) / pi


def interval_prob(family: str, d: float, lo, hi) -> np.ndarray:
    """Dispatch: Pr[f(s)-f(q) in [lo,hi)) for points at distance d.

    family: 'rw' (d = L1, exact random walk), 'cauchy' (d = L1),
            'gaussian' (d = L2).
    """
    if family == "rw":
        return rw_interval_prob(int(round(d)), lo, hi)
    if family == "cauchy":
        return cauchy_interval_prob(float(d), lo, hi)
    if family == "gaussian":
        return gaussian_interval_prob(float(d), lo, hi)
    raise ValueError(f"unknown family {family!r}")


def collision_prob_rw(d: int, width: int) -> float:
    """p(d) = sum_{l=-W}^{W} (1 - |l|/W) Pr[Y_d = l]  (paper Sect. 3.1)."""
    support, pmf = rw_pmf(d)
    mask = np.abs(support) <= width
    return float(np.sum((1.0 - np.abs(support[mask]) / width) * pmf[mask]))


def _continuous_collision(interval_fn, scale: float, width: float, npts: int = 4096) -> float:
    """p(d) = int_{-W}^{W} (1 - |l|/W) pdf(l) dl  via the identity
    p(d) = (1/W) * int_0^W Pr[|X| <= t] dt  (same derivation as paper Eq. 1)."""
    ts = (np.arange(npts) + 0.5) * (width / npts)
    probs = interval_fn(scale, -ts, ts)
    return float(np.mean(probs))


def collision_prob_gaussian(d2: float, width: float) -> float:
    return _continuous_collision(gaussian_interval_prob, d2, width)


def collision_prob_cauchy(d1: float, width: float) -> float:
    return _continuous_collision(cauchy_interval_prob, d1, width)


def rho(p1: float, p2: float) -> float:
    """LSH quality rho = log(1/p1) / log(1/p2); lower is better."""
    if not (0 < p2 < p1 < 1):
        raise ValueError(f"need 0 < p2 < p1 < 1, got p1={p1}, p2={p2}")
    return log(1.0 / p1) / log(1.0 / p2)


def expected_zj_sq(num_hashes: int, width: float) -> np.ndarray:
    """E[z_j^2], j = 1..2M  (paper Sect. 2.2, third refinement).

    For 1 <= j <= M:
        E[z_j^2] = j(j+1) / (4(M+1)(M+2)) * W^2
    For M+1 <= j <= 2M:
        E[z_j^2] = (1 - (2M+1-j)/(M+1) + (2M+1-j)(2M+2-j)/(4(M+1)(M+2))) * W^2
    """
    m = num_hashes
    out = np.empty(2 * m, np.float64)
    for j in range(1, m + 1):
        out[j - 1] = j * (j + 1) / (4.0 * (m + 1) * (m + 2)) * width**2
    for j in range(m + 1, 2 * m + 1):
        r = 2 * m + 1 - j
        out[j - 1] = (1.0 - r / (m + 1.0) + r * (r + 1) / (4.0 * (m + 1) * (m + 2))) * width**2
    return out
