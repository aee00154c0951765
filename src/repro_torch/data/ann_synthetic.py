"""Synthetic ANN datasets shaped like the paper's seven benchmarks (Table 3).

A numpy copy of ``repro.data.ann_synthetic``: the same seed gives the same
data in both packages.  No dataset is downloaded, so Audio/MNIST/Trevi/GIST/GloVe/Deep10M/
SIFT50M are represented by seeded generators matched in (n, m, U) and cluster
structure: a mixture of Laplacian clusters (heavy-ish L1 structure) plus
uniform background, normalized to nonnegative even integers per paper
Sect. 3.2.  Queries are perturbed dataset points (so true neighbors exist at
controlled L1 radii) plus uniform strays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DatasetSpec", "PAPER_DATASETS", "make_dataset",
           "make_skewed_dataset", "make_queries"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int
    dim: int
    universe: int
    num_clusters: int = 64
    cluster_spread: float = 0.03   # Laplace scale as a fraction of U
    seed: int = 0


# Scaled-down stand-ins for paper Table 3 (same dim; n shrunk to CPU scale —
# full n is exercised by the dry-run's ShapeDtypeStructs, not allocation).
PAPER_DATASETS = {
    "audio":   DatasetSpec("audio",   n=53_300 // 4, dim=192,  universe=512),
    "mnist":   DatasetSpec("mnist",   n=69_000 // 4, dim=784,  universe=256),
    "trevi":   DatasetSpec("trevi",   n=16_384,      dim=1024, universe=510),
    "gist":    DatasetSpec("gist",    n=32_768,      dim=960,  universe=256),
    "glove":   DatasetSpec("glove",   n=65_536,      dim=100,  universe=512),
    "deep10m": DatasetSpec("deep10m", n=65_536,      dim=96,   universe=256),
    "sift50m": DatasetSpec("sift50m", n=131_072,     dim=128,  universe=510),
}


def make_dataset(spec: DatasetSpec) -> np.ndarray:
    """(n, m) int32, nonnegative even, <= universe."""
    rng = np.random.default_rng(spec.seed)
    centers = rng.uniform(0.25, 0.75, size=(spec.num_clusters, spec.dim))
    assign = rng.integers(0, spec.num_clusters, size=spec.n)
    noise = rng.laplace(0.0, spec.cluster_spread, size=(spec.n, spec.dim))
    x = centers[assign] + noise
    x = np.clip(x, 0.0, 1.0) * spec.universe
    even = 2 * np.round(x / 2.0)
    return np.clip(even, 0, spec.universe).astype(np.int32)


def make_skewed_dataset(spec: DatasetSpec, zipf_s: float = 1.4,
                        dup_frac: float = 0.15,
                        num_hot: int = 4) -> np.ndarray:
    """Occupancy-skewed variant of ``make_dataset`` (DESIGN.md §9).

    Two production failure modes the uniform generator cannot produce:

    * **Zipfian cluster sizes** — cluster c gets mass ∝ 1/c^zipf_s, so a
      few clusters hold most of the points (the SIFT/GIST-class occupancy
      histograms the revisit benchmark reports);
    * **duplicated points** — a ``dup_frac`` fraction of rows are verbatim
      copies of ``num_hot`` randomly chosen rows.  Identical rows hash
      identically in EVERY table, so each hot row is a guaranteed hot
      bucket at any (L, M, W) — the worst case for a global-max-bucket
      candidate ladder, and exactly what the two-level compaction policy
      must absorb.

    Same value domain as ``make_dataset`` (nonnegative even ints <= U), so
    all downstream tooling (queries, ground truth, hashing) is unchanged.
    """
    rng = np.random.default_rng(spec.seed + 0x5EED)
    centers = rng.uniform(0.25, 0.75, size=(spec.num_clusters, spec.dim))
    weights = 1.0 / np.arange(1, spec.num_clusters + 1) ** zipf_s
    weights /= weights.sum()
    assign = rng.choice(spec.num_clusters, size=spec.n, p=weights)
    noise = rng.laplace(0.0, spec.cluster_spread, size=(spec.n, spec.dim))
    x = np.clip(centers[assign] + noise, 0.0, 1.0) * spec.universe
    data = np.clip(2 * np.round(x / 2.0), 0, spec.universe).astype(np.int32)
    n_dup = int(spec.n * dup_frac)
    if n_dup and num_hot:
        hot = rng.choice(spec.n, size=min(num_hot, spec.n), replace=False)
        targets = rng.choice(spec.n, size=min(n_dup, spec.n), replace=False)
        # don't overwrite the hot originals themselves
        targets = targets[~np.isin(targets, hot)]
        data[targets] = data[hot[rng.integers(0, hot.size,
                                              size=targets.size)]]
    return data


def make_queries(
    spec: DatasetSpec, dataset: np.ndarray, num_queries: int,
    perturb_frac: float = 0.02, seed: int = 1,
) -> np.ndarray:
    """Queries near real points (controlled L1 offsets) + 10% uniform strays."""
    rng = np.random.default_rng(seed + spec.seed)
    base = dataset[rng.integers(0, dataset.shape[0], size=num_queries)].astype(np.float64)
    base += rng.laplace(0.0, perturb_frac * spec.universe, size=base.shape)
    stray = rng.random(size=num_queries) < 0.1
    base[stray] = rng.uniform(0, spec.universe, size=(stray.sum(), spec.dim))
    even = 2 * np.round(base / 2.0)
    return np.clip(even, 0, spec.universe).astype(np.int32)
