"""Synthetic LM token pipeline: deterministic, host-sliceable, restartable;
the port's own copy of the JAX package's ``data/lm_synthetic.py`` (numpy
only, the same bits).

Produces next-token-predictable streams (ordered Markov-ish structure so a
model can actually reduce loss) with a (step, host) -> batch mapping that is
*stateless*: any host can regenerate any shard of any step, so a
replacement host resumes mid-stream with no handshake.  The arrays are
numpy; the caller puts them on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LmDataConfig", "batch_at_step"]


@dataclasses.dataclass(frozen=True)
class LmDataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    order: int = 3  # markov order of the synthetic source


def _mix(*xs: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(entropy=list(xs)))


def batch_at_step(cfg: LmDataConfig, step: int, shard: int = 0, num_shards: int = 1):
    """Return (tokens, labels) for this host's slice of ``step``.

    tokens, labels: (global_batch // num_shards, seq_len) int32.
    Deterministic in (cfg.seed, step, row-index) only — independent of which
    host asks, so shards never disagree and lost hosts are replaceable.
    """
    if cfg.global_batch % num_shards:
        raise ValueError("global_batch must divide num_shards")
    rows = cfg.global_batch // num_shards
    row0 = shard * rows
    out = np.empty((rows, cfg.seq_len + 1), np.int32)
    for r in range(rows):
        rng = _mix(cfg.seed, step, row0 + r)
        # structured stream: tokens follow t_{i+1} = (a*t_i + b + noise) mod V
        a = int(rng.integers(2, 64))
        b = int(rng.integers(0, cfg.vocab))
        t = int(rng.integers(0, cfg.vocab))
        noise = rng.integers(0, 4, size=cfg.seq_len + 1)
        seq = np.empty(cfg.seq_len + 1, np.int64)
        for i in range(cfg.seq_len + 1):
            seq[i] = t
            t = (a * t + b + int(noise[i])) % cfg.vocab
        out[r] = seq.astype(np.int32)
    return out[:, :-1], out[:, 1:]
