"""Recall-target autotuner: the paper's success model, inverted; torch
counterpart of the JAX package's ``eval/autotune.py``.

``core.multiprobe.success_table_mc`` gives P_T(d), the probability that one
table's probing sequence (epicenter + T template probes) lands the bucket of
a point at L1 distance d (paper Sect. 4).  With L independent tables the
per-neighbour success is 1 - (1 - P_T(d))^L, so expected recall@k is that
averaged over the distances of the true neighbours.  The tuner runs the
model over an (L, T) ladder, picks the cheapest configuration whose
*predicted* recall meets the target, then **validates** it on a calibration
split (perturbed copies of indexed points, exact ground truth) and escalates
— candidate cap first, which the model cannot see, then tables — until the
measured recall meets the target or the ladder is exhausted.

On the card the ground truth is ``brute_force_l1`` (the ``l1_distance``
kernel) and each validation a ``query_index`` (the probe's two launches and
``fused_rerank``).  ``ServeConfig.target_recall`` routes through
:func:`tune_for_recall` when the engine starts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import baselines as bl
from repro_torch.core import multiprobe as mp_lib
from repro_torch.core.index import (IndexConfig, IndexState, ParamsFn,
                                    build_index, make_params, query_index)
from repro_torch.core.pipeline import BIG_DIST

__all__ = ["AutotuneResult", "predicted_recall", "tune_for_recall"]


@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    """Outcome of one tuning run; ``cfg`` is the configuration to serve."""

    cfg: IndexConfig
    target_recall: float
    predicted_recall: float     # model prediction for the returned cfg
    validated_recall: float     # measured on the calibration split
    met_target: bool
    d_calib: Tuple[float, ...]  # representative neighbour distances used
    rounds: int
    history: Tuple[dict, ...]   # one record per validation round
    # the validated IndexState of the returned cfg: a caller serving the
    # same dataset seeds from it instead of building again
    state: Optional[IndexState] = None


def _rep_distances(true_d: np.ndarray, family: str,
                   quantiles: Sequence[float] = (0.15, 0.35, 0.55, 0.75, 0.92),
                   ) -> Tuple[float, ...]:
    """Representative true-neighbour distances: quantiles of the calibration
    ground truth's distances (recall@k averages over every rank, so the
    model must see the spread, not only the mean)."""
    flat = np.asarray(true_d, np.float64).ravel()
    flat = flat[flat < BIG_DIST]
    if flat.size == 0:
        raise ValueError("calibration ground truth has no valid distances")
    qs = np.quantile(flat, quantiles)
    if family == "rw":
        # the random-walk displacement pmf is defined on integer step counts
        qs = np.maximum(1.0, np.rint(qs))
    return tuple(float(x) for x in qs)


def predicted_recall(cfg: IndexConfig, d_values: Sequence[float],
                     mc_runs: int = 48, seed: int = 0) -> float:
    """Model recall@k for ``cfg``: E_d[1 - (1 - P_T(d))^L], with P_T(d) the
    success of the universal template the query path runs, Monte-Carlo
    averaged over epicenter offsets."""
    dv = [int(d) if cfg.family == "rw" else float(d) for d in d_values]
    tbl = mp_lib.success_table_mc(
        cfg.family, cfg.num_hashes, float(cfg.width), dv, [cfg.num_probes],
        runs=mc_runs, seed=seed, use_template=True)
    p_t = np.clip(tbl[:, 0], 0.0, 1.0)
    return float(np.mean(1.0 - (1.0 - p_t) ** cfg.num_tables))


def _calibration_queries(data, num: int, universe: int,
                         seed: int = 0) -> np.ndarray:
    """Perturbed copies of indexed points (valid even coordinates): a small
    Laplace offset keeps rank 0 off a trivial distance-0 self-hit.  ``data``
    is a numpy array or a tensor; only the drawn rows leave the device."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, data.shape[0], size=num)
    rows = data[torch.from_numpy(idx)].cpu().numpy() if torch.is_tensor(data) \
        else data[idx]
    rows = rows.astype(np.float64)
    rows += rng.laplace(0.0, 0.01 * universe, size=rows.shape)
    even = 2 * np.round(rows / 2.0)
    return np.clip(even, 0, universe).astype(np.int32)


def tune_for_recall(
    cfg: IndexConfig,
    dataset,
    target_recall: float,
    seed: int = 0,
    num_calib: int = 32,
    table_ladder: Sequence[int] = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
    probe_ladder: Optional[Sequence[int]] = None,
    max_rounds: int = 4,
    mc_runs: int = 48,
    params_fn: Optional[ParamsFn] = None,
    device=None,
) -> AutotuneResult:
    """Propose and validate (num_tables, num_probes, candidate_cap) for a
    target recall@k; ``cfg`` supplies everything else (family, M, W, k).

    ``seed`` draws the calibration queries and the model's offsets, and the
    hash parameters unless ``params_fn(cfg, dim)`` gives them.  ``device``
    (None = the card) holds the data and runs the ground truth and every
    validation.  Returns the best configuration found; ``met_target`` says
    whether the calibration recall reached the target.
    """
    device = resolve_device(device)
    if not torch.is_tensor(dataset):
        dataset = torch.from_numpy(np.ascontiguousarray(dataset, np.int32))
    dataset = dataset.to(device=device, dtype=torch.int32)
    n, dim = dataset.shape
    if n == 0:
        raise ValueError("cannot autotune over an empty dataset")
    params_fn = params_fn or (lambda c, m: make_params(c, m, seed))
    calib_q = torch.from_numpy(_calibration_queries(
        dataset, min(num_calib, max(4, n)), cfg.universe, seed)).to(device)
    td, ti = bl.brute_force_l1(dataset, calib_q, cfg.k)
    ti = ti.cpu().numpy()
    d_values = _rep_distances(td.cpu().numpy(), cfg.family)

    if probe_ladder is None:
        probe_ladder = (cfg.num_probes,)
    table_ladder = tuple(sorted(set(table_ladder)))
    probe_ladder = tuple(sorted(set(probe_ladder)))

    # Analytic proposal: for each T, the smallest L whose predicted recall
    # meets the target; then the cheapest (L, T) by probe count L*(T+1).
    proposals = []
    for t_probes in probe_ladder:
        for l_tables in table_ladder:
            cand = dataclasses.replace(cfg, num_tables=l_tables,
                                       num_probes=t_probes)
            pred = predicted_recall(cand, d_values, mc_runs, seed)
            if pred >= target_recall:
                proposals.append((l_tables * (t_probes + 1), l_tables,
                                  t_probes, pred))
                break
    if proposals:
        _, l_tables, t_probes, _ = min(proposals)
    else:  # the model says the ladder cannot reach the target: top rung
        l_tables, t_probes = table_ladder[-1], probe_ladder[-1]

    cap = max(cfg.candidate_cap, 2 * cfg.k)
    cap_max = 4 * cap
    history, best = [], None
    for rnd in range(1, max_rounds + 1):
        cand = dataclasses.replace(cfg, num_tables=l_tables,
                                   num_probes=t_probes, candidate_cap=cap)
        pred = predicted_recall(cand, d_values, mc_runs, seed)
        state = build_index(cand, dataset,
                            params=params_fn(cand, int(dim)).to(device))
        _, ids = query_index(cand, state, calib_q)
        val = float(bl.recall(ids.cpu().numpy(), ti))
        history.append({"round": rnd, "num_tables": l_tables,
                        "num_probes": t_probes, "candidate_cap": cap,
                        "predicted": round(pred, 4),
                        "validated": round(val, 4)})
        if best is None or val > best[0]:
            best = (val, cand, pred, state)
        if val >= target_recall:
            break
        # cap truncation is invisible to the model: widen the cap first,
        # then climb the table and probe ladders
        if cap < cap_max:
            cap *= 2
            continue
        higher_l = [x for x in table_ladder if x > l_tables]
        higher_t = [x for x in probe_ladder if x > t_probes]
        if higher_l:
            l_tables = higher_l[0]
        elif higher_t:
            t_probes = higher_t[0]
        else:
            break
    val, cand, pred, best_state = best
    return AutotuneResult(
        cfg=cand, target_recall=float(target_recall),
        predicted_recall=float(pred), validated_recall=val,
        met_target=val >= target_recall, d_calib=d_values,
        rounds=len(history), history=tuple(history), state=best_state)
