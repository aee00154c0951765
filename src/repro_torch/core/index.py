"""MP-RW-LSH index: build and batched multi-probe query, torch counterpart of
``repro.core.index``.

  build : raw-hash all points -> bucket vectors -> 32-bit mixed keys -> one
          stable sort per table -> run lengths (occ_from) + occupancy
          histogram (occ_hist).
  query : the staged pipeline of ``core.pipeline``; the compacted two-phase
          form (``probe_index`` -> one host read -> ``finish_index``) is
          what the serving path runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace

from . import hashes as hashes_lib
from . import multiprobe as mp_lib
from . import pipeline as pipe

__all__ = ["IndexConfig", "IndexState", "make_template", "make_params", "ParamsFn",
           "build_index", "probe_index", "finish_index", "query_index_compact",
           "query_index", "OCC_HIST_BINS"]


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Static configuration; the fields and defaults of ``repro``'s."""

    num_tables: int = 8          # L
    num_hashes: int = 10         # M
    width: int = 8               # W (even for 'rw')
    num_probes: int = 100        # T extra buckets per table
    candidate_cap: int = 8       # max candidates gathered per probe
    universe: int = 256          # U, max (even) coordinate for 'rw'
    family: str = "rw"           # 'rw' | 'cauchy' | 'gaussian'
    hash_impl: str = "gather"    # 'gather' | 'thermo' | 'pallas' (the rw_hash kernel)
    rerank_chunk: int = 512      # candidates per rerank scan step
    rerank_impl: str = "fused"   # 'fused' (kernel, sort-free dedup) | 'scan'
    probe_impl: str = "fused"    # 'fused' (extents + gather kernels,
                                 # compactable slab) | 'staged' (plain pair)
    k: int = 50                  # neighbors returned
    dataset_dtype: str = "int32" # 'int16' halves rerank-gather bytes

    def __post_init__(self):
        if self.probe_impl not in ("fused", "staged"):
            raise ValueError(f"unknown probe_impl: {self.probe_impl!r}")

    @property
    def probes_per_table(self) -> int:
        return self.num_probes + 1  # + epicenter


@dataclasses.dataclass
class IndexState:
    """Device-resident index over one point set.

    sorted_keys : (L, n) int64   32-bit bucket keys, ascending per table
    sorted_ids  : (L, n) int32   row ids aligned with sorted_keys
    dataset     : (n, m)         int32 or int16 (``cfg.dataset_dtype``)
    template    : (T+1, 2M) int8 probing template, epicenter row first
    row_offset  : int            global id of row 0
    occ_from    : (L, n) int32   equal-key run length starting at each position
    occ_hist    : (L, 32) int32  ceil-log2 bucket-occupancy histogram
    """

    params: hashes_lib.LshParams
    sorted_keys: torch.Tensor
    sorted_ids: torch.Tensor
    dataset: torch.Tensor
    template: torch.Tensor
    row_offset: int = 0
    occ_from: Optional[torch.Tensor] = None
    occ_hist: Optional[torch.Tensor] = None


def make_template(cfg: IndexConfig) -> np.ndarray:
    """(T+1, 2M) template matrix with the epicenter (all-zero) row first."""
    sets = mp_lib.build_template(cfg.num_hashes, float(cfg.width), cfg.num_probes)
    mat = mp_lib.template_matrix(sets, cfg.num_hashes)
    return np.concatenate([np.zeros((1, 2 * cfg.num_hashes), np.int8), mat])


def make_params(cfg: IndexConfig, dim: int, seed: int = 0,
                device="cpu") -> hashes_lib.LshParams:
    """Random parameters of ``cfg.family`` from a seeded ``torch.Generator``."""
    gen = torch.Generator().manual_seed(int(seed))
    if cfg.family == "rw":
        params = hashes_lib.make_rw_params(cfg.num_tables, cfg.num_hashes, dim,
                                           cfg.universe, cfg.width, gen)
    elif cfg.family == "cauchy":
        params = hashes_lib.make_cp_params(cfg.num_tables, cfg.num_hashes, dim,
                                           cfg.width, gen)
    elif cfg.family == "gaussian":
        params = hashes_lib.make_gp_params(cfg.num_tables, cfg.num_hashes, dim,
                                           cfg.width, gen)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return params.to(device)


# a parameter source: each configuration's hash parameters for a dimension
ParamsFn = Callable[[IndexConfig, int], hashes_lib.LshParams]


def build_index(cfg: IndexConfig, dataset: torch.Tensor, row_offset: int = 0,
                params: Optional[hashes_lib.LshParams] = None,
                template: Optional[torch.Tensor] = None,
                seed: int = 0) -> IndexState:
    """Build the index over ``dataset`` (on its device).

    The per-table sort is stable: equal keys keep id order, which decides
    the rows that survive a bucket's ``candidate_cap`` prefix.
    """
    device = dataset.device
    n, dim = dataset.shape
    if params is None:
        params = make_params(cfg, dim, seed, device)
    keys_t = _bucket_keys(cfg, params, dataset.to(torch.int32))     # (L, n)
    dataset = dataset.to(getattr(torch, cfg.dataset_dtype))
    sorted_keys, order = torch.sort(keys_t, dim=-1, stable=True)
    if template is None:
        template = torch.from_numpy(make_template(cfg)).to(device)  # repro: allow[r1-host-sync] build-time: the template's one copy, once per build given no template
    occ_from = _run_lengths(sorted_keys)
    return IndexState(params=params, sorted_keys=sorted_keys,
                      sorted_ids=order.to(torch.int32), dataset=dataset,
                      template=template, row_offset=int(row_offset),
                      occ_from=occ_from,
                      occ_hist=_occ_histogram(sorted_keys, occ_from))


BUILD_CHUNK_ELEMS = 1 << 27  # bound on one build step's (rows, L*M) temporaries


def _bucket_keys(cfg: IndexConfig, params: hashes_lib.LshParams,
                 points: torch.Tensor) -> torch.Tensor:
    """(L, n) bucket keys of every point: hash, quantize and mix a block of
    rows at a time, so that the (rows, L*M) temporaries stay within
    ``BUILD_CHUNK_ELEMS`` however many hash functions a scheme takes."""
    n = points.shape[0]
    step = max(1, BUILD_CHUNK_ELEMS // (params.num_tables * params.num_hashes))
    keys = torch.empty((params.num_tables, n), dtype=torch.int64,
                       device=points.device)
    for lo in range(0, n, step):
        f = hashes_lib.raw_hash(params, points[lo:lo + step], impl=cfg.hash_impl)
        bucket, _ = hashes_lib.bucket_and_offsets(params, f)
        del f
        keys[:, lo:lo + step] = hashes_lib.mix_keys(params, bucket).t()
    return keys


def _run_lengths(sorted_keys: torch.Tensor) -> torch.Tensor:
    """(L, n) equal-key run length starting at each position."""
    n = sorted_keys.shape[1]
    run_end = torch.searchsorted(sorted_keys, sorted_keys, right=True)
    return (run_end - torch.arange(n, device=sorted_keys.device)).to(torch.int32)


OCC_HIST_BINS = 32  # bin b: occupancy in (2^(b-1), 2^b]; bin 31 also > 2^30


def _occ_histogram(sorted_keys: torch.Tensor, occ_from: torch.Tensor) -> torch.Tensor:
    """(L, 32) histogram of bucket occupancies in ceil-log2 bins: each run
    start counts once, in the bin of its run length."""
    l, n = sorted_keys.shape
    device = sorted_keys.device
    if n == 0:
        return torch.zeros((l, OCC_HIST_BINS), dtype=torch.int32, device=device)
    is_start = torch.ones((l, n), dtype=torch.bool, device=device)
    is_start[:, 1:] = sorted_keys[:, 1:] != sorted_keys[:, :-1]
    edges = torch.from_numpy(2 ** np.arange(31, dtype=np.int64)).to(  # repro: allow[r1-host-sync] build-time: the bin edges' one copy, once per build
        device=device, dtype=torch.int32)
    bins = torch.searchsorted(edges, occ_from).clamp(max=OCC_HIST_BINS - 1)
    bins = torch.where(is_start, bins, OCC_HIST_BINS)   # spill column
    flat = bins + (OCC_HIST_BINS + 1) * torch.arange(l, device=device)[:, None]
    hist = torch.bincount(flat.reshape(-1), minlength=l * (OCC_HIST_BINS + 1))  # repro: allow[r1-host-sync] build-time: the histogram's length read, once per build
    return hist.reshape(l, OCC_HIST_BINS + 1)[:, :OCC_HIST_BINS].to(torch.int32)


# --------------------------------------------------------------------------
# Query path
# --------------------------------------------------------------------------

def query_index(cfg: IndexConfig, state: IndexState, queries: torch.Tensor):
    """Batched ANN query at the worst-case slab.  Returns (dists (Q,k) int32,
    global ids (Q,k) int32)."""
    ids = pipe.probe_candidates(
        cfg, state.params, state.template, state.sorted_keys,
        state.sorted_ids, state.dataset.shape[0], queries,
        occ_from=state.occ_from)
    d, i = pipe.stage_rerank(cfg, state.dataset, queries, ids)
    return d, torch.where(i >= 0, i + state.row_offset, -1)


def probe_index(cfg: IndexConfig, state: IndexState, queries: torch.Tensor):
    """Phase A: (probe_keys (Q, L, P), lo (Q, L*P), occ (Q, L*P), counts (Q,))."""
    with obs_trace.span("stage_hash"):
        bucket, x_neg = pipe.stage_hash(cfg, state.params, queries)
    with obs_trace.span("stage_probe_keys"):
        probe_keys = pipe.stage_probe_keys(cfg, state.params, state.template,
                                           bucket, x_neg)
    with obs_trace.span("stage_probe_extents"):
        lo, occ, counts = pipe.stage_probe_extents(cfg, state.sorted_keys,
                                                   probe_keys, state.occ_from)
    return probe_keys, lo, occ, counts


def finish_index(cfg: IndexConfig, cbucket: int, c_cap: Optional[int],
                 state: IndexState, probe_keys, lo, occ, queries):
    """Phase B: compacted gather at the rung, then rerank."""
    n = state.dataset.shape[0]
    ids, _ = pipe.stage_fused_probe(
        cfg, state.sorted_keys, state.sorted_ids, probe_keys, n, cbucket,
        extents=(lo, occ), c_cap=c_cap, occ_from=state.occ_from)
    if not pipe.rerank_handles_duplicates(cfg):
        ids = pipe.stage_dedup(ids, n)
    d, i = pipe.stage_rerank(cfg, state.dataset, queries, ids)
    return d, torch.where(i >= 0, i + state.row_offset, -1)


def query_index_compact(cfg: IndexConfig, state: IndexState, queries,
                        floor: int = 64, ctot_cap: Optional[int] = None,
                        ctot_norm: Optional[int] = None,
                        c_cap: Optional[int] = None, overflow: str = "escalate"):
    """Two-phase compacted query; equal to ``query_index`` on the normal and
    ``escalate`` paths.  One host read (``counts.max()``) picks the rung."""
    if ctot_cap is None:
        ctot_cap = cfg.num_tables * cfg.probes_per_table * cfg.candidate_cap
    probe_keys, lo, occ, counts = probe_index(cfg, state, queries)
    cb, cc, _ = pipe.pick_rung(int(counts.max()), ctot_cap, floor,  # repro: allow[r1-host-sync] THE sanctioned phase-A rung-pick read (DESIGN.md §8)
                               ctot_norm, c_cap, overflow)
    return finish_index(cfg, cb, cc, state, probe_keys, lo, occ, queries)
