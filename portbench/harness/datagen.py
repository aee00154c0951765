"""The cell's inputs, made on the device from ``--seed``.

A configuration's ``data`` block shapes the points and the queries after the
paper's synthetic stand-ins (Laplacian clusters of even coordinates in
[0, U]; queries near points plus uniform strays), and its ``index`` block
sizes the RW-LSH hash parameters.  Every tensor comes from a
``torch.Generator`` on the device, in a few large calls, a block of rows at
a time; one seed gives the same inputs on every run of one device type.
Each input has a stream of its own (``substream``), so the queries and the
parameters do not depend on how the points were drawn.

Every seed serves the same work in another order: the points, queries and
hash parameters are drawn from the fixed ``BASE_SEED``, and ``--seed``
permutes the points' ids (which of an over-full bucket's points come first)
and the order of the queries.  Data drawn anew for each seed moved
``gist1m.bulk1024``'s rate on an H100 by up to 6% between seeds, against 0.4% between
two runs of one seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["substream", "make_points", "make_queries", "make_hash_params",
           "make_inputs", "make_shard_inputs", "STEP_ELEMS"]

STEP_ELEMS = 1 << 26     # values of one block of rows (its float32 temporaries)
BASE_SEED = 0            # the data, queries and parameters of every run
_INT31 = 2 ** 31 - 1


def substream(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for input ``stream`` of run ``seed`` (any
    integer seed, negative or past 64 bits included)."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1))
    return gen


def _laplace(shape, scale: float, gen, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device) - 0.5
    return -scale * torch.sign(u) * torch.log1p(-2.0 * u.abs())


def _even(x: torch.Tensor, universe: int) -> torch.Tensor:
    """[0, U] floats -> nearest even integers in [0, U], int32."""
    return (2.0 * torch.round(x / 2.0)).clamp(0, universe).to(torch.int32)


def _point_blocks(d: Dict, seed: int, device):
    """The drawn points in blocks of ``STEP_ELEMS`` values: (first drawn
    index, (rows, m) int32), in drawing order."""
    n, m, u = int(d["n"]), int(d["dim"]), int(d["universe"])
    gen = substream(seed, 0, device)
    centres = 0.25 + 0.5 * torch.rand((int(d["num_clusters"]), m), generator=gen,
                                      device=device)
    step = max(1, STEP_ELEMS // m)
    for lo in range(0, n, step):
        rows = min(step, n - lo)
        which = torch.randint(0, centres.shape[0], (rows,), generator=gen, device=device)
        x = centres[which] + _laplace((rows, m), float(d["cluster_spread"]), gen, device)
        yield lo, _even(x.clamp(0.0, 1.0) * u, u)


def make_points(d: Dict, seed: int, device, order: torch.Tensor = None) -> torch.Tensor:
    """(n, m) int32: Laplacian clusters around uniform centres in the middle
    half of [0, 1], scaled to [0, U] and rounded to even integers; drawn
    point i is stored at row ``order[i]`` when an order is given."""
    out = torch.empty((int(d["n"]), int(d["dim"])), dtype=torch.int32, device=device)
    for lo, x in _point_blocks(d, seed, device):
        if order is None:
            out[lo:lo + x.shape[0]] = x
        else:
            out[order[lo:lo + x.shape[0]]] = x
    return out


def _query_picks(d: Dict, n: int, gen, device) -> torch.Tensor:
    """The drawn points the queries start from."""
    return torch.randint(0, n, (int(d["num_queries"]),), generator=gen, device=device)


def _queries_from(d: Dict, sources: torch.Tensor, gen) -> torch.Tensor:
    """The queries from their source points: Laplace noise, and strays."""
    u = int(d["universe"])
    device = sources.device
    x = sources.to(torch.float32)
    x = x + _laplace(x.shape, float(d["perturb_frac"]) * u, gen, device)
    stray = torch.rand((x.shape[0],), generator=gen, device=device) < float(d["stray_frac"])
    uniform = torch.rand(x.shape, generator=gen, device=device) * u
    return _even(torch.where(stray[:, None], uniform, x), u)


def make_queries(d: Dict, points: torch.Tensor, seed: int,
                 order: torch.Tensor = None) -> torch.Tensor:
    """(num_queries, m) int32: drawn points (at rows ``order`` of them, when
    ``points`` were stored in that order) perturbed by Laplace noise of scale
    ``perturb_frac * U``, and a ``stray_frac`` share drawn uniformly."""
    gen = substream(seed, 1, points.device)
    pick = _query_picks(d, points.shape[0], gen, points.device)
    return _queries_from(d, points[pick if order is None else order[pick]], gen)


def make_hash_params(ix: Dict, dim: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """RW-LSH parameters of L tables x M functions: paired walk steps
    (L*M, m, U/2) int8 in {-2, 0, 2}, offsets (L, M) float32 in [0, W), odd
    32-bit multipliers (L, M) and additive constants (L,) as int64."""
    l, mm, u, w = (int(ix["num_tables"]), int(ix["num_hashes"]), int(ix["universe"]),
                   float(ix["width"]))
    gen = substream(seed, 2, device)
    steps = torch.randint(0, 2, (l * mm, dim, u // 2, 2), generator=gen, device=device,
                          dtype=torch.int8)
    pairs = (2 * steps - 1).sum(dim=-1, dtype=torch.int8)
    offsets = torch.rand((l, mm), generator=gen, device=device) * w
    mix_a = torch.randint(0, _INT31, (l, mm), generator=gen, device=device) * 2 + 1
    mix_c = torch.randint(0, _INT31, (l,), generator=gen, device=device)
    return {"pairs": pairs, "offsets": offsets, "mix_a": mix_a, "mix_c": mix_c}


def make_inputs(config: Dict, seed: int, device) -> Dict[str, object]:
    """Points, queries and hash parameters of one run: the configuration's
    fixed draw, with the points' ids and the queries' order permuted by
    ``seed``."""
    d = config["data"]
    gen = substream(seed, 3, device)
    order = torch.randperm(int(d["n"]), generator=gen, device=device)
    points = make_points(d, BASE_SEED, device, order)
    queries = make_queries(d, points, BASE_SEED, order)
    queries = queries[torch.randperm(queries.shape[0], generator=gen, device=device)]
    params = make_hash_params(config["index"], int(d["dim"]), BASE_SEED, device)
    return {"points": points, "queries": queries, "params": params}


def make_shard_inputs(config: Dict, seed: int, device, shard: int,
                      shards: int) -> Dict[str, object]:
    """Rows ``[shard * n/R, (shard + 1) * n/R)`` of the points ``make_inputs``
    makes for ``seed`` (R = ``shards``), with the same queries and hash
    parameters, bit for bit; ``first_row`` is the shard's first row.

    Every point is drawn as ``make_points`` draws it, a block at a time, and
    a block keeps the points that the seed's order stores in the shard, so
    the card holds the shard's rows, the order (n int64) and one block.  The
    queries' source points are taken from the blocks as they pass."""
    d = config["data"]
    n = int(d["n"])
    if shards < 1 or n % shards or not 0 <= shard < shards:
        raise ValueError(f"{n} rows do not split into {shards} shards with a shard {shard}")
    lo_row, rows = shard * (n // shards), n // shards
    gen = substream(seed, 3, device)
    order = torch.randperm(n, generator=gen, device=device)
    qgen = substream(BASE_SEED, 1, device)
    pick = _query_picks(d, n, qgen, device)
    sources = torch.empty((pick.shape[0], int(d["dim"])), dtype=torch.int32, device=device)
    points = torch.empty((rows, int(d["dim"])), dtype=torch.int32, device=device)
    for lo, x in _point_blocks(d, BASE_SEED, device):
        dest = order[lo:lo + x.shape[0]] - lo_row
        keep = (dest >= 0) & (dest < rows)
        points[dest[keep]] = x[keep]
        here = (pick >= lo) & (pick < lo + x.shape[0])
        sources[here] = x[pick[here] - lo]
    del order
    queries = _queries_from(d, sources, qgen)
    queries = queries[torch.randperm(queries.shape[0], generator=gen, device=device)]
    params = make_hash_params(config["index"], int(d["dim"]), BASE_SEED, device)
    return {"points": points, "queries": queries, "params": params, "first_row": lo_row}
