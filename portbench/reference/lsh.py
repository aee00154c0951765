"""Plain-torch reference of the served MP-RW-LSH query.

Written from the method's description (paper Sect. 2-3; Lv et al.'s
shift/expand probing sequence) and the configuration's stated semantics, in
straightforward torch operations.  It imports nothing of the program and
takes nothing that the program made: it builds its own hash tables from the
benchmark's dataset and hash parameters, and its own probing template from
(M, W, T).

Semantics held here (the configuration's ``guarantees``):

* raw hash of an even point s under walk table ``pairs`` (F, m, U2) int8:
  f_k(s) = sum_i tau_{k,i}(s_i), tau(2t) = pairs[k, i, :t].sum();
* bucket h = floor((f + b) / W) and epicenter offset x = ((f + b)/W - h) * W,
  in float32 (``quant_dtype`` lowers it, which is the control);
* one 32-bit key per table: c_l + sum_j a_{l,j} h_j (mod 2^32), then
  key * 2654435761 (mod 2^32) xor (key >> 15);
* probes: the epicenter and the first T perturbation sets of the
  template, ordered by expected score, mapped onto each query's sorted
  boundary distances (stable order on ties);
* a probed bucket gives its first C points in id order;
* the answer is the k (distance, id)-smallest distinct candidates by exact
  L1 distance, padded with (BIG_DIST, -1).

A row-sharded index (rows split into R contiguous shards, each with tables
of its own) answers each shard as above over its own rows, ids offset by
the shard's first row, and keeps the k (distance, id)-smallest of the R
lists (``merge``), the pads last.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

__all__ = ["BIG_DIST", "HashParams", "Tables", "expected_score", "probe_sets",
           "template", "prefix_weights", "raw_hash", "quantize", "mix", "build",
           "probe_keys", "extents", "candidates", "topk", "answer", "work",
           "work_of_probes", "as_params", "answer_shard", "merge"]

BIG_DIST = (2 ** 31 - 1) // 2
MASK32 = 0xFFFFFFFF
KEY_MUL = 2654435761
INT64_MAX = 2 ** 63 - 1

# elements (rows x values) of one step's temporaries
STEP_ELEMS = 1 << 27


@dataclass
class HashParams:
    """The benchmark's hash parameters, as plain tensors."""

    width: float
    pairs: torch.Tensor      # (L*M, m, U2) int8 paired walk steps in {-2, 0, 2}
    offsets: torch.Tensor    # (L, M) float32 in [0, W)
    mix_a: torch.Tensor      # (L, M) int64 odd, < 2^32
    mix_c: torch.Tensor      # (L,) int64, < 2^32

    @property
    def num_tables(self) -> int:
        return self.offsets.shape[0]

    @property
    def num_hashes(self) -> int:
        return self.offsets.shape[1]


# -- the probing template -------------------------------------------------

def expected_score(num_hashes: int, width: float) -> List[float]:
    """E[z_j^2] of the j-th smallest of the 2M boundary distances, j = 1..2M
    (paper Sect. 2.2), for offsets uniform on [0, W)."""
    m = num_hashes
    out = []
    for j in range(1, 2 * m + 1):
        if j <= m:
            out.append(j * (j + 1) / (4.0 * (m + 1) * (m + 2)) * width ** 2)
        else:
            r = 2 * m + 1 - j
            out.append((1.0 - r / (m + 1.0) + r * (r + 1) / (4.0 * (m + 1) * (m + 2)))
                       * width ** 2)
    return out


def probe_sets(num_hashes: int, width: float, num_probes: int) -> List[Tuple[int, ...]]:
    """The first ``num_probes`` valid rank sets (1-based ranks of the sorted
    boundary distances) in increasing expected score: a min-heap seeded with
    {1}, each popped set pushing its shift (last rank + 1) and its expansion
    (append last rank + 1).  A set is valid when it holds no rank j together
    with 2M + 1 - j (the two sides of one coordinate)."""
    two_m = 2 * num_hashes
    z = expected_score(num_hashes, width)

    def score(s):
        return float(sum(z[j - 1] for j in s))

    out, seen = [], set()
    heap = [(score((1,)), (1,))]
    while heap and len(out) < num_probes:
        _, s = heapq.heappop(heap)
        if s in seen:
            continue
        seen.add(s)
        if all(two_m + 1 - j not in s for j in s):
            out.append(s)
        last = s[-1]
        if last < two_m:
            for nxt in (s[:-1] + (last + 1,), s + (last + 1,)):
                heapq.heappush(heap, (score(nxt), nxt))
    return out


def template(num_hashes: int, width: float, num_probes: int) -> torch.Tensor:
    """(T+1, 2M) int8: row 0 the epicenter (no rank), row t the ranks of set t."""
    rows = torch.zeros((num_probes + 1, 2 * num_hashes), dtype=torch.int8)
    for t, s in enumerate(probe_sets(num_hashes, width, num_probes), start=1):
        for j in s:
            rows[t, j - 1] = 1
    return rows


# -- hashing ----------------------------------------------------------------

def prefix_weights(pairs: torch.Tensor) -> torch.Tensor:
    """(m * (U2+1), F) float32: row i*(U2+1) + t holds tau_{., i}(2t)."""
    f, m, u2 = pairs.shape
    tau = torch.zeros((f, m, u2 + 1), dtype=torch.float32, device=pairs.device)
    tau[:, :, 1:] = torch.cumsum(pairs.to(torch.float32), dim=-1)
    return tau.permute(1, 2, 0).reshape(m * (u2 + 1), f).contiguous()


def raw_hash(weights: torch.Tensor, u2: int, points: torch.Tensor) -> torch.Tensor:
    """(n, F) float32 raw hashes of even points in [0, 2*U2]: one summed
    lookup a coordinate (exact: every sum is an integer below 2^24)."""
    n, m = points.shape
    base = torch.arange(m, device=points.device, dtype=torch.int64) * (u2 + 1)
    idx = (points.to(torch.int64) >> 1) + base
    return torch.nn.functional.embedding_bag(idx, weights, mode="sum")


def quantize(params: HashParams, f: torch.Tensor, quant_dtype=torch.float32):
    """Raw hashes (n, L, M) -> (bucket int32, epicenter offset float32)."""
    w = params.width
    shifted = (f.to(quant_dtype) + params.offsets.to(quant_dtype)) / w
    bucket = torch.floor(shifted)
    x_neg = (shifted - bucket) * w
    return bucket.to(torch.int32), x_neg.to(torch.float32)


def _mul32(x: torch.Tensor, c) -> torch.Tensor:
    """x * c mod 2^32 for x, c in [0, 2^32), in int64 without overflow."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & MASK32


def mix(params: HashParams, bucket: torch.Tensor) -> torch.Tensor:
    """(..., L, M) int32 buckets -> (..., L) int64 keys in [0, 2^32)."""
    h = bucket.to(torch.int64) & MASK32
    key = (_mul32(h, params.mix_a).sum(dim=-1) + params.mix_c) & MASK32
    return _mul32(key, KEY_MUL) ^ (key >> 15)


# -- tables -------------------------------------------------------------------

@dataclass
class Tables:
    keys: torch.Tensor       # (L, n) int64 ascending
    ids: torch.Tensor        # (L, n) int32, ascending within equal keys
    weights: torch.Tensor    # the raw hash's lookup weights
    u2: int
    tmpl: torch.Tensor       # (T+1, 2M) int8 on the device


def build(params: HashParams, data: torch.Tensor, num_probes: int,
          quant_dtype=torch.float32) -> Tables:
    """Hash every point, key it per table, and sort each table by key (ids
    in ascending order within a key)."""
    n, m = data.shape
    l, mm = params.num_tables, params.num_hashes
    u2 = params.pairs.shape[2]
    weights = prefix_weights(params.pairs)
    keys = torch.empty((l, n), dtype=torch.int64, device=data.device)
    step = max(1, STEP_ELEMS // max(m, l * mm * 4))
    for lo in range(0, n, step):
        f = raw_hash(weights, u2, data[lo:lo + step]).reshape(-1, l, mm)
        bucket, _ = quantize(params, f, quant_dtype)
        keys[:, lo:lo + step] = mix(params, bucket).t()
    ids = torch.empty((l, n), dtype=torch.int32, device=data.device)
    for t in range(l):
        keys[t], order = torch.sort(keys[t], stable=True)
        ids[t] = order.to(torch.int32)
        del order
    tmpl = template(mm, params.width, num_probes).to(data.device)
    return Tables(keys, ids, weights, u2, tmpl)


def probe_keys(params: HashParams, tables: Tables, queries: torch.Tensor,
               quant_dtype=torch.float32) -> torch.Tensor:
    """(Q, L, T+1) int64 keys of every probed bucket, epicenter first."""
    q = queries.shape[0]
    l, mm = params.num_tables, params.num_hashes
    f = raw_hash(tables.weights, tables.u2, queries).reshape(q, l, mm)
    bucket, x_neg = quantize(params, f, quant_dtype)
    dist = torch.cat([x_neg, params.width - x_neg], dim=-1)     # (Q, L, 2M)
    rank_to_coord = torch.argsort(dist, dim=-1, stable=True)
    p = tables.tmpl.shape[0]
    marks = torch.zeros((q, l, p, 2 * mm), dtype=torch.int8, device=queries.device)
    marks.scatter_(-1, rank_to_coord[:, :, None, :].expand(q, l, p, 2 * mm),
                   tables.tmpl[None, None].expand(q, l, p, 2 * mm).contiguous())
    delta = marks[..., mm:].to(torch.int32) - marks[..., :mm].to(torch.int32)
    probed = (bucket[:, :, None, :] + delta).permute(0, 2, 1, 3)  # (Q, P, L, M)
    return mix(params, probed).permute(0, 2, 1).contiguous()     # (Q, L, P)


def extents(tables: Tables, pk: torch.Tensor):
    """(lo, occupancy) (Q, L, P) int64 of every probed bucket."""
    q, l, p = pk.shape
    lo = torch.empty((q, l, p), dtype=torch.int64, device=pk.device)
    occ = torch.empty_like(lo)
    for t in range(l):
        flat = pk[:, t, :].reshape(-1)
        a = torch.searchsorted(tables.keys[t], flat)
        b = torch.searchsorted(tables.keys[t], flat, right=True)
        lo[:, t, :] = a.reshape(q, p)
        occ[:, t, :] = (b - a).reshape(q, p)
    return lo, occ


def candidates(tables: Tables, lo: torch.Tensor, occ: torch.Tensor, cap: int):
    """(Q, L*P*cap) int64 candidate ids, -1 where a slot is empty or repeats
    an id already listed for the query; and the slots used a query."""
    q, l, p = lo.shape
    n = tables.ids.shape[1]
    off = torch.arange(cap, device=lo.device)
    take = torch.minimum(occ, torch.tensor(cap, device=lo.device))
    pos = (lo[..., None] + off).clamp(max=max(n - 1, 0))         # (Q, L, P, C)
    table = torch.arange(l, device=lo.device)[None, :, None, None]
    ids = tables.ids[table, pos].to(torch.int64)
    ids = torch.where(off < take[..., None], ids, -1).reshape(q, -1)
    ids = torch.sort(ids, dim=-1).values
    repeat = torch.zeros_like(ids, dtype=torch.bool)
    repeat[:, 1:] = ids[:, 1:] == ids[:, :-1]
    return torch.where(repeat, -1, ids), take.sum(dim=(1, 2))


def topk(data: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor, k: int):
    """The k (distance, id)-smallest of each query's listed ids (-1 skipped):
    (dists int32, ids int32), padded with (BIG_DIST, -1)."""
    q, c = ids.shape
    m = data.shape[1]
    packed = torch.full((q, max(c, k)), INT64_MAX, dtype=torch.int64, device=ids.device)
    qs = queries.to(torch.int32)
    step = max(1, STEP_ELEMS // max(1, q * m))
    for lo in range(0, c, step):
        blk = ids[:, lo:lo + step]
        rows = data[blk.clamp(min=0)].to(torch.int32)              # (Q, s, m)
        d = (rows - qs[:, None, :]).abs().sum(dim=-1, dtype=torch.int64)
        packed[:, lo:lo + blk.shape[1]] = torch.where(blk >= 0, (d << 32) | blk, INT64_MAX)
    best = torch.topk(packed, k, dim=-1, largest=False, sorted=True).values
    empty = best == INT64_MAX
    dist = torch.where(empty, BIG_DIST, best >> 32).to(torch.int32)
    gid = torch.where(empty, -1, best & MASK32).to(torch.int32)
    return dist, gid


def _query_chunk(params: HashParams, tables: Tables, cap: int) -> int:
    """Queries a step, so that its (Q, L, P, C) candidate slots stay small."""
    return max(1, STEP_ELEMS // (params.num_tables * tables.tmpl.shape[0] * cap * 4))


def answer(params: HashParams, tables: Tables, data: torch.Tensor,
           queries: torch.Tensor, cap: int, k: int, quant_dtype=torch.float32):
    """The served answer of each query: (dists (Q, k) int32, ids (Q, k) int32)."""
    q = queries.shape[0]
    chunk = _query_chunk(params, tables, cap)
    out_d, out_i = [], []
    for lo in range(0, q, chunk):
        qs = queries[lo:lo + chunk]
        pk = probe_keys(params, tables, qs, quant_dtype)
        a, occ = extents(tables, pk)
        ids, _ = candidates(tables, a, occ, cap)
        d, i = topk(data, qs, ids, k)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def answer_shard(params: HashParams, tables: Tables, rows: torch.Tensor,
                 queries: torch.Tensor, cap: int, k: int, first_row: int):
    """``answer`` over one shard's rows, its ids made global by adding the
    shard's first row (pads stay -1)."""
    d, i = answer(params, tables, rows, queries, cap, k)
    return d, torch.where(i >= 0, i + int(first_row), -1)


def merge(lists: List[Tuple[torch.Tensor, torch.Tensor]], k: int):
    """The k (distance, id)-smallest entries of each query over R (dists,
    ids) (Q, k) lists, ascending, the pads (BIG_DIST, -1) last."""
    d = torch.cat([x[0] for x in lists], dim=1).to(torch.int64)
    i = torch.cat([x[1] for x in lists], dim=1).to(torch.int64)
    key = d * (1 << 32) + torch.where(i < 0, MASK32, i)
    best = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    pad = (best & MASK32) == MASK32
    return ((best >> 32).to(torch.int32),
            torch.where(pad, -1, best & MASK32).to(torch.int32))


def work(params: HashParams, tables: Tables, queries: torch.Tensor, cap: int) -> Dict[str, int]:
    """What one batch of queries asks of the probe's gather and the rerank,
    counted from the semantics (``work_of_probes``)."""
    chunk = _query_chunk(params, tables, cap)
    keys = [probe_keys(params, tables, queries[lo:lo + chunk])
            for lo in range(0, queries.shape[0], chunk)]
    return work_of_probes(tables, keys, cap)


def work_of_probes(tables: Tables, keys: List[torch.Tensor], cap: int) -> Dict[str, int]:
    """Counts of a batch whose probe keys are ``keys`` ((Q_c, L, P) int64
    blocks of its queries): probes, candidate slots (sum of min(occ, C)),
    distinct (query, row) pairs, distinct rows over the batch, and the ids
    the batch's distinct buckets give (each bucket's first min(occ, C),
    once however many queries probe it)."""
    n = tables.ids.shape[1]
    device = tables.ids.device
    seen_rows = torch.zeros(max(n, 1), dtype=torch.bool, device=device)
    codes: List[torch.Tensor] = []
    queries = probes = slots = pairs = 0
    for pk in keys:
        q, l, p = pk.shape
        lo, occ = extents(tables, pk)
        ids, used = candidates(tables, lo, occ, cap)
        queries += q
        probes += q * l * p
        slots += int(used.sum())
        valid = ids[ids >= 0]
        pairs += int(valid.numel())
        seen_rows[valid] = True
        hit = occ > 0
        code = torch.arange(l, device=device)[None, :, None] * max(n, 1) + lo
        take = torch.minimum(occ, torch.tensor(cap, device=device))
        codes.append(torch.stack([code[hit], take[hit]]))
    both = torch.cat(codes, dim=1) if codes else torch.zeros((2, 0), dtype=torch.int64)
    order = torch.argsort(both[0])
    code, take = both[0][order], both[1][order]
    first = torch.ones_like(code, dtype=torch.bool)
    first[1:] = code[1:] != code[:-1]
    return {"queries": queries, "probes": probes, "slots": slots, "pairs": pairs,
            "rows": int(seen_rows.sum()), "bucket_ids": int(take[first].sum())}


def as_params(width: float, tensors: Dict[str, torch.Tensor]) -> HashParams:
    return HashParams(float(width), tensors["pairs"], tensors["offsets"],
                      tensors["mix_a"], tensors["mix_c"])
