"""Adversarial kernel inputs shared by the port's kernel tests (numpy only,
so the card-side tests need no jax).

PROBE_CASES  : name -> (keys (L, n) uint32 sorted, ids (L, n) int32,
                        probe keys (Q, L, P) uint32, cap, cbucket)
RERANK_CASES : name -> (dataset (n, m), queries (Q, m) int32, ids (Q, Ctot) int32, k)
RERANK_WRAP_CASES: the same, with L1 sums that wrap in int32
KERNEL_RERANK_CASES: the rerank cases inside the CUDA kernel's contract
MERGE_CASES  : name -> (da, ia, db, ib), each (Q, k)
RW_HASH_CASES: name -> (pairs (F, m, U2) int8, points (n, m) int32)
L1_CASES     : name -> (queries (Q, m), points (N, m)), one dtype
L1_ROWS_CASES: name -> (queries (Q, m), rows (Q, C, m)), one dtype
L1_INT_CASES : the integer-only pairwise cases of L1_CASES
walk_range_case(): the gather hash's out-of-range inputs (coordinates,
               a dataset, inserts and queries with one point beyond [0, U])

The L1 cases hold integer values, which float32 and bfloat16 sum exactly
in any order, so every kernel equals its plain version bit for bit.
"""
import numpy as np

BIG = np.iinfo(np.int32).max // 2



def _probe_case(seed, l, n, p, q, universe, cap, cbucket):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, universe + 1, (l, n)).astype(np.uint32), axis=-1)
    ids = (np.stack([rng.permutation(n) for _ in range(l)]).astype(np.int32)
           if n else np.zeros((l, 0), np.int32))
    pk = rng.integers(0, universe + 3, (q, l, p)).astype(np.uint32)
    return keys, ids, pk, cap, cbucket


def _probe_cases():
    cases = {
        "random": _probe_case(0, 3, 120, 7, 5, 40, 6, 300),
        "truncating_cbucket": _probe_case(2, 3, 100, 5, 4, 20, 8, 17),
        "one_slot": _probe_case(4, 2, 50, 3, 3, 10, 4, 1),
    }
    for n in (0, 1):                                    # tiny segments
        keys = np.zeros((3, n), np.uint32)
        ids = np.zeros((3, n), np.int32)
        pk = np.random.default_rng(0).integers(0, 3, (5, 3, 4)).astype(np.uint32)
        pk[0] = 0
        cases[f"n{n}"] = (keys, ids, pk, 4, 32)
    rng = np.random.default_rng(1)                      # uint32 extremes
    keys = np.sort(rng.integers(10, 50, (2, 150)).astype(np.uint32), axis=-1)
    keys[:, -3:] = 0xFFFFFFFF
    ids = np.stack([rng.permutation(150) for _ in range(2)]).astype(np.int32)
    pk = np.full((3, 2, 6), 5, np.uint32)
    pk[1] = 0xFFFFFFFF
    pk[2, 0, 0] = keys[0, 0]
    cases["uint32_extremes"] = (keys, ids, pk, 8, 64)
    keys = np.zeros((4, 8), np.uint32)                  # dups across tables
    cases["dup_across_tables"] = (keys, np.tile(np.arange(8, dtype=np.int32), (4, 1)),
                                  np.zeros((1, 4, 1), np.uint32), 8, 64)
    # L*P over one block's width (256 threads): L 4 x P 100 and L 8 x P 200
    cases["wide_l4_p100"] = _probe_case(5, 4, 300, 100, 3, 40, 5, 2000)
    cases["wide_l8_p200"] = _probe_case(6, 8, 200, 200, 2, 60, 4, 700)
    # total > cbucket = 600: the row is cut inside the third 256-slot chunk
    cases["truncate_in_chunk"] = _probe_case(7, 4, 400, 50, 3, 20, 8, 600)
    # buckets far over the cap next to empty ones; query 1 finds nothing
    rng = np.random.default_rng(8)
    keys = np.stack([np.sort(np.concatenate([np.full(300, 7), np.full(150, 9),
                                             rng.integers(20, 60, 50)])),
                     np.sort(np.concatenate([np.full(200, 3), rng.integers(0, 12, 300)]))
                     ]).astype(np.uint32)
    ids = np.stack([rng.permutation(500) for _ in range(2)]).astype(np.int32)
    pk = np.asarray([[[7, 8, 9, 6, 30, 7], [9, 100, 7, 8, 21, 0]],
                     [[1000, 1001, 8, 0, 6, 10], [100, 200, 13, 14, 15, 16]],
                     [[9, 9, 9, 7, 7, 7], [61, 62, 63, 64, 65, 66]]], np.uint32)
    cases["skewed_and_empty"] = (keys, ids, pk, 6, 200)
    return cases


PROBE_CASES = _probe_cases()


def _rerank_cases():
    cases = {}
    for q, n, ctot, k, m in [(1, 40, 24, 5, 9), (5, 100, 67, 9, 17),
                             (7, 50, 3, 8, 12), (4, 30, 33, 1, 7)]:
        for dtype in (np.int32, np.int16):
            rng = np.random.default_rng(q * 100 + ctot)
            cases[f"q{q}_ctot{ctot}_k{k}_{np.dtype(dtype).name}"] = (
                rng.integers(0, 50, (n, m)).astype(dtype),
                rng.integers(0, 50, (q, m)).astype(np.int32),
                rng.integers(-1, n + 2, (q, ctot)).astype(np.int32), k)
    n, m = 12, 4                                            # all ties
    cases["ties"] = (np.full((n, m), 3, np.int32), np.full((2, m), 1, np.int32),
                     np.asarray([[9, 7, 7, 11, 3, 9, 5, 3],
                                 [10, 10, 10, 10, 2, 2, 2, 2]], np.int32), 5)
    rng = np.random.default_rng(2)                          # dups across tiles
    data = rng.integers(0, 100, (64, 8)).astype(np.int32)
    cases["dup_pressure"] = (data, data[:2].copy(),
                             np.tile(np.arange(8, dtype=np.int32), (2, 16)), 8)
    cases["all_sentinel"] = (rng.integers(0, 9, (20, 8)).astype(np.int32),
                             rng.integers(0, 9, (3, 8)).astype(np.int32),
                             np.full((3, 16), 20, np.int32), 6)
    for dtype in (np.int32, np.int16):
        cases.update(_split_cases(np.dtype(dtype)))
    # valid candidates at ~1.34e9 >= BIG: the reference ranks them after
    # every invalid slot, so row 0 is six (BIG, -1)
    data = (2 ** 28 - np.random.default_rng(0).integers(0, 1000, (40, 5))).astype(np.int32)
    ids = np.full((2, 30), -1, np.int32)
    ids[0, :5] = [8, 19, 12, 8, 36]
    cases["beyond_big_dist"] = (data, np.zeros((2, 5), np.int32), ids, 6)
    return cases


def _split_cases(dtype):
    """Rows long enough that the kernel splits them into several slices at
    any slice count it plans for a small Q (it plans >= 512 slots a slice),
    with the traps of the split: one id in every slice, equal distances of
    different ids in different slices, a slice with no valid id, Q = 1, and
    row widths for each way the kernel reads a row."""
    name = dtype.name
    cases = {}
    rng = np.random.default_rng(31)
    n, m, q, ctot = 300, 20, 3, 4000        # m = 20: vectors in int32, not int16
    data = rng.integers(0, 40, (n, m)).astype(dtype)
    queries = rng.integers(0, 40, (q, m)).astype(np.int32)
    queries[2] = queries[0]
    tie_ids = [40] + list(range(50, 60))    # 11 rows at distance 0 from query 0
    data[tie_ids] = queries[0]
    ids = rng.integers(-2, n + 3, (q, ctot)).astype(np.int32)
    ids[:, ::500] = 40                      # id 40 in every slice
    ids[:, 150 + 350 * np.arange(10)] = np.arange(50, 60)   # ties across slices
    ids[1, :2048] = n                       # a first slice with no valid id
    cases[f"split_q{q}_ctot{ctot}_{name}"] = (data, queries, ids, 10)
    rng = np.random.default_rng(32)
    n, m, ctot = 200, 130, 2600             # m = 130: no vectors in either type
    data = rng.integers(-50, 50, (n, m)).astype(dtype)
    ids = rng.integers(0, n, (1, ctot)).astype(np.int32)
    ids[0, 1000:1700] = -1
    cases[f"split_q1_m{m}_{name}"] = (data, rng.integers(-50, 50, (1, m)).astype(np.int32),
                                      ids, 7)
    for m in (128, 256, 1024):              # one vector a lane, or more
        rng = np.random.default_rng(m)
        cases[f"wide_m{m}_{name}"] = (rng.integers(0, 300, (64, m)).astype(dtype),
                                      rng.integers(0, 300, (2, m)).astype(np.int32),
                                      rng.integers(-1, 66, (2, 700)).astype(np.int32), 5)
    return cases


RERANK_CASES = _rerank_cases()

# rows 0-2 sum to 9 * 2**28, which wraps to -1879048192 and ranks first
_WRAP_DATA = np.concatenate([np.full((3, 9), 2 ** 28), np.arange(5, 8)[:, None].repeat(9, 1)])
RERANK_WRAP_CASES = {"wrapped_sum": (_WRAP_DATA.astype(np.int32), np.zeros((1, 9), np.int32),
                                     np.arange(6, dtype=np.int32)[None], 4)}


def reaches_big(case) -> bool:
    """Whether a valid candidate's int32 L1 distance is >= BIG: outside the
    rerank kernel's contract (the serving entry points refuse such data)."""
    data, queries, ids, _ = case
    n = data.shape[0]
    if n == 0:
        return False
    rows = data[np.clip(ids, 0, n - 1)].astype(np.int64)
    d = np.abs(rows - queries[:, None, :].astype(np.int64)).sum(-1)
    d = (d + 2 ** 31) % 2 ** 32 - 2 ** 31                    # the int32 sum
    return bool((((ids >= 0) & (ids < n)) & (d >= BIG)).any())


KERNEL_RERANK_CASES = {name: case for name, case in {**RERANK_CASES, **RERANK_WRAP_CASES}.items()
                       if not reaches_big(case)}


def _merge_cases():
    cases = {}
    # k = 16, 17, 32, 33 at a Q that is no multiple of the kernel's rows a
    # block (128 / kp in registers, 4 in shared memory)
    for q, k, seed in [(1, 1, 0), (3, 5, 1), (9, 10, 2), (4, 16, 3), (5, 33, 4),
                       (13, 16, 5), (13, 17, 6), (13, 32, 7), (13, 33, 8)]:
        rng = np.random.default_rng(seed)
        da = rng.integers(0, 40, (q, k)).astype(np.int32)
        db = rng.integers(0, 40, (q, k)).astype(np.int32)
        ia = rng.integers(0, 50, (q, k)).astype(np.int32)
        ib = rng.integers(0, 50, (q, k)).astype(np.int32)
        lex = lambda d, i: tuple(np.take_along_axis(x, np.lexsort((i, d), axis=-1), -1)
                                 for x in (d, i))
        cases[f"lex_q{q}_k{k}"] = (*lex(da, ia), *lex(db, ib))
        # sorted by distance only, ids in arbitrary order
        cases[f"dist_only_q{q}_k{k}"] = (np.sort(da, -1), ia, np.sort(db, -1), ib)
    k = 8
    cases["all_invalid"] = (np.full((4, k), BIG, np.int32), np.full((4, k), -1, np.int32),
                            np.full((4, k), BIG, np.int32), np.full((4, k), -1, np.int32))
    cases["tied_ids"] = (np.asarray([[5, 5]], np.int32), np.asarray([[9, 10]], np.int32),
                         np.asarray([[5, 5]], np.int32), np.asarray([[1, 2]], np.int32))
    # an entry at dist >= BIG with id >= 0 ranks after a pad (k=3 -> kp=4)
    cases["beyond_pad"] = (np.asarray([[1, BIG, BIG + 5]], np.int32),
                           np.asarray([[4, 7, 2]], np.int32),
                           np.asarray([[2, BIG, BIG + 1]], np.int32),
                           np.asarray([[5, 3, 1]], np.int32))
    return cases


MERGE_CASES = _merge_cases()


def _walk_pairs(rng, f, m, u2):
    return (2 * rng.integers(0, 2, (f, m, u2, 2)) - 1).sum(-1).astype(np.int8)


WALK_RANGE_U = 30
# negatives that wrap (-2(U2+1) reads row 0), the first that does not
# (-2(U2+2)), odd values, U, U + 1 and values that fill with INT32_MIN
WALK_RANGE_COORDS = (-2 * (WALK_RANGE_U // 2 + 2), -2 * (WALK_RANGE_U // 2 + 1),
                     -2 * (WALK_RANGE_U // 2 + 1) - 1, -2, -1, 0, 1, 3, 17,
                     WALK_RANGE_U - 1, WALK_RANGE_U, WALK_RANGE_U + 1,
                     2 * WALK_RANGE_U, 40)


def walk_range_case():
    """(coords (64, 8), data (256, 8), inserts (40, 8), queries (6, 8)),
    int32, at U 30: ``coords`` draws from ``WALK_RANGE_COORDS``; the data
    is even and in [0, U]; insert 3 and query 1 hold coordinates outside
    it; queries 0 and 2 equal inserts 0 and 3."""
    rng = np.random.default_rng(21)
    u = WALK_RANGE_U
    coords = rng.choice(np.asarray(WALK_RANGE_COORDS), (64, 8)).astype(np.int32)
    data = (rng.integers(0, u // 2 + 1, (256, 8)) * 2).astype(np.int32)
    inserts = (rng.integers(0, u // 2 + 1, (40, 8)) * 2).astype(np.int32)
    inserts[3] = [12, -2, 0, 40, 2 * u, u + 1, -7, 3]
    queries = (rng.integers(0, u // 2 + 1, (6, 8)) * 2).astype(np.int32)
    queries[1] = [40, -2, 12, 2 * u, -1, u + 1, 0, 9]
    queries[0], queries[2] = inserts[0], inserts[3]
    return coords, data, inserts, queries


def _rw_hash_cases():
    cases = {}
    # tests/test_kernels.py's shapes, even coordinates in [0, U]
    for f, m, u2, n in [(3, 2, 4, 5), (17, 8, 32, 40), (64, 16, 128, 20)]:
        rng = np.random.default_rng(f * 7 + n)
        cases[f"f{f}_m{m}_u2_{u2}_n{n}"] = (
            _walk_pairs(rng, f, m, u2),
            (rng.integers(0, u2 + 1, (n, m)) * 2).astype(np.int32))
    # odd, negative and above-universe coordinates; F not a multiple of 8
    # and spanning two 32-function tiles; U2 odd; rows over two row tiles
    rng = np.random.default_rng(3)
    cases["out_of_range"] = (_walk_pairs(rng, 37, 7, 31),
                             rng.integers(-70, 2 * 31 + 70, (2100, 7)).astype(np.int32))
    ext = rng.integers(-5, 70, (6, 5)).astype(np.int32)
    ext[0] = np.iinfo(np.int32).min
    ext[1] = np.iinfo(np.int32).max
    ext[2] = -1
    cases["int32_extremes"] = (_walk_pairs(rng, 13, 5, 31), ext)
    # the SIFT widths: U2 = 255 (odd), F = L*M = 96
    cases["sift_widths"] = (_walk_pairs(rng, 96, 16, 255),
                            (rng.integers(0, 256, (70, 16)) * 2).astype(np.int32))
    for n in (0, 1):
        cases[f"n{n}"] = (_walk_pairs(rng, 9, 4, 15),
                          rng.integers(0, 31, (n, 4)).astype(np.int32))
    # enough rows that the kernel does not split the dimensions
    cases["many_rows"] = (_walk_pairs(rng, 65, 2, 5),
                          rng.integers(-3, 14, (100_000, 2)).astype(np.int32))
    # around the hash kernel's 512-row tile, its 16-dimension chunk and the
    # table's 32-function padding
    for n in (511, 513, 1025):
        cases[f"rows{n}"] = (_walk_pairs(rng, 5, 3, 15),
                             rng.integers(-3, 34, (n, 3)).astype(np.int32))
    for m in (17, 33):
        cases[f"m{m}"] = (_walk_pairs(rng, 6, m, 31),
                          rng.integers(-3, 66, (40, m)).astype(np.int32))
    for f in (33, 96):
        cases[f"f{f}"] = (_walk_pairs(rng, f, 5, 15),
                          rng.integers(-3, 34, (50, 5)).astype(np.int32))
    # constant and extreme int8 steps at U2 = 255: the int32 table is exact
    pts = rng.integers(-10, 2 * 255 + 10, (60, 4)).astype(np.int32)
    for name, steps in (("steps_plus2", np.full((7, 4, 255), 2)),
                        ("steps_minus2", np.full((7, 4, 255), -2)),
                        ("steps_extreme", rng.choice([-128, 127], (7, 4, 255)))):
        cases[name] = (steps.astype(np.int8), pts)
    return cases


RW_HASH_CASES = _rw_hash_cases()

L1_DTYPES = ("int32", "int16", "float32", "bfloat16")


def _l1_cases():
    pair, rows = {}, {}
    shapes = [(1, 1, 1), (7, 33, 17), (16, 128, 96), (130, 257, 100), (5, 70, 300)]
    for q, n, m in shapes:                              # tests/test_kernels.py + m=300
        rng = np.random.default_rng(q * 1000 + n)
        pair[f"q{q}_n{n}_m{m}"] = (rng.integers(0, 100, (q, m)),
                                   rng.integers(0, 100, (n, m)))
    rng = np.random.default_rng(8)
    pair["signed"] = (rng.integers(-1000, 1000, (9, 40)),
                      rng.integers(-1000, 1000, (65, 40)))
    for q, c, m in [(3, 5, 9), (16, 33, 64), (9, 128, 200), (4, 37, 300), (6, 40, 1)]:
        rng = np.random.default_rng(c)
        rows[f"q{q}_c{c}_m{m}"] = (rng.integers(0, 200, (q, m)),
                                   rng.integers(0, 200, (q, c, m)))
    rows["signed"] = (rng.integers(-1000, 1000, (5, 40)),
                      rng.integers(-1000, 1000, (5, 33, 40)))
    # the per-row kernel's paths (csrc/l1_distance.cu, plan_rows): m = 8 is one
    # 16-byte vector an int16 row; C = 1,000 ends in a part tile; 256 and 960
    # give rows of 32, 64, 120 and 240 vectors (not all powers of two); 1,040
    # and 8,200 rows of several 256-vector chunks (the query in shared memory,
    # and at 8,200 int32 past its 32 KB, from global memory); 8,199 the scalar
    # path past 32 KB
    for q, c, m in [(3, 70, 8), (2, 1000, 128), (2, 45, 256), (3, 37, 960), (2, 9, 1040),
                    (2, 3, 8200), (2, 3, 8199)]:
        gen = np.random.default_rng(c + m)
        rows[f"q{q}_c{c}_m{m}"] = (gen.integers(-200, 200, (q, m)),
                                   gen.integers(-200, 200, (q, c, m)))
    rows["c0"] = (rng.integers(0, 9, (3, 8)), np.zeros((3, 0, 8), np.int64))
    pair["n0"] = (rng.integers(0, 9, (3, 8)), np.zeros((0, 8), np.int64))
    return pair, rows


def _typed(cases):
    """Every case in every L1 input type (numpy has no bfloat16: those are
    float32 arrays that the tests cast)."""
    return {f"{name}_{dt}": tuple(a.astype(np.float32 if dt == "bfloat16" else dt)
                                  for a in arrays) + (dt,)
            for name, arrays in cases.items() for dt in L1_DTYPES}


# The pairwise kernel runs a full 32-coordinate stage in its float loop while
# 2 * max|value| * 32 <= 2^24, i.e. max|value| <= 2^18 (csrc/l1_distance.cu).
L1_FLOAT_LIMIT = 1 << 18


def _l1_int_cases():
    """Integer-only pairwise cases that reach every branch of the CUDA
    kernel: the int32 loop, a block that mixes both loops, flushes of the
    float sums, and the edges of its 64 x 128 tile and 32-coordinate stage.
    Float32 sums of values near 2^30 depend on the order of the additions,
    so these cases are not cast to every input type."""
    rng = np.random.default_rng(18)
    top = 1 << 30
    cases = {"wrap_q5_n70_m40": (top - rng.integers(0, 1000, (5, 40)),
                                 rng.integers(0, 1000, (70, 40)) - top)}
    q, x = rng.integers(0, 511, (70, 64)), rng.integers(0, 511, (200, 64))
    x[130, 40] = L1_FLOAT_LIMIT + 1     # point tile 1, stage 1: the int32 loop
    x[5, 10] = L1_FLOAT_LIMIT           # point tile 0, stage 0: float, then a flush
    cases["mixed_q70_n200_m64"] = (q, x)
    # m = 33: the last stage holds one coordinate (s = 1), so values above
    # 2^18 may take the float loop there: 2 * 2^22 * 1 <= 2^24 runs it
    # (exact), 2 * (2^23 + 1) * 1 > 2^24 runs the int32 loop
    q, x = rng.integers(0, 511, (5, 33)), rng.integers(0, 511, (200, 33))
    x[10, 32] = 1 << 22                 # point tile 0, stage 1: the float loop
    x[150, 32] = (1 << 23) + 1          # point tile 1, stage 1: the int32 loop
    cases["partial_stage_q5_n200_m33"] = (q, x)
    full = np.iinfo(np.int32)
    q, x = (rng.integers(full.min, full.max, s, endpoint=True) for s in ((9, 70), (130, 70)))
    q[0, :2], x[0, :2] = (full.min, full.max), (full.max, full.min)
    cases["full_range_q9_n130_m70"] = (q, x)
    for q, n, m in [(63, 129, 31), (65, 127, 33), (65, 129, 65)]:
        cases[f"edge_q{q}_n{n}_m{m}"] = (rng.integers(0, 511, (q, m)),
                                         rng.integers(0, 511, (n, m)))
    out = {f"{name}_int32": (a.astype(np.int32), b.astype(np.int32), "int32")
           for name, (a, b) in cases.items()}
    # int16 at its extremes: |q - x| = 65535, so the float sums flush across
    # the 10 stages of m = 300
    ext = [rng.choice(np.array([-32768, 32767], np.int16), s) for s in ((5, 300), (40, 300))]
    out["extremes_q5_n40_m300_int16"] = (*ext, "int16")
    return out


def _l1_rows_wrap_case():
    """int32 rows near +-2^31 whose |q - x| and sums wrap (INT_MIN and
    INT_MAX among them), at m = 64: the vector path, 16 lanes a row."""
    rng = np.random.default_rng(28)
    top = 1 << 30
    q = top - rng.integers(0, 1000, (3, 64))
    x = rng.integers(0, 1000, (3, 50, 64)) - top
    full = np.iinfo(np.int32)
    q[0, :2], x[0, 0, :2] = (full.min, full.max), (full.max, full.min)
    return {"wrap_q3_c50_m64_int32": (q.astype(np.int32), x.astype(np.int32), "int32")}


L1_INT_CASES = _l1_int_cases()
L1_CASES, L1_ROWS_CASES = (_typed(c) for c in _l1_cases())
L1_CASES.update(L1_INT_CASES)
L1_ROWS_CASES.update(_l1_rows_wrap_case())
