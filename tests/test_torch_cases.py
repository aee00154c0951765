"""Adversarial kernel inputs shared by the port's kernel tests (numpy only,
so the card-side tests need no jax).

PROBE_CASES  : name -> (keys (L, n) uint32 sorted, ids (L, n) int32,
                        probe keys (Q, L, P) uint32, cap, cbucket)
RERANK_CASES : name -> (dataset (n, m), queries (Q, m) int32, ids (Q, Ctot) int32, k)
MERGE_CASES  : name -> (da, ia, db, ib), each (Q, k)
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
    return cases


RERANK_CASES = _rerank_cases()


def _merge_cases():
    cases = {}
    for q, k, seed in [(1, 1, 0), (3, 5, 1), (9, 10, 2), (4, 16, 3), (5, 33, 4)]:
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
