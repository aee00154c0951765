"""The plain reference on its own: brute force where every point is a
candidate, the probing template's order, and hand-counted work."""
import itertools

import torch

import portbench_tiny as tiny  # noqa: F401  (puts the checkout on sys.path)
from portbench.harness import datagen
from portbench.reference import lsh as ref


def _inputs(n=500, dim=8, universe=64, width=16.0, tables=2, hashes=1, seed=3):
    data = {"n": n, "dim": dim, "universe": universe, "num_queries": 40, "num_clusters": 4,
            "cluster_spread": 0.05, "perturb_frac": 0.05, "stray_frac": 0.1}
    ix = {"num_tables": tables, "num_hashes": hashes, "width": width, "universe": universe}
    points = datagen.make_points(data, seed, "cpu")
    queries = datagen.make_queries(data, points, seed)
    params = ref.as_params(width, datagen.make_hash_params(ix, dim, seed, "cpu"))
    return points, queries, params


def _brute(points, queries, k):
    d = (points[None, :, :].long() - queries[:, None, :].long()).abs().sum(-1)
    key = d * (1 << 32) + torch.arange(points.shape[0])[None, :]
    best = torch.sort(key, dim=1).values[:, :k]
    return (best >> 32).to(torch.int32), (best & 0xFFFFFFFF).to(torch.int32)


def test_every_point_a_candidate_gives_the_brute_force_top_k():
    # M = 1 and a width far past any raw hash: buckets are -1 or 0, and the
    # epicenter with the two one-sided probes covers both
    points, queries, params = _inputs(width=1e6, hashes=1)
    tables = ref.build(params, points, num_probes=2)
    d, i = ref.answer(params, tables, points, queries, cap=points.shape[0], k=10)
    want_d, want_i = _brute(points, queries, 10)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)


def test_fewer_candidates_than_k_pad_with_big_dist():
    points, queries, params = _inputs(n=5, width=1e6, hashes=1)
    tables = ref.build(params, points, num_probes=2)
    d, i = ref.answer(params, tables, points, queries, cap=8, k=10)
    assert (i[:, 5:] == -1).all() and (d[:, 5:] == ref.BIG_DIST).all()
    assert (i[:, :5] >= 0).all()


def test_probe_sets_follow_expected_score_and_skip_both_sides_of_a_coordinate():
    m, width, t = 4, 10.0, 30
    sets = ref.probe_sets(m, width, t)
    z = ref.expected_score(m, width)
    assert len(sets) == t == len(set(sets))
    scores = [sum(z[j - 1] for j in s) for s in sets]
    assert scores == sorted(scores)
    valid = [s for r in range(1, 2 * m + 1) for s in itertools.combinations(range(1, 2 * m + 1), r)
             if all(2 * m + 1 - j not in s for j in s)]
    best = sorted(sum(z[j - 1] for j in s) for s in valid)[:t]
    assert scores == best
    tm = ref.template(m, width, t)
    assert tm.shape == (t + 1, 2 * m) and tm[0].sum() == 0


def test_mix_is_the_32_bit_arithmetic():
    params = ref.HashParams(8.0, torch.zeros((2, 1, 1), dtype=torch.int8),
                            torch.zeros((1, 2)), torch.tensor([[3, 2 ** 32 - 1]]),
                            torch.tensor([7]))
    bucket = torch.tensor([[[5, -1]]], dtype=torch.int32)
    key = (7 + 3 * 5 + (2 ** 32 - 1) * (2 ** 32 - 1)) % 2 ** 32
    want = ((key * ref.KEY_MUL) % 2 ** 32) ^ (key >> 15)
    assert ref.mix(params, bucket).tolist() == [[want]]


def _hand_tables():
    keys = torch.tensor([[1, 1, 1, 2, 2, 5]])
    ids = torch.tensor([[0, 2, 4, 1, 3, 5]], dtype=torch.int32)
    return ref.Tables(keys, ids, weights=None, u2=0, tmpl=None)


def test_work_of_probes_hand_counted():
    tables = _hand_tables()
    # query 0 probes buckets 1, 5 and an empty one; query 1 probes 1 and 2, 2 twice
    pk = torch.tensor([[[1, 5, 9]], [[1, 2, 2]]])
    c = ref.work_of_probes(tables, [pk], cap=2)
    # slots: q0 2 + 1 + 0, q1 2 + 2 + 2; pairs: q0 {0, 2, 5}, q1 {0, 2, 1, 3};
    # rows over the batch {0, 1, 2, 3, 5}; buckets 1, 5, 2 give 2 + 1 + 2 ids
    assert c == {"queries": 2, "probes": 6, "slots": 9, "pairs": 7, "rows": 5,
                 "bucket_ids": 5}
    # split over two blocks of queries, the batch counts the same
    assert ref.work_of_probes(tables, [pk[:1], pk[1:]], cap=2) == c


def test_candidates_take_each_buckets_first_ids_once():
    tables = _hand_tables()
    lo, occ = ref.extents(tables, torch.tensor([[[1, 2, 1]]]))
    ids, used = ref.candidates(tables, lo, occ, cap=2)
    assert sorted(i for i in ids[0].tolist() if i >= 0) == [0, 1, 2, 3]
    assert used.tolist() == [6]


def _shard_answers(points, queries, params, shards, cap, k, num_probes=2):
    n = points.shape[0] // shards
    lists = []
    for s in range(shards):
        rows = points[s * n:(s + 1) * n]
        tables = ref.build(params, rows, num_probes)
        lists.append(ref.answer_shard(params, tables, rows, queries, cap, k, s * n))
    return ref.merge(lists, k)


def test_the_per_shard_reference_at_one_shard_is_the_answer():
    points, queries, params = _inputs(n=600, width=24.0, tables=3, hashes=2)
    tables = ref.build(params, points, num_probes=6)
    want = ref.answer(params, tables, points, queries, cap=4, k=10)
    got = _shard_answers(points, queries, params, 1, cap=4, k=10, num_probes=6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_per_shard_reference_with_every_point_a_candidate_is_the_brute_force():
    points, queries, params = _inputs(n=600, width=1e6, hashes=1)
    got = _shard_answers(points, queries, params, 4, cap=600, k=10)
    want = _brute(points, queries, 10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_merge_orders_by_distance_then_id_with_the_pads_last():
    pad = (ref.BIG_DIST, -1)
    a = (torch.tensor([[3, 5, pad[0]]], dtype=torch.int32),
         torch.tensor([[40, 2, pad[1]]], dtype=torch.int32))
    b = (torch.tensor([[3, pad[0], pad[0]]], dtype=torch.int32),
         torch.tensor([[7, pad[1], pad[1]]], dtype=torch.int32))
    d, i = ref.merge([a, b], 3)
    assert d.tolist() == [[3, 3, 5]] and i.tolist() == [[7, 40, 2]]
    d, i = ref.merge([(a[0][:, 1:], a[1][:, 1:]), (b[0][:, 1:], b[1][:, 1:])], 3)
    assert d.tolist() == [[5, pad[0], pad[0]]] and i.tolist() == [[2, -1, -1]]
