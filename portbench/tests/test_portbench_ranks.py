"""A cell on several cards, rehearsed on the CPU: one gloo rank a shard (a
benchmark run passes 'nccl'), the row-sharded index served in lockstep and
judged against the per-shard reference, merged.  Four runs spawn ranks: a
sound one, one with a rank's ids shifted, one with the exchange left out,
one with a rank that raises."""
import functools
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

import portbench_tiny as tiny
from portbench.harness import cell as cell_run
from portbench.harness import check, program, ranks


def test_a_four_rank_cell_matches_the_per_shard_reference_and_leaves_no_rank():
    """The program's four ranks (``dist_query_fn``, 'allgather') give, on
    every drawn query, the per-shard reference merged: the contract the
    reference holds them to, confirmed at a tiny size."""
    lines = []
    res = tiny.run_sharded(lines=lines)
    assert res["correct"] is True
    assert res["checks"] == {"mismatched_queries": {"value": 0, "limit": 0}}
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"]["count"] == 4
    assert set(res["metrics"]) == {"qps", "p95_ms", "setup_s"}       # no peak on the CPU
    assert lines[-1] == "check mismatched_queries: 0 (limit 0)"
    assert any(line.startswith("ranks: 4 under gloo") for line in lines)
    assert mp.active_children() == []


@pytest.mark.parametrize("fault", [functools.partial(tiny.shift_ids, broken=1),
                                   tiny.leave_out_exchange],
                         ids=["one_ranks_ids_shifted", "exchange_left_out"])
def test_a_fault_under_the_timed_path_reads_incorrect(fault):
    res = tiny.run_sharded(fault=fault)
    assert res["correct"] is False
    assert res["checks"]["mismatched_queries"]["value"] > 0


def test_a_rank_that_raises_fails_the_run_within_its_limit():
    t = time.monotonic()
    with pytest.raises(ranks.RankFailure) as err:
        tiny.run_sharded(fault=functools.partial(tiny.raise_on_second_request, broken=2),
                         limit_s=120.0)
    assert time.monotonic() - t < 120.0
    assert "rank 2 of 4 failed" in str(err.value)
    assert "the card went away" in str(err.value)
    assert mp.active_children() == []


class _Req:
    def __init__(self, d, i):
        self.dists, self.ids, self.error = d, i, None


def test_ranks_that_disagree_count_as_mismatched():
    rng = np.random.default_rng(3)
    d = np.sort(rng.integers(0, 100, (6, 10)), axis=1).astype(np.int32)
    i = rng.integers(0, 1000, (6, 10)).astype(np.int32)
    drawn = [_Req(d, i)]
    same = [[(d.copy(), i.copy())]]
    assert check.judge(drawn, lambda r: (d, i), peers=same * 3)["mismatched_queries"][
        "value"] == 0
    other = i.copy()
    other[[1, 4], 9] += 1                   # rank 2 answers two queries otherwise
    got = check.judge(drawn, lambda r: (d, i),
                      peers=[same[0], [(d, other)], same[0]])
    assert got["mismatched_queries"]["value"] == 2
    # a query wrong against the reference and disagreed on counts once
    wrong = i.copy()
    wrong[1, 0] += 1
    got = check.judge([_Req(d, wrong)], lambda r: (d, i), peers=[[(d, other)]])
    assert got["mismatched_queries"]["value"] == 2


class _Host:
    """``ranks.Ranks`` with no peers: a broadcast is rank 0's value."""

    def __init__(self, rank):
        self.rank, self.lead = rank, rank == 0
        self.sent = []

    def broadcast(self, value):
        self.sent.append(value)
        return 7 if value is None else value


def test_lockstep_phases_are_rank_zeros_request_counts():
    lead, other = _Host(0), _Host(1)
    now = time.perf_counter()
    deadline, count = cell_run.Lockstep(lead, 0.010).until(now + 0.5)
    assert deadline == 0.0 and 48 <= count <= 50
    assert cell_run.Lockstep(other, 0.010).until(now + 0.5) == (0.0, 7)
    assert other.sent == [None]                  # only rank 0's count is sent
    assert cell_run.Lockstep(lead, 1.0).until(now) == (0.0, 1)      # never an empty phase
    assert cell_run.Clock().until(now + 3.0) == (now + 3.0, 1)


def test_the_shard_rows_give_only_the_shards_own_slice():
    rows = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    shard = program._ShardRows(rows, 12, 6)
    assert shard.shape == (12, 4)
    assert shard[slice(6, 9)] is rows
    with pytest.raises(IndexError):
        shard[slice(0, 3)]


def test_a_configuration_declares_its_row_shards():
    assert program.row_shards(tiny.CONFIG) == 1
    assert program.row_shards(tiny.sharded_cell(4).config) == 4
