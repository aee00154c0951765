"""The bound arithmetic of the roofline metrics, by hand."""
import pytest

import portbench_tiny as tiny  # noqa: F401
from portbench.harness import workcount

COUNTS = {"queries": 2, "probes": 6, "slots": 9, "pairs": 7, "rows": 5, "bucket_ids": 5}


def test_rerank_work_counts_each_input_once():
    nbytes, ops = workcount.rerank_work(COUNTS, dim=4, value_bytes=4, k=3)
    # ids 9*4, rows 5*4*4, queries 2*4*4, answers 2*3*8
    assert nbytes == 36 + 80 + 32 + 48
    assert ops == 3 * 4 * 7


def test_gather_work_counts_extents_ids_and_counts():
    nbytes, ops = workcount.gather_work(COUNTS)
    assert nbytes == 6 * 8 + 5 * 4 + 9 * 4 + 2 * 4 and ops == 0


def test_least_time_is_the_larger_bound_summed_over_launches():
    pk = {"hbm_bytes_per_s": 100.0, "int32_ops_per_s": 10.0}
    assert workcount.least_s(1000, 50, pk) == pytest.approx(10.0)
    assert workcount.least_s(100, 50, pk) == pytest.approx(5.0)
    assert workcount.bound_s([(1000, 50), (100, 50)], pk) == pytest.approx(15.0)


def test_peaks_are_the_h100_data_sheet():
    pk = workcount.peaks()
    assert pk["hbm_bytes_per_s"] == 3.35e12
    # 64 INT32 units an SM (the Hopper whitepaper), not the 128 FP32 lanes
    assert pk["int32_ops_per_s"] == pytest.approx(132 * 64 * 1.98e9, rel=1e-4)
