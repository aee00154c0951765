"""The dry-run's zamba2 prefill cell (reduced) on the (16, 16) world: 4,096
chunks of the scan a layer, the longest cell to trace, in a file of its
own."""
import torch_dryrun_cases as cases


def test_reduced_hybrid_prefill_cell_traces():
    cases.check_reduced_cell("zamba2_1_2b", "prefill_32k")
