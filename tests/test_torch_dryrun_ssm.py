"""The dry-run's mamba2 train and prefill cells (reduced) on the (16, 16)
world: the chunked scan runs a Python step a chunk, so these cells trace
longest."""
import pytest

import torch_dryrun_cases as cases


@pytest.mark.parametrize("arch,shape", [("mamba2_370m", "train_4k"),
                                        ("mamba2_370m", "prefill_32k")])
def test_reduced_ssm_cell_traces(arch, shape):
    cases.check_reduced_cell(arch, shape)
