"""The port's sharded language models on four gloo CPU ranks, (2, 2) and
(1, 4): the archs with a frontend (phi-3-vision, seamless) and gemma-7b.

The checks live in ``tests/torch_shard_ranks_cases.py``."""
import pytest

import torch_shard_ranks_cases as cases

ARCHS = ('phi_3_vision_4_2b', 'gemma_7b', 'seamless_m4t_medium')
sharded = cases.fixture(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_equals_unsharded(sharded, arch):
    cases.check_prefill(sharded, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_equals_unsharded(sharded, arch):
    cases.check_loss(sharded, arch)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "seamless_m4t_medium"])
def test_sharded_decode_step_equals_unsharded(sharded, arch):
    cases.check_decode(sharded, arch)
