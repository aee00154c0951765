"""The port's sharded language models on four gloo CPU ranks, (2, 2) and
(1, 4): granite-moe (its gradients and train step too) and the zamba2
hybrid.

The checks live in ``tests/torch_shard_ranks_cases.py``."""
import pytest

import torch_shard_ranks_cases as cases

ARCHS = ('granite_moe_3b_a800m', 'zamba2_1_2b')
TRAIN_ARCHS = ('granite_moe_3b_a800m',)

sharded = cases.fixture(ARCHS, TRAIN_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_equals_unsharded(sharded, arch):
    cases.check_prefill(sharded, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_equals_unsharded(sharded, arch):
    cases.check_loss(sharded, arch)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "seamless_m4t_medium"])
def test_sharded_decode_step_equals_unsharded(sharded, arch):
    cases.check_decode(sharded, arch)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_gradients_and_train_step(sharded, arch):
    cases.check_train(sharded, arch)
