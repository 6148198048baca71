"""The BatchNorm cases of tests/test_torch_port_train.py (Full-GC with its
GCN BatchNorm in train mode, ``use_bn`` 1 and 2 with the masked statistics
over each row's real nodes): train_forward's logprobs, loss and new
BatchNorm state, and every gradient, held against the JAX package at the
tolerances stated there."""
import pytest

from .test_torch_port_train import (BN_CASES, check_case,  # noqa: F401
                                     one_thread)


@pytest.mark.parametrize("case", BN_CASES)
def test_train_forward_and_gradients_match_jax_bn(case):
    check_case(case)
