"""One torch intra-op thread in every process that runs the port's tests:
tests/torch_common.py sets it, and each tests/test_torch_*.py imports that
module, so a file runs alike alone and in the whole suite."""

import torch

import torch_common  # noqa: F401


def test_one_intra_op_thread():
    assert torch.get_num_threads() == 1
