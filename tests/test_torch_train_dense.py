"""Training of the reduced dense configs (SmolLM-360M, StarCoder2-15B,
Command R+) against the JAX package: the loss, every gradient, the AdamW
step and the step accumulated over two micro-batches in f32 on the
reference's weights, and bf16 gradients as close to the f32 ones as the
reference's (tests/train_parity.py states each tolerance); and the
contract of ``tests/test_archs_smoke.py::test_train_step_decreases_loss``
on the port's own weights."""
from __future__ import annotations

import pytest
import torch

from train_parity import assert_bf16_grads_as_close, assert_train_parity
from train_smoke import assert_train_step_decreases_loss

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

ARCHS = ["smollm-360m", "starcoder2-15b", "command-r-plus-104b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_parity_f32(arch, monkeypatch, capsys):
    assert_train_parity(arch, monkeypatch, capsys)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_grads_as_close_to_f32_as_the_reference(arch):
    assert_bf16_grads_as_close(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_decreases_loss(arch):
    assert_train_step_decreases_loss(arch)
