"""Training of the reduced recurrent configs against the JAX package:
Hymba-1.5B (attention heads and Mamba heads in parallel, the SSD through
B6's plain version, meta tokens dropped before the loss) and xLSTM-1.3B
(an mLSTM layer through the SSD with the normalizer, an sLSTM layer's
loop).  The loss, every gradient, the AdamW step and the step
accumulated over two micro-batches in f32 on the reference's weights,
and bf16 gradients as close to the f32 ones as the reference's
(tests/train_parity.py states each tolerance); and the contract of
``tests/test_archs_smoke.py::test_train_step_decreases_loss`` on the
port's own weights.

A random-weight xLSTM is chaotic in f32 (its served logits lie up to
4.4e-4 from the reference's own float64 run; tests/test_torch_xlstm.py).
Its gradients' bar is set from the reference's own spread: the
reference's f32 gradients against its float64 ones on the same weights
and batch (2.6e-4 of a leaf's scale at its worst leaf here), times
``XLSTM_SLACK``.  The port lies 1.6e-4 from the reference's f32 run.

In bf16 the two recurrent models' gradients, on these weights (seed 0),
come out further from the reference's f32 ones than the reference's own
bf16 gradients: RMS 1.70 times the reference's for Hymba and 1.42 times
for xLSTM.  The ratio follows the weights, not the package: over the
reference's init seeds 0-4 (each with its batch) it spans 0.41-1.70 for
Hymba and 0.78-1.43 for xLSTM, about 1 at the median, and seed 0 is the
highest of the five for both; the attention models lie at 0.95-1.20.
With the same weights laid out as one group of two layers or two groups
of one, the port's bf16 gradients are closer than the reference's
(0.0083 against 0.0092).  So these two are held to
``RECURRENT_BF16_SLACK`` = 2 on seed 0, a bar a change that widens the
gap would cross."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from train_parity import (assert_bf16_grads_as_close, assert_train_parity, cfgs, grad_errors,
                          make_batch, ref_loss_and_grads, ref_weights)
from train_smoke import assert_train_step_decreases_loss

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

ARCHS = ["hymba-1.5b", "xlstm-1.3b"]
XLSTM_SLACK = 2.0
RECURRENT_BF16_SLACK = 2.0


def test_train_parity_f32_hymba(monkeypatch, capsys):
    assert_train_parity("hymba-1.5b", monkeypatch, capsys)


def test_train_parity_f32_xlstm_within_the_references_own_spread(monkeypatch, capsys):
    arch = "xlstm-1.3b"
    rcfg, cfg = cfgs(arch)
    ref_params = ref_weights(arch)
    batch = make_batch(cfg)
    _, _, g32 = ref_loss_and_grads(rcfg, ref_params, batch)
    with jax.enable_x64(True):
        wide = dataclasses.replace(rcfg, compute_dtype="float64", param_dtype="float64")
        _, _, g64 = ref_loss_and_grads(wide, jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), ref_params),
                                       batch)
    spread = max(grad_errors(g64, g32).values())
    assert 0 < spread < 1e-3, spread
    with capsys.disabled():
        print(f"\n{arch}: the reference's f32 gradients lie {spread:.2e} of a leaf's scale from its float64 ones")
    assert_train_parity(arch, monkeypatch, capsys, grad_tol=XLSTM_SLACK * spread)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_grads_within_twice_the_references_distance_from_f32(arch):
    assert_bf16_grads_as_close(arch, slack=RECURRENT_BF16_SLACK)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_decreases_loss(arch):
    assert_train_step_decreases_loss(arch)
