"""The control on the card: the reference in TF32 fails the limit that
the f32 reference's repeat meets (skips without a card).  The full
readings, at the cells' sizes, come from ``portbench/control.py``."""
import pytest
import torch

from portbench import bench


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", ["vgg16.offline.b32", "vgg16.server.b4", "resnet50.offline.card.b128"])
def test_tf32_reference_fails_where_f32_passes(card, cell):
    c = bench.Cell.of(bench.load_spec(), cell, *cell.split(".", 1))
    c.mix["pool"] = 8
    ref = bench.reference_probs(c, 2**31 + 21, card, "f32")
    again = bench.reference_probs(c, 2**31 + 21, card, "f32", batch=8)
    control = bench.reference_probs(c, 2**31 + 21, card, "tf32", batch=8)
    limit = c.config["correct"]["limit"]
    assert bench.worst_gap(again, ref) < limit / 10
    assert bench.worst_gap(control, ref) > 3 * limit
