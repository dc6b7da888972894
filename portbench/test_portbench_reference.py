"""The plain references against the program's served outputs on the CPU,
at full size and a micro-batch of 2, with the benchmark's own weights;
the TF32 control (emulated by rounding every product's operands) against
the configuration's limit; and outputs far from one-hot."""
import pytest
import torch

from portbench import bench
from portbench.reference.common import round_tf32
from portbench.weights import make_images, make_weights

SPEC = bench.load_spec()
SEED = 2**31 + 11


@pytest.fixture(scope="module", params=["resnet50", "vgg16"])
def outputs(request):
    from repro_torch.serving.planner import serve

    torch.set_num_threads(4)
    cell = bench.Cell.of(SPEC, f"{request.param}.test", request.param, "server.b4")
    cfg = cell.config
    params = make_weights(cell.reference.layers(), SEED, cfg["weights"], "cpu")
    x = make_images(2, cfg["input"], SEED, "cpu")
    with torch.no_grad():
        ref = cell.reference.forward(params, x)
        control = cell.reference.forward(params, x, cast=round_tf32)
    server = serve(bench._graph(cfg), backend=cfg["route"], batch_size=2, params=params, device="cpu")
    try:
        served = torch.cat([t.result(timeout=300) for t in [server.submit(img) for img in x]])
    finally:
        server.stop()
    return cell, ref, control, served


def test_the_reference_matches_the_served_outputs(outputs):
    cell, ref, _, served = outputs
    assert served.shape == ref.shape == (2, cell.config["classes"])
    assert bench.worst_gap(served, ref) <= cell.config["correct"]["limit"] / 10


def test_the_tf32_control_fails_the_limit(outputs):
    cell, ref, control, _ = outputs
    assert bench.worst_gap(control, ref) > 3 * cell.config["correct"]["limit"]


def test_the_outputs_are_far_from_one_hot(outputs):
    _, ref, _, _ = outputs
    assert float(ref.max()) < 0.5
    assert torch.allclose(ref.sum(1), torch.ones(2), atol=1e-5)
    assert bench.worst_gap(ref.roll(1, 0), ref) > 1e-2  # two images' answers differ


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 1.0 + 2**-12, -3.0])
    assert round_tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]
