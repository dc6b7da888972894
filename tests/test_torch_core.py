"""The port's package boundary and planning core against the JAX package.

The planning core of ``repro_torch`` is a copy of ``repro.core`` (pure
Python), so everything it computes from the same graph must be EQUAL, not
close: descriptors, the predicted time matrix, the autotuner's cache keys
and the DSE's plans, for all six nets and all three DSE modes.
"""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.cnn.models import MODELS as REF_MODELS
from repro.core.calibration import synthetic_model as ref_synthetic_model
from repro.core.dse import pipe_it_search as ref_search
from repro.core.perfmodel import LayerTimePredictor as RefPredictor
from repro.core.platform import hikey970 as ref_hikey970
from repro.kernels.autotune import descriptor_key as ref_descriptor_key
from repro_torch.cnn.models import MODELS
from repro_torch.core.calibration import _time_gemm, synthetic_model
from repro_torch.core.dse import pipe_it_search
from repro_torch.core.perfmodel import LayerTimePredictor
from repro_torch.core.platform import hikey970
from repro_torch.kernels.autotune import descriptor_key
from repro_torch.kernels.config import resolve_device

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
NETS = sorted(MODELS)


# ------------------------------------------------------ (a) package boundary
def test_port_import_leaves_jax_out():
    code = (
        "import sys, repro_torch, repro_torch.serving, repro_torch.cnn, "
        "repro_torch.kernels.backend, repro_torch.core\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == "", f"port imported: {out.stdout.strip()}"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = [
        (str(f.relative_to(REPO)), mod)
        for f in files
        for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert bad == []


def test_resolve_device_defaults_to_the_card():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)


# ------------------------------------------------- (b) planning core parity
@pytest.mark.parametrize("net", NETS)
def test_descriptors_and_keys_equal_reference(net):
    ours = MODELS[net]().descriptors()
    ref = REF_MODELS[net]().descriptors()
    assert [d.__dict__ for d in ours] == [d.__dict__ for d in ref]
    assert [descriptor_key(d) for d in ours] == [ref_descriptor_key(d) for d in ref]
    assert [descriptor_key(d, op="x") for d in ours] == [
        ref_descriptor_key(d, op="x") for d in ref
    ]


@pytest.mark.parametrize("net", NETS)
def test_time_matrix_and_plans_equal_reference(net):
    T = LayerTimePredictor(model=synthetic_model(), platform=hikey970()).time_matrix(
        MODELS[net]().descriptors()
    )
    T_ref = RefPredictor(
        model=ref_synthetic_model(), platform=ref_hikey970()
    ).time_matrix(REF_MODELS[net]().descriptors())
    assert T == T_ref
    for mode in ("merge", "sweep", "best"):
        plan = pipe_it_search(len(T), hikey970(), T, mode=mode)
        ref = ref_search(len(T_ref), ref_hikey970(), T_ref, mode=mode)
        assert plan.notation() == ref.notation(), mode
        assert plan.allocation == ref.allocation, mode
        assert plan.throughput(T) == ref.throughput(T_ref), mode


def test_measured_times_override_by_descriptor_key():
    """perfmodel looks measured times up through the port's descriptor_key."""
    descs = MODELS["vgg16"]().descriptors()
    measured = {descriptor_key(descs[0]): 1.234}
    T = LayerTimePredictor(
        model=synthetic_model(), platform=hikey970(), measured=measured
    ).time_matrix(descs)
    T_ref = RefPredictor(
        model=ref_synthetic_model(), platform=ref_hikey970(), measured=measured
    ).time_matrix(REF_MODELS["vgg16"]().descriptors())
    assert T == T_ref
    assert T != LayerTimePredictor(
        model=synthetic_model(), platform=hikey970()
    ).time_matrix(descs)


def test_vgg16_plan_is_two_stages():
    """The slice's main path: VGG-16 on hikey970 with synthetic times."""
    descs = MODELS["vgg16"]().descriptors()
    T = LayerTimePredictor(model=synthetic_model(), platform=hikey970()).time_matrix(descs)
    plan = pipe_it_search(len(descs), hikey970(), T, mode="best")
    assert plan.pipeline.stages == (("B", 4), ("s", 4))
    assert [list(a) for a in plan.allocation] == [list(range(9)), list(range(9, 16))]


def test_time_gemm_on_cpu_is_positive_seconds():
    t = _time_gemm(16, 32, 8, repeats=2, device="cpu")
    assert isinstance(t, float) and 0.0 < t < 1.0
    assert np.isfinite(t)
