"""The port's CUDA kernels and served paths on a card.

Imports only ``repro_torch`` (no JAX), so it runs on a CUDA host that has
no JAX:  ``PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py``.
Every test skips on a host without CUDA (decided inside the test).

Tolerance: kernel vs its plain PyTorch version on the same inputs,
``RTOL, ATOL = 1e-4, 1e-5`` (the reference's bar, tests/
test_conv_fused.py); both are IEEE f32 (TF32 off) summed in different
orders at small K.  Batch invariance is bitwise: the kernels sum every
output in a fixed order whatever the batch.  The patch matrix (a copy)
and the quantized conv (an exact int32 sum, then the same two f32
roundings as its plain version) are held bitwise.  Decode attention (B5)
and the SSD scan (B6) are held at the reference's ``2e-4`` in f32
(tests/test_kernels.py, tests/test_kernels_ssd.py); with bf16 operands B5
within one bf16 ulp of its plain version computed in f32 (the ulp taken
no finer than at 2^-8 of the largest output), B6 at the reference's bf16
bar ``5e-2``.  CUDA graphs (``kernels/graphs.py``) replay the kernels and
library calls their eager call makes, in the same order, so captured
stage functions, served outputs across hot swaps and recoveries, and
decode steps are held bitwise to their eager runs, as is B5 with its
length read on the device to B5 with an int.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.cnn import quant as Q
from repro_torch.cnn.graph import Graph
import dataclasses

from repro_torch.configs import get_config
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import conv_fused as K
from repro_torch.kernels import gemm as G
from repro_torch.kernels import im2col as I
from repro_torch.core.pipeline import Pipeline, PipelinePlan
from repro_torch.kernels import runtime
from repro_torch.launch.serve import generate
from repro_torch.models import init_params
from repro_torch.models.blocks import _quantize_kv
from repro_torch.serving import (
    AdmissionError,
    AutoPlanner,
    FaultEvent,
    FaultPlan,
    FleetRouter,
    ModelRegistry,
    MultiModelServer,
    PipelineServer,
    RecoveryPolicy,
    SingleStageEngine,
    build_eager_stage_fns,
    build_stage_fns,
    fault_injecting_builder,
    poisson_trace,
    run_open_loop,
    serve,
)

RTOL, ATOL = 1e-4, 1e-5

# (B, H, W, C, F, Cout, stride, pad, relu)
CONV_CASES = [
    (1, 8, 8, 3, 3, 5, 1, 1, True),  # C=3 (K=27)
    (2, 9, 7, 4, 3, 6, 2, 0, False),  # stride 2, odd Ow
    (1, 13, 13, 5, 5, 7, 4, 2, True),  # stride 4, pad 2
    (1, 6, 6, 8, 1, 4, 1, 0, False),  # 1x1
    (2, 14, 14, 64, 3, 70, 1, 1, True),  # Ow=14 (ragged M tile), Cout not a multiple of 64
    (1, 23, 23, 3, 11, 96, 4, 0, True),  # AlexNet conv1 geometry
    (2, 9, 9, 32, 3, 40, 2, 1, True),  # C % 32 == 0 (one tap a k-step) at stride 2
    (2, 8, 8, 48, 3, 20, 1, 1, False),  # C = 48: one tap a k-step of 16, not of 32
    (3, 7, 7, 256, 1, 36, 2, 0, True),  # strided 1x1 projection
    # csrc/gemm.cu's tensor-core order (K % 16 == 0, K >= 64) at VGG-16's and ResNet-50's widths
    (3, 11, 11, 64, 3, 128, 1, 1, True),  # C = 64 (conv1_2, conv2_1), M = 363 ragged
    (3, 7, 7, 512, 1, 256, 1, 0, True),  # C = 512 (ResNet-50's 1x1 reduce), M = 147 ragged
    (2, 14, 14, 256, 1, 512, 2, 0, False),  # ResNet-50's strided 1x1 projection at C = 256
    (2, 15, 15, 128, 3, 128, 2, 1, True),  # ResNet-50's strided 3x3 at C = 128
    (2, 10, 10, 48, 3, 64, 1, 1, True),  # C = 48: the generic loader's 16-byte copies, K % 32 == 16
    (1, 12, 12, 3, 8, 16, 2, 1, True),  # C = 3, K = 192: the generic loader's 4-byte copies
]
# (M, K, N, relu)
MM_CASES = [(4, 40, 24, True), (3, 17, 10, False), (9, 300, 130, True), (4, 4096, 1000, False),
            (32, 25088, 4096, True)]  # VGG-16's fc1 at the benchmark's micro-batch 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_conv_kernel_matches_plain(cuda, case):
    b, h, w, c, f, cout, stride, pad, relu = case
    rng = np.random.default_rng(sum(case))
    x, wt, bias = _on(cuda, rng, b, h, w, c), _on(cuda, rng, f, f, c, cout, scale=0.3), _on(cuda, rng, cout)
    before = K.launch_counts()["conv2d_fused"]
    y = K.conv2d_fused(x, wt, bias, stride=stride, pad=pad, relu=relu)
    torch.cuda.synchronize()
    assert K.launch_counts()["conv2d_fused"] == before + 1
    ref = K.fused_route_ref(x, wt, bias, stride=stride, pad=pad, relu=relu)
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=RTOL, atol=ATOL)
    # bitwise the same rows whatever the batch they ride in
    y0 = K.conv2d_fused(x[:1].contiguous(), wt, bias, stride=stride, pad=pad, relu=relu)
    assert torch.equal(y0, y[:1])


@pytest.mark.parametrize("case", MM_CASES, ids=lambda c: "x".join(map(str, c)))
def test_matmul_kernel_matches_plain(cuda, case):
    m, k, n, relu = case
    rng = np.random.default_rng(m * k + n)
    a, w, bias = _on(cuda, rng, m, k), _on(cuda, rng, k, n, scale=k ** -0.5), _on(cuda, rng, n)
    y = K.matmul_fused(a, w, bias, relu=relu)
    ref = K.matmul_fused_ref(a, w, bias, relu=relu)
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(K.matmul_fused(a[:1].contiguous(), w, bias, relu=relu)[0], y[0])


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_conv_kernel_bits_equal_every_tile_variant_and_the_unfused_route(cuda, case):
    """The conv sums in the unfused GEMM's order: every tile variant, and
    the patch matrix through ``gemm`` followed by ``+ b`` and ReLU, give
    the same bits."""
    b, h, w, c, f, cout, stride, pad, relu = case
    rng = np.random.default_rng(sum(case) + 1)
    x, wt, bias = _on(cuda, rng, b, h, w, c), _on(cuda, rng, f, f, c, cout, scale=0.3), _on(cuda, rng, cout)
    y = K.conv2d_fused(x, wt, bias, stride=stride, pad=pad, relu=relu)
    before = K.launch_counts()
    for variant in range(G.tile_variants()):
        assert torch.equal(K.conv2d_fused_tiled(x, wt, bias, variant, stride=stride, pad=pad, relu=relu), y)
    assert K.launch_counts() == before  # forced variants count no launch
    unfused = ops.gemm(ops.im2col_batched(x, f, f, stride, pad), wt.reshape(f * f * c, cout))
    unfused = unfused.reshape(y.shape) + bias
    assert torch.equal(torch.relu(unfused) if relu else unfused, y)


@pytest.mark.parametrize("kn", [(300, 130), (4096, 1000), (9216, 4096)], ids=lambda c: "x".join(map(str, c)))
def test_matmul_kernel_rows_bitwise_at_every_batch_and_equal_gemm_plus_bias(cuda, kn):
    """M = 1, 4, 8 (split K) and 16 (tiled) give a row the same bits, and
    those of ``gemm`` followed by ``+ bias`` and ReLU."""
    k, n = kn
    rng = np.random.default_rng(k + n)
    a, w, bias = _on(cuda, rng, 16, k), _on(cuda, rng, k, n, scale=k ** -0.5), _on(cuda, rng, n)
    y = K.matmul_fused(a, w, bias, relu=True)
    for m in (1, 4, 8):
        assert torch.equal(K.matmul_fused(a[:m].contiguous(), w, bias, relu=True), y[:m])
    for m in (4, 16):
        assert torch.equal(torch.relu(ops.gemm(a[:m].contiguous(), w) + bias), y[:m])
    assert torch.equal(K.matmul_fused(a[:4].contiguous(), w, bias), ops.gemm(a[:4].contiguous(), w) + bias)


def test_the_kernels_split_gives_the_plain_versions_bits(cuda):
    """csrc/gemm.cu's ``split_tf32`` on the device gives the bits of
    ``gemm.split_tf32_ref``, over values of every exponent from 2^-100 to
    2^100 and on the rounding ties (the low 13 bits 0x1000), which go away
    from zero."""
    rng = np.random.default_rng(34)
    v = (rng.standard_normal(1 << 16) * 2.0 ** rng.integers(-100, 100, 1 << 16)).astype(np.float32)
    kept = rng.integers(0, 1 << 10, 4096).astype(np.uint32) << 13  # TF32's 10 stored significand bits
    ties = kept | 0x1000 | (rng.integers(1, 250, 4096).astype(np.uint32) << 23)
    x = torch.from_numpy(np.concatenate([v, ties.view(np.float32), -ties.view(np.float32)]))
    hi, lo = G.split_tf32(x.to(cuda))
    want_hi, want_lo = G.split_tf32_ref(x)
    assert torch.equal(hi.cpu().view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo.cpu().view(torch.int32), want_lo.view(torch.int32))


def test_tensor_core_order_takes_twelve_of_vgg16s_thirteen_convs(cuda):
    """``gemm.order`` 1 (K % 16 == 0, K >= 64) takes every VGG-16 conv but
    conv1_1 (K = 27) and all three fcs: a forward counts 13 conv launches,
    12 of them under ``conv2d_fused_tc``, and 3 fc launches, all under
    ``matmul_fused_tc``; conv1_1 alone counts under ``conv2d_fused`` only."""
    from repro_torch.cnn.models import MODELS
    from repro_torch.kernels.backend import resolve_backend

    g = MODELS["vgg16"]()
    params = g.init(0, device=cuda)
    x = torch.randn(2, 224, 224, 3, device=cuda)
    keys = ("conv2d_fused", "conv2d_fused_tc", "matmul_fused", "matmul_fused_tc")
    before = K.launch_counts(tensor_cores=True)
    with torch.no_grad():
        y = g.apply(params, x, backend=resolve_backend("cuda_fused"))
    torch.cuda.synchronize()
    after = K.launch_counts(tensor_cores=True)
    assert y.shape == (2, 1000)
    assert {k: after[k] - before[k] for k in keys} == dict(zip(keys, (13, 12, 3, 3)))
    assert set(K.launch_counts()) == set(runtime.KERNEL_NAMES)  # the default keys stay as they were
    conv1_1 = next(nd for nd in g.nodes if nd.kind == "conv")
    p = params[conv1_1.name]
    K.conv2d_fused(x, p["w"], p["b"], stride=1, pad=1, relu=True)
    last = K.launch_counts(tensor_cores=True)
    assert (last["conv2d_fused"] - after["conv2d_fused"], last["conv2d_fused_tc"] - after["conv2d_fused_tc"]) == (1, 0)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 4, 2, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        K.conv2d_fused(x, torch.zeros(3, 3, 2, 2, device=cuda), None, pad=1)
    with pytest.raises(ValueError):
        K.conv2d_fused(x.float(), torch.zeros(3, 3, 3, 2, device=cuda), None, pad=1)
    with pytest.raises(ValueError):
        K.conv2d_fused(x.float(), torch.zeros(3, 3, 2, 2), None, pad=1)  # weights on the CPU
    with pytest.raises(ValueError):
        K.matmul_fused(torch.zeros(2, 3, device=cuda), torch.zeros(4, 5, device=cuda),
                       torch.zeros(5, device=cuda))


def test_build_is_cached_by_content(cuda):
    first = build.build_all()
    assert build.build_all() == first
    assert all("-" in p.rsplit("/", 1)[-1] for p in first)


def _tiny():
    g = Graph("tiny", (16, 16, 3))
    a = g.conv("c1", "input", 8, 3)
    a = g.conv("c2", a, 8, 3, stride=2)
    a = g.pool_max("p1", a, 2, 2)
    a = g.conv("c3", a, 16, 3)
    a = g.fc("fc1", a, 24, act="relu")
    a = g.fc("fc2", a, 10)
    g.softmax("sm", a)
    return g


def test_served_outputs_bitwise_equal_single_stage(cuda):
    g = _tiny()
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(10)]
    K.reset_launches()
    server = serve(g, backend="cuda_fused", batch_size=4, warmup=False, seed=1)
    try:
        outs = [o.cpu() for o in server.run(images)["outputs"]]
        batches = server.metrics.stages[0].snapshot()["batches"]
    finally:
        server.stop()
    counts = K.launch_counts()
    assert counts == {"conv2d_fused": 3 * batches, "matmul_fused": 2 * batches,
                      "qconv2d_fused": 0, "gemm": 0, "im2col": 0, "flash_decode": 0, "ssd": 0}
    single = SingleStageEngine(g, server.params, backend="cuda_fused").run(images)["outputs"]
    for a, b in zip(outs, single):
        assert torch.equal(a, b.cpu())
    plain = SingleStageEngine(g, server.params, backend="torch").run(images)["outputs"]
    for a, b in zip(outs, plain):
        np.testing.assert_allclose(a.numpy(), b.cpu().numpy(), rtol=RTOL, atol=ATOL)


# ------------------------------------------------- the unfused route (B3, B4)
# (M, K, N): skinny (M <= 8, split K) and tiled, ragged everywhere; the
# tiled path picks each of its tile variants at one of these: 32 x 64
# (conv5's 784 rows and the small cases), 64 x 64 (K = 27 as conv1_1, and
# conv4), 128 x 64 (N = 64, M not a tile multiple), 64 x 128 (conv2, conv3)
GEMM_CASES = [(1, 27, 64), (4, 300, 130), (8, 4096, 1000), (9, 40, 24), (130, 576, 70), (784, 4608, 512),
              (200704, 27, 64), (3136, 4608, 512), (67650, 576, 64), (50176, 576, 128), (12544, 1152, 256)]


@pytest.mark.parametrize("case", GEMM_CASES, ids=lambda c: "x".join(map(str, c)))
def test_gemm_kernel_matches_plain(cuda, case):
    m, k, n = case
    rng = np.random.default_rng(m * k + n)
    a, b = _on(cuda, rng, m, k), _on(cuda, rng, k, n, scale=k ** -0.5)
    before = K.launch_counts()["gemm"]
    y = ops.gemm(a, b)
    torch.cuda.synchronize()
    assert K.launch_counts()["gemm"] == before + 1
    ref = G.gemm_ref(a, b)
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=RTOL, atol=ATOL)
    # each row's sum order is fixed by (K, N): the same bits alone, in a
    # skinny batch, in a tiled one and through every tile variant
    assert torch.equal(ops.gemm(a[:1].contiguous(), b)[0], y[0])
    assert torch.equal(ops.gemm(a[:4].contiguous(), b), y[:4])
    tall = torch.cat([a, a.new_zeros(20, k)])
    assert torch.equal(ops.gemm(tall, b)[:m], y)
    for variant in range(G.tile_variants()):
        assert torch.equal(G.gemm_tiled(a, b, variant), y)


# (B, H, W, C, stride, pad): C = 3, 5, 70 take the staged path, C = 8, 64
# the 16-byte one; at batch 4 and these sizes spans cross image boundaries
@pytest.mark.parametrize("case", [(1, 9, 8, 3, 1, 0), (2, 9, 8, 3, 1, 1), (2, 13, 13, 3, 2, 2),
                                  (1, 23, 23, 3, 4, 0), (2, 7, 7, 70, 1, 1), (1, 6, 7, 5, 2, 0),
                                  (4, 6, 7, 8, 1, 1), (4, 9, 9, 5, 2, 2), (3, 11, 10, 64, 1, 1),
                                  (4, 15, 15, 3, 4, 2)],
                         ids=lambda c: "x".join(map(str, c)))
def test_im2col_kernel_matches_plain_bitwise(cuda, case):
    b, h, w, c, stride, pad = case
    rng = np.random.default_rng(sum(case))
    x = _on(cuda, rng, b, h, w, c)
    assert I.wide_path(x) == (c % 4 == 0)
    for f in (1, 3, 5):
        if (h - f + 2 * pad) // stride + 1 < 1:
            continue
        before = K.launch_counts()["im2col"]
        cols = ops.im2col_batched(x, f, f, stride, pad)
        assert K.launch_counts()["im2col"] == before + 1
        assert torch.equal(cols, I.im2col_ref(x, f, f, stride, pad))
        assert torch.equal(ops.im2col(x[0], f, f, stride, pad), I.im2col_ref(x[:1], f, f, stride, pad))
        assert torch.equal(I.im2col_library(x, f, f, stride, pad), cols)


# (C, F, stride, pad, pitch, channel offset): AlexNet's grouped convs read
# channel slices (48 of 96, 192 of 384); 16-byte aligned offsets take the
# 16-byte path, the others the staged one
@pytest.mark.parametrize("case", [(48, 5, 1, 2, 96, 0), (48, 5, 1, 2, 96, 48), (192, 3, 1, 1, 384, 192),
                                  (8, 3, 2, 1, 16, 4), (8, 3, 1, 1, 13, 2), (48, 3, 1, 1, 96, 47)],
                         ids=lambda c: "x".join(map(str, c)))
def test_im2col_reads_a_channel_slice_in_place(cuda, case):
    c, f, stride, pad, pitch, at = case
    rng = np.random.default_rng(pitch + at)
    full = _on(cuda, rng, 4, 13, 12, pitch)
    view = full[..., at:at + c]
    assert not view.is_contiguous()
    assert I.wide_path(view) == (c % 4 == 0 and at % 4 == 0 and pitch % 4 == 0)
    before = K.launch_counts()["im2col"]
    cols = I.im2col(view, f, f, stride, pad)
    assert K.launch_counts()["im2col"] == before + 1
    want = I.im2col(view.contiguous(), f, f, stride, pad)
    assert torch.equal(cols, want)
    assert torch.equal(cols, I.im2col_ref(view, f, f, stride, pad))


@pytest.mark.parametrize("c", [3, 64], ids=lambda c: f"conv1_{1 if c == 3 else 2}")
def test_im2col_at_vgg16_first_convs_full_shape(cuda, c):
    """VGG-16's conv1_1 (staged path) and conv1_2 (16-byte path, a
    462 MB patch matrix) at batch 4."""
    x = _on(cuda, np.random.default_rng(c), 4, 224, 224, c)
    cols = I.im2col(x, 3, 3, 1, 1)
    assert tuple(cols.shape) == (4 * 224 * 224, 9 * c)
    assert torch.equal(cols, I.im2col_ref(x, 3, 3, 1, 1))
    del cols
    assert torch.equal(I.im2col_library(x, 3, 3, 1, 1), I.im2col_ref(x, 3, 3, 1, 1))


def test_im2col_refuses_what_it_does_not_take(cuda):
    nchw = torch.zeros(1, 3, 6, 6, device=cuda).permute(0, 2, 3, 1)  # channel stride 36
    with pytest.raises(ValueError):
        I.im2col(nchw, 3, 3, 1, 1)
    with pytest.raises(TypeError):
        I.im2col(torch.zeros(1, 4, 4, 8, device=cuda, dtype=torch.float16), 3, 3)
    with pytest.raises(ValueError):  # no output pixel
        I.im2col(torch.zeros(1, 2, 2, 8, device=cuda), 3, 3)


def test_cuda_route_takes_every_conv_input_of_the_six_nets_as_it_lies(cuda):
    """No conv input of the six nets on the ``cuda`` route (channel slices,
    pool and depthwise outputs) has a layout the patch-matrix kernel
    refuses: every group of every conv launches it once."""
    from repro_torch.cnn.models import MODELS
    from repro_torch.kernels.backend import resolve_backend

    kb = resolve_backend("cuda")
    for net, make in sorted(MODELS.items()):
        g = make()
        params = g.init(seed=0, device=cuda)
        x = _on(cuda, np.random.default_rng(0), 2, *g.infer_shapes()["input"])
        want = sum(n.attrs.get("groups", 1) for n in g.nodes if n.kind == "conv")
        K.reset_launches()
        with torch.no_grad():
            y = g.apply(params, x, backend=kb)
        torch.cuda.synchronize()
        assert K.launch_counts()["im2col"] == want, net
        assert bool(torch.isfinite(y).all()), net


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_qconv_kernel_matches_plain_bitwise(cuda, case):
    b, h, w, c, f, cout, stride, pad, relu = case
    rng = np.random.default_rng(sum(case))
    x, wt, bias = _on(cuda, rng, b, h, w, c), _on(cuda, rng, f, f, c, cout, scale=0.3), _on(cuda, rng, cout)
    qp = Q.quantize_graph_params({"l": {"w": wt, "b": bias}})["l"]
    args = (qp["qw"], qp["scale"], qp["zp"], qp["b"], qp["shape"])
    before = K.launch_counts()["qconv2d_fused"]
    y = K.qconv2d_fused(x, *args, stride=stride, pad=pad, relu=relu)
    torch.cuda.synchronize()
    assert K.launch_counts()["qconv2d_fused"] == before + 1
    assert torch.equal(y, K.qfused_route_ref(x, *args, stride=stride, pad=pad, relu=relu))


# (B, H, W, C, F, Cout, stride, pad): C = 3 and 24 (byte gathers), C % 16 == 0
# (16-byte copies), stride 2, padding, Cout odd, ragged and over 128
QCONV_U8_CASES = [(2, 13, 11, 3, 3, 70, 2, 1), (1, 9, 9, 32, 3, 37, 1, 1), (2, 14, 14, 64, 3, 130, 2, 1),
                  (1, 7, 7, 24, 5, 64, 1, 2), (3, 8, 8, 16, 1, 20, 2, 0)]


@pytest.mark.parametrize("case", QCONV_U8_CASES, ids=lambda c: "x".join(map(str, c)))
def test_qconv_u8_kernel_bitwise_with_the_zero_point_in_the_padding(cuda, case):
    """Inputs with negative values put the activation zero point inside (0,
    255), so a padding tap must hold it; every tile variant and the kernel
    alone on ready u8 operands give the plain version's bits."""
    b, h, w, c, f, cout, stride, pad = case
    rng = np.random.default_rng(sum(case))
    x = _on(cuda, rng, b, h, w, c) - 0.3
    wt, bias = _on(cuda, rng, f, f, c, cout, scale=0.3), _on(cuda, rng, cout)
    qp = Q.quantize_graph_params({"l": {"w": wt, "b": bias}})["l"]
    args = (qp["qw"], qp["scale"], qp["zp"], qp["b"], qp["shape"])
    kw = dict(stride=stride, pad=pad, relu=True)
    ref = K.qfused_route_ref(x, *args, **kw)
    qa, sa, za = Q.quantize_tensor(x, axis=None)
    assert 0 < float(za) < 255
    before = K.launch_counts()
    y = K.qconv2d_fused(x, *args, **kw)
    assert K.launch_counts()["qconv2d_fused"] == before["qconv2d_fused"] + 1
    assert torch.equal(y, ref)
    for variant in range(K.qconv_tile_variants()):
        assert torch.equal(K.qconv2d_fused_tiled(x, *args, variant, **kw), ref)
    packed, colsum = K.packed_weights(qp["qw"])
    alone = K.qconv_launch(qa, sa, za, packed, colsum, qp["scale"], qp["zp"], qp["b"], qp["shape"], **kw)
    assert torch.equal(alone, ref)
    assert K.launch_counts()["qconv2d_fused"] == before["qconv2d_fused"] + 1  # only the routed call counts


_TF32_SCRIPT = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, "src")
default = torch.backends.cudnn.allow_tf32
from repro_torch.cnn import layers as L
from repro_torch.kernels import conv_fused as K
from repro_torch.serving import SingleStageEngine, serve
out = {"default_allow_tf32": default}
if sys.argv[1] == "serve":
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((1, 224, 224, 3)).astype(np.float32) for _ in range(4)]
    server = serve("mobilenet", backend="cuda_fused", batch_size=2, warmup=False, seed=1)
    try:
        got = torch.cat([o.cpu() for o in server.run(images)["outputs"]])
        graph, params = server.graph, server.params
    finally:
        server.stop()
    cpu = {name: {k: v.cpu() if torch.is_tensor(v) else v for k, v in p.items()} for name, p in params.items()}
    want = torch.cat(SingleStageEngine(graph, cpu, backend="torch", device="cpu").run(images)["outputs"])
    out["max_abs_diff"] = float((got - want).abs().max())
    out["close"] = bool(torch.allclose(got, want, rtol=1e-3, atol=1e-6))
else:  # the conv call sites alone, no device resolved first
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 56, 56, 128, generator=g)
    w = torch.randn(3, 3, 1, 128, generator=g) * 0.3
    wg = torch.randn(3, 3, 16, 128, generator=g) * 0.1
    worst = 0.0
    for got, want in ((L.depthwise_conv2d(x.cuda(), w.cuda(), None, pad=1), L.depthwise_conv2d(x, w, None, pad=1)),
                      (K.fused_route_ref(x.cuda(), wg.cuda(), None, pad=1, groups=8),
                       K.fused_route_ref(x, wg, None, pad=1, groups=8))):
        tol = 1e-4 * want.abs() + 1e-5 * max(1.0, float(want.abs().max()))
        worst = max(worst, float(((got.cpu() - want).abs() / tol).max()))
    out["worst_err_over_tol"] = worst
out["allow_tf32_after"] = torch.backends.cudnn.allow_tf32
print(json.dumps(out))
"""


@pytest.mark.parametrize("what", ["serve", "call_sites"])
def test_library_convs_run_in_ieee_f32_under_default_flags(cuda, what):
    """In a fresh process, whose cuDNN flags are torch's defaults (TF32 on
    for convs; the ``cuda`` fixture turns it off in this one), the port's
    ``F.conv2d`` calls run in IEEE f32: MobileNet served on ``cuda_fused``
    (13 depthwise convs through ``cnn/layers.py``) matches the CPU plain
    route at the served bar, and the two call sites alone (``depthwise_conv2d``
    and the fused conv's grouped route) match the CPU at the reference's
    per-node bar ``1e-4 * |r| + 1e-5 * max(1, max |r|)``, which TF32's ten
    mantissa bits would miss."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _TF32_SCRIPT, what], cwd=root, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["default_allow_tf32"] is True
    assert out["allow_tf32_after"] is False
    if what == "serve":
        assert out["close"], out
    else:
        assert out["worst_err_over_tol"] <= 1.0, out


def test_unfused_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        ops.gemm(torch.zeros(2, 3, device=cuda, dtype=torch.float64), torch.zeros(3, 4, device=cuda))
    with pytest.raises(ValueError):
        ops.gemm(torch.zeros(2, 3, device=cuda), torch.zeros(4, 5, device=cuda))
    with pytest.raises(ValueError):
        ops.gemm(torch.zeros(2, 3, device=cuda), torch.zeros(3, 5))  # b on the CPU
    with pytest.raises(TypeError):
        ops.im2col_batched(torch.zeros(1, 4, 4, 2, device=cuda, dtype=torch.float16), 3, 3)
    with pytest.raises(TypeError):
        K.qconv2d_fused(torch.zeros(1, 4, 4, 2, device=cuda, dtype=torch.float64),
                        torch.zeros(18, 2, device=cuda, dtype=torch.uint8),
                        torch.ones(1, 2, device=cuda), torch.zeros(1, 2, device=cuda),
                        None, (3, 3, 2, 2), pad=1)
    # the u8 route's own arguments
    x, ones, zeros = torch.zeros(1, 4, 4, 2, device=cuda), torch.ones(1, 2, device=cuda), torch.zeros(1, 2, device=cuda)
    qw = torch.zeros(18, 2, device=cuda, dtype=torch.uint8)
    with pytest.raises(TypeError):  # qw not uint8
        K.qconv2d_fused(x, qw.float(), ones, zeros, None, (3, 3, 2, 2), pad=1)
    with pytest.raises(ValueError):  # qw not [FH*FW*C, Cout]
        K.qconv2d_fused(x, qw[:9], ones, zeros, None, (3, 3, 2, 2), pad=1)
    with pytest.raises(ValueError):  # qw on the CPU
        K.qconv2d_fused(x, qw.cpu(), ones, zeros, None, (3, 3, 2, 2), pad=1)
    with pytest.raises(ValueError):  # scale not [1, Cout]
        K.qconv2d_fused(x, qw, torch.ones(2, device=cuda), zeros, None, (3, 3, 2, 2), pad=1)
    with pytest.raises(ValueError):
        K.qconv2d_fused_tiled(x, qw, ones, zeros, None, (3, 3, 2, 2), K.qconv_tile_variants(), pad=1)
    qa = torch.zeros(1, 4, 4, 2, device=cuda, dtype=torch.uint8)
    one, packed, colsum = torch.ones(1, device=cuda), *K.packed_weights(qw)
    with pytest.raises(TypeError):  # qa not uint8
        K.qconv_launch(qa.float(), one, one, packed, colsum, ones, zeros, None, (3, 3, 2, 2), stride=1, pad=1, relu=False)
    with pytest.raises(ValueError):  # wt's Kp not a multiple of 16
        K.qconv_launch(qa, one, one, packed[:, :18].contiguous(), colsum, ones, zeros, None, (3, 3, 2, 2),
                       stride=1, pad=1, relu=False)
    with pytest.raises(ValueError):  # column sums not int32
        K.qconv_launch(qa, one, one, packed, colsum.long(), ones, zeros, None, (3, 3, 2, 2), stride=1, pad=1,
                       relu=False)


def test_cuda_route_served_bitwise_equal_single_stage(cuda):
    g = _tiny()
    rng = np.random.default_rng(2)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(10)]
    K.reset_launches()
    server = serve(g, backend="cuda", batch_size=4, warmup=False, seed=1)
    try:
        outs = [o.cpu() for o in server.run(images)["outputs"]]
        batches = server.metrics.stages[0].snapshot()["batches"]
    finally:
        server.stop()
    counts = K.launch_counts()
    assert counts == {"conv2d_fused": 0, "matmul_fused": 0, "qconv2d_fused": 0,
                      "im2col": 3 * batches, "gemm": 5 * batches, "flash_decode": 0, "ssd": 0}
    single = SingleStageEngine(g, server.params, backend="cuda").run(images)["outputs"]
    for a, b in zip(outs, single):
        assert torch.equal(a, b.cpu())
    plain = SingleStageEngine(g, server.params, backend="torch").run(images)["outputs"]
    for a, b in zip(outs, plain):
        np.testing.assert_allclose(a.numpy(), b.cpu().numpy(), rtol=RTOL, atol=ATOL)


def test_host_images_cross_to_the_card_in_stage_0(cuda):
    """A CUDA server's submit() does no device work for a host image: it
    queues a host copy taken at submit (a later write to the caller's
    buffer does not reach it), stage 0 moves each micro-batch to the card
    in one copy, and the outputs keep the bits of the same images
    submitted from the card."""
    from repro_torch.serving.server import device_batch

    host = [torch.full((1, 2, 2, 3), float(i)) for i in range(3)]
    env = device_batch(host[:2] + [host[2].to(cuda)], cuda, 4)
    assert env["input"].device.type == "cuda" and env["input"].shape == (4, 2, 2, 3)
    assert torch.equal(env["input"].cpu(), torch.cat(host + [torch.zeros(1, 2, 2, 3)]))
    g = _tiny()
    rng = np.random.default_rng(3)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(10)]
    server = serve(g, backend="cuda_fused", batch_size=4, seed=1)
    try:
        want = [o.cpu() for o in server.run([torch.as_tensor(im, device=cuda) for im in images])["outputs"]]
        buf = images[0].copy()
        ticket = server.submit(buf)
        buf[...] = 0.0
        got = ticket.result(timeout=60).cpu()
        outs = [o.cpu() for o in server.run(images)["outputs"]]
    finally:
        server.stop()
    assert torch.equal(got, want[0])
    for a, b in zip(outs, want):
        assert torch.equal(a, b)


def test_fused_and_unfused_routes_serve_the_same_bits(cuda):
    """``cuda_fused`` (conv and fc kernels with the epilogue) and ``cuda``
    (im2col + gemm, then ``+ b`` and ReLU) sum in one order: the served
    outputs are bitwise equal on the same weights."""
    g = _tiny()
    rng = np.random.default_rng(3)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(10)]
    outs = {}
    params = None
    for backend in ("cuda_fused", "cuda"):
        server = serve(g, backend=backend, batch_size=4, warmup=False, seed=1, params=params)
        try:
            outs[backend] = [o.cpu() for o in server.run(images)["outputs"]]
            params = server.params
        finally:
            server.stop()
    for a, b in zip(outs["cuda_fused"], outs["cuda"]):
        assert torch.equal(a, b)


# --------------------------------------------------- decode attention (B5)
# (B, Hkv, G, D, W, length): Hymba's served shape, other G and D, ragged;
# each side of the first split boundary (64 slots at these W and D); a
# 32768-slot cache whose splits past the prefix are empty; G over 8
FD_CASES = [(4, 5, 5, 64, 1024, 1), (4, 5, 5, 64, 1024, 777), (4, 5, 5, 64, 1024, 1024),
            (2, 3, 1, 128, 300, 300), (1, 2, 5, 128, 300, 129), (2, 5, 5, 64, 1, 1),
            (4, 5, 5, 64, 1024, 63), (4, 5, 5, 64, 1024, 64), (4, 5, 5, 64, 1024, 65),
            (4, 5, 5, 64, 32768, 1), (4, 5, 5, 64, 32768, 777), (2, 2, 13, 64, 300, 200)]


def _bf16_ulp(r):
    """Spacing of bf16 numbers (8 significant bits) at |r|, taken no finer
    than at 2^-8 of the largest |r|: an output that cancels to near 0 is
    rounded from a sum of terms as large as the others."""
    _, e = torch.frexp(torch.maximum(r.abs(), r.abs().max() * 2.0 ** -8))
    return torch.ldexp(torch.ones_like(r), e - 8)


def _check_flash_decode(cuda, case, dtype, quant=False):
    """B5 at ``case`` against its plain version (f32 at 2e-4, bf16 within
    one bf16 ulp of the f32 plain version on the same cache), a row at
    batch 1 and a second call bitwise equal.  ``quant``: the cache is
    int8 with its scales, and the result must also be bitwise the
    kernel's on the cache dequantized into q's type, and the same with
    the length on the device."""
    b, hkv, g, d, w, length = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(case))
    q = _on(cuda, rng, b, hkv, g, d, scale=0.5).to(dt)
    k, v = _on(cuda, rng, b, w, hkv, d, scale=0.5).to(dt), _on(cuda, rng, b, w, hkv, d).to(dt)
    scales = {}
    if quant:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        scales = {"k_scale": ks, "v_scale": vs}
        kd, vd = FD.dequantize(k, ks, dt), FD.dequantize(v, vs, dt)
    else:
        kd, vd = k, v
    before = K.launch_counts()["flash_decode"]
    y = ops.flash_decode(q, k, v, length, **scales)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_decode"] == before + 1
    assert y.dtype == dt and y.shape == q.shape
    if dtype == "float32":
        ref = FD.flash_decode_ref(q, k, v, length, **scales)
        np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=2e-4, atol=2e-4)
    else:
        r32 = FD.flash_decode_ref(q.float(), kd.float(), vd.float(), length)
        assert bool(((y.float() - r32).abs() <= _bf16_ulp(r32)).all())
    # the split length depends on (W, D) alone: a row's bits do not depend
    # on the batch it rides in, nor on the call
    row = b - 1
    one = {key: t[row:row + 1].contiguous() for key, t in scales.items()}
    y1 = ops.flash_decode(q[row:row + 1].contiguous(), k[row:row + 1].contiguous(),
                          v[row:row + 1].contiguous(), length, **one)
    assert torch.equal(y1, y[row:row + 1])
    assert torch.equal(ops.flash_decode(q, k, v, length, **scales), y)
    if quant:  # dequantized as it reads, in the plain version's arithmetic
        assert torch.equal(ops.flash_decode(q, kd, vd, length), y)
        dev_len = torch.tensor([length], dtype=torch.int32, device=cuda)
        assert torch.equal(ops.flash_decode(q, k, v, dev_len, **scales), y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_decode_kernel_matches_plain(cuda, case, dtype):
    _check_flash_decode(cuda, case, dtype)


# PaliGemma's MQA at D = 256 (G 8, its served 1152 slots: splits of 128),
# a valid prefix of 1, ragged, all, each side of the first split; a
# smaller G (f32 rows of 64 pieces: two a lane)
FD256_CASES = [(4, 1, 8, 256, 1152, 1), (4, 1, 8, 256, 1152, 1025), (4, 1, 8, 256, 1152, 1152),
               (2, 1, 8, 256, 1152, 128), (2, 1, 8, 256, 1152, 129), (2, 2, 3, 256, 300, 200)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FD256_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_decode_kernel_at_head_dim_256_matches_plain(cuda, case, dtype):
    _check_flash_decode(cuda, case, dtype)


# an int8 cache: MusicGen's served shape (Hkv 32, G 1, D 64, 896 slots:
# splits of 64) at a prefix of 1, ragged, all and each side of the first
# split; Command R+'s G 12 at D 128 (two G-chunks); GQA; D = 256
FD_INT8_CASES = [(4, 32, 1, 64, 896, 1), (4, 32, 1, 64, 896, 769), (4, 32, 1, 64, 896, 896),
                 (4, 32, 1, 64, 896, 64), (4, 32, 1, 64, 896, 65), (2, 8, 12, 128, 300, 200),
                 (2, 2, 3, 64, 300, 129), (2, 1, 8, 256, 300, 200)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FD_INT8_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_decode_kernel_on_an_int8_cache_bitwise_equal_the_dequantized(cuda, case, dtype):
    _check_flash_decode(cuda, case, dtype, quant=True)


# ------------------------------------------------------------- SSD (B6)
# (B, S, H, P, N, chunk, nonzero h0, head-stride-0 B/C)
SSD_CASES = [(2, 128, 50, 64, 16, 64, False, True), (1, 256, 4, 64, 16, 128, True, False),
             (2, 64, 3, 8, 4, 16, True, True),
             # 3 chunks and more, each handing its state to the next: Hymba's
             # heads, chunk 128, and a chunk of 100 with P = 12 (24-byte bf16
             # rows, read one element at a time) and N = 5
             (2, 256, 50, 64, 16, 64, True, True), (1, 384, 4, 64, 16, 128, True, True),
             (2, 300, 5, 12, 5, 100, True, True)]


def _ssd_inputs(cuda, rng, b, s, h, p, n, h0, shared, dt):
    x = _on(cuda, rng, b, s, h, p).to(dt)
    la = -_on(cuda, rng, b, s, h).abs() * 0.3
    if shared:
        B = (_on(cuda, rng, b, s, 1, n) * 0.4).to(dt).expand(b, s, h, n)
        C = (_on(cuda, rng, b, s, 1, n) * 0.4).to(dt).expand(b, s, h, n)
    else:
        B, C = (_on(cuda, rng, b, s, h, n) * 0.4).to(dt), (_on(cuda, rng, b, s, h, n) * 0.4).to(dt)
    return x, la.to(dt), B, C, (_on(cuda, rng, b, h, n, p) if h0 else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_kernel_matches_plain(cuda, case, dtype):
    b, s, h, p, n, chunk, h0, shared = case
    rng = np.random.default_rng(s + h)
    x, la, B, C, h0t = _ssd_inputs(cuda, rng, b, s, h, p, n, h0, shared, getattr(torch, dtype))
    before = K.launch_counts()["ssd"]
    y, hf = ops.ssd(x, la, B, C, h0=h0t, chunk=chunk)
    torch.cuda.synchronize()
    assert K.launch_counts()["ssd"] == before + 1
    ry, rh = SSD.ssd_ref(x, la, B, C, chunk=chunk, h0=h0t)
    tol = 2e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(y.float().cpu().numpy(), ry.float().cpu().numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(hf.cpu().numpy(), rh.cpu().numpy(), rtol=tol, atol=tol)


def test_ssd_ragged_sequence_through_ops(cuda):
    rng = np.random.default_rng(149)
    x, la, B, C, _ = _ssd_inputs(cuda, rng, 2, 149, 4, 64, 16, False, True, torch.float32)
    y, hf = ops.ssd(x, la, B, C, chunk=64)
    assert y.shape == x.shape
    ry, rh = SSD.ssd_ref(x, la, B, C, chunk=64)
    np.testing.assert_allclose(y.cpu().numpy(), ry.cpu().numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(hf.cpu().numpy(), rh.cpu().numpy(), rtol=2e-4, atol=2e-4)


def test_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(FD, "flash_decode_ref", refuse)
    monkeypatch.setattr(SSD, "ssd_ref", refuse)
    rng = np.random.default_rng(0)
    before = K.launch_counts()
    ops.flash_decode(_on(cuda, rng, 1, 2, 2, 64), _on(cuda, rng, 1, 8, 2, 64), _on(cuda, rng, 1, 8, 2, 64), 5)
    x, la, B, C, _ = _ssd_inputs(cuda, rng, 1, 70, 2, 64, 16, False, True, torch.float32)
    ops.ssd(x, la, B, C, chunk=64)  # ragged: padded, then the kernel
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["flash_decode"] == before["flash_decode"] + 1 and after["ssd"] == before["ssd"] + 1


def test_decode_and_ssd_kernels_refuse_what_they_do_not_take(cuda):
    z = torch.zeros(1, 2, 2, 64, device=cuda)
    cache = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError):
        ops.flash_decode(z.half(), cache.half(), cache.half(), 3)
    with pytest.raises(TypeError):
        ops.flash_decode(z, cache.bfloat16(), cache, 3)
    with pytest.raises(ValueError):
        ops.flash_decode(z, cache, cache, 0)
    for d in (62, 264):  # not a multiple of a 16-byte vector of f32, too wide
        with pytest.raises(ValueError):
            ops.flash_decode(torch.zeros(1, 2, 2, d, device=cuda), torch.zeros(1, 8, 2, d, device=cuda),
                             torch.zeros(1, 8, 2, d, device=cuda), 3)
    x = torch.zeros(1, 70, 2, 64, device=cuda)
    la, bc = torch.zeros(1, 70, 2, device=cuda), torch.zeros(1, 70, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        SSD.ssd(x, la, bc, bc, chunk=64)  # S not a chunk multiple
    with pytest.raises(ValueError):
        SSD.ssd(torch.zeros(1, 64, 2, 6, device=cuda), la[:, :64], bc[:, :64], bc[:, :64], chunk=64)
    with pytest.raises(TypeError):
        SSD.ssd(x[:, :64].double(), la[:, :64], bc[:, :64].double(), bc[:, :64].double(), chunk=64)
    with pytest.raises(ValueError):  # h0 not [B, H, N, P]
        SSD.ssd(x[:, :64], la[:, :64], bc[:, :64], bc[:, :64], h0=torch.zeros(1, 2, 16, 32, device=cuda), chunk=64)
    with pytest.raises(ValueError):  # more 4 x 4 tiles of the state than a block has threads
        wide = torch.zeros(1, 8, 1, 1028, device=cuda)
        SSD.ssd(wide, la[:, :8, :1], bc[:, :8, :1], bc[:, :8, :1], chunk=8)


def test_reduced_hymba_served_through_both_kernels(cuda):
    """A reduced Hymba (2 layers) served on the card: 2 SSD launches in the
    prefill and 2 flash-decode launches in each decode step, none of the
    other; in f32 its logits match the plain route's."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), compute_dtype="float32")
    model = init_params(cfg, seed=0, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 21), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    per_phase = []

    def hook(phase, i):
        per_phase.append((phase, K.launch_counts()))
        K.reset_launches()

    K.reset_launches()
    out = generate(cfg, model, prompt, 4, keep_logits=4, step_hook=hook)
    assert per_phase[0][0] == "prefill"
    assert per_phase[0][1]["ssd"] == 2 and per_phase[0][1]["flash_decode"] == 0
    for phase, counts in per_phase[1:]:
        assert phase == "decode" and counts["flash_decode"] == 2 and counts["ssd"] == 0
    plain = generate(cfg, model, prompt, 4, backend="torch", keep_logits=4)
    np.testing.assert_allclose(out["last_hidden"].cpu().numpy(), plain["last_hidden"].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(out["logits"], plain["logits"]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4, atol=1e-4)


# The wide form with the normalizer (xLSTM's mLSTM): (B, S, H, P = N,
# chunk, h0 and n0 given).  xLSTM-1.3B's served shape at N = P = 512 over
# 6 chunks (the shape the first form refused), a ragged S through ops
# (padded to 3 chunks), the reduced xLSTM's dh = 64, a chunk of 100 (t
# padded to 104 in shared memory), and one of 21 (the reduced model's
# prefill of 21 tokens: t padded to 24, below the 64 columns of a state
# slice that reuse B's)
SSD_NORM_CASES = [(4, 768, 4, 512, 128, False), (2, 300, 2, 512, 128, True),
                  (2, 256, 4, 64, 128, True), (1, 300, 2, 128, 100, True), (2, 21, 4, 64, 128, True)]


def _mlstm_inputs(cuda, rng, b, s, h, n, dt):
    """v, the log of a sigmoid forget gate, k scaled by dh**-0.5 times the
    input gate e^min(i, 8), and q, as the mLSTM makes them."""
    x = _on(cuda, rng, b, s, h, n).to(dt)
    la = torch.nn.functional.logsigmoid(2.0 + _on(cuda, rng, b, s, h)).to(dt)
    gate = torch.exp(torch.clamp(_on(cuda, rng, b, s, h, scale=2.0), max=8.0))
    B = (_on(cuda, rng, b, s, h, n) * n ** -0.5 * gate[..., None]).to(dt)
    return x, la, B, _on(cuda, rng, b, s, h, n).to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_NORM_CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_kernel_with_the_normalizer_matches_plain(cuda, case, dtype):
    """y, h_final, den and n_final against the plain version, f32 at the
    reference's 2e-4 and bf16 at its 5e-2, relative to the output's scale
    (the absolute floor scaled by max|r|: with the input gate at up to
    e^8 the scan's sums run over 512 and 128 terms as large as the
    output's range, and an output that cancels to near 0 keeps their f32
    rounding); den and both states in f32."""
    b, s, h, n, chunk, state = case
    rng = np.random.default_rng(s + n)
    x, la, B, C = _mlstm_inputs(cuda, rng, b, s, h, n, getattr(torch, dtype))
    h0 = _on(cuda, rng, b, h, n, n, scale=0.3) if state else None
    n0 = _on(cuda, rng, b, h, n).abs() if state else None
    before = K.launch_counts()["ssd"]
    got = ops.ssd(x, la, B, C, h0=h0, chunk=chunk, normalizer=True, n0=n0)
    torch.cuda.synchronize()
    assert K.launch_counts()["ssd"] == before + 1
    # the same bits on a second call: no block reads what another writes out of order
    assert all(torch.equal(a, b) for a, b in zip(got, ops.ssd(x, la, B, C, h0=h0, chunk=chunk, normalizer=True, n0=n0)))
    want = ops.ssd(x, la, B, C, h0=h0, chunk=chunk, normalizer=True, n0=n0, backend="torch")
    assert [g.dtype for g in got] == [x.dtype] + [torch.float32] * 3
    tol = 2e-4 if dtype == "float32" else 5e-2
    for g, w in zip(got, want):
        w = w.float().cpu().numpy()
        np.testing.assert_allclose(g.float().cpu().numpy(), w, rtol=tol, atol=tol * max(1.0, float(np.abs(w).max())))


def test_ssd_kernel_takes_the_large_state_without_the_normalizer(cuda):
    """N = P = 512, which the first form refuses, runs on the wide form
    and gives the normalizer's y and state without it."""
    rng = np.random.default_rng(11)
    x, la, B, C = _mlstm_inputs(cuda, rng, 2, 256, 2, 512, torch.float32)
    y, hf = ops.ssd(x, la, B, C)
    ry, rh = ops.ssd(x, la, B, C, backend="torch")
    np.testing.assert_allclose(y.cpu().numpy(), ry.cpu().numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(hf.cpu().numpy(), rh.cpu().numpy(), rtol=2e-4, atol=2e-4)
    y2, hf2, _, _ = ops.ssd(x, la, B, C, normalizer=True)
    assert torch.equal(y, y2) and torch.equal(hf, hf2)
    with pytest.raises(ValueError):  # the normalizer needs P a multiple of 64
        ops.ssd(x[..., :12], la, B, C, normalizer=True)
    with pytest.raises(ValueError):  # and a chunk of at most 128
        ops.ssd(x, la, B, C, chunk=256, normalizer=True)


# The wide form's clusters (B, S, H, N, P, chunk, h0 and n0 given, blocks a
# cluster): one P-tile a block and one cluster a chunk at P = 64, 128 and
# 512 (1, 2 and 8 blocks); P = 576, three clusters of 3 a chunk, each
# computing the scores; a single chunk (S = Q); N = 32, a single slice of
# N (bf16 stages 64 rows a slice: half of it past N) and N = 96 (its
# second slice half past N)
SSD_CLUSTER_CASES = [(2, 256, 2, 64, 64, 128, True, 1), (2, 256, 2, 128, 128, 128, True, 2),
                     (1, 384, 2, 512, 512, 128, True, 8), (1, 256, 1, 64, 576, 128, True, 3),
                     (2, 128, 2, 256, 512, 128, True, 8), (2, 256, 2, 32, 512, 128, True, 8),
                     (1, 200, 2, 96, 128, 100, False, 2)]


def _mlstm_inputs_wide(cuda, rng, b, s, h, n, p, dt):
    """As _mlstm_inputs, with x of P columns and B, C of N."""
    x = _on(cuda, rng, b, s, h, p).to(dt)
    la = torch.nn.functional.logsigmoid(2.0 + _on(cuda, rng, b, s, h)).to(dt)
    gate = torch.exp(torch.clamp(_on(cuda, rng, b, s, h, scale=2.0), max=8.0))
    B = (_on(cuda, rng, b, s, h, n) * n ** -0.5 * gate[..., None]).to(dt)
    return x, la, B, _on(cuda, rng, b, s, h, n).to(dt)


def _assert_wide_matches(got, want):
    """Each output of the wide form against the plain version relative to
    its scale, at its own type's bar: y in bf16 at 5e-2, and every f32
    output (den and both states on bf16 inputs too) at 2e-4, since the
    kernel's products are exact and only the order of its f32 sums
    differs."""
    for g, w in zip(got, want):
        tol = 2e-4 if g.dtype == torch.float32 else 5e-2
        w = w.float().cpu().numpy()
        np.testing.assert_allclose(g.float().cpu().numpy(), w, rtol=tol, atol=tol * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CLUSTER_CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_wide_form_clusters_match_plain(cuda, case, dtype):
    """Each cluster size and the edges of the pass over N, with the
    normalizer, against the plain version (y at its type's bar, the f32
    outputs at 2e-4); the launch takes the stated blocks a cluster and two
    calls give the same bits."""
    b, s, h, n, p, chunk, state, blocks = case
    rng = np.random.default_rng(s + n + p)
    dt = getattr(torch, dtype)
    x, la, B, C = _mlstm_inputs_wide(cuda, rng, b, s, h, n, p, dt)
    h0 = _on(cuda, rng, b, h, n, p, scale=0.3) if state else None
    n0 = _on(cuda, rng, b, h, n).abs() if state else None
    info = SSD.wide_launch_info(min(chunk, s), p, dt)
    assert info["cluster_blocks"] == blocks and info["resident_clusters"] >= 1
    got = ops.ssd(x, la, B, C, h0=h0, chunk=chunk, normalizer=True, n0=n0)
    again = ops.ssd(x, la, B, C, h0=h0, chunk=chunk, normalizer=True, n0=n0)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = ops.ssd(x, la, B, C, h0=h0, chunk=chunk, normalizer=True, n0=n0, backend="torch")
    _assert_wide_matches(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["head_stride_0", "rows_off_16_bytes"])
def test_ssd_wide_form_takes_operands_no_tensor_map_describes(cuda, kind, dtype):
    """B and C that the tensor memory accelerator's maps cannot take come
    in by the threads into the same layout: one B and one C broadcast to
    every head (a head stride of 0), and rows that start off a 16-byte
    boundary (read one element at a time); y at its type's bar, the f32
    outputs at 2e-4."""
    b, s, h, n, p = 2, 256, 4, 128, 128
    rng = np.random.default_rng(7 + len(kind))
    dt = getattr(torch, dtype)
    x, la, B, C = _mlstm_inputs_wide(cuda, rng, b, s, h, n, p, dt)
    if kind == "head_stride_0":
        B, C = B[:, :, :1].expand(b, s, h, n), C[:, :, :1].expand(b, s, h, n)
    else:
        B, C = torch.cat([B, B[..., :8]], -1)[..., 1:n + 1], torch.cat([C, C[..., :8]], -1)[..., 3:n + 3]
        assert not SSD._rows_of_16_bytes(B) and not SSD._rows_of_16_bytes(C)
    h0, n0 = _on(cuda, rng, b, h, n, p, scale=0.3), _on(cuda, rng, b, h, n).abs()
    got = ops.ssd(x, la, B, C, h0=h0, normalizer=True, n0=n0)
    want = ops.ssd(x, la, B, C, h0=h0, normalizer=True, n0=n0, backend="torch")
    _assert_wide_matches(got, want)


def test_ssd_wide_form_bitwise_beside_a_concurrent_copy(cuda):
    """xLSTM-1.3B's served prefill shape called three times, the second
    while another stream copies 2 GB: the same bits each time (sums in a
    fixed order, no atomics in any sum, the chain of chunks unaffected by
    when its blocks run)."""
    rng = np.random.default_rng(768)
    x, la, B, C = _mlstm_inputs(cuda, rng, 4, 768, 4, 512, torch.bfloat16)
    first = ops.ssd(x, la, B, C, normalizer=True)
    torch.cuda.synchronize()
    src = torch.empty(1 << 29, device=cuda)
    dst = torch.empty_like(src)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(4):
            dst.copy_(src)
    second = ops.ssd(x, la, B, C, normalizer=True)
    torch.cuda.synchronize()
    third = ops.ssd(x, la, B, C, normalizer=True)
    torch.cuda.synchronize()
    del src, dst
    for got in (second, third):
        assert all(torch.equal(a, c) for a, c in zip(first, got))


def test_reduced_xlstm_decode_graph_bitwise_equal_op_by_op(cuda):
    """A reduced xLSTM (7 mLSTM layers and one sLSTM, dh = 64) served on
    the card: 7 SSD launches in the prefill and none in a decode step; the
    replayed step gives the op-by-op step's tokens and logits bitwise, in
    bf16 and f32; in f32 the kernel route is within 1e-4 of the plain
    route's prefill hidden state."""
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(), compute_dtype=dtype)
        model = init_params(cfg, seed=0, device=cuda)
        prompt = torch.randint(0, cfg.vocab_size, (2, 21), device=cuda,
                               generator=torch.Generator(device=cuda).manual_seed(0))
        per_phase = []

        def hook(phase, i):
            per_phase.append((phase, K.launch_counts(), runtime.graph_launches()))
            K.reset_launches()

        K.reset_launches()
        out = generate(cfg, model, prompt, 6, keep_logits=6, step_hook=hook)
        assert per_phase[0][1]["ssd"] == 7 and sum(per_phase[0][1].values()) == 7
        assert [g for _, _, g in per_phase[1:]] == [0] + [1] * 5
        assert all(sum(c.values()) == 0 for _, c, _ in per_phase[1:])
        eager = generate(cfg, model, prompt, 6, keep_logits=6, graphs=False)
        assert torch.equal(out["tokens"], eager["tokens"])
        assert all(torch.equal(a, b) for a, b in zip(out["logits"], eager["logits"]))
        if dtype == "float32":
            plain = generate(cfg, model, prompt, 1, backend="torch")
            np.testing.assert_allclose(out["last_hidden"].cpu().numpy(), plain["last_hidden"].cpu().numpy(),
                                       rtol=1e-4, atol=1e-4)


# ------------------------------------------- CUDA graphs (kernels/graphs.py)
def _tiny_plan(backend):
    """The tiny net's planned stages, their weights, and seeded micro-batches of 4."""
    server = serve(_tiny(), backend=backend, batch_size=4, warmup=False, seed=1)
    server.stop()
    return server.graph, server.plan, server.params


def _run_stages(fns, params, x):
    env = {"input": x}
    for fn in fns:
        env = fn(params, env)
    torch.cuda.synchronize()
    return env


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda", "torch"])
def test_captured_stage_fns_bitwise_equal_eager(cuda, backend):
    """Each stage captured as a CUDA graph gives the eager stage's bits, and
    each replay counts the launches the eager call makes."""
    g, plan, params = _tiny_plan(backend)
    eager = build_eager_stage_fns(g, plan, backend=backend)
    graphed = build_stage_fns(g, plan, backend=backend)
    rng = np.random.default_rng(5)
    for rep in range(3):  # eager and capture, then two replays
        x = _on(cuda, rng, 4, 16, 16, 3)
        K.reset_launches()
        want = _run_stages(eager, params, x)
        want_counts = K.launch_counts()
        K.reset_launches()
        got = _run_stages(graphed, params, x)
        assert K.launch_counts() == want_counts
        assert runtime.graph_launches() == (0 if rep == 0 else len(graphed))
        assert want.keys() == got.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), (backend, rep, key)
    assert all(len(fn.graphs) == 1 and next(iter(fn.graphs.values())).replays == 2 for fn in graphed)


def test_swap_plan_recaptures_and_never_replays_the_old_graphs(cuda):
    """Each swap_plan captures the new epoch's graphs in its prepare phase;
    after it the old epoch's graphs are never replayed, the outputs keep
    their bits and the replays count 3 conv and 2 fc launches a batch."""
    g, plan, params = _tiny_plan("cuda_fused")
    rng = np.random.default_rng(6)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(10)]
    n = sum(len(a) for a in plan.allocation)
    one_stage = PipelinePlan(pipeline=Pipeline(stages=(plan.pipeline.stages[0],)), allocation=(tuple(range(n)),))
    server = PipelineServer(g, params, plan, batch_size=4, backend="cuda_fused")
    server.warmup()
    runs, retired = [], []
    try:
        with server:
            for new_plan in (None, one_stage, plan):
                if new_plan is not None:
                    old = [c for fn in server._stage_fns for c in fn.graphs.values()]
                    server.swap_plan(new_plan)
                    retired.append((old, [c.replays for c in old]))
                live = [c for fn in server._stage_fns for c in fn.graphs.values()]
                assert len(live) == len(server._stage_fns)  # captured by the swap's warm-up
                K.reset_launches()
                runs.append([o.cpu() for o in server.run(images)["outputs"]])
                batches = server.metrics.stages[0].snapshot()["batches"]
                counts = K.launch_counts()
                assert counts["conv2d_fused"] == 3 * batches and counts["matmul_fused"] == 2 * batches
                assert runtime.graph_launches() == len(live) * batches
                for old, replays in retired:
                    assert [c.replays for c in old] == replays
                    assert not {id(c) for c in old} & {id(c) for c in live}
    finally:
        server.stop()
    for outs in runs[1:]:
        for a, b in zip(outs, runs[0]):
            assert torch.equal(a, b)


def test_one_graph_is_replayed_by_one_caller_at_a_time(cuda):
    """A stalled stage worker and its replacement (server.py's recovery)
    call one stage function from two threads on two streams; the graph's
    replays are serialised, so each caller gets the bits of its own input."""
    g, plan, params = _tiny_plan("cuda_fused")
    fn = build_stage_fns(g, plan, backend="cuda_fused")[0]
    eager = build_eager_stage_fns(g, plan, backend="cuda_fused")[0]
    rng = np.random.default_rng(7)
    xs = [_on(cuda, rng, 4, 16, 16, 3) for _ in range(2)]
    wants = [eager(params, {"input": x}) for x in xs]
    fn(params, {"input": xs[0]})  # eager, then the capture
    torch.cuda.synchronize()
    bad = []

    def caller(i):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            for _ in range(40):
                out = fn(params, {"input": xs[i]})
                stream.synchronize()
                bad.extend(i for key in out if not torch.equal(out[key], wants[i][key]))

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad
    assert next(iter(fn.graphs.values())).replays == 80


def test_graph_server_recovers_a_stalled_stage_with_the_same_bits(cuda):
    """A stage stalls past the watchdog's deadline; its replacement
    re-dispatches while the stalled call wakes and replays the same graph
    late.  Every ticket resolves once, with the single-stage engine's bits."""
    g, plan, params = _tiny_plan("cuda_fused")
    rng = np.random.default_rng(8)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(24)]
    policy = RecoveryPolicy(max_retries=1, backoff_base_s=0.001, heartbeat_deadline_s=0.2,
                            restart_delay_s=0.0)
    inj = FaultPlan(events=(FaultEvent("stall", stage=0, at_call=2, stall_s=0.6),)).injector(policy)
    builder = fault_injecting_builder(lambda gr, pl: build_stage_fns(gr, pl, backend="cuda_fused"), inj)
    server = PipelineServer(g, params, plan, batch_size=4, flush_timeout_s=0.0,
                            stage_fn_builder=builder, recovery=policy)
    with server:
        outs = [o.cpu() for o in server.run(images)["outputs"]]
    assert inj.fired_kinds() == {"stall": 1}
    assert server.metrics.recovery.snapshot()["worker_restarts"] >= 1
    want = SingleStageEngine(g, params, backend="cuda_fused").run(images)["outputs"]
    for a, b in zip(outs, want):
        assert torch.equal(a, b.cpu())


def test_each_stage_thread_launches_on_a_stream_of_its_own_inside_its_launch_spans(cuda):
    """What the span metrics stand on, over a served run of VGG-16 at
    micro-batch 8 with the span log on and the profiler tracing the CUDA
    activity.  Kineto gives a runtime call's thread as its resource id:
    the low 32 bits of its pthread id, the span log's ``ident``.  Every
    device operation a stage's thread launched runs on one stream, and no
    two stages share one, so a stream's busy time is its stage's device
    time.  Once the spans are moved onto the profiler's clock (Unix
    nanoseconds), at least 95% of the graph launches lie inside a
    ``launch`` span of their thread."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.cnn.models import MODELS

    server = serve(MODELS["vgg16"](), backend="cuda_fused", batch_size=8, seed=3)
    images = list(torch.randn(128, 224, 224, 3, device=cuda).unbind(0))
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        log = server.metrics.start_spans(1024)
        server.run(images[:32])  # every stage thread reads the log on from here
        prof.start()
        server.run(images)
        prof.stop()
        server.metrics.stop_spans()
    finally:
        server.stop()
    reads = []
    for _ in range(5):
        a, u, b = time.perf_counter_ns(), time.time_ns(), time.perf_counter_ns()
        reads.append((b - a, u - (a + b) // 2))
    offset = min(reads)[1]
    assert log.dropped == 0
    records = log.records()
    stage_of = {s.ident & 0xFFFFFFFF: s.stage for s in records if s.name == f"stage{s.stage}"}
    ops, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            ops.append((e.device_resource_id(), e.correlation_id() or e.linked_correlation_id()))
        elif e.name().startswith("cuda"):
            calls[e.correlation_id()] = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                                         e.device_resource_id() & 0xFFFFFFFF)
    streams = collections.defaultdict(collections.Counter)
    for stream, corr in ops:
        if corr in calls and calls[corr][3] in stage_of:
            streams[stage_of[calls[corr][3]]][stream] += 1
    n_stages = len(server.plan.allocation)
    assert sorted(streams) == list(range(n_stages)), (streams, stage_of)
    assert all(len(c) == 1 for c in streams.values()), streams
    assert len({next(iter(c)) for c in streams.values()}) == n_stages, streams
    launches = collections.defaultdict(list)
    for s in records:
        if s.name.endswith(".launch"):
            launches[s.ident & 0xFFFFFFFF].append((s.start_ns + offset, s.end_ns + offset))
    graph = [c for c in calls.values() if c[0].startswith("cudaGraphLaunch")]
    inside = [c for c in graph if any(a <= c[1] and c[2] <= b for a, b in launches.get(c[3], ()))]
    assert len(graph) >= n_stages * len(images) // 8
    assert len(inside) >= 0.95 * len(graph), (len(inside), len(graph))


def test_a_failed_capture_raises(cuda):
    """Code that reads a device value on the host cannot be captured: the
    capture raises, and nothing falls back to running op by op.  In a
    fresh process, so that the failed capture leaves no state behind."""
    import os
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from repro_torch.kernels.graphs import GraphedFn\n"
        "fn = GraphedFn(lambda c, x: x * float(x.sum()))\n"
        "x = torch.ones(4, device='cuda')\n"
        "try:  # the first call runs op by op, then captures\n"
        "    fn(None, x)\n"
        "except RuntimeError:\n"
        "    print('raised')\n"
        "else:\n"
        "    print('no error')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.stdout.strip() == "raised", (out.stdout, out.stderr[-2000:])


# (B, W, D, lengths): each side of the first split boundary and W, at batch 1 and 4
FD_DEVICE_CASES = [(b, w, d) for b in (1, 4) for (w, d) in ((1024, 64), (300, 128), (32768, 64))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FD_DEVICE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_decode_device_length_bitwise_equal_int(cuda, case, dtype):
    """B5 with ``length`` read on the device gives the int form's bits, at
    the split boundaries and at W; a device value outside [1, W] is
    clamped there."""
    b, w, d = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(w + d + b)
    q = _on(cuda, rng, b, 5, 5, d, scale=0.5).to(dt)
    k, v = _on(cuda, rng, b, w, 5, d, scale=0.5).to(dt), _on(cuda, rng, b, w, 5, d).to(dt)
    split = FD.split_len(w, d)
    for length in sorted({1, split - 1, split, split + 1, w - 1, w}):
        dev_len = torch.tensor([length], dtype=torch.int32, device=cuda)
        assert torch.equal(ops.flash_decode(q, k, v, dev_len), ops.flash_decode(q, k, v, length)), length
    for outside, inside in ((0, 1), (w + 7, w)):
        dev_len = torch.tensor(outside, dtype=torch.int32, device=cuda)
        assert torch.equal(ops.flash_decode(q, k, v, dev_len), ops.flash_decode(q, k, v, inside))
        ref = FD.flash_decode_ref(q.float(), k.float(), v.float(), dev_len)
        np.testing.assert_allclose(ref.cpu().numpy(), FD.flash_decode_ref(q.float(), k.float(), v.float(),
                                                                         inside).cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_with_graphs_gives_the_eager_tokens(cuda, dtype):
    """A reduced Hymba decoded with one captured step replayed gives the
    eager run's tokens and logits bit for bit; each step counts 2
    flash-decode launches, and every step after the first one graph launch."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), compute_dtype=dtype)
    model = init_params(cfg, seed=0, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 21), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    per_step = []

    def hook(phase, i):
        per_step.append((phase, K.launch_counts()["flash_decode"], runtime.graph_launches()))
        K.reset_launches()

    eager = generate(cfg, model, prompt, 6, keep_logits=6, graphs=False)
    K.reset_launches()
    graphed = generate(cfg, model, prompt, 6, keep_logits=6, step_hook=hook)
    assert torch.equal(graphed["tokens"], eager["tokens"])
    for a, b in zip(graphed["logits"], eager["logits"]):
        assert torch.equal(a, b)
    assert per_step[0] == ("prefill", 0, 0)
    assert per_step[1:] == [("decode", 2, 0 if i == 0 else 1) for i in range(6)]


# B5 at the dense and MoE decode shapes (B, Hkv, G, D, W): SmolLM-360M's
# and OLMoE-1B-7B's served steps (768 + 128 slots), and StarCoder2-15B's
# (G = 12 > 8 query rows a block: two blocks per KV head) on its
# 4096-slot window ring, which has wrapped: every slot valid, length W
LM_FD_SHAPES = [(4, 5, 3, 64, 896), (4, 16, 1, 128, 896), (4, 4, 12, 128, 4096)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", LM_FD_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_flash_decode_at_the_dense_and_moe_decode_shapes(cuda, case, dtype):
    b, hkv, g, d, w = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(w + g)
    q = _on(cuda, rng, b, hkv, g, d, scale=0.5).to(dt)
    k, v = _on(cuda, rng, b, w, hkv, d, scale=0.5).to(dt), _on(cuda, rng, b, w, hkv, d).to(dt)
    lengths = [w] if w == 4096 else [1, 769, FD.split_len(w, d) + 1, w]
    for length in lengths:
        y = ops.flash_decode(q, k, v, length)
        if dtype == "float32":
            ref = FD.flash_decode_ref(q, k, v, length)
            np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=2e-4, atol=2e-4)
        else:
            r32 = FD.flash_decode_ref(q.float(), k.float(), v.float(), length)
            assert bool(((y.float() - r32).abs() <= _bf16_ulp(r32)).all()), length
        dev_len = torch.tensor([length], dtype=torch.int32, device=cuda)
        assert torch.equal(ops.flash_decode(q, k, v, dev_len), y)
        y1 = ops.flash_decode(q[1:2].contiguous(), k[1:2].contiguous(), v[1:2].contiguous(), dev_len)
        assert torch.equal(y1, y[1:2])
    # a wrapped ring's position is past W: the device length clamps to W
    past = torch.tensor([w + 904], dtype=torch.int32, device=cuda)
    assert torch.equal(ops.flash_decode(q, k, v, past), ops.flash_decode(q, k, v, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "smollm-360m"])
def test_reduced_dense_and_moe_decode_replayed_bitwise_equal_eager(cuda, arch, dtype):
    """A reduced OLMoE (the MoE step: routing, fixed-capacity buffers and
    the combine, all on the device) and SmolLM decoded with one captured
    step replayed give the eager run's tokens and logits bit for bit; the
    prefill launches no counted kernel, each step 2 flash-decode launches,
    and every step after the first one graph launch."""
    cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype)
    model = init_params(cfg, seed=0, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (4, 40), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    per_step = []

    def hook(phase, i):
        per_step.append((phase, sum(K.launch_counts().values()), K.launch_counts()["flash_decode"],
                         runtime.graph_launches()))
        K.reset_launches()

    eager = generate(cfg, model, prompt, 6, keep_logits=6, graphs=False)
    K.reset_launches()
    graphed = generate(cfg, model, prompt, 6, keep_logits=6, step_hook=hook)
    assert torch.equal(graphed["tokens"], eager["tokens"])
    for a, b in zip(graphed["logits"], eager["logits"]):
        assert torch.equal(a, b)
    assert per_step[0] == ("prefill", 0, 0, 0)
    assert per_step[1:] == [("decode", 2, 2, 0 if i == 0 else 1) for i in range(6)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_reduced_feature_models_decode_replayed_bitwise_equal_eager(cuda, arch, dtype):
    """A reduced PaliGemma (image patches before the prompt) and MusicGen
    (four codebooks on an int8 cache) decoded with one captured step
    replayed give the eager run's tokens and logits bit for bit; each step
    launches 2 flash-decode kernels and nothing else, and every step
    after the first one graph launch."""
    cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype)
    model = init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompt = torch.randint(0, cfg.vocab_size, (4, 40) + books, device=cuda, generator=gen)
    patches = torch.randn((4, cfg.n_patches, 1152), device=cuda, generator=gen) if cfg.n_patches else None
    per_step = []

    def hook(phase, i):
        per_step.append((phase, sum(K.launch_counts().values()), K.launch_counts()["flash_decode"],
                         runtime.graph_launches()))
        K.reset_launches()

    eager = generate(cfg, model, prompt, 6, keep_logits=6, graphs=False, patches=patches)
    K.reset_launches()
    graphed = generate(cfg, model, prompt, 6, keep_logits=6, step_hook=hook, patches=patches)
    assert tuple(graphed["tokens"].shape) == (4, 6) + books
    assert torch.equal(graphed["tokens"], eager["tokens"])
    for a, b in zip(graphed["logits"], eager["logits"]):
        assert torch.equal(a, b)
    assert per_step[0] == ("prefill", 0, 0, 0)
    assert per_step[1:] == [("decode", 2, 2, 0 if i == 0 else 1) for i in range(6)]


# ------------------------------------------------ the autotuner on the card
# B1's tile variants sum every output in one order, so the tuner picks by
# time alone: every pick is held bitwise to the heuristic (-1).
def _vgg16_conv_geometries():
    from repro_torch.cnn.models import MODELS
    from repro_torch.kernels.autotune import descriptor_key

    seen = {}
    for d in MODELS["vgg16"]().descriptors():
        if d.kind == "conv":
            seen.setdefault(descriptor_key(d), d)
    return list(seen.values())


def test_autotune_sweep_picks_a_tile_variant(cuda, tmp_path):
    from repro_torch.core.descriptors import conv_descriptor
    from repro_torch.kernels.autotune import ConvAutotuner

    tuner = ConvAutotuner(cache_path=str(tmp_path / "tune.json"), repeats=1)
    assert tuner.sweep and tuner.platform == torch.cuda.get_device_name(0)
    desc = conv_descriptor("c", 14, 64, 3, 70)
    cfg = tuner.tune(desc)
    assert -1 <= cfg.variant < G.tile_variants()
    entry = tuner.entry(desc)
    assert entry["swept"] and entry["candidates"] == G.tile_variants() + 1
    assert tuner.timings_run == entry["candidates"]
    assert sorted(entry["candidate_s"], key=int) == [str(v) for v in range(-1, G.tile_variants())]
    assert entry["time_s"] == min(entry["candidate_s"].values())


def test_conv_fused_variant_bitwise_equal_heuristic_at_vgg16_geometries(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in _vgg16_conv_geometries():
        x = torch.randn(2, d.i_h, d.i_w, d.i_d, device="cuda", generator=gen)
        w = torch.randn(d.f_h, d.f_w, d.i_d, d.ofm, device="cuda", generator=gen) * 0.05
        b = torch.randn(d.ofm, device="cuda", generator=gen)
        want = K.conv2d_fused(x, w, b, stride=d.stride, pad=d.pad, relu=True)
        for v in range(G.tile_variants()):
            K.reset_launches()
            got = K.conv2d_fused(x, w, b, stride=d.stride, pad=d.pad, relu=True, variant=v)
            assert K.launch_counts()["conv2d_fused"] == 1  # counted as the main path's
            assert torch.equal(got, want), (d, v)
    with pytest.raises(ValueError, match="no tile variant"):
        K.conv2d_fused(x, w, b, variant=G.tile_variants())


def test_served_graph_with_a_tuner_bitwise_equal_without(cuda, tmp_path):
    from repro_torch.kernels.autotune import ConvAutotuner, descriptor_key
    from repro_torch.serving import host_platform

    g = _tiny()
    rng = np.random.default_rng(7)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(10)]
    plain = serve(g, backend="cuda_fused", batch_size=4, seed=1)
    try:
        want = [o.cpu() for o in plain.run(images)["outputs"]]
    finally:
        plain.stop()
    tuner = ConvAutotuner(cache_path=str(tmp_path / "tune.json"), repeats=1, batch=4)
    server = serve(g, backend="cuda_fused", batch_size=4, params=plain.params,
                   platform=host_platform(2), tuner=tuner)
    try:
        K.reset_launches()
        got = [o.cpu() for o in server.run(images)["outputs"]]
        batches = server.metrics.stages[0].snapshot()["batches"]
        counts = K.launch_counts()
    finally:
        server.stop()
    assert counts["conv2d_fused"] == 3 * batches and counts["matmul_fused"] == 2 * batches
    assert all(tuner.entry(d)["swept"] and tuner.entry(d)["batch"] == 4
               for d in g.descriptors() if d.kind == "conv")
    assert set(tuner.route_seconds("cuda_fused")) == {
        descriptor_key(d) for d in g.descriptors()}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_autotune_refuses_to_time_under_a_capture(cuda, tmp_path):
    """A miss inside a CUDA-graph capture raises (it would enqueue timing
    kernels and synchronise); a hit returns the cached variant."""
    from repro_torch.core.descriptors import conv_descriptor
    from repro_torch.kernels.autotune import ConvAutotuner

    tuner = ConvAutotuner(cache_path=str(tmp_path / "tune.json"), repeats=1)
    hit, miss = conv_descriptor("a", 8, 4, 3, 8), conv_descriptor("b", 10, 4, 3, 8)
    cfg = tuner.tune(hit)
    y = torch.zeros(4, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y.add_(1.0)
        assert tuner.tune(hit) == cfg
        with pytest.raises(RuntimeError, match="capturing"):
            tuner.tune(miss)
        with pytest.raises(RuntimeError, match="capturing"):
            tuner.measure_route(miss, lambda: y.add_(1.0), route="cuda_fused")
    assert tuner.entry(miss) is None


def test_warm_cache_times_nothing_on_the_card(cuda, tmp_path):
    """A route-only entry does not suppress the sweep; a second tuner on the
    file picks the same variants and times nothing."""
    from repro_torch.kernels.autotune import ConvAutotuner

    cache = str(tmp_path / "tune.json")
    geos = _vgg16_conv_geometries()[-3:]
    first = ConvAutotuner(cache_path=cache, repeats=1)
    first.measure_route(geos[0], lambda: None, route="cuda")
    before = first.timings_run
    picks = [first.tune(d) for d in geos]
    assert first.timings_run == before + len(geos) * (G.tile_variants() + 1)
    assert "cuda" in first.entry(geos[0])["routes"]
    warm = ConvAutotuner(cache_path=cache, repeats=1)
    assert [warm.tune(d) for d in geos] == picks
    assert warm.measured_route(geos[0], "cuda") == first.measured_route(geos[0], "cuda")
    assert warm.timings_run == 0


def _hikey_tiny():
    """The tiny net on hikey970()'s synthetic time matrix, and 16 seeded images."""
    from repro_torch.core import LayerTimePredictor, hikey970
    from repro_torch.core.calibration import synthetic_model

    g = _tiny()
    plat = hikey970()
    T = LayerTimePredictor(model=synthetic_model(), platform=plat).time_matrix(g.descriptors())
    rng = np.random.default_rng(9)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(16)]
    return g, plat, T, images


def _static_outputs(g, plat, T, images):
    server = serve(g, backend="cuda_fused", batch_size=4, seed=1, platform=plat, time_matrix=T)
    try:
        return server.params, [o.cpu() for o in server.run(images)["outputs"]]
    finally:
        server.stop()


def test_adaptive_loop_swaps_after_a_drift_with_the_static_bits(cuda):
    """serve(adaptive=True) on cuda_fused behind the delayed builder (the
    delay a sleep kernel on the stage's stream): a hand-stepped monitor
    hot-swaps after the Big cluster's truth slows 2x, the new epoch's
    graphs replay 3 conv and 2 fc launches a micro-batch, and every output
    keeps a static server's bits."""
    from repro_torch.serving import AdaptiveConfig, DriftingMatrix, delayed_stage_fn_builder

    g, plat, T, images = _hikey_tiny()
    params, want = _static_outputs(g, plat, T, images)
    truth = DriftingMatrix(T)
    cfg = AdaptiveConfig(alpha=0.5, threshold=0.3, patience=1, min_gain=1.02,
                         interval_s=3600.0, min_items=8)  # the thread never steps
    server = serve(g, backend="cuda_fused", batch_size=4, params=params, platform=plat,
                   time_matrix=T, adaptive=True, adaptive_config=cfg,
                   stage_fn_builder=delayed_stage_fn_builder(truth, scale=200.0, backend="cuda_fused"))
    monitor, outs = server.monitor, []
    try:
        outs += server.run(images)["outputs"]
        monitor.step()  # absorbs the static bias (compute atop the delays)
        base = monitor.controller.swaps
        truth.scale("B", 2.0)
        for _ in range(6):
            outs += server.run(images)["outputs"]
            if monitor.step() is not None:
                break
        swaps, plan = monitor.controller.swaps, monitor.controller.plan
        K.reset_launches()
        outs += server.run(images)["outputs"]
        batches = server.metrics.stages[0].snapshot()["batches"]
        counts = K.launch_counts()
    finally:
        server.stop()
    history = [(e.round, e.old_plan.notation(), e.new_plan.notation(), e.predicted_gain, e.swapped)
               for e in monitor.controller.history]
    assert swaps > base and server.plan == plan and server.epoch >= 1, history
    assert monitor.error is None
    assert counts["conv2d_fused"] == 3 * batches and counts["matmul_fused"] == 2 * batches
    for i, o in enumerate(outs):
        assert torch.equal(o.cpu(), want[i % len(images)]), i


def test_governor_throttle_swaps_with_zero_drops(cuda):
    """serve(power_cap_w=...) on cuda_fused: a throttle mid-stream moves
    to the capped plan (another allocation, re-captured) with its clocks,
    no ticket is lost and every output keeps a static server's bits."""
    from repro_torch.core import power_aware_search

    g, plat, T, images = _hikey_tiny()
    params, want = _static_outputs(g, plat, T, images)
    envelope = plat.max_power_w()
    cap0, cap1 = 1.05 * envelope, 0.5 * envelope
    n = len(T)
    p0 = power_aware_search(n, plat, T, mode="best", power_cap_w=cap0)
    p1 = power_aware_search(n, plat, T, mode="best", power_cap_w=cap1)
    assert p1.plan != p0.plan  # the throttle must force a hot swap
    server = serve(g, backend="cuda_fused", batch_size=4, params=params, platform=plat,
                   time_matrix=T, power_cap_w=cap0)
    tickets = []

    def feed():
        for i in range(64):
            tickets.append((i, server.submit(images[i % len(images)])))

    try:
        assert server.plan == p0.plan
        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        while len(tickets) < 16 and feeder.is_alive():
            time.sleep(0.001)
        got = server.governor.throttle(cap1)
        feeder.join(timeout=120)
        outs = [(i, t.result(timeout=120).cpu()) for i, t in tickets]
    finally:
        server.stop()
    assert len(outs) == 64
    assert server.epoch == 1 and server.plan == p1.plan and got.plan == p1.plan
    assert server.governor.stage_freqs == p1.stage_freqs
    for i, o in outs:
        assert torch.equal(o, want[i % len(images)]), i


def test_device_delay_follows_truth_after_the_capture(cuda):
    """The delayed builder's delay runs after the stage's graph replay, not
    inside it: scaling ``truth`` after the capture changes the next
    replayed call's time by the scripted amount."""
    from repro_torch.core import pipe_it_search
    from repro_torch.core.pipeline import stage_time
    from repro_torch.serving import DriftingMatrix, delayed_stage_fn_builder

    g, plat, T, images = _hikey_tiny()
    plan = pipe_it_search(len(T), plat, T, mode="best")
    layers, stage = tuple(plan.allocation[0]), plan.pipeline.stages[0]
    scale = 0.02 / stage_time(T, layers, stage)  # stage 0 sleeps 20 ms a call
    truth = DriftingMatrix(T)
    fn = delayed_stage_fn_builder(truth, scale=scale, backend="cuda_fused")(g, plan)[0]
    params = g.init(seed=1, device="cuda")
    x = torch.from_numpy(np.concatenate(images[:4])).cuda()

    def call():
        t0 = time.perf_counter()
        out = fn(params, {"input": x})
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    call()  # eager, then the capture
    runtime.reset_launches()
    times, outs = [], []
    for drift in (None, None, 3.0, None):
        if drift is not None:
            truth.scale(stage[0], drift)
        dt, out = call()
        times.append(dt)
        outs.append(out)
    assert runtime.graph_launches() == 4  # every timed call replayed the one capture
    assert 0.018 < min(times[:2]) < 0.03
    assert 0.055 < min(times[2:]) < 0.07  # 3x the delay, replay unchanged
    for out in outs[1:]:
        assert all(torch.equal(out[k], outs[0][k]) for k in out)


def test_swaps_free_the_old_epochs_graph_pools(cuda):
    """Alternating hot swaps on a graph server: the reserved memory after
    the last of six is no higher than after the first plus one epoch's
    (the server's startup warm-up and capture), so old epochs' graphs and
    their pools are given back (at the next capture)."""
    g, plan, params = _tiny_plan("cuda_fused")
    n = sum(len(a) for a in plan.allocation)
    one_stage = PipelinePlan(pipeline=Pipeline(stages=(plan.pipeline.stages[0],)),
                             allocation=(tuple(range(n)),))
    images = [np.zeros((1, 16, 16, 3), np.float32)] * 8
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    server = PipelineServer(g, params, plan, batch_size=64, backend="cuda_fused")
    server.warmup()
    torch.cuda.synchronize()
    epoch_bytes = torch.cuda.memory_reserved() - before
    reserved = []
    try:
        with server:
            for new_plan in (one_stage, plan) * 3:
                server.swap_plan(new_plan)
                server.run(images)
                torch.cuda.synchronize()
                reserved.append(torch.cuda.memory_reserved())
    finally:
        server.stop()
    assert epoch_bytes > 0
    assert reserved[-1] <= reserved[0] + epoch_bytes, (reserved, epoch_bytes)


# ------------------------------------------------- multi-model co-serving
def _tiny2():
    """A second co-resident net: other widths, a 1x1 conv, a global pool
    and one fc (4 conv + 1 dense launches a micro-batch)."""
    g = Graph("tiny2", (16, 16, 3))
    a = g.conv("c1", "input", 12, 3)
    a = g.conv("c2", a, 12, 3, stride=2)
    a = g.conv("c3", a, 24, 1)
    a = g.pool_max("p1", a, 2, 2)
    a = g.conv("c4", a, 24, 3)
    a = g.gap("gap", a)
    a = g.fc("fc", a, 10)
    g.softmax("sm", a)
    return g


# launches a micro-batch of each co-served tiny net on cuda_fused
_PER_BATCH = {"a": (3, 2), "b": (4, 1)}


def _duo(cuda, **kw):
    """The two tiny nets (seeded weights on the card), two partitions of
    ``hikey970()`` whose plans differ, and a server on the first."""
    from repro_torch.core import hikey970, partition_search

    reg = ModelRegistry()
    reg.add("a", _tiny(), seed=1)
    reg.add("b", _tiny2(), seed=2)
    Ts = AutoPlanner(platform=hikey970()).time_matrices(reg.graphs())
    part1 = partition_search(Ts, hikey970(), weights={"a": 5.0, "b": 1.0})
    part2 = partition_search(Ts, hikey970(), weights={"a": 1.0, "b": 5.0})
    assert part1.plans() != part2.plans()
    mm = MultiModelServer(reg, part1, backend="cuda_fused", **kw)
    return reg, part1, part2, mm


def _single(reg, images):
    return {n: [o.cpu() for o in SingleStageEngine(reg[n].graph, reg[n].params, backend="cuda_fused")
                .run(images)["outputs"]] for n in reg.names}


def test_coserved_graphs_keep_single_stage_bits_across_a_partition_swap(cuda):
    """Two nets co-served on cuda_fused graphs at micro-batch 4: while a
    thread submits to both, swap_partition moves each model's plan; every
    ticket resolves with its single-stage bits, and after the swap each
    micro-batch replays its model's kernels and one graph per stage."""
    reg, part1, part2, mm = _duo(cuda, batch_size=4, queue_depth=4)
    rng = np.random.default_rng(8)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(48)]
    want = _single(reg, images)
    mm.warmup()
    tickets = []

    def feed():
        for i, img in enumerate(images):
            for n in reg.names:
                tickets.append((n, i, mm.submit(n, img, timeout=120.0)))

    try:
        with mm:
            feeder = threading.Thread(target=feed, daemon=True)
            feeder.start()
            while len(tickets) < len(images) // 2 and feeder.is_alive():
                time.sleep(0.001)
            mm.swap_partition(part2)
            feeder.join(timeout=300.0)
            assert not feeder.is_alive()
            for n, i, t in tickets:
                assert torch.equal(t.result(timeout=300.0).cpu(), want[n][i]), (n, i)
            assert len(tickets) == 2 * len(images) and mm.partition_epoch == 1
            assert all(mm.servers[n].plan == part2[n].plan for n in reg.names)
            b0 = {n: mm.servers[n].metrics.stages[0].snapshot()["batches"] for n in reg.names}
            K.reset_launches()
            res = mm.run({n: images for n in reg.names}, timeout=300.0)
            batches = {n: mm.servers[n].metrics.stages[0].snapshot()["batches"] - b0[n] for n in reg.names}
            counts, graph_launches = K.launch_counts(), runtime.graph_launches()
    finally:
        mm.stop()
    for n in reg.names:
        assert all(torch.equal(a.cpu(), b) for a, b in zip(res["outputs"][n], want[n]))
    assert counts["conv2d_fused"] == sum(_PER_BATCH[n][0] * batches[n] for n in reg.names)
    assert counts["matmul_fused"] == sum(_PER_BATCH[n][1] * batches[n] for n in reg.names)
    assert graph_launches == sum(len(part2[n].plan.allocation) * batches[n] for n in reg.names)


def test_router_flood_on_one_model_sheds_only_its_tickets(cuda):
    """A flood of non-blocking submits to one model past its in-flight
    bound sheds that model's tickets only: the other model, fed at the
    same time, is admitted in full, and every admitted ticket keeps its
    single-stage bits."""
    reg, part1, _, mm = _duo(cuda, batch_size=4, flush_timeout_s=0.05, max_inflight={"a": 2})
    rng = np.random.default_rng(9)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(200)]
    want = _single(reg, images[:16])
    mm.warmup()
    admitted, shed, b_tickets = [], 0, []

    def feed_b():
        for i in range(16):
            b_tickets.append((i, mm.submit("b", images[i], timeout=120.0)))

    try:
        with mm:
            feeder = threading.Thread(target=feed_b, daemon=True)
            feeder.start()
            for i, img in enumerate(images):
                try:
                    admitted.append((i, mm.submit("a", img, block=False)))
                except AdmissionError:
                    shed += 1
            feeder.join(timeout=300.0)
            assert not feeder.is_alive()
            outs_a = [(i, t.result(timeout=300.0).cpu()) for i, t in admitted]
            outs_b = [(i, t.result(timeout=300.0).cpu()) for i, t in b_tickets]
    finally:
        mm.stop()
    assert shed > 0 and len(admitted) + shed == len(images)
    assert mm.router.rejected("a") == shed and mm.router.admitted("a") == len(admitted)
    assert mm.router.rejected("b") == 0 and mm.router.admitted("b") == 16
    single_a = SingleStageEngine(reg["a"].graph, reg["a"].params, backend="cuda_fused")
    got_a = single_a.run([images[i] for i, _ in outs_a])["outputs"]
    assert all(torch.equal(o, w.cpu()) for (_, o), w in zip(outs_a, got_a))
    assert all(torch.equal(o, want["b"][i]) for i, o in outs_b)


# ------------------------------------------------- open-loop load and the fleet
def test_open_loop_run_completes_every_admitted_ticket_with_single_stage_bits(cuda):
    """``run_open_loop`` paces a Poisson trace into a graph server at
    micro-batch 4 (batches fill or leave on the flush timeout): every
    submitted ticket completes, bitwise equal to the single-stage engine
    on its image, as phase 4's served outputs are."""
    g = _tiny()
    rng = np.random.default_rng(10)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(8)]
    index = {id(x): i for i, x in enumerate(images)}
    server = serve(g, backend="cuda_fused", batch_size=4, queue_depth=16, seed=3)
    tickets = []

    class Recording:
        def ingress_depth(self):
            return server.ingress_depth()

        def set_batching(self, **kw):
            server.set_batching(**kw)

        def submit(self, image, *, block=True):
            ticket = server.submit(image, block=block)
            tickets.append((index[id(image)], ticket))
            return ticket

    try:
        report = run_open_loop(Recording(), poisson_trace(400.0, n=96, seed=2), images,
                               result_timeout_s=120.0)
    finally:
        server.stop()
    assert report.shed_admission == 0
    assert report.submitted == report.completed == len(tickets) == 96 - report.shed_backpressure
    assert report.shed_backpressure == 0
    single = SingleStageEngine(g, server.params, backend="cuda_fused").run(images)["outputs"]
    for i, t in tickets:
        assert torch.equal(t.result(timeout=0).cpu(), single[i].cpu())


def test_fleet_of_graph_boards_keeps_single_stage_bits_across_board_loss(cuda, monkeypatch):
    """Two boards on one card, each co-serving both tiny nets on
    ``cuda_fused`` graphs at micro-batch 4: a board fails while traffic
    flows and rejoins (its rebuilt server captures while the other board
    replays).  No ticket is lost, failed or duplicated, every output keeps
    its single-stage bits, and no stage worker captures a graph: warm-up
    and rejoin capture before traffic reaches a board."""
    from repro_torch.core import BoardSpec, fleet_search, hikey970
    from repro_torch.kernels import graphs

    captured_on = []

    class Counting(graphs.Captured):
        def __init__(self, *a, **kw):
            captured_on.append(threading.current_thread().name)
            super().__init__(*a, **kw)

    monkeypatch.setattr(graphs, "Captured", Counting)
    reg = ModelRegistry()
    reg.add("a", _tiny(), seed=1)
    reg.add("b", _tiny2(), seed=2)
    boards = (BoardSpec("b0", hikey970()), BoardSpec("b1", hikey970()))
    Ts = AutoPlanner(platform=hikey970()).time_matrices(reg.graphs())
    fp = fleet_search(Ts, boards, replicas={"a": 2, "b": 2})
    rng = np.random.default_rng(11)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(24)]
    want = _single(reg, images)
    victim = FaultPlan.seeded_board_cycle(11, ["b0", "b1"]).events[0].board
    outs = []
    with FleetRouter(reg, fp, backend="cuda_fused", batch_size=4, boards=boards) as router:
        router.warmup()
        warm = len(captured_on)
        for _ in range(2):
            tickets = [(n, i, router.submit(n, img)) for i, img in enumerate(images[:12])
                       for n in reg.names]
            loss = threading.Thread(target=router.fail_board, args=(victim,), daemon=True)
            loss.start()
            tickets += [(n, i, router.submit(n, img)) for i, img in enumerate(images[12:], 12)
                        for n in reg.names]
            outs += [(n, i, t.result(timeout=300.0).cpu()) for n, i, t in tickets]
            loss.join(timeout=300.0)
            assert not loss.is_alive()
            router.rejoin_board(victim)
        snap = router.metrics()
    assert warm > 0 and not [t for t in captured_on if "-stage" in t], captured_on
    assert snap["failed"] == 0 and snap["completed"] == snap["submitted"] == len(outs)
    assert snap["boards"][victim]["alive"] and snap["boards"][victim]["generation"] == 4
    assert all(torch.equal(o, want[n][i]) for n, i, o in outs)


# ---------------------------------------------------------------- training
# per-leaf gradient bar on the card against the CPU, f32 (TF32 off): the
# same sums in other orders through two layers; xLSTM's is wider, since a
# random-weight xLSTM is chaotic in f32 (the reference's own f32
# gradients lie 2.6e-4 of a leaf's scale from its float64 ones;
# tests/test_torch_train_recurrent.py)
TRAIN_GRAD_TOL = {"smollm-360m": 1e-4, "olmoe-1b-7b": 1e-4, "hymba-1.5b": 1e-4, "xlstm-1.3b": 1e-3}


def _train_batch(cfg, dev, b=4, s=32):
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)))
    return {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}


@pytest.mark.parametrize("arch", list(TRAIN_GRAD_TOL))
def test_reduced_models_train_one_f32_step_on_the_card_as_on_the_cpu(cuda, arch):
    """A reduced config of each block kind (dense, MoE, Hymba, xLSTM) in
    f32 on the same weights and batch: the loss, every gradient (within
    its leaf's bar of the leaf's scale) and one train step's loss and
    grad norm on the card equal the CPU's; the step launches no counted
    kernel."""
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import params_from_numpy, params_to_numpy
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32", grad_accum=1)
    tree = params_to_numpy(cfg, init_params(cfg, seed=0, device="cpu"))
    out = {}
    for dev in ("cpu", cuda):
        model = params_from_numpy(cfg, tree, device=dev)
        batch = _train_batch(cfg, dev)
        loss, _, grads = loss_and_grads(cfg, model, batch)
        K.reset_launches()
        _, opt, metrics = make_train_step(cfg, warmup=0)(model, adamw_init(dict(model.named_parameters())), batch)
        assert all(n == 0 for n in K.launch_counts().values())
        out[str(dev)] = (float(loss), {k: g.cpu() for k, g in grads.items()},
                         float(metrics["loss"]), float(metrics["grad_norm"]))
    (l0, g0, m0, n0), (l1, g1, m1, n1) = out["cpu"], out["cuda"]
    assert l1 == pytest.approx(l0, rel=1e-5) and m1 == pytest.approx(m0, rel=1e-5)
    assert n1 == pytest.approx(n0, rel=TRAIN_GRAD_TOL[arch])
    for k, g in g0.items():
        scale = float(g.abs().max())
        assert float((g1[k] - g).abs().max()) <= TRAIN_GRAD_TOL[arch] * max(scale, 1e-30), k


def test_kernel_routes_raise_under_autograd(cuda):
    """B6 and B5 on their kernel route (``backend=None``, CUDA tensors)
    raise when autograd records, rather than return an output with no
    gradient; without gradients they launch, and ``backend="torch"``
    differentiates."""
    rng = np.random.default_rng(0)
    x, log_a = _on(cuda, rng, 1, 64, 2, 64), -_on(cuda, rng, 1, 64, 2).abs()
    bm, cm = _on(cuda, rng, 1, 64, 2, 16), _on(cuda, rng, 1, 64, 2, 16)
    xg = x.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd(xg, log_a, bm, cm)
    with torch.no_grad():
        ops.ssd(xg, log_a, bm, cm)
    y, _ = ops.ssd(xg, log_a, bm, cm, backend="torch")
    assert y.grad_fn is not None
    q = _on(cuda, rng, 2, 2, 3, 64).requires_grad_()
    k, v = _on(cuda, rng, 2, 40, 2, 64), _on(cuda, rng, 2, 40, 2, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_decode(q, k, v, 33)
    with torch.no_grad():
        ops.flash_decode(q, k, v, 33)
    assert ops.flash_decode(q, k, v, 33, backend="torch").grad_fn is not None


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A model's parameters on the card saved and restored into a fresh
    model on the card, bitwise; a bf16 tensor on the card comes back bf16
    on the card."""
    from repro_torch.checkpoint import restore, save_checkpoint
    from repro_torch.models import params_from_numpy, params_to_numpy

    cfg = get_config("olmoe-1b-7b").reduced()
    model = init_params(cfg, seed=3, device=cuda)
    half = torch.randn(5, 7, device=cuda).to(torch.bfloat16)
    tree = {"params": params_to_numpy(cfg, model), "half": half}
    save_checkpoint(str(tmp_path), 1, tree)
    got = restore(str(tmp_path), {"params": tree["params"], "half": torch.zeros_like(half)})
    fresh = params_from_numpy(cfg, got["params"], device=cuda)
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), fresh.parameters()))
    assert got["half"].device.type == "cuda" and got["half"].dtype == torch.bfloat16
    assert torch.equal(got["half"], half)


def test_captured_decode_step_serves_the_trained_weights(cuda):
    """A decode step captured as a CUDA graph before a train step replays
    after it with the new weights (the blocks' bf16 copy is refreshed in
    place): its logits equal a fresh model's, loaded with the trained
    weights, op by op."""
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.models import init_cache, params_from_numpy, params_to_numpy, prefill, serve_step
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), grad_accum=1)
    model = init_params(cfg, seed=0, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (4, 17), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    step = make_serve_step(cfg)
    caches = init_cache(cfg, 4, 17, device=cuda)
    prefill(cfg, model, {"tokens": prompt[:, :16]}, caches)
    before = step(model, caches, prompt[:, 16:], 16)  # eager, then captured
    make_train_step(cfg, warmup=0)(model, adamw_init(dict(model.named_parameters())), _train_batch(cfg, cuda))
    prefill(cfg, model, {"tokens": prompt[:, :16]}, caches)
    graphs_before = runtime.graph_launches()
    after = step(model, caches, prompt[:, 16:], 16)
    assert runtime.graph_launches() == graphs_before + 1  # a replay of the old capture
    fresh = params_from_numpy(cfg, params_to_numpy(cfg, model), device=cuda)
    fc = init_cache(cfg, 4, 17, device=cuda)
    prefill(cfg, fresh, {"tokens": prompt[:, :16]}, fc)
    want = serve_step(cfg, fresh, fc, prompt[:, 16:], 16)
    assert torch.equal(after, want) and not torch.equal(after, before)


@pytest.mark.parametrize("arch", ["starcoder2-15b", "deepseek-moe-16b", "moonshot-v1-16b-a3b"])
def test_serving_form_on_the_card_holds_what_meta_counts_and_serves_the_same_bits(cuda, arch):
    """A reduced model in the serving form: its load allocates the bytes
    counted on ``meta`` (up to the allocator's rounding: 512 bytes a
    tensor of up to 1 MiB, 1 MiB a larger one), its init holds at most one
    f32 block above them, and its
    decode, captured and replayed, gives the two-copy form's tokens and
    logits bit for bit, with one B5 launch an attention layer a step."""
    from repro_torch.models import abstract_params

    cfg = get_config(arch).reduced()
    shape = abstract_params(cfg, serving=True)
    counted = sum(p.numel() * p.element_size() for p in shape.parameters())
    f32_block = max(4 * sum(p.numel() for p in blk.parameters()) for grp in shape.groups for blk in grp)
    slack = sum(512 if p.numel() * 4 <= 1 << 20 else 1 << 20 for p in shape.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    serving = init_params(cfg, seed=0, device=cuda, serving=True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda) - before
    assert 0 <= held - counted <= slack, (held, counted)
    assert torch.cuda.max_memory_allocated(cuda) - before <= counted + f32_block + 2 * slack
    prompt = torch.randint(0, cfg.vocab_size, (4, 40), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    want = generate(cfg, init_params(cfg, seed=0, device=cuda), prompt, 6, keep_logits=6)
    per_step = []

    def hook(phase, i):
        per_step.append((phase, K.launch_counts()["flash_decode"], runtime.graph_launches()))
        K.reset_launches()

    K.reset_launches()
    got = generate(cfg, serving, prompt, 6, keep_logits=6, step_hook=hook)
    assert torch.equal(got["tokens"], want["tokens"]) and torch.equal(got["last_hidden"], want["last_hidden"])
    assert all(torch.equal(a, b) for a, b in zip(got["logits"], want["logits"]))
    assert per_step == [("prefill", 0, 0)] + [("decode", cfg.n_layers, 0 if i == 0 else 1) for i in range(6)]
