"""The port's fused conv and dense kernels against the JAX package's.

On the CPU the port's wrappers take their plain PyTorch versions, which
must match the reference's Pallas kernels run in interpret mode (the way
the reference's own tests run them off-TPU).  The CUDA kernels themselves
run only on a card: tests/test_torch_gpu.py holds them against these
plain versions there.

Tolerance: ``RTOL, ATOL = 1e-4, 1e-5``, the reference's own bar
(tests/test_conv_fused.py): both sides accumulate in f32 but in different
orders, and at these small K the reordering error stays below 1e-6.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels.conv_fused import conv2d_fused as ref_conv2d_fused
from repro.kernels.conv_fused import matmul_fused as ref_matmul_fused
from repro_torch.kernels import conv_fused as K
from repro_torch.kernels.backend import BACKENDS, KernelBackend, finish_act, resolve_backend

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# (B, H, W, C, F, Cout, stride, pad, relu)
CONV_CASES = [
    (1, 8, 8, 3, 3, 5, 1, 1, True),  # C=3, the first conv of every net
    (2, 9, 7, 4, 3, 6, 2, 0, False),  # stride 2, odd Ow
    (1, 13, 13, 5, 5, 7, 4, 2, True),  # stride 4, pad 2
    (1, 6, 6, 8, 1, 4, 1, 0, False),  # 1x1: the GEMM special case
    (1, 7, 7, 3, 1, 4, 2, 0, True),  # strided 1x1
    (1, 15, 15, 3, 11, 4, 4, 0, True),  # AlexNet conv1 geometry, small
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_fused_route_ref_matches_reference_kernel(case):
    b, h, w, c, f, cout, stride, pad, relu = case
    rng = np.random.default_rng(sum(case))
    x, wt, bias = _np(rng, b, h, w, c), _np(rng, f, f, c, cout, scale=0.3), _np(rng, cout)
    ref = np.asarray(
        ref_conv2d_fused(x, wt, bias, stride=stride, pad=pad, relu=relu, interpret=True)
    )
    before = K.launch_counts()
    ours = K.conv2d_fused(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias),
        stride=stride, pad=pad, relu=relu,
    )
    assert K.launch_counts() == before  # the CPU route launches nothing
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
    plain = K.fused_route_ref(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias),
        stride=stride, pad=pad, relu=relu,
    )
    assert torch.equal(plain, ours)


# (M, K, N, relu, blocks): blocks force several K steps in the reference
MM_CASES = [
    (4, 40, 24, True, dict(block_k=16)),
    (3, 17, 10, False, {}),
    (1, 256, 130, True, dict(block_k=128, block_n=64)),
]


@pytest.mark.parametrize("case", MM_CASES, ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}")
def test_matmul_fused_ref_matches_reference_kernel(case):
    m, k, n, relu, blocks = case
    rng = np.random.default_rng(m * k + n)
    a, w, bias = _np(rng, m, k), _np(rng, k, n, scale=k ** -0.5), _np(rng, n)
    ref = np.asarray(ref_matmul_fused(a, w, bias, relu=relu, interpret=True, **blocks))
    ours = K.matmul_fused(
        torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(bias), relu=relu
    )
    np.testing.assert_allclose(ours.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(
        ours,
        K.matmul_fused_ref(torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(bias), relu=relu),
    )


# -------------------------------------------------------------- backend
def test_backend_routes_and_records_fallbacks():
    assert BACKENDS == ("torch", "cuda", "cuda_fused")
    with pytest.raises(ValueError):
        KernelBackend(spec="pallas_fused")
    kb = resolve_backend({"c1": "cuda_fused"})
    assert kb.for_node("c1") == "cuda_fused" and kb.for_node("c2") == "torch"
    assert resolve_backend(kb) is kb and resolve_backend(None) is None
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_np(rng, 1, 6, 6, 4))
    wg = torch.from_numpy(_np(rng, 3, 3, 2, 4))
    fused = KernelBackend(spec="cuda_fused")
    y, done = fused.conv2d("g", x, wg, None, pad=1, groups=2, relu=True)
    assert done and fused.fallbacks == {"g": "groups=2"}
    y_t, done_t = KernelBackend().conv2d("g", x, wg, None, pad=1, groups=2)
    assert not done_t
    np.testing.assert_allclose(y.numpy(), finish_act((y_t, done_t)).numpy(), rtol=RTOL, atol=ATOL)
    wd = torch.from_numpy(_np(rng, 3, 3, 1, 4))
    yd, _ = fused.depthwise("d", x, wd, None, pad=1, relu=True)
    assert fused.fallbacks["d"] == "depthwise"
    yd_t = finish_act(KernelBackend().depthwise("d", x, wd, None, pad=1))
    np.testing.assert_allclose(yd.numpy(), yd_t.numpy(), rtol=RTOL, atol=ATOL)


def test_dense_flattens_nhwc_on_both_routes():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_np(rng, 2, 3, 3, 4))
    w = torch.from_numpy(_np(rng, 36, 5))
    b = torch.from_numpy(_np(rng, 5))
    expect = torch.relu(x.reshape(2, -1) @ w + b)
    y_f = finish_act(KernelBackend(spec="cuda_fused").dense("f", x, w, b, relu=True))
    y_t = finish_act(KernelBackend(spec="torch").dense("f", x, w, b, relu=True))
    np.testing.assert_allclose(y_f.numpy(), expect.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y_t.numpy(), expect.numpy(), rtol=1e-6, atol=1e-6)
