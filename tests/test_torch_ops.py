"""The port's unfused conv-as-GEMM route against the JAX package's.

On the CPU, ``ops.gemm`` (B3) and ``ops.im2col`` (B4) take their plain
PyTorch versions, which must match the reference's Pallas kernels run in
interpret mode; the CUDA kernels themselves run only on a card
(tests/test_torch_gpu.py).  The ``"cuda"`` backend route and the
restored ``gemm_fn`` injection point of ``Graph.apply`` are held to the
reference's ``"pallas"`` route and ``gemm_fn`` on the same weights.

Tolerances: the GEMM ``RTOL, ATOL = 1e-4, 1e-5``, the reference's bar
(tests/test_conv_fused.py), for f32 sums taken in another order; the
patch matrix is a copy, so it is held exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.graph import Graph as RefGraph
from repro.cnn.layers import conv2d as ref_conv2d
from repro.kernels.backend import KernelBackend as RefKernelBackend
from repro.kernels.gemm import gemm as ref_gemm
from repro.kernels.im2col import im2col as ref_im2col
from repro_torch.cnn import layers as L
from repro_torch.cnn.graph import Graph
from repro_torch.cnn.params import params_from_numpy
from repro_torch.kernels import gemm as G
from repro_torch.kernels import im2col as I
from repro_torch.kernels import ops, runtime
from repro_torch.kernels.backend import KernelBackend, finish_act

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------------- B3
# (M, K, N, block): none a multiple of its block, so every tile is ragged
GEMM_CASES = [(5, 7, 3, 8), (33, 70, 17, 16), (4, 300, 130, 64), (130, 27, 64, 32)]


@pytest.mark.parametrize("case", GEMM_CASES, ids=lambda c: "x".join(map(str, c)))
def test_gemm_plain_route_matches_reference_kernel(case):
    m, k, n, blk = case
    rng = np.random.default_rng(m * k + n)
    a, b = _np(rng, m, k), _np(rng, k, n, scale=k ** -0.5)
    want = np.asarray(ref_gemm(a, b, block_m=blk, block_n=blk, block_k=blk, interpret=True))
    before = runtime.launch_counts()
    got = ops.gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, G.gemm_ref(torch.from_numpy(a), torch.from_numpy(b)))


# B3's tensor-core order multiplies each f32 operand split into two TF32
# terms (csrc/gemm.cu::split_tf32, whose plain version is gemm.py's)
def _split_values(rng, n):
    """f32 values of every exponent from 2^-100 to 2^100, values TF32
    holds exactly, and rounding ties (low 13 bits 0x1000), both signs."""
    v = (rng.standard_normal(n) * 2.0 ** rng.integers(-100, 100, n)).astype(np.float32)
    kept = rng.integers(0, 1 << 10, n).astype(np.uint32) << 13
    expo = rng.integers(30, 220, n).astype(np.uint32) << 23
    exact, ties = (kept | expo).view(np.float32), (kept | 0x1000 | expo).view(np.float32)
    return {"spread": v, "tf32_exact": np.concatenate([exact, -exact]),
            "ties": np.concatenate([ties, -ties])}


def test_tf32_split_gives_the_f32_value_back_within_2_to_the_minus_22():
    """hi and lo are TF32 values (low 13 bits 0), v - hi is exact in f32,
    and hi + lo is v within 2^-22 |v|: 22 of v's 24 significant bits.
    A value TF32 holds is hi itself; a tie rounds away from zero."""
    rng = np.random.default_rng(34)
    for name, v in _split_values(rng, 50_000).items():
        hi, lo = (t.numpy() for t in G.split_tf32_ref(torch.from_numpy(v)))
        for t in (hi, lo):
            assert not (t.view(np.uint32) & 0x1FFF).any(), name
        v64, hi64, lo64 = v.astype(np.float64), hi.astype(np.float64), lo.astype(np.float64)
        np.testing.assert_array_equal((v - hi).astype(np.float64), v64 - hi64, err_msg=name)
        assert np.all(np.abs(v64 - hi64 - lo64) <= 2.0 ** -22 * np.abs(v64)), name
        assert np.all(np.abs(lo64) <= 2.0 ** -11 * (1 + 2.0 ** -10) * np.abs(v64)), name
        if name == "tf32_exact":
            np.testing.assert_array_equal(hi, v)
            assert not lo.any()
        if name == "ties":
            assert np.all(np.abs(hi64) > np.abs(v64))


def test_three_term_products_keep_the_product_within_3_times_2_to_the_minus_22():
    """lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), each product of two TF32
    values exact in f32, is a b within 3 x 2^-22 |a b| (the dropped lo(a)
    lo(b) and each operand's split error), summed exactly; the kernel sums
    them on the tensor cores and folds each 32-deep step by an f32 add."""
    rng = np.random.default_rng(35)
    a, b = ((rng.standard_normal(50_000) * 2.0 ** rng.integers(-50, 50, 50_000)).astype(np.float32)
            for _ in range(2))  # every product and term product a normal f32
    (ha, la), (hb, lb) = ((t.numpy().astype(np.float64) for t in G.split_tf32_ref(torch.from_numpy(x)))
                          for x in (a, b))
    for x, y in ((la, hb), (ha, lb), (ha, hb)):
        np.testing.assert_array_equal((x * y).astype(np.float32).astype(np.float64), x * y)
    exact = a.astype(np.float64) * b.astype(np.float64)
    kept = la * hb + ha * lb + ha * hb
    assert np.all(np.abs(exact - kept) <= 3.01 * 2.0 ** -22 * np.abs(exact))


# ------------------------------------------------------------------- B4
# (H, W, F, stride, pad), C = 3
IM2COL_CASES = [
    (7, 6, 3, 1, 0), (7, 6, 3, 1, 1), (9, 8, 3, 2, 1), (9, 9, 3, 2, 2),
    (13, 13, 5, 4, 2), (15, 15, 11, 4, 0), (6, 7, 1, 2, 0),
]


@pytest.mark.parametrize("case", IM2COL_CASES, ids=lambda c: "x".join(map(str, c)))
def test_im2col_plain_route_matches_reference_kernel_exactly(case):
    h, w, f, stride, pad = case
    rng = np.random.default_rng(sum(case))
    x = _np(rng, h, w, 3)
    want = np.asarray(ref_im2col(x, f, f, stride, pad, interpret=True))
    before = runtime.launch_counts()
    got = ops.im2col(torch.from_numpy(x), f, f, stride, pad)
    assert runtime.launch_counts() == before
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_im2col_stacks_the_images():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_np(rng, 3, 9, 8, 4))
    batched = ops.im2col_batched(x, 3, 3, 2, 1)
    oh, ow = I.out_hw(9, 8, 3, 3, 2, 1)
    assert tuple(batched.shape) == (3 * oh * ow, 36)
    per_image = torch.cat([ops.im2col(x[i], 3, 3, 2, 1) for i in range(3)])
    assert torch.equal(batched, per_image)


# -------------------------------------------------------- "cuda" route
@pytest.mark.parametrize("groups,stride,pad", [(1, 1, 1), (1, 2, 0), (2, 1, 1), (3, 2, 2)])
def test_cuda_route_conv_matches_reference_pallas_route(groups, stride, pad):
    rng = np.random.default_rng(groups * 10 + stride + pad)
    cin, cout = 3 * groups, 4 * groups
    x, w, b = _np(rng, 2, 9, 8, cin), _np(rng, 3, 3, cin // groups, cout, scale=0.3), _np(rng, cout)
    y_ref, done_ref = RefKernelBackend(spec="pallas").conv2d(
        "c", jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        stride=stride, pad=pad, groups=groups, relu=True,
    )
    kb = KernelBackend(spec="cuda")
    y, done = kb.conv2d(
        "c", torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        stride=stride, pad=pad, groups=groups, relu=True,
    )
    assert not done and not done_ref  # the ReLU is left to finish_act
    assert kb.fallbacks == {}
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=RTOL, atol=ATOL)
    # the same function as the plain route's layers
    want = L.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                    stride=stride, pad=pad, groups=groups)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_cuda_route_dense_and_depthwise():
    rng = np.random.default_rng(5)
    kb = KernelBackend(spec="cuda")
    x = torch.from_numpy(_np(rng, 2, 3, 3, 4))
    w, b = torch.from_numpy(_np(rng, 36, 5)), torch.from_numpy(_np(rng, 5))
    y = finish_act(kb.dense("f", x, w, b, relu=True))
    np.testing.assert_allclose(
        y.numpy(), torch.relu(x.reshape(2, -1) @ w + b).numpy(), rtol=1e-6, atol=1e-6
    )
    wd = torch.from_numpy(_np(rng, 3, 3, 1, 4))
    yd, done = kb.depthwise("d", x, wd, b[:4], pad=1, relu=True)
    assert not done and kb.fallbacks == {}
    assert torch.equal(yd, L.depthwise_conv2d(x, wd, b[:4], pad=1))


# ------------------------------------------------ Graph.apply(gemm_fn=...)
def _graph(G_):
    g = G_("gemmfn", (10, 10, 3))
    a = g.conv("c1", "input", 6, 3)
    a = g.conv("c2", a, 8, 3, stride=2)
    a = g.pool_max("p1", a, 2, 2)
    a = g.fc("fc1", a, 12, act="relu")
    a = g.fc("fc2", a, 5)
    g.softmax("sm", a)
    return g


def _numpy_gemm(calls, to_framework):
    """The same behaviour for both packages: an f64 product in numpy,
    scaled by 0.5, cast to f32; records each call's (M, K, N)."""

    def fn(a, b):
        a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
        calls.append((a64.shape[0], a64.shape[1], b64.shape[1]))
        return to_framework((0.5 * (a64 @ b64)).astype(np.float32))

    return fn


def test_graph_gemm_fn_matches_reference_and_wins_over_backend():
    ref_g, g = _graph(RefGraph), _graph(Graph)
    ref_params = ref_g.init(jax.random.PRNGKey(0))
    params = params_from_numpy(
        {n: {k: np.asarray(v) for k, v in p.items()} for n, p in ref_params.items()},
        device="cpu",
    )
    x = _np(np.random.default_rng(6), 2, 10, 10, 3)
    ref_calls, calls = [], []
    want = np.asarray(ref_g.apply(ref_params, jnp.asarray(x), gemm_fn=_numpy_gemm(ref_calls, jnp.asarray)))
    before = runtime.launch_counts()
    got = g.apply(
        params, torch.from_numpy(x), gemm_fn=_numpy_gemm(calls, torch.from_numpy),
        backend="cuda_fused",
    )
    assert runtime.launch_counts() == before
    assert calls == ref_calls == [(200, 27, 6), (50, 54, 8), (2, 32, 12), (2, 12, 5)]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    plain = g.apply(params, torch.from_numpy(x))
    assert not np.allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)


def test_conv_gemm_fn_runs_once_per_group():
    rng = np.random.default_rng(8)
    x, w = _np(rng, 1, 6, 6, 6), _np(rng, 3, 3, 2, 9)
    calls = []
    got = L.conv2d(torch.from_numpy(x), torch.from_numpy(w), None, pad=1, groups=3,
                   gemm_fn=_numpy_gemm(calls, torch.from_numpy))
    assert calls == [(36, 18, 3)] * 3
    want = np.asarray(ref_conv2d(x, w, None, pad=1, groups=3))
    np.testing.assert_allclose(got.numpy(), 0.5 * want, rtol=RTOL, atol=ATOL)
