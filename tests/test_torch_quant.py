"""The port's quantized path against the JAX package's.

``cnn/quant.py`` (QASYMM8 quantization, ``qgemm``) and the quantized
fused conv (``qconv2d_fused`` / ``qfused_route_ref``) on the CPU, where
``qconv2d_fused`` takes its plain version.  The int32 CUDA kernel itself
runs only on a card (tests/test_torch_gpu.py).

Tolerances: quantization is held exactly (``q`` and ``zp`` equal,
``scale`` bitwise): both packages round half to even in f32.  The
integer sums are exact on both sides, so ``qgemm`` and
``qfused_route_ref`` match the reference bitwise; the reference's Pallas
kernel in interpret mode and the patch-matrix route differ from them in
f32 rounding of the requant step, under the reference's bar
``RTOL, ATOL = 1e-4, 1e-5`` (tests/test_conv_fused.py).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import quant as RQ
from repro.kernels import conv_fused as RK
from repro_torch.cnn import layers as L
from repro_torch.cnn import quant as Q
from repro_torch.cnn.models import MODELS
from repro_torch.kernels import conv_fused as K
from repro_torch.kernels import runtime

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _same(ours: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert ours.numpy().dtype == ref.dtype and ours.numpy().shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)


# -------------------------------------------------------- quantization
@pytest.mark.parametrize("shape,axis", [((27, 5), -1), ((144, 16), -1), ((3, 7, 7, 4), None), ((9,), None), ((9,), -1)])
def test_quantize_tensor_matches_reference_exactly(shape, axis):
    rng = np.random.default_rng(len(shape) * 31 + shape[0])
    w = _np(rng, *shape, scale=0.3)
    q, s, z = Q.quantize_tensor(torch.from_numpy(w), axis=axis)
    rq, rs, rz = RQ.quantize_tensor(jnp.asarray(w), axis=axis)
    _same(q, rq)
    _same(s, rs)
    _same(z, rz)
    np.testing.assert_allclose(
        Q.dequantize(q, s, z).numpy(), np.asarray(RQ.dequantize(rq, rs, rz)), rtol=0, atol=0
    )


def test_quantize_tensor_all_positive_and_all_zero():
    w = np.abs(_np(np.random.default_rng(2), 6, 3)) + 0.5  # min clamps to 0
    for arr in (w, np.zeros((4, 3), np.float32)):  # zero range: scale 1
        ours = Q.quantize_tensor(torch.from_numpy(arr))
        ref = RQ.quantize_tensor(jnp.asarray(arr))
        for o, r in zip(ours, ref):
            _same(o, r)


def test_quantize_graph_params_matches_reference():
    rng = np.random.default_rng(4)
    shapes = {"conv": (3, 3, 5, 8), "conv1x1": (1, 1, 8, 6), "dw": (3, 3, 1, 6), "fc": (54, 10)}
    params = {
        n: {"w": torch.from_numpy(_np(rng, *s, scale=0.2)), "b": torch.from_numpy(_np(rng, s[-1]))}
        for n, s in shapes.items()
    }
    ours = Q.quantize_graph_params(params)
    ref = RQ.quantize_graph_params(
        {n: {k: jnp.asarray(v.numpy()) for k, v in p.items()} for n, p in params.items()}
    )
    assert set(ours) == set(ref)
    for name in ours:
        for key in ("qw", "scale", "zp", "b"):
            _same(ours[name][key], ref[name][key])
        assert ours[name]["shape"] == tuple(ref[name]["shape"])


@pytest.mark.parametrize("m,k,n", [(9, 27, 5), (4, 300, 13), (1, 64, 7)])
def test_qgemm_matches_reference_bitwise(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, w = _np(rng, m, k), _np(rng, k, n, scale=0.2)
    qw, s, z = Q.quantize_tensor(torch.from_numpy(w))
    ours = Q.qgemm(torch.from_numpy(a), qw, s, z)
    ref = RQ.qgemm(jnp.asarray(a), *RQ.quantize_tensor(jnp.asarray(w)))
    _same(ours, ref)
    gemm_fn = Q.make_quant_gemm_fn({"qw": qw, "scale": s, "zp": z})
    assert torch.equal(gemm_fn(torch.from_numpy(a), None), ours)


# ------------------------------------------------- quantized fused conv
# (B, H, W, C, F, Cout, stride, pad, relu)
QCONV_CASES = [
    (1, 8, 8, 3, 3, 5, 1, 1, True),
    (2, 9, 7, 4, 3, 6, 2, 0, False),
    (1, 13, 13, 5, 5, 7, 4, 2, True),
    (2, 6, 6, 8, 1, 4, 1, 0, False),
]


def _qcase(case):
    b, h, w, c, f, cout, stride, pad, relu = case
    rng = np.random.default_rng(sum(case))
    x, wt, bias = _np(rng, b, h, w, c), _np(rng, f, f, c, cout, scale=0.3), _np(rng, cout)
    ref_qp = RQ.quantize_graph_params({"l": {"w": jnp.asarray(wt), "b": jnp.asarray(bias)}})["l"]
    qp = Q.quantize_graph_params({"l": {"w": torch.from_numpy(wt), "b": torch.from_numpy(bias)}})["l"]
    return x, ref_qp, qp, dict(stride=stride, pad=pad, relu=relu)


@pytest.mark.parametrize("case", QCONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_qfused_routes_match_reference(case):
    x, ref_qp, qp, kw = _qcase(case)
    args = (qp["qw"], qp["scale"], qp["zp"], qp["b"], qp["shape"])
    ref_args = (ref_qp["qw"], ref_qp["scale"], ref_qp["zp"], ref_qp["b"], ref_qp["shape"])
    plain = K.qfused_route_ref(torch.from_numpy(x), *args, **kw)
    _same(plain, RK.qfused_route_ref(jnp.asarray(x), *ref_args, **kw))
    before = runtime.launch_counts()
    routed = K.qconv2d_fused(torch.from_numpy(x), *args, **kw)
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    assert torch.equal(routed, plain)
    ref_kernel = RK.qconv2d_fused(jnp.asarray(x), *ref_args, interpret=True, **kw)
    np.testing.assert_allclose(routed.numpy(), np.asarray(ref_kernel), rtol=RTOL, atol=ATOL)


def test_make_quant_conv_fn_routes_match():
    x, _, qp, kw = _qcase(QCONV_CASES[0])
    kw.pop("relu")
    by_kernel = Q.make_quant_conv_fn(qp, relu=True, kernel=True, **kw)(torch.from_numpy(x))
    plain = Q.make_quant_conv_fn(qp, relu=True, **kw)(torch.from_numpy(x))
    assert torch.equal(by_kernel, plain)
    assert bool((plain >= 0).all())


def _conv_descriptors(net):
    return [d for d in MODELS[net]().descriptors() if d.kind == "conv" and d.groups == 1]


def _covered_size(n: int, f: int, stride: int, pad: int) -> int:
    """The largest size <= min(n, 12) whose every row some output window
    reads.  The two routes quantize activations per tensor, the fused one
    over the input and the patch-matrix one over the patch matrix, so they
    agree only where the patch matrix holds every input pixel (a 1x1
    stride-2 conv reads one pixel in four, and reads all of a 1x1 input)."""
    for h in range(min(n, 12), 0, -1):
        oh = (h + 2 * pad - f) // stride + 1
        rows = {o * stride - pad + i for o in range(max(oh, 0)) for i in range(f)}
        if oh >= 1 and set(range(h)) <= rows:
            return h
    raise AssertionError(f"no covered size for {f}x{f}/s{stride}/p{pad}")


@pytest.mark.parametrize("net", sorted(MODELS))
def test_quantized_fused_route_matches_qgemm_all_conv_nodes(net):
    """For every distinct groups == 1 conv geometry of the net, the fused
    quant route (int32 direct conv + merged-scale epilogue) matches the
    patch-matrix route (im2col + qgemm).  Spatial dims are capped at 12
    and cut to a size whose pixels the patch matrix all holds: the quant
    math is per element, so equivalence there is equivalence at full size
    for the same descriptor wherever both routes see the same values."""
    rng = np.random.default_rng(3)
    seen = set()
    for d in _conv_descriptors(net):
        geo = (d.i_h, d.i_w, d.i_d, d.f_h, d.stride, d.pad, d.ofm)
        if geo in seen:
            continue
        seen.add(geo)
        h = _covered_size(d.i_h, d.f_h, d.stride, d.pad)
        wd = _covered_size(d.i_w, d.f_w, d.stride, d.pad)
        x = torch.from_numpy(_np(rng, 1, h, wd, d.i_d))
        w = torch.from_numpy(_np(rng, d.f_h, d.f_w, d.i_d, d.ofm, scale=0.1))
        b = torch.from_numpy(_np(rng, d.ofm))
        qp = Q.quantize_graph_params({"l": {"w": w, "b": b}})["l"]
        got = K.qfused_route_ref(
            x, qp["qw"], qp["scale"], qp["zp"], b, qp["shape"], stride=d.stride, pad=d.pad
        )
        cols = L.im2col(x, d.f_h, d.f_w, d.stride, d.pad)
        want = Q.qgemm(cols.reshape(-1, cols.shape[-1]), qp["qw"], qp["scale"], qp["zp"])
        want = want.reshape(got.shape) + b
        np.testing.assert_allclose(
            got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{net}:{d.name}"
        )
    assert seen


def test_int32_accumulator_cannot_overflow_on_any_conv():
    """Shifted operands lie in [-255, 255], so |acc| <= K * 255**2; the
    largest K over the six nets (3*3*512) keeps that under 2**31 (the
    int32 kernel) and far under 2**53 (the float64 plain version)."""
    ks = [d.f_h * d.f_w * d.i_d for net in MODELS for d in _conv_descriptors(net)]
    assert max(ks) == 3 * 3 * 512
    assert max(ks) * 255 * 255 < 2 ** 31 - 1
    assert max(ks) * 255 * 255 < 2 ** 53


def test_int32_accumulator_is_exact_at_the_extremes():
    """The plain version's float64 integer conv at the largest K with
    every product at +-255**2: it must round back to the exact int32."""
    xq = torch.full((1, 3, 3, 512), 255, dtype=torch.int32)
    wq = torch.full((3, 3, 512, 2), -255, dtype=torch.int32)
    wq[..., 1] = 255
    acc = K._int_conv(xq, wq, 1, 0)
    assert acc.dtype == torch.int32
    assert acc.flatten().tolist() == [-4608 * 255 * 255, 4608 * 255 * 255]


# ------------------------------------- the u8 tensor-core form of B1q
BK = 64  # bytes of k the kernel stages a step (csrc/conv_fused.cu)


def _u8_identity_conv(qa, za, wt, colsum, zw, w_shape, stride, pad, pad_value=None):
    """The int32 sum of ``csrc/conv_fused.cu``'s ``qconv_u8``, in int64:
    the unshifted u8 operands multiplied, then corrected by the zero points,

        sum_k (qa - za)(qw - zw) = sum_k qa qw - zw sum_k qa - za sum_k qw + K za zw.

    A tap in the spatial padding holds ``za`` (not 0); a k past the real K,
    up to the kernel's last k-step, is 0 on both operands; the row sums
    come from the operands as staged, the column sums from
    ``packed_weights``, and K is the real K.  ``pad_value`` replaces ``za``
    in the padding only, to show what a zero-filling copy would give."""
    fh, fw, c, cout = w_shape
    bsz, h, wd, _ = qa.shape
    k = fh * fw * c
    fill = int(za) if pad_value is None else pad_value
    padded = torch.full((bsz, h + 2 * pad, wd + 2 * pad, c), fill, dtype=torch.int64)
    padded[:, pad:pad + h, pad:pad + wd] = qa.to(torch.int64)
    cols = L.im2col(padded, fh, fw, stride, 0)
    a = cols.reshape(-1, k)
    kk = -(-k // BK) * BK
    a = torch.cat([a, a.new_zeros(a.shape[0], kk - k)], 1)  # past K: 0
    w = torch.zeros(kk, cout, dtype=torch.int64)
    w[:wt.shape[1]] = wt.t().to(torch.int64)  # zero past K already
    prod = (a.double() @ w.double()).round().to(torch.int64)  # exact: < 2**53
    rowsum = a.sum(1, keepdim=True)
    zw = zw.reshape(1, -1).to(torch.int64)
    acc = prod - zw * rowsum - int(za) * colsum.to(torch.int64)[None] + k * int(za) * zw
    assert acc.abs().max() < 2 ** 31  # the kernel's int32 sums are exact
    return acc.to(torch.int32).reshape(bsz, (h + 2 * pad - fh) // stride + 1, -1, cout)


@pytest.mark.parametrize("net", sorted(MODELS))
def test_u8_identity_is_bitwise_the_reference_route_at_every_conv_geometry(net):
    """The kernel's arithmetic, mirrored: its int32 sum equals the exact
    sum of the zero-point-shifted operands, and after its epilogue (the
    f32 requant step, bias, ReLU) it is bitwise the port's and the
    reference's ``qfused_route_ref`` at every distinct ``groups == 1``
    conv geometry of the net.  Inputs take negative values, so the
    activation zero point is well inside (0, 255) and a padding tap that
    held 0 instead of ``za`` would show."""
    rng = np.random.default_rng(23)
    seen = set()
    for d in _conv_descriptors(net):
        geo = (d.i_h, d.i_w, d.i_d, d.f_h, d.stride, d.pad, d.ofm)
        if geo in seen:
            continue
        seen.add(geo)
        h = _covered_size(d.i_h, d.f_h, d.stride, d.pad)
        wd = _covered_size(d.i_w, d.f_w, d.stride, d.pad)
        x = _np(rng, 1, h, wd, d.i_d) - 0.3
        w = _np(rng, d.f_h, d.f_w, d.i_d, d.ofm, scale=0.1)
        bias = _np(rng, d.ofm)
        qp = Q.quantize_graph_params({"l": {"w": torch.from_numpy(w), "b": torch.from_numpy(bias)}})["l"]
        xt = torch.from_numpy(x)
        qa, sa, za = Q.quantize_tensor(xt, axis=None)
        assert 0 < float(za) < 255
        wt, colsum = K.packed_weights(qp["qw"])
        acc = _u8_identity_conv(qa, za, wt, colsum, qp["zp"], qp["shape"], d.stride, d.pad)
        xq = qa.to(torch.int32) - za.to(torch.int32)
        wq = (qp["qw"].to(torch.int32) - qp["zp"].to(torch.int32)).reshape(qp["shape"])
        assert torch.equal(acc, K._int_conv(xq, wq, d.stride, d.pad)), f"{net}:{d.name}"
        y = acc.to(torch.float32) * (sa * qp["scale"]).reshape(-1) + qp["b"]
        y = torch.relu(y)
        kw = dict(stride=d.stride, pad=d.pad, relu=True)
        args = (qp["qw"], qp["scale"], qp["zp"], qp["b"], qp["shape"])
        assert torch.equal(y, K.qfused_route_ref(xt, *args, **kw)), f"{net}:{d.name}"
        # the reference's route, eager as its tests run it, on the same
        # quantized weights (the two packages' quantization is held bitwise
        # above); under jit XLA would contract its requant step into an FMA
        ref = RK.qfused_route_ref(jnp.asarray(x), *(jnp.asarray(a.numpy()) for a in args[:4]),
                                  tuple(qp["shape"]), **kw)
        _same(y, ref)
    assert seen


@pytest.mark.parametrize("case", [(3, 3, 5, 1, 1), (1, 16, 7, 2, 0), (3, 24, 70, 2, 1)],
                         ids=lambda c: "x".join(map(str, c)))
def test_u8_identity_padding_must_hold_the_zero_point(case):
    """With ``za > 0``, padding the u8 input with 0 instead of ``za`` (what
    a zero-filling copy would do) changes the sum at the border, and only
    there; ``za`` gives the reference's."""
    f, c, cout, stride, pad = case
    rng = np.random.default_rng(sum(case))
    x = torch.from_numpy(_np(rng, 1, 7, 6, c) - 0.5)
    w = torch.from_numpy(_np(rng, f, f, c, cout, scale=0.2))
    qp = Q.quantize_graph_params({"l": {"w": w, "b": torch.zeros(cout)}})["l"]
    qa, _, za = Q.quantize_tensor(x, axis=None)
    assert float(za) > 0
    wt, colsum = K.packed_weights(qp["qw"])
    args = (qa, za, wt, colsum, qp["zp"], qp["shape"], stride, pad)
    want = K._int_conv(qa.to(torch.int32) - za.to(torch.int32),
                       (qp["qw"].to(torch.int32) - qp["zp"].to(torch.int32)).reshape(qp["shape"]),
                       stride, pad)
    assert torch.equal(_u8_identity_conv(*args), want)
    wrong = _u8_identity_conv(*args, pad_value=0)
    if pad:
        assert not torch.equal(wrong[:, 0], want[:, 0])  # the top row of outputs reads padding
        assert torch.equal(wrong[:, 1:-1, 1:-1], want[:, 1:-1, 1:-1])  # the interior does not
    else:
        assert torch.equal(wrong, want)


def test_packed_weights_transpose_pad_and_column_sums():
    rng = np.random.default_rng(8)
    w = torch.from_numpy(_np(rng, 3, 3, 3, 10, scale=0.2))
    qp = Q.quantize_graph_params({"l": {"w": w, "b": torch.zeros(10)}})["l"]
    qw = qp["qw"]
    wt, colsum = K.packed_weights(qw)
    assert wt.dtype == torch.uint8 and tuple(wt.shape) == (10, 32)  # K = 27 rounded up to 16
    assert torch.equal(wt[:, :27], qw.t()) and not wt[:, 27:].any()
    assert colsum.dtype == torch.int32 and torch.equal(colsum, qw.to(torch.int32).sum(0))
    again = K.packed_weights(qw)
    assert again[0] is wt and again[1] is colsum  # made once per weight tensor
    qw[0, 0] = 255 - qw[0, 0]  # an in-place change makes them again
    wt2, colsum2 = K.packed_weights(qw)
    assert wt2 is not wt and torch.equal(wt2[:, :27], qw.t())
    assert torch.equal(colsum2, qw.to(torch.int32).sum(0))
    other = qw.clone()  # an equal tensor is another weight
    assert K.packed_weights(other)[0] is not wt2
