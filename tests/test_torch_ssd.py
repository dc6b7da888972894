"""The port's SSD chunked scan (B6) against the JAX package's.

On the CPU, ``ops.ssd`` takes the plain version of the CUDA kernel
(``kernels/ssd.py::ssd_ref``, the port of ``repro.models.ssm.ssd_scan``),
which must match the reference's Pallas kernel run in interpret mode and
its jnp oracle ``ssd_scan``; the CUDA kernel itself runs only on a card
(tests/test_torch_gpu.py).  ``ops.ssd`` pads a ragged S to a chunk
multiple and keeps a head stride of 0 on B and C (Hymba broadcasts one B
and one C to every head), so both are covered here.

Tolerances: ``2e-4`` in f32, the reference's bar
(tests/test_kernels_ssd.py); ``5e-2`` for bf16 operands, its
test_ssd_kernel_dtypes bar.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd as ref_ssd_kernel
from repro.models.ssm import ssd_scan as ref_ssd_scan
from repro_torch.kernels import ops, runtime
from repro_torch.models.ssm import ssd_scan

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

TOL = 2e-4


def _inputs(rng, b, s, h, p, n):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    la = (-np.abs(rng.standard_normal((b, s, h))) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, s, h, n)) * 0.4).astype(np.float32)
    C = (rng.standard_normal((b, s, h, n)) * 0.4).astype(np.float32)
    return x, la, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# (s, h, p, n, chunk): the reference's kernel test shapes
CASES = [(32, 2, 8, 4, 8), (64, 1, 16, 8, 16), (128, 3, 4, 2, 32), (16, 2, 8, 4, 16)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_route_matches_reference_kernel_and_oracle(case):
    s, h, p, n, chunk = case
    rng = np.random.default_rng(s * h + p)
    x, la, B, C = _inputs(rng, 1, s, h, p, n)
    h0 = np.zeros((h, n, p), np.float32)
    y_k, hf_k = ref_ssd_kernel(x[0], la[0], B[0], C[0], h0, chunk=chunk, interpret=True)
    y_o, hf_o = ref_ssd_scan(x, la, B, C, chunk=chunk)
    before = runtime.launch_counts()
    y, hf = ops.ssd(*_t(x, la, B, C), chunk=chunk)
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    assert y.dtype == torch.float32 and hf.dtype == torch.float32
    for got, want in ((y[0], y_k), (hf[0], hf_k), (y, y_o), (hf, hf_o)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_batched_nonzero_state_matches_vmapped_reference_kernel():
    rng = np.random.default_rng(5)
    b, s, h, p, n, chunk = 3, 32, 2, 8, 4, 8
    x, la, B, C = _inputs(rng, b, s, h, p, n)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    y_k, hf_k = jax.vmap(lambda *a: ref_ssd_kernel(*a, chunk=chunk, interpret=True))(x, la, B, C, h0)
    y, hf = ops.ssd(*_t(x, la, B, C, h0), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hf_k), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,chunk", [(45, 16), (149, 64), (7, 64)])
def test_ragged_sequence_is_padded_exactly(s, chunk):
    rng = np.random.default_rng(s)
    x, la, B, C = _inputs(rng, 2, s, 3, 8, 4)
    h0 = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    y_o, hf_o = ref_ssd_scan(x, la, B, C, chunk=chunk, h0=h0)
    y, hf = ops.ssd(*_t(x, la, B, C, h0), chunk=chunk)
    assert tuple(y.shape) == (2, s, 3, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_o), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hf_o), rtol=TOL, atol=TOL)
    # the kernel's route refuses a ragged S itself: the padding is ops.ssd's
    from repro_torch.kernels import ssd as SSD
    if s % min(chunk, s):
        with pytest.raises(ValueError):
            SSD.ssd(*_t(x, la, B, C), chunk=chunk)


def test_head_stride_zero_b_and_c_match_materialised_copies():
    """Hymba's B/C: one per token, broadcast to every head (stride 0),
    through a ragged S whose padding must keep them broadcast."""
    rng = np.random.default_rng(9)
    b, s, h, p, n, chunk = 2, 70, 5, 8, 4, 16
    x, la, _, _ = _inputs(rng, b, s, h, p, n)
    Bm = (rng.standard_normal((b, s, n)) * 0.4).astype(np.float32)
    Cm = (rng.standard_normal((b, s, n)) * 0.4).astype(np.float32)
    Bt, Ct = torch.from_numpy(Bm)[:, :, None].expand(b, s, h, n), torch.from_numpy(Cm)[:, :, None].expand(b, s, h, n)
    assert Bt.stride(2) == 0
    assert ops._pad_seq(Bt, 10).stride(2) == 0
    y, hf = ops.ssd(*_t(x, la), Bt, Ct, chunk=chunk)
    Bf = np.broadcast_to(Bm[:, :, None], (b, s, h, n)).copy()
    Cf = np.broadcast_to(Cm[:, :, None], (b, s, h, n)).copy()
    y_m, hf_m = ops.ssd(*_t(x, la, Bf, Cf), chunk=chunk)
    assert torch.equal(y, y_m) and torch.equal(hf, hf_m)
    y_o, hf_o = ref_ssd_scan(x, la, Bf, Cf, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_o), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hf_o), rtol=TOL, atol=TOL)


def test_normalizer_channel_matches_reference():
    """``ssd_scan(normalizer=True)`` (the mLSTM form) is the same function."""
    rng = np.random.default_rng(13)
    x, la, B, C = _inputs(rng, 2, 40, 2, 8, 4)
    h0 = rng.standard_normal((2, 2, 4, 8)).astype(np.float32)
    n0 = rng.standard_normal((2, 2, 4)).astype(np.float32)
    want = ref_ssd_scan(x, la, B, C, chunk=16, h0=h0, normalizer=True, n0=n0)
    got = ssd_scan(*_t(x, la, B, C), chunk=16, h0=torch.from_numpy(h0), normalizer=True,
                   n0=torch.from_numpy(n0))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_operand_dtypes_match_reference_kernel(dtype):
    rng = np.random.default_rng(11)
    x, la, B, C = _inputs(rng, 1, 32, 2, 8, 4)
    jdt = jnp.dtype(dtype)
    xj, Bj, Cj = (jnp.asarray(a[0], jdt) for a in (x, B, C))
    y_k, _ = ref_ssd_kernel(xj, la[0], Bj, Cj, np.zeros((2, 4, 8), np.float32), chunk=8, interpret=True)
    tdt = getattr(torch, dtype)
    xt, Bt, Ct = (torch.tensor(np.asarray(a.astype(jnp.float32)))[None].to(tdt) for a in (xj, Bj, Cj))
    y, hf = ops.ssd(xt, torch.from_numpy(la), Bt, Ct, chunk=8)
    assert y.dtype == tdt and hf.dtype == torch.float32
    tol = TOL if dtype == "float32" else 5e-2
    np.testing.assert_allclose(y[0].float().numpy(), np.asarray(y_k.astype(jnp.float32)), rtol=tol, atol=tol)


def test_backend_choice_on_the_cpu():
    rng = np.random.default_rng(2)
    args = _t(*_inputs(rng, 1, 24, 2, 4, 3))
    y0, h0 = ops.ssd(*args, chunk=8)
    y1, h1 = ops.ssd(*args, chunk=8, backend="torch")
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    with pytest.raises(ValueError):
        ops.ssd(*args, chunk=8, backend="interpret")


# ------------------------- the kernel's chunk-parallel form, mirrored
def _scan_order_cumsum(la):
    """``csrc/ssd.cu``'s inclusive cumulative sum of one chunk's log_a, in
    its order: each 32-step segment by a Kogge-Stone scan (step o adds the
    value o places down), then the totals of the segments before it added
    in order, from 0."""
    q = la.shape[0]
    nseg = -(-q // 32)
    v = np.zeros((nseg, 32), np.float32)
    v.reshape(-1)[:q] = la
    for o in (1, 2, 4, 8, 16):
        v[:, o:] = v[:, o:] + v[:, :-o]
    out, off = np.empty_like(v), np.float32(0.0)
    for seg in range(nseg):
        out[seg] = v[seg] + off
        off = np.float32(off + v[seg, 31])
    return out.reshape(-1)[:q]


def _chunk_parallel_ssd(x, la, B, C, h0, q):
    """The kernel's arithmetic in numpy f32, S a multiple of q: every chunk
    computes, from its own inputs alone, L (in scan order), its state
    summary H_c = sum_s exp(L_end - L_s) B_s x_s^T and its scores; the state
    goes down the chunks of a sequence in order, h <- exp(L_end) h + H_c
    (each step rounded); a chunk's output is exp(L) (C h) with the state it
    was handed, plus scores x."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = np.empty_like(x)
    h_final = np.empty((b, h, n, p), np.float32)
    causal = np.tril(np.ones((q, q), bool))
    for bi in range(b):
        for hi in range(h):
            state = h0[bi, hi].astype(np.float32)
            for c in range(s // q):
                sl = slice(c * q, (c + 1) * q)
                xc, Bc, Cc = x[bi, sl, hi], B[bi, sl, hi], C[bi, sl, hi]
                L = _scan_order_cumsum(la[bi, sl, hi])
                Hc = (Bc * np.exp(L[-1] - L)[:, None]).T @ xc
                scores = np.where(causal, (Cc @ Bc.T) * np.exp(np.minimum(L[:, None] - L[None, :], 0)), 0)
                y[bi, sl, hi] = np.exp(L)[:, None] * (Cc @ state) + scores.astype(np.float32) @ xc
                state = np.float32(np.exp(L[-1])) * state + Hc
            h_final[bi, hi] = state
    return y, h_final


def _pad_to(a, s, axis=1):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, s - a.shape[axis])
    return np.pad(a, pad)


# (B, S, H, P, N, chunk): 3 to 5 chunks, a ragged S, chunks of one and two
# 32-step segments (40: the second part-filled), N not a multiple of 4
MIRROR_CASES = [(2, 48, 3, 8, 4, 16), (1, 149, 2, 8, 4, 64), (2, 200, 2, 4, 3, 40), (1, 96, 2, 12, 5, 32)]


@pytest.mark.parametrize("case", MIRROR_CASES, ids=lambda c: "x".join(map(str, c)))
def test_chunk_parallel_mirror_matches_reference_kernel_and_oracle(case):
    b, s, h, p, n, chunk = case
    rng = np.random.default_rng(s * h + n)
    x, la, B, C = _inputs(rng, b, s, h, p, n)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    sp = -(-s // chunk) * chunk  # ops.ssd's padding: x = B = C = 0, log_a = 0
    xp, lap, Bp, Cp = (_pad_to(a, sp) for a in (x, la, B, C))
    assert sp // chunk >= 3
    y_m, hf_m = _chunk_parallel_ssd(xp, lap, Bp, Cp, h0, chunk)
    y_m = y_m[:, :s]
    y_k, hf_k = jax.vmap(lambda *a: ref_ssd_kernel(*a, chunk=chunk, interpret=True))(xp, lap, Bp, Cp, h0)
    y_o, hf_o = ref_ssd_scan(x, la, B, C, chunk=chunk, h0=h0)
    y_t, hf_t = ops.ssd(*_t(x, la, B, C, h0), chunk=chunk)
    for want_y, want_h in ((np.asarray(y_k)[:, :s], hf_k), (y_o, hf_o), (y_t.numpy(), hf_t.numpy())):
        np.testing.assert_allclose(y_m, np.asarray(want_y), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(hf_m, np.asarray(want_h), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("q", [7, 32, 40, 64, 128])
def test_scan_order_cumsum_is_a_cumulative_sum(q):
    la = (-np.abs(np.random.default_rng(q).standard_normal(q)) * 0.3).astype(np.float32)
    got = _scan_order_cumsum(la)
    np.testing.assert_allclose(got, np.cumsum(la.astype(np.float64)), rtol=1e-6, atol=1e-6)
    if q <= 32:  # one segment: the first 2 steps are exact either way
        assert got[0] == la[0] and got[1] == np.float32(la[0] + la[1])


def test_rows_of_16_bytes_decides_the_wide_loads():
    from repro_torch.kernels.ssd import _rows_of_16_bytes

    x = torch.zeros(2, 64, 3, 64, dtype=torch.bfloat16)
    assert _rows_of_16_bytes(x)
    assert _rows_of_16_bytes(torch.zeros(2, 64, 1, 16).expand(2, 64, 50, 16))  # head stride 0
    assert not _rows_of_16_bytes(torch.zeros(2, 64, 3, 12, dtype=torch.bfloat16))  # 24-byte rows
    assert not _rows_of_16_bytes(torch.zeros(2, 64, 3, 65)[..., 1:])  # rows off a 16-byte boundary


# ------------------------- the wide form's split operands (csrc/ssd.cu)
# The wide form runs its products on the bf16 tensor cores with f32 sums
# and splits every f32 operand into three bf16 terms, hi = bf16(v), mid =
# bf16(v - hi), lo = bf16(v - hi - mid) (nearest even, as __float2bfloat16_rn
# and torch's .to(bfloat16)); a product of two bf16 values is exact in f32.
def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _split3(v):
    hi = _bf16(v)
    r = (v - hi).astype(np.float32)
    mid = _bf16(r)
    return hi, mid, _bf16((r - mid).astype(np.float32))


def _mlstm_values(rng, size):
    """f32 values over the range the mLSTM hands the scan: k dh^-0.5 times
    the input gate e^min(i, 8) (i of spread 2), decays exp(L_end - L_s)
    from 1 down to the smallest normal f32, their products with v, the
    carried state and decayed scores."""
    k = (rng.standard_normal(size) * 512 ** -0.5 * np.exp(np.minimum(rng.standard_normal(size) * 2, 8)))
    decay = np.exp2(-rng.uniform(0, 126, size))
    v = rng.standard_normal(size)
    scores = rng.standard_normal(size) * np.exp(np.minimum(rng.standard_normal(size) * 2, 8)) * 8
    return {name: a.astype(np.float32) for name, a in (
        ("gated k", k), ("decay", decay), ("decay v", decay * v), ("state", rng.standard_normal(size) * 30),
        ("decayed scores", scores * decay))}


def test_three_bf16_terms_give_the_f32_value_back():
    """hi + mid + lo == v bit for bit wherever lo stays in bf16's normal
    range (|v| >= 2^-110: lo's exponent is at least v's less 16).  Below
    that, down to the smallest normal f32 (2^-126), lo is a bf16 subnormal
    and keeps fewer bits: what is lost is under half its spacing, 2^-134,
    which no output of the scan (of order 1) can see.  Two terms leave up
    to 2^-17 of the value (its low 7 or 8 bits)."""
    rng = np.random.default_rng(29)
    for name, v in _mlstm_values(rng, 200_000).items():
        hi, mid, lo = _split3(v)
        back = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
        normal = np.abs(v) >= 2.0 ** -110
        assert normal.any()
        np.testing.assert_array_equal(back[normal], v[normal].astype(np.float64), err_msg=name)
        assert np.all(np.abs(back - v.astype(np.float64)) <= 2.0 ** -134), name
        two = hi.astype(np.float64) + mid.astype(np.float64)
        assert np.all(np.abs(two - v) <= np.abs(v).astype(np.float64) * 2.0 ** -16 + 2.0 ** -134), name


def _tc(a_terms, b_terms):
    """The wide form's product of split operands: the term products whose
    orders add to less than 3, each a bf16 x bf16 product summed in f32."""
    out = None
    for u, a in enumerate(a_terms):
        for w, b in enumerate(b_terms):
            if u + w < 3:
                p = (a.astype(np.float32) @ b.astype(np.float32)).astype(np.float32)
                out = p if out is None else (out + p).astype(np.float32)
    return out


def _split_scan(x, la, B, C, h0, n0, q):
    """The wide form's arithmetic on bf16 inputs in numpy f32 (S a
    multiple of q): x, B and C as they are (bf16 values), every f32 operand
    -- w x, the carried state, the decayed scores -- split in three; the
    cumulative sum, exps, decays and the state's hand-down in f32, as
    csrc/ssd.cu does them on the CUDA cores.  (f32 inputs take the CUDA
    cores for the products too, nothing split.)"""
    one = lambda a: (a,)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = np.empty_like(x)
    den = np.empty((b, s, h), np.float32)
    hf = np.empty((b, h, n, p), np.float32)
    nf = np.empty((b, h, n), np.float32)
    causal = np.tril(np.ones((q, q), bool))
    for bi in range(b):
        for hi in range(h):
            state, nstate = h0[bi, hi].copy(), n0[bi, hi].copy()
            for c in range(s // q):
                sl = slice(c * q, (c + 1) * q)
                xc, Bc, Cc = x[bi, sl, hi], B[bi, sl, hi], C[bi, sl, hi]
                L = _scan_order_cumsum(la[bi, sl, hi])
                e, w, a_end = np.exp(L), np.exp(L[-1] - L), np.float32(np.exp(L[-1]))
                scores = _tc(one(Cc), one(Bc.T))
                sc = np.where(causal, scores * np.exp(np.minimum(L[:, None] - L[None, :], 0)), 0).astype(np.float32)
                Hc = _tc(one(Bc.T), _split3((w[:, None] * xc).astype(np.float32)))
                y[bi, sl, hi] = (e[:, None] * _tc(one(Cc), _split3(state)) + _tc(_split3(sc), one(xc)))
                den[bi, sl, hi] = e * (Cc @ nstate) + sc.sum(1)
                state = (a_end * state + Hc).astype(np.float32)
                nstate = (a_end * nstate + w @ Bc).astype(np.float32)
            hf[bi, hi], nf[bi, hi] = state, nstate
    return y, hf, den, nf


@pytest.mark.parametrize("b,s,h,n,p,q", [(2, 48, 2, 16, 8, 16), (1, 96, 2, 8, 16, 32), (1, 64, 3, 32, 8, 64),
                                         (2, 40, 1, 8, 8, 8)])
def test_split_operand_scan_matches_plain_version_and_reference(b, s, h, n, p, q):
    """The scan with every f32 operand split in three, on bf16 inputs (the
    served model's), stays within the f32 bar, relative to each output's
    scale as the card's tests hold the kernel, of ssd_ref and of the
    reference's ssd_scan, with the normalizer, inputs as the mLSTM makes
    them (the input gate up to e^8) and a given state.  One term would not
    (bf16 rounding of the operand: about 2^-9 of it)."""
    rng = np.random.default_rng(s + n + p)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    la = np.log(1 / (1 + np.exp(-(2.0 + rng.standard_normal((b, s, h)))))).astype(np.float32)
    gate = np.exp(np.minimum(rng.standard_normal((b, s, h)) * 2.0, 8.0))
    B = (rng.standard_normal((b, s, h, n)) * n ** -0.5 * gate[..., None]).astype(np.float32)
    C = rng.standard_normal((b, s, h, n)).astype(np.float32)
    x, la, B, C = (_bf16(a) for a in (x, la, B, C))  # bf16 values, as served
    h0 = (rng.standard_normal((b, h, n, p)) * 0.3).astype(np.float32)
    n0 = np.abs(rng.standard_normal((b, h, n))).astype(np.float32)
    got = _split_scan(x, la, B, C, h0, n0, q)
    plain = ssd_scan(*_t(x, la, B, C), chunk=q, h0=torch.from_numpy(h0), normalizer=True,
                     n0=torch.from_numpy(n0))
    ref = ref_ssd_scan(x, la, B, C, chunk=q, h0=h0, normalizer=True, n0=n0)
    for g, want_t, want_j in zip(got, plain, ref):
        for w in (want_t.numpy(), np.asarray(want_j)):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * max(1.0, float(np.abs(w).max())))
