"""The patch-matrix kernel's decomposition (B4, ``csrc/im2col.cu``) against
the JAX package's patch matrix.

CUDA code does not run on the CPU, so this file mirrors the kernel's
arithmetic step for step in numpy: the span of consecutive runs each
block owns (``nr`` from the host's rule, with the constants read from the
source), each run's table entry (source offset of its first pixel, valid
pixels ``[lo, hi)``: a zero head and tail in whole pixels, or nothing
when the input row is out of range), and each element's run and pixel,
every quotient by the kernel's multiply-shift division ``quot``.  The mirror is held bitwise to
``repro.kernels.im2col.im2col(..., interpret=True)`` (the Pallas kernel)
and to ``repro.kernels.ref.im2col_ref``, both vmapped over a batch of 3,
so that spans cross image boundaries, on contiguous inputs and on channel
slices with a pitch wider than C, on both of the kernel's paths.  The
port's plain version and its one-copy library yardstick are held to the
same bits.  A gather is a copy: everything here is held exactly.  The
kernel itself is held to the plain version on the card by
tests/test_torch_gpu.py.
"""
from __future__ import annotations

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.im2col import im2col as pallas_im2col
from repro.kernels.ref import im2col_ref
from repro_torch.kernels import build
from repro_torch.kernels import im2col as I

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

BATCH = 3


def _constants():
    """The ``constexpr int`` constants of ``csrc/im2col.cu``."""
    with open(os.path.join(build.CSRC, "im2col.cu")) as f:
        src = f.read()
    out = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([0-9 *]+);", src):
        out[name] = int(np.prod([int(t) for t in expr.split("*")]))
    return out


CONST = _constants()


# ----------------------------------------------------- the kernel, mirrored
def make_div(d):
    """``make_div``: (m, s) with n / d = umulhi(n, m) >> s for n < 2^31."""
    if d == 1:
        return 0, 0
    l = int(d - 1).bit_length()  # ceil(log2 d)
    p = 31 + l
    return ((1 << p) + d - 1) // d, p - 32


def quot(n, d):
    """``quot``: n // d by the kernel's multiply-shift (uint32 umulhi)."""
    m, s = make_div(d)
    if d == 1:
        return n
    return ((n.astype(np.uint64) * np.uint64(m)) >> np.uint64(32 + s)).astype(n.dtype)


def span_runs(runs, run_len, wide):
    """The host's choice of runs a block (``nr``)."""
    nr = min(max((CONST["SPAN4"] if wide else CONST["STAGE"]) // run_len, 1), CONST["MAX_RUNS"])
    nr = min(nr, max(1, -(-runs // CONST["MIN_BLOCKS"])))
    return max(4, nr // 4 * 4) if not wide else nr


def decode(r, fh, fw, stride, pad, h, w, oh, ow, strides):
    """``decode``: each run's source offset of pixel 0 and valid [lo, hi)."""
    sb, sh, sw = strides
    r = r.astype(np.uint32)
    m = quot(r, fh)  # the patch row (b, oh, ow)
    fi = (r - m * np.uint32(fh)).astype(np.int64)
    b = quot(m, oh * ow)
    rem = m - b * np.uint32(oh * ow)
    o_h = quot(rem, ow)
    ih = o_h.astype(np.int64) * stride - pad + fi
    iw0 = (rem - o_h * np.uint32(ow)).astype(np.int64) * stride - pad
    src = b.astype(np.int64) * sb + ih * sh + iw0 * sw
    lo = np.maximum(0, -iw0)
    hi = np.where((ih < 0) | (ih >= h), 0, np.minimum(fw, w - iw0))
    return src, lo, hi


def mirror(buf, offset, shape, strides, fh, fw, stride, pad, wide, nr=None):
    """The kernel's patch matrix from the flat storage ``buf`` of a view
    with element ``offset``, ``shape`` [B,H,W,C] and ``strides`` (batch,
    row, pixel; unit channel stride).  Returns (cols, nr)."""
    bsz, h, w, c = shape
    oh, ow = I.out_hw(h, w, fh, fw, stride, pad)
    unit = 4 if wide else 1  # floats an element moves
    per_px = c // unit
    run_len = fw * per_px
    runs = bsz * oh * ow * fh
    nr = span_runs(runs, run_len, wide) if nr is None else nr
    out = np.empty(runs * run_len * unit, dtype=buf.dtype)
    for r0 in range(0, runs, nr):
        n = min(nr, runs - r0) * run_len
        src, lo, hi = decode(np.arange(r0, r0 + min(nr, runs - r0)), fh, fw, stride, pad, h, w, oh, ow, strides)
        q = np.arange(n, dtype=np.uint32)
        t = quot(q, run_len)
        j = q - t * np.uint32(run_len)
        fj = quot(j, per_px)
        c_el = (j - fj * np.uint32(per_px)).astype(np.int64) * unit
        fj = fj.astype(np.int64)
        valid = (fj >= lo[t]) & (fj < hi[t])
        at = offset + src[t] + fj * strides[2] + c_el  # first float of the element
        for k in range(unit):
            vals = np.where(valid, buf[np.where(valid, at + k, 0)], np.float32(0))
            out[(r0 * run_len + q.astype(np.int64)) * unit + k] = vals
    return out.reshape(bsz * oh * ow, fh * fw * c), nr


def mirror_of(x: torch.Tensor, fh, fw, stride, pad, wide=None, nr=None):
    """:func:`mirror` on a torch view, as the wrapper hands it over."""
    wide = I.wide_path(x) if wide is None else wide
    flat = x.as_strided((x.untyped_storage().nbytes() // x.element_size(),), (1,), 0).numpy()
    return mirror(flat, x.storage_offset(), tuple(x.shape), I.kernel_strides(x), fh, fw, stride, pad, wide, nr)


# ----------------------------------------------------------- the references
@functools.lru_cache(maxsize=None)
def _batched(fn, f, stride, pad):
    return jax.jit(jax.vmap(functools.partial(fn, fh=f, fw=f, stride=stride, pad=pad)))


def reference(x: np.ndarray, f, stride, pad):
    """The Pallas kernel (interpret mode) and ``im2col_ref``, vmapped over
    the batch and stacked, each checked against the other."""
    pallas = functools.partial(pallas_im2col, interpret=True)
    got = np.asarray(_batched(pallas, f, stride, pad)(jnp.asarray(x)))
    ref = np.asarray(_batched(im2col_ref, f, stride, pad)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    return ref.reshape(-1, ref.shape[-1])


# (C, F, stride, pad): every C in {1, 3, 5, 8, 64}, F in {1, 3, 5, 11},
# stride in {1, 2, 4} and pad in {0, 1, 2} at least once
GEOMETRIES = [
    (1, 3, 1, 1), (1, 11, 4, 2), (3, 3, 1, 1), (3, 11, 4, 0), (3, 5, 2, 2),
    (5, 5, 1, 2), (5, 1, 2, 0), (5, 3, 4, 1), (8, 1, 1, 0), (8, 3, 2, 1),
    (8, 11, 1, 2), (64, 3, 1, 1), (64, 5, 2, 0), (64, 1, 4, 0),
]


def _image(c, f, stride, pad):
    h = max(f - 2 * pad, 1) + 2 * stride + 1  # OH = 3 (4 with pad rounding)
    return h, h + 1


def _gid(g):
    return "C{}-F{}-s{}-p{}".format(*g)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=_gid)
def test_mirror_is_bitwise_the_reference_kernel(geom):
    c, f, stride, pad = geom
    h, w = _image(c, f, stride, pad)
    rng = np.random.default_rng(c * 1000 + f * 10 + stride + pad)
    x = rng.standard_normal((BATCH, h, w, c)).astype(np.float32)
    want = reference(x, f, stride, pad)
    xt = torch.from_numpy(x).clone()
    paths = (True, False) if c % 4 == 0 else (False,)
    oh, ow = I.out_hw(h, w, f, f, stride, pad)
    for wide in paths:
        got, _ = mirror_of(xt, f, f, stride, pad, wide=wide)
        np.testing.assert_array_equal(got, want)
        # spans of runs that cross image boundaries, on both paths
        forced = (1, 3, 4, 7) if wide else (4, 8, 12)
        assert any((oh * ow * f) % k for k in forced)  # some span crosses an image
        for k in forced:
            got, _ = mirror_of(xt, f, f, stride, pad, wide=wide, nr=k)
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(I.im2col_ref(xt, f, f, stride, pad).numpy(), want)
    np.testing.assert_array_equal(I.im2col_library(xt, f, f, stride, pad).numpy(), want)


# (C, F, stride, pad, pitch, channel offset): channel slices of a wider
# NHWC tensor, read in place; aligned (16-byte path) and not
SLICES = [
    (8, 3, 1, 1, 16, 8), (8, 3, 2, 0, 16, 4), (64, 3, 1, 1, 128, 64),
    (8, 5, 1, 2, 13, 2), (3, 3, 1, 1, 7, 1), (48, 5, 1, 2, 96, 48), (5, 11, 4, 2, 12, 6),
]


@pytest.mark.parametrize("case", SLICES, ids=lambda s: "C{}-F{}-s{}-p{}-pitch{}-at{}".format(*s))
def test_mirror_reads_a_channel_slice_in_place(case):
    c, f, stride, pad, pitch, at = case
    h, w = _image(c, f, stride, pad)
    rng = np.random.default_rng(pitch * 100 + at)
    full = torch.from_numpy(rng.standard_normal((BATCH, h, w, pitch)).astype(np.float32)).clone()
    view = full[..., at:at + c]
    assert not view.is_contiguous() and view.stride() == (h * w * pitch, w * pitch, pitch, 1)
    aligned = c % 4 == 0 and at % 4 == 0 and pitch % 4 == 0
    assert I.wide_path(view) == aligned
    want = reference(view.contiguous().numpy(), f, stride, pad)
    got, _ = mirror_of(view, f, f, stride, pad)
    np.testing.assert_array_equal(got, want)
    if aligned:  # the staged path takes every layout the wide one does
        got, _ = mirror_of(view, f, f, stride, pad, wide=False)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(I.im2col_ref(view, f, f, stride, pad).numpy(), want)
    np.testing.assert_array_equal(I.im2col_library(view, f, f, stride, pad).numpy(), want)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 9, 12, 27, 33, 48, 55, 144, 384, 576, 1152, 4608, 45056])
def test_multiply_shift_division_is_exact_below_two_to_the_31(d):
    rng = np.random.default_rng(d)
    n = np.concatenate([
        np.arange(0, 1 << 16, dtype=np.uint32),
        rng.integers(0, 1 << 31, size=1 << 16, dtype=np.uint64).astype(np.uint32),
        np.array([(1 << 31) - 1, (1 << 31) - d, d * (((1 << 31) - 1) // d), d * 7 - 1], dtype=np.uint32),
    ])
    np.testing.assert_array_equal(quot(n, d), n // np.uint32(d))


def test_path_choice_follows_alignment_of_pointer_and_strides():
    x = torch.zeros(2, 5, 6, 64)
    assert I.wide_path(x) and I.kernel_strides(x) == (5 * 6 * 64, 6 * 64, 64)
    assert not I.wide_path(torch.zeros(2, 5, 6, 3))  # C % 4 != 0
    wide = torch.zeros(2, 5, 6, 18)
    assert not I.wide_path(wide[..., :8])  # pitch of 18 floats: 72 bytes
    assert not I.wide_path(x[..., 2:10])  # base 8 bytes past a 16-byte boundary
    assert I.wide_path(x[..., 4:12]) and I.kernel_strides(x[..., 4:12])[2] == 64
    # a dimension of size 1 is never stepped along: its stride does not count
    one = torch.zeros(6, 1, 7, 8)[1:2]  # batch stride 56 floats, row stride 56
    assert I.kernel_strides(one)[:2] == (0, 0) and I.wide_path(one)
    assert I.kernel_strides(torch.zeros(1, 4, 4, 4)) == (0, 16, 4)


def test_span_rule_keeps_spans_aligned_and_the_grid_full():
    # VGG-16's convs at batch 4: (rows, FH, run length in floats)
    for rows, fh, run in [(200704, 3, 9), (200704, 3, 192), (50176, 3, 384), (3136, 3, 1536), (784, 3, 1536)]:
        for wide in (True, False) if run % 4 == 0 else (False,):
            runs = rows * fh
            nr = span_runs(runs, run // 4 if wide else run, wide)
            assert 1 <= nr <= CONST["MAX_RUNS"]
            assert -(-runs // nr) >= CONST["MIN_BLOCKS"] // 2  # conv5 too fills the card
            assert wide or nr % 4 == 0  # a staged span starts at a 16-byte boundary
