"""The fused conv's implicit A loader (``csrc/gemm.cu``, ``ImplicitA``)
against the JAX package's patch matrix.

The conv kernel never writes its patch matrix: each copy of its A tile
reads ``x`` at an offset made from a per-block row table and a per-k
decomposition, or writes 0 for a padding tap.  CUDA code does not run on
the CPU, so this file mirrors that arithmetic step for step in numpy
(``build_rows``, ``k_at`` in its generic and its one-tap-a-k-step form,
``Walk::next`` and ``src``), builds the batched patch matrix with it, and
holds it bitwise to the reference's ``repro.kernels.ref.im2col_ref``
stacked over the batch, at every ``groups == 1`` conv geometry of the six
nets (batch 2, a small spatial size).  The map is a gather, so it is held
exactly.  The kernel on the card is held to the unfused route's bits by
tests/test_torch_gpu.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import im2col_ref
from repro_torch.cnn.models import MODELS
from repro_torch.kernels import im2col as I

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

BATCH = 2
TILE_BKS = (16, 32)  # the k-step of the kernel's tile variants
TILE_BMS = (128, 64, 32)  # their rows a block


def _geometries():
    """Every distinct (C, F, stride, pad) of a ``groups == 1`` conv of the
    six nets, in a fixed order."""
    seen = {}
    for net, make in sorted(MODELS.items()):
        for d in make().descriptors():
            if d.kind == "conv" and d.groups == 1:
                assert d.f_h == d.f_w
                seen.setdefault((d.i_d, d.f_h, d.stride, d.pad), f"{net}:{d.name}")
    return sorted(seen)


GEOMETRIES = _geometries()
FAST_CASES = [(g, bk) for g in GEOMETRIES for bk in TILE_BKS if g[0] % bk == 0]


def _gid(g):
    return "c{}-f{}-s{}-p{}".format(*g)


def _shape(c, f, stride, pad):
    """A small input, not square, with at least 2 x 2 outputs."""
    h, w = f + 2 * stride, f + stride + 1
    return BATCH, h, w, c


# ------------------------------------------------------ the kernel's map
def build_rows(b, h, w, c, oh, ow, stride, pad, rows):
    """``ImplicitA::build_rows``: each output pixel's (base, ih0, iw0),
    for ``rows`` rows (a whole number of blocks): rows past M get ih0 =
    -2^28, which fails every bounds check."""
    m_total = b * oh * ow
    m = np.arange(rows, dtype=np.int64)
    mm = np.minimum(m, m_total - 1)
    bb = mm // (oh * ow)
    rem = mm - bb * (oh * ow)
    o_h = rem // ow
    o_w = rem - o_h * ow
    ih0 = np.where(m < m_total, o_h * stride - pad, -(1 << 28))
    iw0 = np.where(m < m_total, o_w * stride - pad, 0)
    base = np.where(m < m_total, ((bb * h + ih0) * w + iw0) * c, 0)
    return base, ih0, iw0


def k_generic(k, w, c, fw, k_total):
    """``ImplicitA<false>::k_at``: k split into (fi, fj, c) by division."""
    ok = k < k_total
    kc = np.where(ok, k, 0)
    tap = kc // c
    cc = kc - tap * c
    fi = tap // fw
    fj = tap - fi * fw
    return fi, fj, (fi * w + fj) * c + cc, ok


def k_walk(w, c, fw, k_total, bk):
    """``ImplicitA<true>``: ``Walk::next`` from (0, 0, 0) once per k-step
    of ``bk``, and ``k_at`` = the walk's tap at channel c0 + kl."""
    assert c % bk == 0
    fi, fj, c0 = 0, 0, 0
    out = []
    for _ in range(-(-k_total // bk)):
        for kl in range(bk):
            out.append((fi, fj, (fi * w + fj) * c + c0 + kl))
        c0 += bk
        if c0 == c:
            c0 = 0
            fj += 1
            if fj == fw:
                fj = 0
                fi += 1
    fi, fj, off = (np.array(v, dtype=np.int64) for v in zip(*out))
    return fi, fj, off, np.ones_like(fi, dtype=bool)


def implicit_a_offsets(x_shape, f, stride, pad, bk=None, bm=1):
    """The (m, k) -> flat offset into x map, -1 where the copy writes 0
    (``src``): rows padded to a multiple of ``bm``; k by the walk when
    ``bk`` is given, else by division."""
    b, h, w, c = x_shape
    oh, ow = I.out_hw(h, w, f, f, stride, pad)
    k_total = f * f * c
    rows = -(-(b * oh * ow) // bm) * bm
    base, ih0, iw0 = build_rows(b, h, w, c, oh, ow, stride, pad, rows)
    if bk is None:
        fi, fj, off, kok = k_generic(np.arange(k_total, dtype=np.int64), w, c, f, k_total)
    else:
        fi, fj, off, kok = (v[:k_total] for v in k_walk(w, c, f, k_total, bk))
    ih = ih0[:, None] + fi[None, :]
    iw = iw0[:, None] + fj[None, :]
    ok = kok[None, :] & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
    return np.where(ok, base[:, None] + off[None, :], -1)


def gather(x, idx):
    flat = x.reshape(-1)
    return np.where(idx >= 0, flat[np.maximum(idx, 0)], np.float32(0))


def _reference(x, f, stride, pad):
    """The JAX package's patch matrix of each image, stacked over the batch
    (one jitted program per geometry: eager, each of the F*F slices would
    compile on its own)."""
    per_image = jax.jit(jax.vmap(functools.partial(im2col_ref, fh=f, fw=f, stride=stride, pad=pad)))
    cols = np.asarray(per_image(jnp.asarray(x)))
    return cols.reshape(-1, cols.shape[-1])


def _input(c, f, stride, pad):
    shape = _shape(c, f, stride, pad)
    rng = np.random.default_rng(c * 1000 + f * 10 + stride + pad)
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- tests
def test_every_net_geometry_is_covered():
    # C = 3 first convs (3x3, 7x7/s2, 11x11/s4), 1x1 at stride 2, 5x5 ...
    assert len(GEOMETRIES) >= 30
    assert {(3, 11, 4, 0), (3, 7, 2, 3), (3, 3, 1, 1)} <= set(GEOMETRIES)
    assert any(g[1] == 1 and g[2] == 2 for g in GEOMETRIES)
    assert any(g[1] == 5 for g in GEOMETRIES)
    assert any(g[0] % 16 for g in GEOMETRIES if g[0] > 3)  # odd C takes the generic form


@pytest.mark.parametrize("geom", GEOMETRIES, ids=_gid)
def test_generic_map_builds_the_reference_patch_matrix(geom):
    c, f, stride, pad = geom
    x = _input(c, f, stride, pad)
    idx = implicit_a_offsets(x.shape, f, stride, pad)
    got = gather(x, idx)
    want = _reference(x, f, stride, pad)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # and the port's plain patch matrix (B4's plain version) is the same
    np.testing.assert_array_equal(I.im2col_ref(torch.from_numpy(x), f, f, stride, pad).numpy(), want)


@pytest.mark.parametrize("case", FAST_CASES, ids=lambda c: f"{_gid(c[0])}-bk{c[1]}")
def test_one_tap_a_k_step_map_builds_the_reference_patch_matrix(case):
    (c, f, stride, pad), bk = case
    x = _input(c, f, stride, pad)
    fast = implicit_a_offsets(x.shape, f, stride, pad, bk=bk)
    np.testing.assert_array_equal(fast, implicit_a_offsets(x.shape, f, stride, pad))
    np.testing.assert_array_equal(gather(x, fast), _reference(x, f, stride, pad))


@pytest.mark.parametrize("geom", [g for g in GEOMETRIES if g[0] % 4 == 0], ids=_gid)
def test_four_k_from_a_multiple_of_four_lie_side_by_side(geom):
    """The tensor-core order's 16-byte copies where C % 4 == 0: the generic
    ``k_at`` of a k that is a multiple of 4 gives the tap of k .. k + 3,
    whose offsets in x run on by one (one bounds check holds for all
    four), and K % 4 == 0 keeps the four on the same side of K."""
    c, f, stride, pad = geom
    w, k_total = _shape(c, f, stride, pad)[2], f * f * c
    k = np.arange(0, k_total + 4, 4, dtype=np.int64)
    fi0, fj0, off0, ok0 = k_generic(k, w, c, f, k_total)
    for u in range(1, 4):
        fi, fj, off, ok = k_generic(k + u, w, c, f, k_total)
        np.testing.assert_array_equal(ok, ok0)
        np.testing.assert_array_equal(fi[ok], fi0[ok])
        np.testing.assert_array_equal(fj[ok], fj0[ok])
        np.testing.assert_array_equal(off[ok], off0[ok] + u)


@pytest.mark.parametrize("bm", TILE_BMS)
def test_rows_past_m_read_nothing(bm):
    # VGG-16's conv5 has 4 * 14 * 14 = 784 rows: not a multiple of 128
    c, f, stride, pad = 8, 3, 1, 1
    shape = (4, 14, 14, c)
    m_total = 4 * 14 * 14
    idx = implicit_a_offsets(shape, f, stride, pad, bk=8, bm=bm)
    assert idx.shape[0] % bm == 0 and idx.shape[0] >= m_total
    assert (idx[m_total:] == -1).all()
    assert (idx[:m_total].max() < np.prod(shape)) and (idx[:m_total] >= -1).all()


def test_padding_taps_are_the_only_zero_fills():
    # 3x3 pad 1 on 5 x 4: a corner output reads 4 of its 9 taps
    x_shape = (1, 5, 4, 2)
    idx = implicit_a_offsets(x_shape, 3, 1, 1)
    taps = idx.reshape(idx.shape[0], 9, 2)
    assert (taps[0] >= 0).all(axis=1).sum() == 4  # output (0, 0)
    assert (taps[1 * 4 + 1] >= 0).all()  # output (1, 1): fully inside
