"""The port's decode attention (B5) against the JAX package's.

On the CPU, ``ops.flash_decode`` takes the plain version of the CUDA
kernel (``kernels/flash_decode.py::flash_decode_ref``), which must match
the reference's Pallas kernel run in interpret mode and its jnp oracle
``ref.flash_decode_ref``; the CUDA kernel itself runs only on a card
(tests/test_torch_gpu.py).  The kernel attends over a *prefix* of cache
slots where the model's reference decode masks by *position*; the last
tests hold the two equal on ring buffers before and after they wrap, and
the port's ring write equal to the reference's beyond the window.

The CUDA kernel cuts the cache into splits, leaves a partial softmax
state for each and adds the partials in split order; a few-line
emulation of that algorithm (``_split_kv``) is held here against the
plain version and the reference kernel, with empty splits and a split
cut by the valid prefix.

Tolerances: ``2e-4`` in f32, the reference's own bar
(tests/test_kernels.py::test_flash_decode_matches_ref); ``3e-2`` in bf16,
its bar for bf16 operands (test_flash_decode_dtypes).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_decode import flash_decode as ref_flash_decode
from repro.models.attention import decode_attention as ref_decode_attention
from repro.models.blocks import _ring_write as ref_ring_write
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ops, runtime
from repro_torch.models.attention import decode_attention
from repro_torch.models.blocks import _ring_write

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

TOL = 2e-4


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# (hq, d, s, length, block_s): the reference's kernel test shapes
CASES = [(8, 64, 256, 256, 128), (4, 32, 300, 177, 64), (16, 128, 128, 1, 128), (1, 64, 512, 400, 128)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_route_matches_reference_kernel(case):
    hq, d, s, length, bs = case
    rng = np.random.default_rng(hq * d + s)
    q, k, v = _np(rng, hq, d, scale=0.5), _np(rng, s, d, scale=0.5), _np(rng, s, d)
    want = np.asarray(ref_flash_decode(q, k, v, jnp.int32(length), block_s=bs, interpret=True))
    oracle = np.asarray(ref.flash_decode_ref(q, k, v, length))
    before = runtime.launch_counts()
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_decode(qt[None, None], kt[None, :, None], vt[None, :, None], length)[0, 0]
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == (hq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,hkv,g,d,w,length", [(3, 2, 5, 64, 100, 77), (2, 5, 5, 64, 130, 130), (1, 3, 2, 32, 65, 1)])
def test_batched_gqa_matches_reference_kernel_per_head(b, hkv, g, d, w, length):
    """The batched, GQA-grouped form is the reference kernel vmapped over
    (batch, KV head), as the TPU kernel is used."""
    rng = np.random.default_rng(b * w + g)
    q, k, v = _np(rng, b, hkv, g, d, scale=0.5), _np(rng, b, w, hkv, d, scale=0.5), _np(rng, b, w, hkv, d)
    per_head = jax.vmap(jax.vmap(
        lambda qq, kk, vv: ref_flash_decode(qq, kk, vv, jnp.int32(length), block_s=64, interpret=True)
    ))
    want = np.asarray(per_head(q, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)))
    got = ops.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)), length)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # backend="torch" is the same plain version, asked for by name
    assert torch.equal(ops.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)), length, backend="torch"), got)


def test_bf16_operands_match_reference_kernel():
    rng = np.random.default_rng(7)
    q, k, v = (jnp.asarray(_np(rng, *sh), jnp.bfloat16) for sh in ((8, 64), (256, 64), (256, 64)))
    want = np.asarray(ref_flash_decode(q, k, v, jnp.int32(200), interpret=True).astype(jnp.float32))
    qt, kt, vt = (torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16() for a in (q, k, v))
    got = ops.flash_decode(qt[None, None], kt[None, :, None], vt[None, :, None], 200)[0, 0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


def test_refuses_length_outside_the_cache():
    q, k = torch.zeros(1, 1, 2, 8), torch.zeros(1, 5, 1, 8)
    for bad in (0, 6):
        with pytest.raises(ValueError):
            ops.flash_decode(q, k, k, bad)
    with pytest.raises(ValueError):
        ops.flash_decode(q, k, k, 3, backend="jnp")


# ------------------------------------------- the split-KV algorithm (B5)
def _split_kv(q, k, v, length, split):
    """Decode attention as ``csrc/flash_decode.cu`` computes it: one partial
    ``(m, l, acc)`` per split of ``split`` cache slots (an empty one, m =
    -1e30 and l = acc = 0, for a split wholly past ``length``; a split cut
    by ``length`` holds only its valid slots), then the partials added in
    split order: ``M = max m_s``, ``L = sum l_s exp(m_s - M)``, ``out = sum
    acc_s exp(m_s - M) / max(L, 1e-30)``."""
    b, hkv, g, d = q.shape
    parts = []
    for s0 in range(0, k.shape[1], split):
        n = min(s0 + split, length) - s0
        if n <= 0:
            parts.append((torch.full((b, hkv, g), -1e30), torch.zeros(b, hkv, g), torch.zeros(b, hkv, g, d)))
            continue
        logits = torch.einsum("bkgd,bskd->bkgs", q, k[:, s0:s0 + n]) / d ** 0.5
        m = logits.max(-1).values
        p = torch.exp(logits - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bkgs,bskd->bkgd", p, v[:, s0:s0 + n])))
    big_m = torch.stack([m for m, _, _ in parts]).max(0).values
    big_l, acc = torch.zeros_like(big_m), torch.zeros_like(q)
    for m, l, a in parts:  # in split order
        w = torch.exp(m - big_m)
        big_l = big_l + l * w
        acc = acc + a * w[..., None]
    return acc / torch.clamp(big_l, min=1e-30)[..., None]


# (b, hkv, g, d, w, length, split): ragged prefixes, a prefix ending on and
# either side of a split boundary, most splits empty, one split in all
SPLIT_CASES = [
    (2, 2, 5, 64, 300, 177, 64), (2, 2, 5, 64, 300, 63, 64), (2, 2, 5, 64, 300, 64, 64),
    (2, 2, 5, 64, 300, 65, 64), (1, 3, 2, 32, 1000, 1, 128), (1, 3, 2, 32, 1000, 777, 256),
    (2, 1, 4, 16, 130, 130, 512),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "x".join(map(str, c)))
def test_split_kv_matches_plain_version_and_reference_kernel(case):
    b, hkv, g, d, w, length, split = case
    rng = np.random.default_rng(w + length + split)
    q, k, v = _np(rng, b, hkv, g, d, scale=0.5), _np(rng, b, w, hkv, d, scale=0.5), _np(rng, b, w, hkv, d)
    got = _split_kv(*(torch.from_numpy(a) for a in (q, k, v)), length, split)
    plain = FD.flash_decode_ref(*(torch.from_numpy(a) for a in (q, k, v)), length)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
    per_head = jax.vmap(jax.vmap(
        lambda qq, kk, vv: ref_flash_decode(qq, kk, vv, jnp.int32(length), block_s=64, interpret=True)
    ))
    want = np.asarray(per_head(q, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_empty_splits_change_no_bit():
    """Splits wholly past the prefix weigh exp(-1e30 - M) = 0: the result
    is bitwise the same as with the cache cut after the prefix's splits."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(_np(rng, *sh)) for sh in ((2, 2, 3, 32), (2, 640, 2, 32), (2, 640, 2, 32)))
    full = _split_kv(q, k, v, 150, 64)
    assert torch.equal(full, _split_kv(q, k[:, :192], v[:, :192], 150, 64))


# ------------------------------------- a prefix stands for the position mask
def _ring_cache(rng, b, w, hkv, d, n_pos, prefill_len):
    """The port's ring buffer after a prefill of ``prefill_len`` positions
    and single-position decode writes up to ``n_pos`` positions."""
    cache = {"k": torch.zeros(b, w, hkv, d), "v": torch.zeros(b, w, hkv, d),
             "pos": torch.full((w,), -1, dtype=torch.int32)}
    k = torch.from_numpy(_np(rng, b, n_pos, hkv, d, scale=0.5))
    v = torch.from_numpy(_np(rng, b, n_pos, hkv, d))
    positions = torch.arange(n_pos, dtype=torch.int32)
    _ring_write(cache, k[:, :prefill_len], v[:, :prefill_len], positions[:prefill_len])
    for p in range(prefill_len, n_pos):
        _ring_write(cache, k[:, p:p + 1], v[:, p:p + 1], positions[p:p + 1])
    return cache


# (max_len, window, n_pos, prefill_len): W = min(max_len, window) or max_len
RING_CASES = [
    (200, 0, 150, 149),  # full attention: W = max_len, slot i holds position i
    (200, 64, 40, 30),  # window layer before the ring wraps
    (200, 64, 150, 149),  # prefill longer than the ring, then a decode write
    (200, 64, 203, 149),  # wrapped by prefill and again by decode
    (50, 64, 47, 20),  # max_len below the window: W = max_len, never wraps
]


@pytest.mark.parametrize("case", RING_CASES, ids=lambda c: "x".join(map(str, c)))
def test_prefix_of_slots_selects_the_reference_positions(case):
    max_len, window, n_pos, prefill_len = case
    w = min(max_len, window) if window else max_len
    rng = np.random.default_rng(n_pos)
    b, hkv, g, d = 2, 2, 3, 32
    cache = _ring_cache(rng, b, w, hkv, d, n_pos, prefill_len)
    q = torch.from_numpy(_np(rng, b, hkv * g, d, scale=0.5))
    length = n_pos  # the newest position is n_pos - 1
    got = ops.flash_decode(q.reshape(b, hkv, g, d), cache["k"], cache["v"], min(length, w))
    pos = np.broadcast_to(cache["pos"].numpy()[None], (b, w))
    want = ref_decode_attention(
        jnp.asarray(q.numpy()), jnp.asarray(cache["k"].numpy()), jnp.asarray(cache["v"].numpy()),
        length, window=window, positions=jnp.asarray(pos),
    )
    np.testing.assert_allclose(got.reshape(b, hkv * g, d).numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # the port's own position-masked decode_attention agrees too
    mine = decode_attention(q, cache["k"], cache["v"], length, window=window,
                            positions=torch.from_numpy(np.ascontiguousarray(pos)))
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("prefill_len", [30, 64, 149])
def test_ring_write_matches_reference_beyond_the_window(prefill_len):
    """A prefill longer than the ring scatters several positions into one
    slot; the port writes only the last W (last-wins made explicit).  The
    reference's scatter on the CPU leaves the same cache."""
    rng = np.random.default_rng(prefill_len)
    b, w, hkv, d = 2, 64, 2, 16
    k, v = _np(rng, b, prefill_len, hkv, d), _np(rng, b, prefill_len, hkv, d)
    positions = np.arange(prefill_len, dtype=np.int32)
    want = ref_ring_write(
        {"k": jnp.zeros((b, w, hkv, d)), "v": jnp.zeros((b, w, hkv, d)),
         "pos": jnp.full((w,), -1, jnp.int32)},
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions),
    )
    cache = {"k": torch.zeros(b, w, hkv, d), "v": torch.zeros(b, w, hkv, d),
             "pos": torch.full((w,), -1, dtype=torch.int32)}
    _ring_write(cache, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(positions))
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(cache[key].numpy(), np.asarray(want[key]))


def test_plain_version_is_its_own_module_function():
    """``ops.flash_decode`` on a CPU tensor is exactly ``flash_decode_ref``."""
    rng = np.random.default_rng(3)
    q, k = torch.from_numpy(_np(rng, 2, 2, 3, 16)), torch.from_numpy(_np(rng, 2, 40, 2, 16))
    assert torch.equal(ops.flash_decode(q, k, k, 33), FD.flash_decode_ref(q, k, k, 33))
