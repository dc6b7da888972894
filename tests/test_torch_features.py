"""The port's model features against the JAX package's: the int8 KV cache
(``kv_quant``), PaliGemma's vision prefix (``n_patches``) and MusicGen's
codebooks (``n_codebooks``).

Both packages get the same configuration and the reference's weights
(``params_from_numpy``), and their inputs are made with numpy from a
seed.  On the CPU the decode attention takes B5's plain version, which
dequantizes an int8 cache into q's type as the reference's decode does;
the CUDA kernel's int8 and D = 256 routes are held to it on the card
(tests/test_torch_gpu.py).

Tolerances:

- quantizing, writing the ring and dequantizing are the same f32 (or
  bf16) operations in the same order in both packages: exact
  (``assert_array_equal``);
- the codebook embedding sum is the same f32 adds in codebook order:
  exact; the patch projection is one f32 matrix product: ``MODULE_TOL``;
- one module (the prefix-masked prefill attention, a dense block with a
  prefix): ``MODULE_TOL = 1e-5`` in f32 (the same f32 operations in
  another order);
- B5's plain version on an int8 cache against the reference's
  dequantize + ``decode_attention``: ``FD_TOL = 2e-4`` in f32, the
  reference's own flash-decode bar;
- a whole reduced model, prefill + 8 decode steps: ``MODEL_TOL = 1e-4``
  on the last hidden state and every step's logits in f32.  Every int8
  cache write is compared with the reference's: the scales within
  ``MODEL_TOL`` (relative), and a value may differ, by one, only where
  the reference's x / scale lies within ``INT8_TIE`` of a rounding
  boundary at the first value that differs in its sequence (the two
  packages' k and v agree to about 1e-5 in f32, and one int8 step moves
  a logit by far more than ``MODEL_TOL``); the f32 outputs are compared
  on the sequences no such value has reached (``tests/lm_parity.py``);
- bf16: the port's result as close to the reference's f32 result as the
  reference's own bf16 result is (RMS error at most ``BF16_SLACK`` times
  the reference's), the rule of tests/test_torch_models.py.  A MoE model
  may route otherwise in bf16 on a near-tie; Moonlight's bf16 runs are
  compared on the sequences no routing flip has reached, and each first
  flip must lie on a near-tie of the f32 run (``FLIP_MARGIN``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import init_params as ref_init_params
from repro.models.attention import blockwise_attention as ref_blockwise_attention
from repro.models.attention import decode_attention as ref_decode_attention
from repro.models.blocks import _quantize_kv as ref_quantize_kv
from repro.models.blocks import _ring_write as ref_ring_write
from repro.models.blocks import dense_block_apply as ref_dense_block_apply
from repro.models.model import embed_inputs as ref_embed_inputs
from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ops, runtime
from repro_torch.launch import serve as S
from repro_torch.models import init_cache, init_params
from repro_torch.models.attention import blockwise_attention
from repro_torch.models.blocks import _quantize_kv, _ring_write, dense_block_apply
from repro_torch.models.model import SIGLIP_DIM, embed_inputs, prefix_tokens

from lm_parity import assert_bf16_as_close, assert_f32_parity, cfgs, port_model, serve_both

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

MODULE_TOL = 1e-5
MODEL_TOL = 1e-4
FD_TOL = 2e-4
BF16_SLACK = 1.25
FLIP_MARGIN = 0.02
INT8_TIE = 1e-2  # |x / scale - n - 0.5| where an int8 value may differ between the packages


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------ the int8 cache
def _kv(rng, *shape):
    """k/v-like values with a zero row (the scale's 1e-6 floor) and values
    on rounding ties: x / scale = n + 0.5 exactly, for round half to even."""
    x = _np(rng, *shape)
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = np.float32(127.0) * (np.arange(shape[-1], dtype=np.float32) % 5 - 2.0) / 2.0 ** 4
    x[0, 1, 0, 0] = 127.0 / 2.0 ** 4 * 2.0  # amax 2^-3 * 127: the scale 2^-3, ties at half-integers
    return x


def test_quantize_kv_equals_the_reference():
    rng = np.random.default_rng(0)
    x = _kv(rng, 2, 7, 3, 16)
    want_q, want_s = ref_quantize_kv(jnp.asarray(x))
    got_q, got_s = _quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert float(got_s[0, 0, 0]) == np.float32(np.float32(1e-6) / np.float32(127.0))
    # bf16 input: quantized from its f32 value, as the reference's astype
    xb = torch.from_numpy(x).bfloat16()
    want_q, want_s = ref_quantize_kv(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    got_q, got_s = _quantize_kv(xb)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _quant_cache(b, w, hkv, d):
    port = {"k": torch.zeros(b, w, hkv, d, dtype=torch.int8), "v": torch.zeros(b, w, hkv, d, dtype=torch.int8),
            "pos": torch.full((w,), -1, dtype=torch.int32),
            "k_scale": torch.zeros(b, w, hkv), "v_scale": torch.zeros(b, w, hkv)}
    ref = {key: jnp.asarray(t.numpy()) for key, t in port.items()}
    return ref, port


# (W, prefill length, positions written in all): a prefill inside the
# ring, then decode writes that wrap it; a prefill that fills it exactly
@pytest.mark.parametrize("w,prefill_len,n_pos", [(16, 9, 12), (16, 9, 40), (16, 16, 19)])
def test_ring_write_with_scales_equals_the_reference(w, prefill_len, n_pos):
    rng = np.random.default_rng(w + n_pos)
    b, hkv, d = 2, 3, 16
    k, v = _kv(rng, b, n_pos, hkv, d), _np(rng, b, n_pos, hkv, d)
    positions = np.arange(n_pos, dtype=np.int32)
    ref, port = _quant_cache(b, w, hkv, d)
    writes = [slice(0, prefill_len)] + [slice(p, p + 1) for p in range(prefill_len, n_pos)]
    for sl in writes:
        ref = ref_ring_write(ref, jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]), jnp.asarray(positions[sl]))
        _ring_write(port, torch.from_numpy(k[:, sl]), torch.from_numpy(v[:, sl]), torch.from_numpy(positions[sl]))
    for key in ("k", "v", "pos", "k_scale", "v_scale"):
        assert port[key].dtype == {"k": torch.int8, "v": torch.int8, "pos": torch.int32}.get(key, torch.float32)
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_ring_write_keeps_the_last_window_of_a_long_prefill_quantized():
    """S > W: the last W positions, each at its own slot, with its scale."""
    rng = np.random.default_rng(5)
    b, w, hkv, d, s = 2, 8, 2, 16, 21
    k, v = _np(rng, b, s, hkv, d), _np(rng, b, s, hkv, d)
    _, port = _quant_cache(b, w, hkv, d)
    _ring_write(port, torch.from_numpy(k), torch.from_numpy(v), torch.arange(s, dtype=torch.int32))
    slots = np.arange(s - w, s) % w
    kq, ks = _quantize_kv(torch.from_numpy(k[:, -w:]))
    assert torch.equal(port["k"][:, slots], kq) and torch.equal(port["k_scale"][:, slots], ks)
    np.testing.assert_array_equal(port["pos"].numpy()[slots], np.arange(s - w, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_equals_the_reference_decode(dtype):
    rng = np.random.default_rng(1)
    kq, ks = ref_quantize_kv(jnp.asarray(_np(rng, 2, 9, 3, 16)))
    jdt = jnp.dtype(dtype)
    want = kq.astype(jdt) * ks[..., None].astype(jdt)
    got = FD.dequantize(torch.from_numpy(np.array(kq)), torch.from_numpy(np.array(ks)), getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# (B, Hkv, G, D, W, length, window): full attention, a window ring that
# has wrapped, PaliGemma's MQA at D = 256
@pytest.mark.parametrize("case", [(2, 2, 3, 32, 40, 29, 0), (2, 4, 1, 16, 24, 57, 24), (2, 1, 8, 256, 20, 13, 0)],
                         ids=lambda c: "x".join(map(str, c)))
def test_plain_decode_on_an_int8_cache_matches_the_reference(case):
    b, hkv, g, d, w, n_pos, window = case
    rng = np.random.default_rng(d + w)
    ref, port = _quant_cache(b, w, hkv, d)
    k, v = _np(rng, b, n_pos, hkv, d, scale=0.5), _np(rng, b, n_pos, hkv, d)
    positions = np.arange(n_pos, dtype=np.int32)
    cut = min(n_pos, w)
    for sl in [slice(0, cut)] + [slice(p, p + 1) for p in range(cut, n_pos)]:
        ref = ref_ring_write(ref, jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]), jnp.asarray(positions[sl]))
        _ring_write(port, torch.from_numpy(k[:, sl]), torch.from_numpy(v[:, sl]), torch.from_numpy(positions[sl]))
    q = _np(rng, b, hkv * g, d, scale=0.5)
    ck = ref["k"].astype(jnp.float32) * ref["k_scale"][..., None]
    cv = ref["v"].astype(jnp.float32) * ref["v_scale"][..., None]
    want = ref_decode_attention(jnp.asarray(q), ck, cv, n_pos, window=window,
                                positions=jnp.broadcast_to(ref["pos"][None], (b, w)))
    before = runtime.launch_counts()
    got = ops.flash_decode(torch.from_numpy(q).reshape(b, hkv, g, d), port["k"], port["v"], min(n_pos, w),
                           k_scale=port["k_scale"], v_scale=port["v_scale"])
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    np.testing.assert_allclose(got.reshape(b, hkv * g, d).numpy(), np.asarray(want), rtol=FD_TOL, atol=FD_TOL)


def test_int8_cache_takes_its_scales_and_nothing_else():
    q, k8 = torch.zeros(1, 1, 2, 8), torch.zeros(1, 5, 1, 8, dtype=torch.int8)
    s = torch.ones(1, 5, 1)
    with pytest.raises(TypeError):
        ops.flash_decode(q, k8, k8, 3)  # int8 without scales
    with pytest.raises(TypeError):
        ops.flash_decode(q, k8.float(), k8.float(), 3, k_scale=s, v_scale=s)  # scales on a float cache
    with pytest.raises(ValueError):
        ops.flash_decode(q, k8, k8, 3, k_scale=s[:, :4], v_scale=s)


# --------------------------------------------------------- inputs and prefix
def test_embed_inputs_sums_the_codebooks_as_the_reference():
    rcfg, cfg = cfgs("musicgen-large")
    ref_params = ref_init_params(rcfg, jax.random.PRNGKey(0))
    model = port_model(cfg, ref_params)
    assert tuple(model.embed.shape) == (4, cfg.vocab_size, cfg.d_model)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7, 4)).astype(np.int32)
    for mode, start in (("prefill", 0), ("decode", 7)):
        rx, rpos, rprefix, rn = ref_embed_inputs(rcfg, ref_params, {"tokens": jnp.asarray(toks)}, start, mode)
        x, pos, prefix, n = embed_inputs(cfg, model, {"tokens": torch.from_numpy(toks).long()}, start, mode)
        np.testing.assert_array_equal(x.detach().numpy(), np.asarray(rx))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
        assert (prefix, n) == (rprefix, rn) == (0, 0)


def test_embed_inputs_prepends_the_projected_patches_as_the_reference():
    rcfg, cfg = cfgs("paligemma-3b")
    ref_params = ref_init_params(rcfg, jax.random.PRNGKey(0))
    model = port_model(cfg, ref_params)
    assert tuple(model.vision_proj.shape) == (SIGLIP_DIM, cfg.d_model)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    patches = _np(rng, 2, cfg.n_patches, SIGLIP_DIM)
    rx, rpos, rprefix, rn = ref_embed_inputs(
        rcfg, ref_params, {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}, 0, "prefill")
    x, pos, prefix, n = embed_inputs(
        cfg, model, {"tokens": torch.from_numpy(toks).long(), "patches": torch.from_numpy(patches)}, 0, "prefill")
    assert x.shape == (2, cfg.n_patches + 5, cfg.d_model)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(rx), rtol=MODULE_TOL, atol=MODULE_TOL)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    assert prefix == n == rprefix == rn == cfg.n_patches == prefix_tokens(cfg)
    # decode: the patches live in the cache; the token alone, at its position
    x, pos, prefix, n = embed_inputs(cfg, model, {"tokens": torch.from_numpy(toks[:, :1]).long()}, 21, "decode")
    assert x.shape == (2, 1, cfg.d_model) and pos.tolist() == [21] and prefix == n == 0


# (S, prefix, chunk): a prefix inside the first chunk, one across chunks
@pytest.mark.parametrize("case", [(70, 20, 32), (149, 100, 64)], ids=lambda c: "x".join(map(str, c)))
def test_prefill_attention_is_bidirectional_over_the_prefix(case):
    s, prefix, chunk = case
    rng = np.random.default_rng(s)
    b, h, hkv, dh = 2, 8, 1, 32  # MQA, as PaliGemma
    q, k, v = _np(rng, b, s, h, dh), _np(rng, b, s, hkv, dh), _np(rng, b, s, hkv, dh)
    pos = np.arange(s, dtype=np.int32)
    want = ref_blockwise_attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)), prefix=prefix, chunk=chunk)
    got = blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)), prefix=prefix, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODULE_TOL, atol=MODULE_TOL)
    # the prefix attends past itself only within the prefix: a later key
    # moves no prefix row, and an earlier prefix row sees a later one
    causal = blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)), chunk=chunk)
    k2 = k.copy()
    k2[:, prefix:] += 1.0
    moved = blockwise_attention(*(torch.from_numpy(a) for a in (q, k2, v, pos, pos)), prefix=prefix, chunk=chunk)
    assert torch.equal(moved[:, :prefix], got[:, :prefix])
    assert not torch.allclose(causal[:, :prefix], got[:, :prefix])


def test_dense_block_with_the_prefix_matches_the_reference():
    rcfg, cfg = cfgs("paligemma-3b")
    ref_params = ref_init_params(rcfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: a[0], ref_params["groups"][0])
    blk = port_model(cfg, ref_params).groups[0][0]
    rng = np.random.default_rng(4)
    x, pos = _np(rng, 2, 40, cfg.d_model), np.arange(40, dtype=np.int32)
    want, _, _ = ref_dense_block_apply(rcfg, None, lp, jnp.asarray(x), None, "train", jnp.asarray(pos),
                                       {"window": 0, "prefix": cfg.n_patches})
    got, _ = dense_block_apply(cfg, blk, torch.from_numpy(x), None, "train", torch.from_numpy(pos), 0,
                               prefix=cfg.n_patches)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=MODULE_TOL, atol=MODULE_TOL)


# ------------------------------------------------------- prefill + decode
# (arch, overrides): the vision prefix; the codebooks on an int8 cache;
# Command R+ and Moonlight (MoE) on their int8 caches; each served with a
# prompt of PROMPT tokens and STEPS decode steps
PROMPT, STEPS = 13, 8
MODEL_CASES = {
    "paligemma": ("paligemma-3b", {}),
    "musicgen": ("musicgen-large", {}),
    "command_r_int8": ("command-r-plus-104b", {}),
    "moonlight_int8": ("moonshot-v1-16b-a3b", {}),
}


def test_model_cases_have_the_features_they_stand_for():
    by_name = {name: cfgs(arch, **kw)[1] for name, (arch, kw) in MODEL_CASES.items()}
    assert by_name["paligemma"].n_patches == 16 and by_name["paligemma"].n_kv_heads == 1
    assert by_name["musicgen"].n_codebooks == 4 and by_name["musicgen"].kv_quant
    assert by_name["command_r_int8"].kv_quant and by_name["command_r_int8"].parallel_residual
    assert by_name["moonlight_int8"].kv_quant and by_name["moonlight_int8"].n_experts
    for name in ("musicgen", "command_r_int8", "moonlight_int8"):
        cache = init_cache(by_name[name], 2, 11, device="cpu")
        for g in cache:
            assert g["k"].dtype == g["v"].dtype == torch.int8
            assert g["k_scale"].shape == g["k"].shape[:-1] and g["v_scale"].dtype == torch.float32


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_prefill_and_decode_match_reference_f32(case, monkeypatch):
    arch, kw = MODEL_CASES[case]
    out, rc, c, seen = serve_both(arch, "float32", PROMPT, STEPS, monkeypatch, seed=7, **kw)
    cfg = cfgs(arch, **kw)[1]
    assert [got.shape for _, got in out] == [(2, cfg.d_model)] + [
        (2, cfg.n_codebooks, cfg.vocab_size) if cfg.n_codebooks else (2, cfg.vocab_size)] * STEPS
    assert len(seen["qport"]) == (2 * cfg.n_layers * len(out) if cfg.kv_quant else 0)
    assert_f32_parity(cfg, out, rc, c, seen, MODEL_TOL, INT8_TIE)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_prefill_and_decode_bf16_as_close_to_f32_as_the_reference(case, monkeypatch):
    arch, kw = MODEL_CASES[case]
    exact, _, _, seen32 = serve_both(arch, "float32", PROMPT, STEPS, monkeypatch, seed=7, **kw)
    half, _, _, seen16 = serve_both(arch, "bfloat16", PROMPT, STEPS, monkeypatch, seed=7, **kw)
    assert_bf16_as_close(exact, half, seen32, seen16, BF16_SLACK, FLIP_MARGIN)


# ------------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large", "command-r-plus-104b"])
def test_cli_serves_the_feature_architectures_on_the_cpu(arch, capsys):
    before = runtime.launch_counts()
    out = S.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "9",
                  "--gen", "3"])
    assert runtime.launch_counts() == before  # plain versions only
    cfg = get_config(arch).reduced()
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert tuple(out["tokens"].shape) == (2, 3) + books
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all())
    assert out["max_len"] == 9 + cfg.n_patches + 3
    assert all(torch.isfinite(lg).all() for lg in out["logits"]) and torch.isfinite(out["last_hidden"]).all()
    if cfg.kv_quant:
        assert all(c["k"].dtype == torch.int8 for c in out["caches"])
    text = capsys.readouterr().out
    assert "prefill: 2x9" in text and "tok/s" in text
    assert ("image patches" in text) == bool(cfg.n_patches) and ("codebooks" in text) == bool(books)


def test_generate_refuses_a_prompt_without_its_features():
    cfg = get_config("musicgen-large").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="prompt"):
        S.generate(cfg, model, torch.zeros(2, 5, dtype=torch.long), 1)
    pcfg = get_config("paligemma-3b").reduced()
    with pytest.raises(ValueError, match="patches"):
        S.generate(pcfg, init_params(pcfg, seed=0, device="cpu"), torch.zeros(2, 5, dtype=torch.long), 1)


# (field, value): each feature on a reduced dense config builds and serves
@pytest.mark.parametrize("field,value", [("kv_quant", True), ("n_patches", 4), ("n_codebooks", 2)])
def test_each_option_builds_on_a_reduced_dense_config(field, value):
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), **{field: value})
    model = init_params(cfg, seed=0, device="cpu")
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6) + books)).long()
    patches = torch.randn(2, cfg.n_patches, SIGLIP_DIM) if cfg.n_patches else None
    out = S.generate(cfg, model, prompt, 2, keep_logits=2, patches=patches)
    assert tuple(out["tokens"].shape) == (2, 2) + books
    assert out["logits"][0].shape == (2,) + books + (cfg.vocab_size,)
    assert out["max_len"] == 6 + (cfg.n_patches or 0) + 2
    assert (out["caches"][0]["k"].dtype == torch.int8) == bool(cfg.kv_quant)
