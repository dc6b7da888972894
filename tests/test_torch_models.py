"""The port's transformer substrate against the JAX package's: the
configs and parameter shapes of every architecture (dense, MoE, Hymba
and xLSTM blocks), the shared modules, and Hymba.

Both packages get the same configuration and the reference's weights
(``params_from_numpy``), and their inputs are made with numpy from a seed.
On the CPU the port's kernels take their plain versions (B5 and B6 are
held to the reference's Pallas kernels in tests/test_torch_flash_decode.py
and tests/test_torch_ssd.py), so these tests hold the algorithm: configs,
parameter shapes, RoPE, the blockwise prefill attention, the Mamba head,
one Hymba block, and prefill + greedy decode of a reduced Hymba with GQA
(G = 2), a prompt that is no chunk multiple, and a prompt past the window.
The dense and MoE blocks and models are held in tests/test_torch_dense.py
and tests/test_torch_moe.py.

Tolerances, in f32: ``1e-5`` for one module (the same f32 operations in
another order), ``1e-4`` for the whole model's hidden states and logits.
In bf16 the two frameworks round at different places (XLA on the CPU
keeps f32 through fused elementwise chains), and each package's bf16
result lies farther from the reference's f32 result than any fixed
``3e-2`` bar between the two: a Hymba block's outputs are of order 5,
where one bf16 ulp is 0.03.  So the bf16 tests hold that the port's bf16
result is as close to the reference's f32 result as the reference's own
bf16 result is (RMS error at most ``BF16_SLACK`` times the reference's).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import abstract_params as ref_abstract_params
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import serve_step as ref_serve_step
from repro.models.attention import blockwise_attention as ref_blockwise_attention
from repro.models.attention import rope as ref_rope
from repro.models.blocks import hymba_block_apply as ref_hymba_block_apply
from repro.models.ssm import mamba_mix as ref_mamba_mix
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import runtime
from repro_torch.models import (
    abstract_params,
    forward,
    init_cache,
    init_params,
    layer_groups,
    params_from_numpy,
    prefill,
    serve_step,
)
from repro_torch.models.attention import blockwise_attention, rope
from repro_torch.models.blocks import hymba_block_apply
from repro_torch.models.model import N_META_TOKENS
from repro_torch.models.params import tree_leaf
from repro_torch.models.ssm import mamba_mix

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

MODULE_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_SLACK = 1.25


def _cfgs(dtype="float32", **kw):
    """(reference, port) reduced Hymba with G = 2 query heads per KV head."""
    ref = dataclasses.replace(ref_get_config("hymba-1.5b").reduced(), n_kv_heads=2,
                              compute_dtype=dtype, **kw)
    port = dataclasses.replace(get_config("hymba-1.5b").reduced(), n_kv_heads=2,
                               compute_dtype=dtype, **kw)
    return ref, port


@pytest.fixture(scope="module")
def ref_params():
    rcfg, _ = _cfgs()
    return ref_init_params(rcfg, jax.random.PRNGKey(0))


def _model(cfg, ref_params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ----------------------------------------------------------------- configs
def test_configs_equal_the_reference_field_by_field():
    assert ARCHS == REF_ARCHS
    for arch in ARCHS:
        mine, ref = get_config(arch), ref_get_config(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
        assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced()), arch


# every architecture whose blocks are ported, with its features: the
# vision projection, the codebook embeddings and heads (the int8 KV cache
# adds no parameter)
PORTED = ["smollm-360m", "starcoder2-15b", "command-r-plus-104b", "deepseek-moe-16b",
          "moonshot-v1-16b-a3b", "olmoe-1b-7b", "hymba-1.5b", "paligemma-3b", "musicgen-large",
          "xlstm-1.3b"]


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", PORTED)
def test_parameter_shapes_equal_the_reference(arch, reduced):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    ref_tree = ref_abstract_params(rcfg)
    mine = abstract_params(cfg)  # the meta device: no storage
    n_ref = len(jax.tree.leaves(ref_tree))
    names = dict(mine.named_parameters())
    per_leaf = {}
    for name, p in names.items():
        leaf, layer = tree_leaf(ref_tree, name)
        want = tuple(leaf.shape[1:]) if layer is not None else tuple(leaf.shape)
        assert tuple(p.shape) == want, name
        assert str(p.dtype).split(".")[-1] == str(leaf.dtype), name
        per_leaf.setdefault(id(leaf), []).append(layer)
    # every reference leaf is covered, every stacked layer exactly once
    assert len(per_leaf) == n_ref
    for leaf in jax.tree.leaves(ref_tree):
        layers = per_leaf[id(leaf)]
        assert layers == [None] or sorted(layers) == list(range(leaf.shape[0]))
    if reduced:
        real = init_params(cfg, seed=0, device="cpu")
        assert {n: p.shape for n, p in real.named_parameters()} == {n: p.shape for n, p in names.items()}


def test_init_params_is_seeded():
    cfg = get_config("hymba-1.5b").reduced()
    a, b = init_params(cfg, seed=3, device="cpu"), init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    assert torch.equal(a.groups[1][0].attn.wq, b.groups[1][0].attn.wq)
    assert not torch.equal(a.groups[1][0].attn.wq, c.groups[1][0].attn.wq)
    # the reference's scales: ones for norms, d**-0.5 for projections
    assert torch.equal(a.final_norm.scale, torch.ones(cfg.d_model))
    assert abs(float(a.embed.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


# every block kind of the configs is ported; another raises, as the
# reference's _init_group does
def test_unknown_block_kind_raises():
    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(), block_kind="retnet")
    with pytest.raises(ValueError, match="retnet"):
        layer_groups(cfg)
    with pytest.raises(ValueError, match="retnet"):
        init_params(cfg, device="cpu")


# the model features build on Hymba too: the int8 cache in its attention
# caches, the codebooks, the patch projection
@pytest.mark.parametrize("field", ["kv_quant", "n_patches", "n_codebooks"])
def test_features_build_on_hymba(field):
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), **{field: 2})
    model = init_params(cfg, device="cpu")
    caches = init_cache(cfg, 2, 9, device="cpu")
    assert (caches[0]["attn"]["k"].dtype == torch.int8) == (field == "kv_quant")
    assert (model.vision_proj is not None) == (field == "n_patches")
    assert (model.heads is not None) == (field == "n_codebooks")


# ----------------------------------------------------------------- modules
def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = _np(rng, 2, 37, 3, 16)
    pos = np.arange(100, 137, dtype=np.int32)
    want = ref_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODULE_TOL, atol=MODULE_TOL)


# (sq, window, prefix, chunk): ragged chunks, sliding window, prefix-LM
ATTN_CASES = [(149, 0, 0, 64), (149, 40, 0, 64), (70, 0, 20, 32), (33, 16, 0, 512)]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_blockwise_attention_forward_matches_reference(case):
    sq, window, prefix, chunk = case
    rng = np.random.default_rng(sq + window)
    b, h, hkv, dh = 2, 4, 2, 16
    q, k, v = _np(rng, b, sq, h, dh), _np(rng, b, sq, hkv, dh), _np(rng, b, sq, hkv, dh)
    pos = np.arange(sq, dtype=np.int32)
    want = ref_blockwise_attention(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                                   window=window, prefix=prefix, chunk=chunk)
    got = blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)),
                              window=window, prefix=prefix, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODULE_TOL, atol=MODULE_TOL)


def test_mamba_mix_prefill_and_decode_match_reference(ref_params):
    rcfg, cfg = _cfgs()
    model = _model(cfg, ref_params)
    mp = jax.tree.map(lambda a: a[0], ref_params["groups"][1]["mamba"])
    rng = np.random.default_rng(1)
    u = _np(rng, 2, 149, cfg.d_model)
    want, (rconv, rh) = ref_mamba_mix(mp, jnp.asarray(u), rcfg)
    got, (conv, hs) = mamba_mix(model.groups[1][0].mamba, torch.from_numpy(u), cfg)
    for g, w in ((got, want), (conv, rconv), (hs, rh)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=MODULE_TOL, atol=MODULE_TOL)
    u1 = _np(rng, 2, 1, cfg.d_model)
    want1, (rconv1, rh1) = ref_mamba_mix(mp, jnp.asarray(u1), rcfg, state=(rconv, rh), decode=True)
    got1, (conv1, hs1) = mamba_mix(model.groups[1][0].mamba, torch.from_numpy(u1), cfg,
                                   state=(conv, hs), decode=True)
    for g, w in ((got1, want1), (conv1, rconv1), (hs1, rh1)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=MODULE_TOL, atol=MODULE_TOL)


def _block_outputs(ref_params, dtype):
    """One window-layer Hymba block on the same bf16-representable input:
    (reference, port) outputs in ``dtype``."""
    rcfg, cfg = _cfgs(dtype)
    jdt = jnp.dtype(dtype)
    lp = jax.tree.map(lambda a: a[0].astype(jdt), ref_params["groups"][1])
    rng = np.random.default_rng(2)
    x = np.asarray(jnp.asarray(_np(rng, 2, 149, cfg.d_model), jnp.bfloat16), np.float32)
    pos = np.arange(149, dtype=np.int32)
    want, _, _ = ref_hymba_block_apply(rcfg, None, lp, jnp.asarray(x, jdt), None, "train",
                                       jnp.asarray(pos), {"window": cfg.sliding_window})
    blk = _model(cfg, ref_params).compute_blocks(getattr(torch, dtype))[1][0]
    got = hymba_block_apply(cfg, blk, torch.from_numpy(x).to(getattr(torch, dtype)), None, "train",
                            torch.from_numpy(pos), cfg.sliding_window)
    return np.asarray(want, np.float32), got.detach().float().numpy()


def test_hymba_block_matches_reference(ref_params):
    want, got = _block_outputs(ref_params, "float32")
    np.testing.assert_allclose(got, want, rtol=MODULE_TOL, atol=MODULE_TOL)


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def test_hymba_block_bf16_as_close_to_f32_as_the_reference(ref_params):
    exact, _ = _block_outputs(ref_params, "float32")
    ref16, port16 = _block_outputs(ref_params, "bfloat16")
    assert _rms(port16, exact) <= BF16_SLACK * _rms(ref16, exact), (_rms(port16, exact), _rms(ref16, exact))


# ------------------------------------------------------- prefill + decode
def _serve_both(ref_params, dtype, prompt_len, steps, seed=0):
    """Prefill a 2-sequence prompt and run ``steps`` teacher-forced decode
    steps in both packages; returns [(ref, port)] for the prefill's last
    hidden state, then each step's logits, and the two final caches."""
    rcfg, cfg = _cfgs(dtype)
    rp = jax.tree.map(lambda a: a, ref_params)
    model = _model(cfg, ref_params)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, prompt_len + steps)).astype(np.int32)
    max_len = prompt_len + N_META_TOKENS + steps
    rc = ref_init_cache(rcfg, 2, max_len)
    rh, rc = ref_prefill(rcfg, rp, {"tokens": jnp.asarray(toks[:, :prompt_len])}, rc)
    c = init_cache(cfg, 2, max_len, device="cpu")
    before = runtime.launch_counts()
    h = prefill(cfg, model, {"tokens": torch.from_numpy(toks[:, :prompt_len]).long()}, c)
    out = [(np.asarray(rh, np.float32), h.float().numpy())]
    for i in range(steps):
        pos = prompt_len + N_META_TOKENS + i
        t = toks[:, prompt_len + i:prompt_len + i + 1]
        rl, rc = ref_serve_step(rcfg, rp, rc, jnp.asarray(t), jnp.int32(pos))
        lg = serve_step(cfg, model, c, torch.from_numpy(t).long(), pos)
        out.append((np.asarray(rl), lg.numpy()))
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    return out, rc, c


@pytest.mark.parametrize("prompt_len,steps", [(21, 4), (72, 3)], ids=["ragged", "beyond_window"])
def test_prefill_and_decode_match_reference_f32(ref_params, prompt_len, steps):
    """Prompt 21 (149 with the meta tokens: no chunk multiple, longer than
    the window of 64) and prompt 72 (200 tokens, past the window again)."""
    out, rc, c = _serve_both(ref_params, "float32", prompt_len, steps)
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL)
    # the caches agree too: ring slots, positions and Mamba states
    for rg, g in zip(rc, c):
        np.testing.assert_array_equal(g["attn"]["pos"].numpy(), np.asarray(rg["attn"]["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(g["attn"][key].numpy(), np.asarray(rg["attn"][key]),
                                       rtol=MODEL_TOL, atol=MODEL_TOL)
        for mine, ref in zip(g["ssm"], rg["ssm"]):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=MODEL_TOL, atol=MODEL_TOL)


def test_prefill_and_decode_bf16_as_close_to_f32_as_the_reference(ref_params):
    exact, _, _ = _serve_both(ref_params, "float32", 21, 4)
    half, _, _ = _serve_both(ref_params, "bfloat16", 21, 4)
    for (want, _), (ref16, port16) in zip(exact, half):
        assert np.isfinite(port16).all()
        assert _rms(port16, want) <= BF16_SLACK * _rms(ref16, want), (_rms(port16, want), _rms(ref16, want))


def test_prefill_hidden_equals_the_forward_without_cache(ref_params):
    _, cfg = _cfgs()
    model = _model(cfg, ref_params)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9))).long()
    full, _ = forward(cfg, model, {"tokens": toks}, mode="train")
    last = prefill(cfg, model, {"tokens": toks}, init_cache(cfg, 2, 9 + N_META_TOKENS, device="cpu"))
    assert torch.equal(full[:, -1], last)
    with pytest.raises(ValueError):
        forward(cfg, model, {"tokens": toks}, mode="decode")
