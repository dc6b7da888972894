"""The port's dense blocks, and prefill + greedy decode of reduced dense
and MoE models, against the JAX package's.

Both packages get the same configuration and the reference's weights
(``params_from_numpy``), and their inputs are made with numpy from a seed.
On the CPU the decode attention takes B5's plain version (B5 is held to
the reference's Pallas kernel in ``tests/test_torch_flash_decode.py``), so
these tests hold the algorithm.  The block variants:

- SmolLM: GQA, at G = 2 and G = 3 query heads per KV head (the reference
  groups q as ``[B, Hkv, G, dh]``; the port's decode reshape assumes the
  same head order);
- StarCoder2: layer norm, biases, GELU without GLU, a window of 64;
- Command R: ``parallel_residual`` (no ``ln2``), layer norm, served on a
  bf16/f32 cache (``kv_quant=False``) and on its int8 one (the config's
  ``kv_quant=True``).  Every int8 write is compared with the reference's:
  the scales within ``MODEL_TOL`` (relative), and a value may differ, by
  one, only where the reference's x / scale lies within ``INT8_TIE`` of a
  rounding boundary at the first value that differs in its sequence (the
  two packages' k and v agree to about 1e-5 in f32, and one int8 step
  moves a logit by far more than ``MODEL_TOL``); the f32 outputs are
  compared on the sequences no such value has reached
  (``tests/lm_parity.py``).

Tolerances, as in ``tests/test_torch_models.py``: in f32 ``1e-5`` for one
block and ``1e-4`` for a whole model's hidden states and logits; in bf16
the port's result must lie as close to the reference's f32 result as the
reference's own bf16 result does (RMS error at most ``BF16_SLACK`` times
the reference's).

A MoE model routes: a top-k near-tie can pick another expert when the
inputs differ by one rounding, which moves that token's output by far
more than any bar.  In f32 the two packages route identically, and the
tests assert it.  In bf16 the bf16 runs' routes are compared with the f32
run's: every primary flip (the first in its sequence; the later ones
follow from it) must sit on a near-tie (the f32 run's gap between its
k-th and (k+1)-th probability below ``FLIP_MARGIN``), and the RMS bar is
held over the sequences that no flip has reached.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import init_params as ref_init_params
from repro.models.blocks import dense_block_apply as ref_dense_block_apply
import repro_torch.models.moe as M
from repro_torch.configs import get_config
from repro_torch.kernels import runtime
from repro_torch.launch import serve as S
from repro_torch.models import forward, init_cache, init_params, prefill
from repro_torch.models.blocks import dense_block_apply
from repro_torch.models.model import layer_groups, prefix_tokens

from lm_parity import assert_bf16_as_close, assert_f32_parity, cfgs, port_model, rms, serve_both

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

MODULE_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_SLACK = 1.25
FLIP_MARGIN = 0.02  # a bf16 run may route otherwise only where f32's k-th and (k+1)-th probs are this close
INT8_TIE = 1e-2  # |x / scale - n - 0.5| where an int8 value may differ between the packages

# (name, arch, config overrides); every config is the arch's reduced one
VARIANTS = {
    "smollm_g2": ("smollm-360m", {"n_kv_heads": 2}),
    "smollm_g3": ("smollm-360m", {"n_heads": 6, "n_kv_heads": 2, "head_dim": 32}),
    "starcoder2": ("starcoder2-15b", {}),
    "command_r": ("command-r-plus-104b", {"kv_quant": False}),
}


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_variants_have_the_features_they_stand_for():
    by_name = {name: cfgs(arch, **kw)[1] for name, (arch, kw) in VARIANTS.items()}
    assert by_name["smollm_g2"].q_per_kv == 2 and by_name["smollm_g3"].q_per_kv == 3
    sc = by_name["starcoder2"]
    assert (sc.norm, sc.use_bias, sc.act, sc.glu, sc.sliding_window) == ("layer", True, "gelu", False, 64)
    cr = by_name["command_r"]
    assert cr.parallel_residual and cr.norm == "layer" and not cr.kv_quant
    model = init_params(cr, seed=0, device="cpu")
    assert model.groups[0][0].ln2 is None and model.meta_tokens is None
    assert prefix_tokens(cr) == 0 and prefix_tokens(get_config("hymba-1.5b")) == 128
    assert [g.kind for g in layer_groups(cr)] == ["dense"]


# ------------------------------------------------------------------ blocks
def _block_outputs(variant, dtype, mode="train"):
    """One dense block of ``variant`` on the same bf16-representable input:
    (reference, port) outputs in ``dtype``."""
    arch, kw = VARIANTS[variant]
    rcfg, cfg = cfgs(arch, dtype, **kw)
    ref_params = ref_init_params(rcfg, jax.random.PRNGKey(0))
    jdt = jnp.dtype(dtype)
    lp = jax.tree.map(lambda a: a[0].astype(jdt), ref_params["groups"][0])
    rng = np.random.default_rng(2)
    x = np.asarray(jnp.asarray(_np(rng, 2, 149, cfg.d_model), jnp.bfloat16), np.float32)
    pos = np.arange(149, dtype=np.int32)
    want, _, _ = ref_dense_block_apply(rcfg, None, lp, jnp.asarray(x, jdt), None, "train",
                                       jnp.asarray(pos), {"window": cfg.sliding_window})
    blk = port_model(cfg, ref_params).compute_blocks(getattr(torch, dtype))[0][0]
    got, _ = dense_block_apply(cfg, blk, torch.from_numpy(x).to(getattr(torch, dtype)), None, "train",
                               torch.from_numpy(pos), cfg.sliding_window)
    return np.asarray(want, np.float32), got.detach().float().numpy()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dense_block_matches_reference(variant):
    want, got = _block_outputs(variant, "float32")
    np.testing.assert_allclose(got, want, rtol=MODULE_TOL, atol=MODULE_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dense_block_bf16_as_close_to_f32_as_the_reference(variant):
    exact, _ = _block_outputs(variant, "float32")
    ref16, port16 = _block_outputs(variant, "bfloat16")
    assert rms(port16, exact) <= BF16_SLACK * rms(ref16, exact), (rms(port16, exact), rms(ref16, exact))


# ------------------------------------------------------- prefill + decode
# (name, arch, prompt, steps, overrides): SmolLM with G = 2; StarCoder2
# with a prompt past its window of 64 (the ring wraps); OLMoE, at its
# capacity factor and at one that drops pairs in the prefill; DeepSeek
# (a dense group, then MoE with shared experts); Command R
SERVE_CASES = [
    ("smollm", "smollm-360m", 21, 4, {"n_kv_heads": 2}),
    ("starcoder2_past_window", "starcoder2-15b", 72, 3, {}),
    ("olmoe", "olmoe-1b-7b", 21, 4, {}),
    ("olmoe_dropping", "olmoe-1b-7b", 40, 3, {"capacity_factor": 0.5}),
    ("deepseek", "deepseek-moe-16b", 21, 3, {}),
    ("command_r", "command-r-plus-104b", 21, 3, {"kv_quant": False}),
    ("command_r_int8", "command-r-plus-104b", 21, 3, {"kv_quant": True}),
]


@pytest.mark.parametrize("case", SERVE_CASES, ids=[c[0] for c in SERVE_CASES])
def test_prefill_and_decode_match_reference_f32(case, monkeypatch):
    _, arch, prompt_len, steps, kw = case
    out, rc, c, seen = serve_both(arch, "float32", prompt_len, steps, monkeypatch, **kw)
    cfg = cfgs(arch, **kw)[1]
    assert_f32_parity(cfg, out, rc, c, seen, MODEL_TOL, INT8_TIE)
    if cfg.n_experts:
        n_moe = cfg.n_layers - cfg.first_dense_layers
        assert len(seen["port"]) == n_moe * (1 + steps)
        cap = M.capacity(2 * prompt_len * cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        dropped = sum(
            int(np.maximum(np.bincount(idx.reshape(-1), minlength=cfg.n_experts) - cap, 0).sum())
            for idx, _ in seen["port"][:n_moe])  # the prefill's calls
        assert dropped > 0 or cfg.capacity_factor >= 1.0, dropped  # the low factor drops
    else:
        assert not seen["port"]


BF16_CASES = [c for c in SERVE_CASES if c[0] in ("smollm", "starcoder2_past_window", "olmoe")]


@pytest.mark.parametrize("case", BF16_CASES, ids=[c[0] for c in BF16_CASES])
def test_prefill_and_decode_bf16_as_close_to_f32_as_the_reference(case, monkeypatch):
    _, arch, prompt_len, steps, kw = case
    exact, _, _, seen32 = serve_both(arch, "float32", prompt_len, steps, monkeypatch, **kw)
    half, _, _, seen16 = serve_both(arch, "bfloat16", prompt_len, steps, monkeypatch, **kw)
    assert_bf16_as_close(exact, half, seen32, seen16, BF16_SLACK, FLIP_MARGIN)


def test_cli_serves_reduced_dense_and_moe_models_on_the_cpu(capsys):
    for arch in ("smollm-360m", "olmoe-1b-7b"):
        before = runtime.launch_counts()
        out = S.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "9", "--gen", "3"])
        assert runtime.launch_counts() == before  # plain versions only
        assert tuple(out["tokens"].shape) == (2, 3)
        assert out["max_len"] == 9 + 3  # no meta tokens
        text = capsys.readouterr().out
        assert "prefill: 2x9 in" in text and "meta tokens" not in text and "tok/s" in text


def test_dense_prefill_hidden_equals_the_forward_without_cache():
    _, cfg = cfgs("olmoe-1b-7b")
    model = init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9))).long()
    full, _ = forward(cfg, model, {"tokens": toks}, mode="train")
    last = prefill(cfg, model, {"tokens": toks}, init_cache(cfg, 2, 9, device="cpu"))
    assert torch.equal(full[:, -1], last)
