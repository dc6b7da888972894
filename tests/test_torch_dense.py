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
- Command R: ``parallel_residual`` (no ``ln2``), layer norm, with
  ``kv_quant=False`` (the int8 cache is not ported).

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

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.configs import get_config as ref_get_config
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import serve_step as ref_serve_step
from repro.models.blocks import dense_block_apply as ref_dense_block_apply
import repro_torch.models.moe as M
from repro_torch.configs import get_config
from repro_torch.kernels import runtime
from repro_torch.launch import serve as S
from repro_torch.models import forward, init_cache, init_params, params_from_numpy, prefill, serve_step
from repro_torch.models.blocks import dense_block_apply
from repro_torch.models.model import layer_groups, prefix_tokens

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

MODULE_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_SLACK = 1.25
FLIP_MARGIN = 0.02  # a bf16 run may route otherwise only where f32's k-th and (k+1)-th probs are this close

# (name, arch, config overrides); every config is the arch's reduced one
VARIANTS = {
    "smollm_g2": ("smollm-360m", {"n_kv_heads": 2}),
    "smollm_g3": ("smollm-360m", {"n_heads": 6, "n_kv_heads": 2, "head_dim": 32}),
    "starcoder2": ("starcoder2-15b", {}),
    "command_r": ("command-r-plus-104b", {"kv_quant": False}),
}


def _cfgs(arch, dtype="float32", **kw):
    """(reference, port) reduced configs; ``scan_layers=False`` makes the
    reference call each block eagerly, so its router calls can be
    recorded (the port has no scan)."""
    ref = dataclasses.replace(ref_get_config(arch).reduced(), compute_dtype=dtype, scan_layers=False, **kw)
    port = dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype, scan_layers=False, **kw)
    return ref, port


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def _model(cfg, ref_params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")


def test_variants_have_the_features_they_stand_for():
    cfgs = {name: _cfgs(arch, **kw)[1] for name, (arch, kw) in VARIANTS.items()}
    assert cfgs["smollm_g2"].q_per_kv == 2 and cfgs["smollm_g3"].q_per_kv == 3
    sc = cfgs["starcoder2"]
    assert (sc.norm, sc.use_bias, sc.act, sc.glu, sc.sliding_window) == ("layer", True, "gelu", False, 64)
    cr = cfgs["command_r"]
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
    rcfg, cfg = _cfgs(arch, dtype, **kw)
    ref_params = ref_init_params(rcfg, jax.random.PRNGKey(0))
    jdt = jnp.dtype(dtype)
    lp = jax.tree.map(lambda a: a[0].astype(jdt), ref_params["groups"][0])
    rng = np.random.default_rng(2)
    x = np.asarray(jnp.asarray(_np(rng, 2, 149, cfg.d_model), jnp.bfloat16), np.float32)
    pos = np.arange(149, dtype=np.int32)
    want, _, _ = ref_dense_block_apply(rcfg, None, lp, jnp.asarray(x, jdt), None, "train",
                                       jnp.asarray(pos), {"window": cfg.sliding_window})
    blk = _model(cfg, ref_params).compute_blocks(getattr(torch, dtype))[0][0]
    got, _ = dense_block_apply(cfg, blk, torch.from_numpy(x).to(getattr(torch, dtype)), None, "train",
                               torch.from_numpy(pos), cfg.sliding_window)
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dense_block_matches_reference(variant):
    want, got = _block_outputs(variant, "float32")
    np.testing.assert_allclose(got, want, rtol=MODULE_TOL, atol=MODULE_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dense_block_bf16_as_close_to_f32_as_the_reference(variant):
    exact, _ = _block_outputs(variant, "float32")
    ref16, port16 = _block_outputs(variant, "bfloat16")
    assert _rms(port16, exact) <= BF16_SLACK * _rms(ref16, exact), (_rms(port16, exact), _rms(ref16, exact))


# ------------------------------------------------------- prefill + decode
def _recording(monkeypatch):
    """Record, for every router call of both packages, the experts each
    token picks and the gap between its k-th and (k+1)-th probability."""
    seen = {"ref": [], "port": []}
    ref_router, port_router = ref_moe.router, M.router

    def gap(x, w, k):
        logits = np.asarray(x, np.float32) @ np.asarray(w, np.float32)
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p = -np.sort(-p / p.sum(-1, keepdims=True), axis=-1)
        return p[:, k - 1] - p[:, k] if k < p.shape[-1] else np.full(p.shape[0], np.inf)

    def ref_rec(x, w, k, renorm=True):
        out = ref_router(x, w, k, renorm=renorm)
        seen["ref"].append((np.asarray(out[1]), gap(jnp.asarray(x, jnp.float32), w, k)))
        return out

    def port_rec(x, w, k, renorm=True):
        out = port_router(x, w, k, renorm=renorm)
        seen["port"].append((out[1].numpy(), gap(x.float().numpy(), w.float().numpy(), k)))
        return out

    monkeypatch.setattr(ref_moe, "router", ref_rec)
    monkeypatch.setattr(M, "router", port_rec)
    return seen


def _serve_both(arch, dtype, prompt_len, steps, monkeypatch, seed=0, **kw):
    """Prefill a 2-sequence prompt and run ``steps`` teacher-forced decode
    steps in both packages on the reference's f32 weights.  Returns
    [(ref, port)] for the prefill's last hidden state, then each step's
    logits; the two final caches; and both packages' router records."""
    rcfg, cfg = _cfgs(arch, dtype, **kw)
    ref_params = ref_init_params(dataclasses.replace(rcfg, compute_dtype="float32"), jax.random.PRNGKey(0))
    model = _model(cfg, ref_params)
    seen = _recording(monkeypatch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, prompt_len + steps)).astype(np.int32)
    max_len = prompt_len + steps
    rc = ref_init_cache(rcfg, 2, max_len)
    rh, rc = ref_prefill(rcfg, ref_params, {"tokens": jnp.asarray(toks[:, :prompt_len])}, rc)
    c = init_cache(cfg, 2, max_len, device="cpu")
    before = runtime.launch_counts()
    h = prefill(cfg, model, {"tokens": torch.from_numpy(toks[:, :prompt_len]).long()}, c)
    out = [(np.asarray(rh, np.float32), h.float().numpy())]
    for i in range(steps):
        pos = prompt_len + i
        t = toks[:, prompt_len + i:prompt_len + i + 1]
        rl, rc = ref_serve_step(rcfg, ref_params, rc, jnp.asarray(t), jnp.int32(pos))
        lg = serve_step(cfg, model, c, torch.from_numpy(t).long(), pos)
        out.append((np.asarray(rl), lg.numpy()))
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    monkeypatch.undo()
    return out, rc, c, seen


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
]


@pytest.mark.parametrize("case", SERVE_CASES, ids=[c[0] for c in SERVE_CASES])
def test_prefill_and_decode_match_reference_f32(case, monkeypatch):
    _, arch, prompt_len, steps, kw = case
    out, rc, c, seen = _serve_both(arch, "float32", prompt_len, steps, monkeypatch, **kw)
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL)
    # the caches agree too: ring slots, positions, keys and values
    for rg, g in zip(rc, c):
        np.testing.assert_array_equal(g["pos"].numpy(), np.asarray(rg["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key].numpy(), np.asarray(rg[key]), rtol=MODEL_TOL, atol=MODEL_TOL)
    # f32 routes identically, call by call
    assert len(seen["port"]) == len(seen["ref"])
    for (pi, _), (ri, _) in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(pi, ri)
    cfg = _cfgs(arch, **kw)[1]
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
    exact, _, _, seen32 = _serve_both(arch, "float32", prompt_len, steps, monkeypatch, **kw)
    half, _, _, seen16 = _serve_both(arch, "bfloat16", prompt_len, steps, monkeypatch, **kw)
    # the sequences a routing flip of either bf16 run has reached, from
    # the output it first reaches on
    # (a primary flip lies in the first call that differs in its sequence,
    # on inputs the runs share up to rounding; later ones follow from it)
    n_moe = len(seen32["ref"]) // (1 + steps) if seen32["ref"] else 0
    reached = {}
    primary_gaps = []
    for who in ("ref", "port"):
        first = {}
        for call, ((i16, _), (i32, g32)) in enumerate(zip(seen16[who], seen32["ref"])):
            out = call // n_moe  # 0: the prefill, 1 + i: decode step i
            s = i16.shape[0] // 2
            for t in np.flatnonzero((np.sort(i16, -1) != np.sort(i32, -1)).any(-1)):
                row = int(t // s)
                if first.setdefault(row, call) == call:
                    primary_gaps.append(float(g32[t]))
                reached[row] = min(reached.get(row, out), out)
    assert all(g < FLIP_MARGIN for g in primary_gaps), primary_gaps
    gated = 0
    for out_i, ((want, _), (ref16, port16)) in enumerate(zip(exact, half)):
        assert np.isfinite(port16).all()
        rows = [r for r in range(2) if reached.get(r, len(exact)) > out_i]
        if not rows:
            continue
        gated += 1
        w, r16, p16 = want[rows], ref16[rows], port16[rows]
        assert _rms(p16, w) <= BF16_SLACK * _rms(r16, w), (out_i, _rms(p16, w), _rms(r16, w))
    assert gated >= len(exact) // 2, (gated, reached)


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
    _, cfg = _cfgs("olmoe-1b-7b")
    model = init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9))).long()
    full = forward(cfg, model, {"tokens": toks}, mode="train")
    last = prefill(cfg, model, {"tokens": toks}, init_cache(cfg, 2, 9, device="cpu"))
    assert torch.equal(full[:, -1], last)
