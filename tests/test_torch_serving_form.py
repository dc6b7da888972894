"""The serving form of the port's model: the blocks held in the compute
dtype only (``init_params(..., serving=True)``, ``params_from_numpy(...,
serving=True)``, ``abstract_params(..., serving=True)``).

It is the two-copy form's serving copy made once and kept alone, so it is
held to that copy bit for bit: the blocks of every config in
``configs/`` (reduced) equal ``init_params(...).compute_blocks(bf16)``,
the f32 leaves equal the two-copy form's, and ``generate`` gives the same
tokens and logits.  Against the JAX package the serving form loaded from
the reference's weights is held at the bars of the two-copy form's
``*_bf16_as_close_to_f32_*`` tests (tests/test_torch_dense.py,
tests/test_torch_features.py: RMS error to the reference's f32 result at
most ``BF16_SLACK`` times the reference's own bf16 run's, routing flips
only on near-ties).  On ``meta`` the full configs count 2 bytes a block
parameter and 4 for the rest.
"""
from __future__ import annotations

import dataclasses
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.models import init_params as ref_init_params
import repro_torch.models.model as MM
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import runtime
from repro_torch.launch import dryrun as D
from repro_torch.launch import serve as S
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import abstract_params, init_params, params_from_numpy
from repro_torch.models.model import SIGLIP_DIM
from repro_torch.optim import adamw_init

from lm_parity import assert_bf16_as_close, cfgs, serve_both

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

BF16 = torch.bfloat16
BF16_SLACK = 1.25  # tests/test_torch_dense.py's and tests/test_torch_features.py's bar
FLIP_MARGIN = 0.02
# (arch, prompt, steps, seed): the cases the two-copy form is held to
# (StarCoder2 past its window of 64, DeepSeek's dense layer and shared
# experts, Moonlight's int8 cache under MoE)
REF_CASES = {"starcoder2": ("starcoder2-15b", 72, 3, 0), "deepseek": ("deepseek-moe-16b", 21, 3, 0),
             "moonlight": ("moonshot-v1-16b-a3b", 13, 8, 7)}
# the full configs on meta, GB in the serving form (2 bytes a block
# parameter, 4 for the rest) and with the f32 parameters and their copy
FULL_GB = {"starcoder2-15b": (33.1, 94.5), "deepseek-moe-16b": (33.5, 97.1),
           "moonshot-v1-16b-a3b": (58.0, 168.6), "command-r-plus-104b": (213.9, 616.6)}


def _blocks(model, dtype=BF16):
    return [p for grp in model.compute_blocks(dtype) for blk in grp for p in blk.parameters()]


def _rest(model):
    return {n: p for n, p in model.named_parameters() if not n.startswith("groups.")}


def _assert_same_bits(serving, two_copy):
    a, b = _blocks(serving), _blocks(two_copy)
    assert len(a) == len(b) and all(x.dtype == y.dtype == BF16 and torch.equal(x, y) for x, y in zip(a, b))
    ra, rb = _rest(serving), _rest(two_copy)
    assert list(ra) == list(rb)
    assert all(ra[n].dtype == rb[n].dtype == torch.float32 and torch.equal(ra[n], rb[n]) for n in ra)


def _prompt(cfg, seed=0, batch=2, length=9):
    g = torch.Generator().manual_seed(seed)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompt = torch.randint(0, cfg.vocab_size, (batch, length) + books, generator=g)
    patches = torch.randn((batch, cfg.n_patches, SIGLIP_DIM), generator=g) if cfg.n_patches else None
    return prompt, patches


# ----------------------------------------------------- the same bits
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_form_blocks_bitwise_equal_the_compute_copy(arch):
    cfg = get_config(arch).reduced()
    serving = init_params(cfg, seed=3, device="cpu", serving=True)
    assert serving.serving and all(not p.requires_grad for p in serving.groups.parameters())
    assert all(p.dtype == BF16 for p in serving.groups.parameters())  # a MoE router and the sLSTM's r, b too
    _assert_same_bits(serving, init_params(cfg, seed=3, device="cpu"))
    grouped = serving.compute_blocks(BF16)
    assert all(a is b for ga, gb in zip(grouped, serving.groups) for a, b in zip(ga, gb))  # nothing copied


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_bitwise_equal_between_the_forms(arch):
    cfg = get_config(arch).reduced()
    prompt, patches = _prompt(cfg)
    runs = [S.generate(cfg, init_params(cfg, seed=0, device="cpu", serving=serving), prompt, 3,
                       keep_logits=3, patches=patches) for serving in (False, True)]
    assert torch.equal(runs[0]["tokens"], runs[1]["tokens"])
    assert torch.equal(runs[0]["last_hidden"], runs[1]["last_hidden"])
    assert len(runs[1]["logits"]) == 3 and all(torch.equal(a, b) for a, b in zip(*(r["logits"] for r in runs)))


@pytest.mark.parametrize("case", list(REF_CASES))
def test_params_from_numpy_serving_form_casts_on_load(case):
    arch = REF_CASES[case][0]
    rcfg, cfg = cfgs(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, ref_init_params(dataclasses.replace(rcfg, compute_dtype="float32"),
                                                    jax.random.PRNGKey(0)))
    _assert_same_bits(params_from_numpy(cfg, tree, device="cpu", serving=True),
                      params_from_numpy(cfg, tree, device="cpu"))


@pytest.mark.parametrize("case", list(REF_CASES))
def test_serving_form_bf16_as_close_to_f32_as_the_reference(case, monkeypatch):
    """The serving form loaded from the reference's f32 weights: prefill
    and teacher-forced ``serve_step`` logits against the JAX package at
    the two-copy form's bars."""
    arch, prompt_len, steps, seed = REF_CASES[case]
    exact, _, _, seen32 = serve_both(arch, "float32", prompt_len, steps, monkeypatch, seed=seed)
    half, _, _, seen16 = serve_both(arch, "bfloat16", prompt_len, steps, monkeypatch, seed=seed, serving=True)
    assert [got.shape for _, got in half] == [got.shape for _, got in exact]
    assert_bf16_as_close(exact, half, seen32, seen16, BF16_SLACK, FLIP_MARGIN)


# ------------------------------------------------------- bytes held
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_form_counts_two_bytes_a_block_parameter_on_meta(arch):
    cfg = get_config(arch)
    serving, two_copy = abstract_params(cfg, serving=True), abstract_params(cfg)
    n = sum(p.numel() for p in two_copy.parameters())
    block = sum(p.numel() for p in two_copy.groups.parameters())
    held = sum(p.numel() * p.element_size() for p in serving.parameters())
    assert all(p.device.type == "meta" for p in serving.parameters())
    assert sum(p.numel() for p in serving.parameters()) == n
    assert held == 2 * block + 4 * (n - block)
    assert D.argument_parts(serving, {})["compute_copy"] == 0
    if arch in FULL_GB:
        assert (round(held / 1e9, 1), round((4 * n + 2 * block) / 1e9, 1)) == FULL_GB[arch]


def test_init_holds_at_most_one_f32_block_at_a_time(monkeypatch):
    """The serving form's init draws each block in f32 and frees it before
    the next is drawn: when a block is made on a real device, no block
    made before it there is still alive."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), n_layers=5)
    made, alive_at_make = [], []
    make = MM._make_block

    def counting(cfg_, kind, dtype, device):
        blk = make(cfg_, kind, dtype, device)
        if torch.device(device).type != "meta":
            alive_at_make.append(sum(r() is not None for r in made))
            made.append(weakref.ref(blk))
        return blk

    monkeypatch.setattr(MM, "_make_block", counting)
    model = init_params(cfg, seed=0, device="cpu", serving=True)
    assert len(made) == cfg.n_layers and all(p.dtype == BF16 for p in model.groups.parameters())
    assert alive_at_make == [0] * cfg.n_layers
    assert all(r() is None for r in made)


def test_serving_form_holds_no_other_dtype():
    cfg = get_config("smollm-360m").reduced()
    model = init_params(cfg, seed=0, device="cpu", serving=True)
    with pytest.raises(ValueError, match="serving form"):
        model.compute_blocks(torch.float32)
    with pytest.raises(ValueError, match="serving form"):
        S.generate(dataclasses.replace(cfg, compute_dtype="float32"), model, _prompt(cfg)[0], 2)


# ---------------------------------------------------------- training
def test_training_a_serving_form_raises():
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), grad_accum=1)
    model = init_params(cfg, seed=0, device="cpu", serving=True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens}
    before = [p.clone() for p in model.parameters()]
    with pytest.raises(ValueError, match="serving form"):
        loss_and_grads(cfg, model, batch)
    with pytest.raises(ValueError, match="serving form"):
        make_train_step(cfg)(model, adamw_init(dict(model.named_parameters())), batch)
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    two_copy = init_params(cfg, seed=0, device="cpu")  # the f32 parameters still train
    loss, _, grads = loss_and_grads(cfg, two_copy, batch)
    assert torch.isfinite(loss) and set(grads) == {n for n, _ in two_copy.named_parameters()}


# ------------------------------------------------------------ the CLI
@pytest.mark.parametrize("arch", ["starcoder2-15b", "deepseek-moe-16b", "moonshot-v1-16b-a3b"])
def test_cli_serves_the_serving_form(arch, monkeypatch):
    """``python -m repro_torch.launch.serve`` builds the serving form; its
    tokens are the two-copy form's on the same seed and prompt."""
    built = []
    init = S.init_params

    def recording(*a, **kw):
        model = init(*a, **kw)
        built.append(model.serving)
        return model

    monkeypatch.setattr(S, "init_params", recording)
    before = runtime.launch_counts()
    out = S.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "9",
                  "--gen", "3", "--seed", "5"])
    assert runtime.launch_counts() == before and built == [True]
    cfg = get_config(arch).reduced()
    prompt = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(5))
    want = S.generate(cfg, init(cfg, seed=5, device="cpu"), prompt, 3)
    assert torch.equal(out["tokens"], want["tokens"])
