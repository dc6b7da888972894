"""The port's serving launcher, ``python -m repro_torch.launch.serve``.

On the CPU it runs a reduced Hymba and a reduced xLSTM through their
kernels' plain versions (``--device cpu``; the dense and MoE models in
tests/test_torch_dense.py); without ``--device`` it means the card and
raises on a host without one.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import runtime
from repro_torch.kernels.config import resolve_device
from repro_torch.launch import serve as S
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import init_cache, init_params, prefill, serve_step
from repro_torch.models.model import N_META_TOKENS

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)


def test_cli_serves_reduced_hymba_on_the_cpu(capsys):
    before = runtime.launch_counts()
    out = S.main(["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "9", "--gen", "3"])
    assert runtime.launch_counts() == before  # plain versions only
    assert tuple(out["tokens"].shape) == (2, 3)
    assert out["timer"] == "host_clock"
    assert out["max_len"] == 9 + N_META_TOKENS + 3
    text = capsys.readouterr().out
    assert "prefill: 2x9" in text and "tok/s" in text and "host clock, CPU" in text


def test_cli_without_device_means_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.main(["--arch", "hymba-1.5b", "--reduced", "--gen", "1"])


def test_cli_serves_reduced_xlstm_on_the_cpu(capsys):
    before = runtime.launch_counts()
    out = S.main(["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu", "--batch", "2",
                  "--prompt-len", "8", "--gen", "4"])
    assert runtime.launch_counts() == before  # plain versions only
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["max_len"] == 8 + 4  # no prefix tokens
    text = capsys.readouterr().out
    assert "prefill: 2x8 in" in text and "meta tokens" not in text and "tok/s" in text


def test_generate_is_greedy_over_the_step_functions():
    """generate() = prefill, then serve steps feeding back the argmax (the
    first step re-feeds the prompt's last token, as the reference's
    launcher does); the step hook sees the prefill and every step."""
    cfg = get_config("hymba-1.5b").reduced()
    model = init_params(cfg, seed=1, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5))).long()
    seen = []
    out = S.generate(cfg, model, prompt, 3, keep_logits=2, step_hook=lambda ph, i: seen.append((ph, i)))
    assert seen == [("prefill", 0), ("decode", 0), ("decode", 1), ("decode", 2)]
    assert len(out["logits"]) == 2

    caches = init_cache(cfg, 2, 5 + N_META_TOKENS + 3, device="cpu")
    last = make_prefill_step(cfg)(model, {"tokens": prompt}, caches)
    assert torch.equal(last, out["last_hidden"])
    step = make_serve_step(cfg)
    tok = prompt[:, -1:]
    for i in range(3):
        logits = step(model, caches, tok, 5 + N_META_TOKENS + i)
        if i < 2:
            assert torch.equal(logits, out["logits"][i])
        tok = logits.argmax(-1)[:, None]
        assert torch.equal(tok[:, 0], out["tokens"][:, i])


def test_step_builders_are_the_model_functions():
    cfg = get_config("hymba-1.5b").reduced()
    model = init_params(cfg, seed=2, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 4))).long()
    c1 = init_cache(cfg, 1, 4 + N_META_TOKENS + 1, device="cpu")
    c2 = init_cache(cfg, 1, 4 + N_META_TOKENS + 1, device="cpu")
    assert torch.equal(make_prefill_step(cfg, backend="torch")(model, {"tokens": prompt}, c1),
                       prefill(cfg, model, {"tokens": prompt}, c2))
    pos = 4 + N_META_TOKENS
    assert torch.equal(make_serve_step(cfg, backend="torch")(model, c1, prompt[:, -1:], pos),
                       serve_step(cfg, model, c2, prompt[:, -1:], pos))
