"""The contract of ``tests/test_archs_smoke.py::test_train_step_decreases_loss``
on the port, for tests/test_torch_train_*.py: a reduced config at its
own compute dtype, the port's random weights, one batch whose labels are
its tokens, four AdamW steps (loss_fn, autograd, adamw_update at lr
1e-3, as the reference's test steps): the losses finite, the fourth below
the first (robust to the first step's Adam transient), and some
parameter moved by the first step."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params, loss_fn
from repro_torch.models.model import SIGLIP_DIM
from repro_torch.optim import adamw_init, adamw_update


def assert_train_step_decreases_loss(arch):
    cfg = get_config(arch).reduced()
    model = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    shape = (2, 32, cfg.n_codebooks) if cfg.n_codebooks else (2, 32)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.n_patches:
        batch["patches"] = torch.from_numpy(rng.standard_normal((2, cfg.n_patches, SIGLIP_DIM)).astype(np.float32))
    named = dict(model.named_parameters())
    opt = adamw_init(named)
    before = {k: p.detach().clone() for k, p in named.items()}

    def step(opt):
        loss, _ = loss_fn(cfg, model, batch, backend="torch")
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(named[k]) if g is None else g for k, g in grads.items()}
        new, opt, _ = adamw_update(named, grads, opt, lr=1e-3)
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new[k])
        return float(loss.detach()), opt

    loss1, opt = step(opt)
    moved = max(float((named[k].detach() - before[k]).abs().max()) for k in named)
    for _ in range(3):
        loss2, opt = step(opt)
    assert np.isfinite(loss1) and np.isfinite(loss2)
    assert loss2 < loss1, (loss1, loss2)
    assert moved > 0
