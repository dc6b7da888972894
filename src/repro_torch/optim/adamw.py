"""AdamW + cosine schedule + global-norm clipping, plain PyTorch.

Port of ``repro/optim/adamw.py``.  Parameters, gradients and moments are
dicts of tensors keyed by the port's parameter names
(``dict(model.named_parameters())``), so a checkpoint can carry the
state beside the parameters.  The arithmetic is the reference's, in its
order and in f32; ``torch.optim.AdamW`` is not used, since its weight
decay and rounding order differ.  Weight decay applies to every
parameter, norms and embeddings too, as in the reference.  Each function
returns new tensors and leaves its inputs as they are.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch

Tree = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the parameters' device
    m: Dict[str, torch.Tensor]  # f32, keyed like the parameters
    v: Dict[str, torch.Tensor]


def adamw_init(params: Tree) -> AdamWState:
    """Step 0 and zero moments in f32, one per parameter."""
    params = dict(params)
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=zeros,
        v={k: torch.zeros_like(z) for k, z in zeros.items()},
    )


def cosine_schedule(step: Union[int, torch.Tensor], base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup from 0 over ``warmup`` steps, then a cosine from
    ``base_lr`` down to ``min_frac * base_lr`` at ``total``; an f32 0-d
    tensor (on ``step``'s device), computed on the device."""
    step = torch.as_tensor(step).float()
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / ||g||)``, the norm taken
    in f32 over all of them; returns (clipped, norm)."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(
    params: Tree,
    grads: Tree,
    state: AdamWState,
    lr: Union[float, torch.Tensor],
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
) -> Tuple[Dict[str, torch.Tensor], AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step after clipping: returns (new params in their dtype,
    the new state, {"grad_norm", "lr"}).  Bias correction at the
    incremented step, ``delta = m^ / (sqrt(v^) + eps) + wd p``, ``p - lr
    delta``, all in f32, one parameter at a time, outside autograd."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    t = step.float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        gf = grads[k].float()
        m2 = b1 * state.m[k] + (1 - b1) * gf
        v2 = b2 * state.v[k] + (1 - b2) * gf * gf
        mh = m2 / bc1
        vh = v2 / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m2, v2
    lr_t = lr if isinstance(lr, torch.Tensor) else torch.tensor(lr, dtype=torch.float32, device=step.device)
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr_t}
