"""Mixture-of-Experts with capacity-based routing, on one device.

Port of ``repro/models/moe.py``'s local path (``moe_local``): the tokens
are bucketed per expert into fixed-capacity buffers ``[E, C, D]`` and the
expert FFNs run as batched products ``[E, C, D] x [E, D, F]``, as the
reference's einsum.  The reference's expert-parallel path
(``moe_expert_parallel``) shards the experts over a mesh axis and has no
counterpart on one card.

Capacity overflow drops pairs (standard capacity-factor routing): a
dropped pair contributes nothing to the combine.  Everything has a shape
fixed by the input's and is computed on the device: nothing reads a
device value on the host, so a decode step through this module can be
captured as a CUDA graph.  Two places differ in form from the reference:

- the reference scatters with ``mode="drop"`` and gathers with JAX's
  clamped indices.  An out-of-range index is a device-side assert in
  PyTorch, so here a dropped pair is written (as zeros) to one spare row
  past the buffer, which is sliced off, and gathered from row 0 before
  its weight of 0 is applied;
- the reference's combine ``y.at[src].add(...)`` is a scatter-add.  Each
  token's ``top_k`` pairs are contiguous, so here they are added in k
  order, one elementwise add each, in x's type: the same sum, and the
  same bits on every run (``index_add_`` on CUDA adds in no fixed order).

The experts' products are ``torch.bmm``: the reference computes them
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


# ----------------------------------------------------------------- router
def router(x_flat: torch.Tensor, w_router: torch.Tensor, top_k: int, renorm: bool = True):
    """x_flat [T, D] -> (weights [T,k] in x's type, expert_idx [T,k],
    aux_loss scalar f32)."""
    logits = x_flat.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    w, idx = torch.topk(probs, top_k, dim=-1)
    if renorm:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    e = probs.shape[-1]
    me = probs.mean(dim=0)
    top1 = idx[:, :1] == torch.arange(e, device=idx.device)  # one-hot of the top-1 expert
    ce = top1.float().mean(dim=0)  # fraction routed (top-1 proxy)
    aux = e * (me * ce).sum()
    return w.to(x_flat.dtype), idx, aux


def _bucket_positions(dest: torch.Tensor, n_buckets: int, capacity: int):
    """Rank of each element within its destination bucket.

    dest [P] int -> (pos [P], valid [P]).  Order-preserving (stable).
    """
    onehot = (dest[:, None] == torch.arange(n_buckets, device=dest.device)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1  # rank among same-dest
    pos = torch.gather(pos, 1, dest[:, None].long())[:, 0]
    valid = pos < capacity
    return pos, valid


def _expert_ffn(buf: torch.Tensor, wp: "MoE", act: str, glu: bool) -> torch.Tensor:
    """buf [E, C, D] -> [E, C, D] through per-expert (Sw)iGLU MLPs."""
    h = torch.bmm(buf, wp.w1)
    a = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    if glu:
        a = a * torch.bmm(buf, wp.w3)
    return torch.bmm(a, wp.w2)


def capacity(pairs: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: the reference's formula, Python float floor
    division included; the floor of 8 keeps tiny (decode) batches
    drop-free."""
    return min(pairs, max(8, -(-pairs * capacity_factor // n_experts).__int__()))


# ------------------------------------------------------------- local path
def moe_local(
    params: "MoE",
    x: torch.Tensor,  # [B, S, D]
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    act: str = "silu",
    glu: bool = True,
    renorm: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e = params.w1.shape[0]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    w, idx, aux = router(xf, params.router, top_k, renorm=renorm)

    pairs = t * top_k
    cap = capacity(pairs, e, capacity_factor)
    dest = idx.reshape(-1)  # [P], pairs token-major: (t0,k0), (t0,k1), ...
    pos, valid = _bucket_positions(dest, e, cap)

    # row dest * cap + pos of the flattened buffers; a dropped pair goes to
    # the spare row e * cap (written with zeros), and is gathered from row
    # 0 and weighted by 0, as the reference's clamped gather times valid
    slot = dest * cap + pos
    spare = torch.full_like(slot, e * cap)
    src_x = xf[:, None].expand(t, top_k, d).reshape(-1, d)  # xf[src], src = repeat(arange(t), k)
    buf = xf.new_zeros((e * cap + 1, d))
    buf.index_copy_(0, torch.where(valid, slot, spare).long(),
                    torch.where(valid[:, None], src_x, torch.zeros_like(src_x)))
    out_buf = _expert_ffn(buf[: e * cap].view(e, cap, d), params, act, glu).reshape(e * cap, d)
    take = torch.where(valid, slot, torch.zeros_like(slot)).long()
    out_pairs = out_buf.index_select(0, take) * valid[:, None].to(x.dtype)  # [P, D]
    weighted = (out_pairs * w.reshape(-1)[:, None]).view(t, top_k, d)
    y = torch.zeros_like(xf)
    for j in range(top_k):  # the scatter-add's sum, in k order
        y = y + weighted[:, j]
    return y.reshape(b, s, d), aux


# ------------------------------------------------------------- parameters
class MoE(nn.Module):
    """Router ``[D, E]`` and expert stacks ``w1``/``w3`` ``[E, D, F]``,
    ``w2`` ``[E, F, D]``.  The router is f32 whatever ``dtype`` is, as in
    the reference (the model's copy in the compute dtype rounds it, as the
    reference's per-block cast)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, dtype, device, glu: bool = True):
        super().__init__()

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.router = param(d_model, n_experts, dt=torch.float32)
        self.w1 = param(n_experts, d_model, d_ff)
        self.w2 = param(n_experts, d_ff, d_model)
        self.w3 = param(n_experts, d_model, d_ff) if glu else None


def init_moe_params(p: MoE, gen: torch.Generator) -> None:
    """The reference's scales: router and w1/w3 ``d_model**-0.5``, w2
    ``d_ff**-0.5``."""
    _, d, f = p.w1.shape
    p.router.normal_(0.0, d ** -0.5, generator=gen)
    p.w1.normal_(0.0, d ** -0.5, generator=gen)
    p.w2.normal_(0.0, f ** -0.5, generator=gen)
    if p.w3 is not None:
        p.w3.normal_(0.0, d ** -0.5, generator=gen)
