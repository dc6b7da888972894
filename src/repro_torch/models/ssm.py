"""State-space sequence mixer: the SSD selective scan and the Mamba head
of Hymba.

Port of ``repro/models/ssm.py`` as far as Hymba needs it.  ``ssd_scan`` is
the chunked dual form (Mamba-2 / SSD), the plain version of the B6 kernel,
which lives beside the kernel in ``kernels/ssd.py`` and is re-exported
here under the reference's name.  ``mamba_mix`` runs its prefill scan
through ``kernels/ops.py::ssd`` (the kernel for CUDA tensors) and its
decode step through ``ssd_decode_step``, O(1) per token, which has no
kernel in the reference either.  mLSTM and sLSTM (xLSTM) are not ported
yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.ssd import ssd_ref as ssd_scan

__all__ = ["Mamba", "init_mamba_params", "mamba_mix", "ssd_decode_step", "ssd_scan"]

HEAD_P = 64  # Mamba head size, fixed as in the reference


def ssd_decode_step(
    x: torch.Tensor,  # [B, H, P]
    log_a: torch.Tensor,  # [B, H]
    B: torch.Tensor,  # [B, H, N]
    C: torch.Tensor,  # [B, H, N]
    h: torch.Tensor,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent step: returns (y [B,H,P], h').  The reference's
    normalizer channel (mLSTM) comes with the xLSTM blocks."""
    a = torch.exp(log_a.float())[..., None, None]
    h_new = a * h + B[..., :, None].float() * x[..., None, :].float()
    y = torch.einsum("bhn,bhnp->bhp", C.float(), h_new)
    return y.to(x.dtype), h_new


class Mamba(nn.Module):
    """Parameters of one Mamba head, named as the reference's dict keys."""

    def __init__(self, d_model: int, d_inner: int, n_state: int, conv_kernel: int,
                 dtype: torch.dtype, device):
        super().__init__()
        nh = d_inner // HEAD_P

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)

        self.w_in = p(d_model, 2 * d_inner)
        self.conv_w = p(conv_kernel, d_inner)
        self.conv_b = p(d_inner)
        self.B_proj = p(d_inner, n_state)
        self.C_proj = p(d_inner, n_state)
        self.dt_proj = p(d_inner, nh)
        self.dt_bias = p(nh)
        self.A_log = p(nh)
        self.D_skip = p(d_inner)
        self.w_out = p(d_inner, d_model)


def init_mamba_params(m: Mamba, gen: torch.Generator) -> None:
    """Fill ``m`` with the reference's scales (``init_mamba_params``)."""
    d_model, d_inner = m.w_in.shape[0], m.w_out.shape[0]

    def normal(t, scale):
        t.normal_(0.0, scale, generator=gen)

    normal(m.w_in, d_model ** -0.5)
    normal(m.conv_w, 0.5)
    m.conv_b.zero_()
    normal(m.B_proj, d_inner ** -0.5)
    normal(m.C_proj, d_inner ** -0.5)
    normal(m.dt_proj, d_inner ** -0.5)
    m.dt_bias.zero_()
    m.A_log.zero_()
    m.D_skip.fill_(1.0)
    normal(m.w_out, d_inner ** -0.5)


def mamba_mix(p: Mamba, u: torch.Tensor, cfg, state=None, decode: bool = False,
              backend: Optional[str] = None):
    """Mamba(-2 style) mixer: in-proj -> causal conv -> SSD -> gate -> out.

    u: [B, S, D] (S = 1 with decode=True).  state: (conv_state [B,K-1,dI],
    ssd h [B,H,N,P]) for decode.  Returns (out [B,S,D], (conv_state, h)),
    new tensors; the caller stores them.  ``backend`` goes to
    ``ops.ssd``."""
    b, s, _ = u.shape
    d_inner = p.w_in.shape[1] // 2
    nh = d_inner // HEAD_P
    n = p.B_proj.shape[-1]

    xz = u @ p.w_in  # [B, S, 2*dI]
    x, z = xz.chunk(2, dim=-1)

    wconv = p.conv_w  # [K, dI]
    kk = wconv.shape[0]
    if decode:
        xfull = torch.cat([state[0], x], dim=1)  # [B, K, dI]
        new_conv_state = xfull[:, 1:]
        x = torch.einsum("bkd,kd->bd", xfull, wconv)[:, None] + p.conv_b
    else:
        xpad = F.pad(x, (0, 0, kk - 1, 0))
        acc = xpad[:, 0:s] * wconv[0][None, None]
        for i in range(1, kk):
            acc = acc + xpad[:, i:i + s] * wconv[i][None, None]
        x = acc + p.conv_b
        new_conv_state = xpad[:, s:]  # the last K-1 inputs
    x = F.silu(x)

    Bm = x @ p.B_proj  # [B, S, N]
    Cm = x @ p.C_proj
    dt = F.softplus(x @ p.dt_proj + p.dt_bias)  # [B, S, nh]
    log_a = -dt * torch.exp(p.A_log)[None, None]

    xh = x.reshape(b, s, nh, HEAD_P)
    # one B and one C for every head: a head stride of 0, not a copy
    Bh = Bm[:, :, None].expand(b, s, nh, n)
    Ch = Cm[:, :, None].expand(b, s, nh, n)

    if decode:
        y, h_new = ssd_decode_step(xh[:, 0], log_a[:, 0], Bh[:, 0], Ch[:, 0], state[1])
        y = y[:, None]
    else:
        y, h_new = ops.ssd(xh, log_a, Bh, Ch, chunk=cfg.ssd_chunk, backend=backend)

    y = y.reshape(b, s, d_inner) + x * p.D_skip[None, None]
    y = y * F.silu(z)
    return y @ p.w_out, (new_conv_state, h_new)
