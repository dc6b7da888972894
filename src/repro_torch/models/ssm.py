"""State-space / recurrent sequence mixers: the SSD selective scan, the
Mamba head of Hymba, and xLSTM's mLSTM and sLSTM cells.

Port of ``repro/models/ssm.py``.  ``ssd_scan`` is the chunked dual form
(Mamba-2 / SSD), the plain version of the B6 kernel, which lives beside
the kernel in ``kernels/ssd.py`` and is re-exported here under the
reference's name.  ``mamba_mix`` and ``mlstm_mix`` run their prefill scan
through ``kernels/ops.py::ssd`` (the kernel for CUDA tensors; the mLSTM
with the normalizer channel) and their decode step through
``ssd_decode_step``, O(1) per token, which has no kernel in the reference
either.  ``slstm_mix`` has a true hidden-to-hidden recurrence: the
reference runs it as a ``lax.scan`` over time with no Pallas kernel, and
the port as a plain loop over time.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..kernels.ssd import ssd_ref as ssd_scan

__all__ = ["MLSTM", "Mamba", "SLSTM", "init_mamba_params", "init_mlstm_params", "init_slstm_params",
           "mamba_mix", "mlstm_mix", "slstm_mix", "ssd_decode_step", "ssd_scan"]

HEAD_P = 64  # Mamba head size, fixed as in the reference


def ssd_decode_step(
    x: torch.Tensor,  # [B, H, P]
    log_a: torch.Tensor,  # [B, H]
    B: torch.Tensor,  # [B, H, N]
    C: torch.Tensor,  # [B, H, N]
    h: torch.Tensor,  # [B, H, N, P] f32
    normalizer: bool = False,
    nz: Optional[torch.Tensor] = None,  # [B, H, N] f32
    in_place: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """O(1) recurrent step: returns (y [B,H,P], h'), and with
    ``normalizer=True`` also (den [B,H] f32, n'), as the reference.

    ``in_place=True`` writes h' into ``h`` (and n' into ``nz``) and
    returns them: the mLSTM's decode state is 1 MB a (sequence, head), and
    updating it where it lies takes two read-write passes over it (scale,
    then the rank-1 update) and one read (the y product), where the
    functional form writes a new state and its caller copies it back.
    With bf16 B and x the rank-1 update's product is exact in f32, so the
    fused multiply-add of ``addcmul_`` gives the reference's bits."""
    a = torch.exp(log_a.float())[..., None, None]
    Bf = B.float()
    if in_place:
        h_new = h.mul_(a).addcmul_(Bf[..., :, None], x[..., None, :].float())
    else:
        h_new = a * h + Bf[..., :, None] * x[..., None, :].float()
    y = torch.einsum("bhn,bhnp->bhp", C.float(), h_new)
    if not normalizer:
        return y.to(x.dtype), h_new
    n_new = nz.mul_(a[..., 0]).add_(Bf) if in_place else a[..., 0] * nz + Bf
    den = torch.einsum("bhn,bhn->bh", C.float(), n_new)
    return y.to(x.dtype), h_new, den, n_new


class Mamba(nn.Module):
    """Parameters of one Mamba head, named as the reference's dict keys."""

    def __init__(self, d_model: int, d_inner: int, n_state: int, conv_kernel: int,
                 dtype: torch.dtype, device):
        super().__init__()
        nh = d_inner // HEAD_P

        def p(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

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


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ------------------------------------------------------------------ mLSTM
class MLSTM(nn.Module):
    """Parameters of one mLSTM cell, named as the reference's dict keys
    (``_m``: the reference shards them apart from attention's)."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype, device):
        super().__init__()
        dh = d_model // n_heads
        kw = dict(dtype=dtype, device=device)
        self.wq_m = _param(d_model, n_heads, dh, **kw)
        self.wk_m = _param(d_model, n_heads, dh, **kw)
        self.wv_m = _param(d_model, n_heads, dh, **kw)
        self.w_gates = _param(d_model, 2 * n_heads, **kw)
        self.b_gates = _param(2 * n_heads, **kw)
        self.w_o_gate = _param(d_model, d_model, **kw)
        self.w_out = _param(d_model, d_model, **kw)


def init_mlstm_params(m: MLSTM, gen: torch.Generator) -> None:
    """The reference's scales (``init_mlstm_params``): d**-0.5, the
    forget-gate bias at 2 and the input gate's at 0."""
    d, nh = m.wq_m.shape[0], m.wq_m.shape[1]
    for w in (m.wq_m, m.wk_m, m.wv_m, m.w_gates, m.w_o_gate, m.w_out):
        w.normal_(0.0, d ** -0.5, generator=gen)
    m.b_gates[:nh].fill_(2.0)
    m.b_gates[nh:].zero_()


def _project_heads(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe", u, w)`` as one matrix product."""
    b, s, d = u.shape
    return (u @ w.reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])


def mlstm_mix(p: MLSTM, u: torch.Tensor, cfg, state=None, decode: bool = False,
              backend: Optional[str] = None):
    """mLSTM (xLSTM matrix-memory cell) via the SSD machinery:
    ``C_t = f_t C_{t-1} + i_t v_t k_t^T``, ``n_t = f_t n_{t-1} + i_t k_t``,
    ``y_t = (C_t q_t) / max(|n_t . q_t|, 1)``; input gate exponential
    (clamped at 8), forget gate sigmoid.

    u: [B, S, D].  state: (h [B,H,dh,dh] f32, n [B,H,dh] f32) or None for
    zeros.  The prefill scan goes through ``ops.ssd(normalizer=True)`` at
    the reference's default chunk of 128 (``ssd_scan`` is called with no
    ``chunk``; ``cfg.ssd_chunk`` is Hymba's), so through B6 for CUDA
    tensors, and returns new state tensors, which the caller stores.  The
    decode step updates ``state`` in place (``ssd_decode_step(in_place=
    True)``) and returns it.  Returns (out [B,S,D] f32, (h, n)).

    Dtypes follow the reference's promotion (JAX promotes bf16 with f32
    to f32, PyTorch's matmul does not): ``num`` comes back in v's type
    and ``den`` in f32, so ``num / max(|den|, 1)`` and its product with
    the bf16 output gate are f32, and the output projection is an f32
    product with ``w_out`` promoted; the block's output is f32 until
    ``_apply_group`` casts it."""
    b, s, d = u.shape
    nh, dh = p.wq_m.shape[1], p.wq_m.shape[2]
    q = _project_heads(u, p.wq_m)
    k = _project_heads(u, p.wk_m) * (dh ** -0.5)
    v = _project_heads(u, p.wv_m)
    gates = u @ p.w_gates + p.b_gates  # [B, S, 2*nh]
    f_t, i_t = gates.chunk(2, dim=-1)
    log_f = F.logsigmoid(f_t)
    # the input gate e^min(i, 8): B grows to ~2981 k and the state and den
    # with it; both stay f32 (den is never a bf16 column of the output)
    i_gate = torch.exp(torch.clamp(i_t, max=8.0))
    B_in = k * i_gate[..., None]

    if decode:
        num, h_new, den, n_new = ssd_decode_step(
            v[:, 0], log_f[:, 0], B_in[:, 0], q[:, 0], state[0], normalizer=True, nz=state[1],
            in_place=True,
        )
        num, den = num[:, None], den[:, None]
    else:
        h0, nz0 = state if state is not None else (None, None)
        num, h_new, den, n_new = ops.ssd(v, log_f, B_in, q, h0=h0, normalizer=True, n0=nz0,
                                         backend=backend)

    out_h = num / torch.clamp(den.abs(), min=1.0)[..., None]  # bf16 / f32 -> f32
    o_gate = torch.sigmoid(u @ p.w_o_gate).reshape(b, s, nh, dh)
    out = (out_h * o_gate).reshape(b, s, nh * dh)  # f32 * bf16 -> f32
    return out @ p.w_out.float(), (h_new, n_new)


# ------------------------------------------------------------------ sLSTM
class SLSTM(nn.Module):
    """Parameters of one sLSTM cell, named as the reference's dict keys:
    ``wx`` [d, h, 4dh], the head-wise recurrence ``r`` [h, dh, 4dh], its
    bias ``b`` [h, 4dh] and ``w_out_slstm``."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype, device):
        super().__init__()
        dh = d_model // n_heads
        kw = dict(dtype=dtype, device=device)
        self.wx = _param(d_model, n_heads, 4 * dh, **kw)
        self.r = _param(n_heads, dh, 4 * dh, **kw)
        self.b = _param(n_heads, 4 * dh, **kw)
        self.w_out_slstm = _param(d_model, d_model, **kw)


def init_slstm_params(m: SLSTM, gen: torch.Generator) -> None:
    """The reference's scales (``init_slstm_params``)."""
    d, dh = m.wx.shape[0], m.r.shape[1]
    m.wx.normal_(0.0, d ** -0.5, generator=gen)
    m.r.normal_(0.0, dh ** -0.5, generator=gen)
    m.b.zero_()
    m.w_out_slstm.normal_(0.0, d ** -0.5, generator=gen)


SLSTM_REMAT_CHUNK = 128  # steps a checkpointed chunk of the sLSTM's loop holds (the reference's)


def _slstm_steps(wx: torch.Tensor, r: torch.Tensor, bias: torch.Tensor, c: torch.Tensor,
                 n: torch.Tensor, h: torch.Tensor, m: torch.Tensor):
    """The recurrence over the steps of wx [B, T, nh, 4dh]: returns (ys
    [B, T, nh, dh] f32, c, n, h, m)."""
    ys = []
    for t in range(wx.shape[1]):
        rec = torch.bmm(h.transpose(0, 1), r).transpose(0, 1)  # einsum("bhe,hef->bhf", h, r)
        pre = wx[:, t] + rec + bias
        z_in, i_in, f_in, o_in = pre.float().chunk(4, dim=-1)
        z = torch.tanh(z_in)
        o = torch.sigmoid(o_in)
        m_new = torch.maximum(f_in + m, i_in)
        i_g = torch.exp(i_in - m_new)
        f_g = torch.exp(f_in + m - m_new)
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = o * (c / torch.clamp(n, min=1e-6))
        m = m_new
        ys.append(h)
    return torch.stack(ys, dim=1), c, n, h, m


def slstm_mix(p: SLSTM, u: torch.Tensor, cfg, state=None, decode: bool = False):
    """sLSTM: scalar-memory cell with a head-wise block-diagonal
    recurrence and the exponential-gate stabilizer m.  state: (c, n, h, m)
    [B,H,dh] f32 each, or None for zeros with m = -1e30.  Returns (out
    [B,S,D], (c, n, h, m)), new tensors.

    A plain loop over time: the reference's ``lax.scan``, with no Pallas
    kernel.  Under autograd, with S a multiple of ``SLSTM_REMAT_CHUNK``
    above it, each chunk of that many steps is checkpointed, as the
    reference's nested ``jax.checkpoint``: the backward keeps the carry
    at each chunk's start and recomputes the chunk, where plain BPTT
    would keep every step's.  The values are the same either way.
    Dtypes: the carry is f32,
    so ``h @ r`` (r bf16) is f32, as JAX's promotion makes it, and
    ``x_t + h r + b`` is f32; the outputs are cast back to u's type."""
    b, s, d = u.shape
    nh, dh = p.r.shape[0], p.r.shape[1]
    if state is None:
        zeros = u.new_zeros((b, nh, dh), dtype=torch.float32)
        state = (zeros, zeros, zeros, torch.full_like(zeros, -1e30))
    c, n, h, m = state
    wx = _project_heads(u, p.wx)  # [B, S, nh, 4*dh]
    r = p.r.float()  # promoted once, as the reference's einsum does each step
    chunk = SLSTM_REMAT_CHUNK
    if torch.is_grad_enabled() and s % chunk == 0 and s > chunk:
        parts = []
        for i in range(0, s, chunk):
            ys, c, n, h, m = checkpoint(_slstm_steps, wx[:, i:i + chunk], r, p.b, c, n, h, m,
                                        use_reentrant=False)
            parts.append(ys)
        ys = torch.cat(parts, dim=1)
    else:
        ys, c, n, h, m = _slstm_steps(wx, r, p.b, c, n, h, m)
    y = ys.reshape(b, s, nh * dh).to(u.dtype)
    return y @ p.w_out_slstm, (c, n, h, m)
