"""SSD chunked selective scan (B6), with its plain PyTorch version.

``ssd`` replaces the Pallas kernel ``repro/kernels/ssd.py::_ssd_kernel``:
the Mamba-2 dual form of ``h_t = a_t h_{t-1} + B_t x_t^T, y_t = C_t h_t``,
computed per chunk of Q steps as a causal ``Q x Q`` product plus the
carried ``[N, P]`` state.  The TPU kernel's grid is (head, chunk) with the
chunk axis sequential, and the reference vmaps it over the batch.
``csrc/ssd.cu`` runs the chunks in parallel, one block each: a block
computes its chunk's state summary, waits for the previous chunk of its
sequence to publish the state it starts from, publishes its own for the
next, and then computes its scores and output (an ordered handoff
through scratch the wrapper allocates, a fixed size per shape).  f32
arithmetic, y in x's type, h_final in f32.

The wide form is the counterpart of ``repro/models/ssm.py::ssd_scan``
with the normalizer channel (``den`` and ``n_final``, in f32), as xLSTM's
mLSTM calls it: a large state (N = P = 512, 1 MB a sequence and head).
A block takes 64 columns of P; the P/64 blocks of a chunk run as one
thread block cluster (8 at P = 512), which computes the scores ``C B^T``
once, each block a share of the tiles, written into the others' shared
memory.  Its products run on the bf16 tensor cores with f32 sums: x, B
and C are staged in bf16 as they are in memory, and every f32 operand
(``exp(L_end - L_s) x``, the carried state, the decayed scores) is split
exactly into three bf16 terms, so each product is exact.  f32 inputs keep
the same structure with the products on the CUDA cores (chains of fmaf,
nothing split), as the f32 bars need.  Slices of B, C and the state come
in, and the state goes out, by the tensor memory accelerator through
tensor maps the C side encodes at each call (B and C by the threads where
a map cannot describe them).  What bounds it: 14.5 GFLOP at xLSTM-1.3B's
served prefill by :func:`repro_torch.roofline.analysis.ssd_cost`, 0.2165
ms at the f32 CUDA-core rate, the bound of the kernel it replaced; its
own bound, the one 6d's row of ``chip_smoke.py`` keeps, counts the
multiply-adds it issues to the tensor cores
(:func:`wide_tensor_core_macs`, 39.4 GFLOP at bf16, 0.040 ms at 989
TFLOP/s).  The first cluster of a chunk carries the normalizer.
:func:`ssd` picks the form by shape, so Hymba's shape keeps the first
form and its bits; a shape neither form takes raises.

B and C are read through strides: Hymba computes one B and one C per
token and broadcasts them to every head (``repro/models/ssm.py:180-181``),
so ``mamba_mix`` passes ``expand``ed views with head stride 0 and the
kernel reads 1/H of the bytes a materialised copy would cost.

:func:`ssd_ref` is the plain version and the port of
``repro.models.ssm.ssd_scan`` (the reference's oracle for the kernel),
normalizer channel included; ``models/ssm.py`` re-exports it under that
name.  The kernel takes S a multiple of the chunk, as the TPU kernel
does; ``kernels/ops.py::ssd`` pads a ragged S (``log_a = 0, B = 0`` is
exact) and slices the result back.

A CPU tensor takes :func:`ssd_ref`; a CUDA tensor launches the kernel or
raises.  Each call counts once under ``"ssd"`` in ``kernels/runtime.py``'s
``launches``: one memset and one kernel launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import runtime as R

DTYPES = (torch.float32, torch.bfloat16)
MAX_SMEM = 232_448  # bytes of shared memory a block may use on sm_90
# the wide form (csrc/ssd.cu, ssd_wide_fwd): columns of P a block, rows of
# N staged at a time, the longest chunk
WIDE_PT, WIDE_NS, WIDE_Q = 64, 32, 128


def ssd_ref(
    x: torch.Tensor,  # [B, S, H, P]
    log_a: torch.Tensor,  # [B, S, H]  log decay, <= 0
    B: torch.Tensor,  # [B, S, H, N]
    C: torch.Tensor,  # [B, S, H, N]
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,  # [B, H, N, P]
    normalizer: bool = False,
    n0: Optional[torch.Tensor] = None,  # [B, H, N] normalizer state
) -> Tuple[torch.Tensor, ...]:
    """Chunked selective scan, the reference's ``ssd_scan`` step for step.

    Returns (y [B,S,H,P] in x's type, h_final [B,H,N,P] f32); with
    ``normalizer=True`` also (den [B,S,H], n_final [B,H,N]): the mLSTM
    normalizer ``n_t = a_t n_{t-1} + B_t``, ``den_t = C_t . n_t`` from the
    same scores and decay."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))  # log a = 0 -> a = 1
        B = F.pad(B, (0, 0, 0, 0, 0, pad))  # B = 0: no input
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q

    xc = x.reshape(b, nc, q, h, p).float()
    lac = log_a.reshape(b, nc, q, h).float()
    Bc = B.reshape(b, nc, q, h, n).float()
    Cc = C.reshape(b, nc, q, h, n).float()

    L = torch.cumsum(lac, dim=2)  # [B, NC, Q, H] inclusive cumulative log-decay
    L_end = L[:, :, -1:, :]

    # intra-chunk: causal (C_t . B_s) exp(L_t - L_s), clamped at 0 so the
    # masked anti-causal region cannot make inf * 0
    scores = torch.einsum("bcqhn,bcshn->bchqs", Cc, Bc)
    Lt = L.permute(0, 1, 3, 2)  # [B, NC, H, Q]
    decay = torch.exp(torch.clamp(Lt[..., :, None] - Lt[..., None, :], max=0.0))
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    scores = torch.where(causal, scores * decay, 0.0)
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", scores, xc)

    # chunk summary H_c = sum_s exp(L_end - L_s) B_s x_s^T, chunk decay A_c
    w = torch.exp(L_end - L)  # [B, NC, Q, H]
    Hc = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", w, Bc, xc)
    Ac = torch.exp(L_end[:, :, 0, :])  # [B, NC, H]

    # inter-chunk state scan: the state before each chunk
    hprev = h0.float() if h0 is not None else x.new_zeros((b, h, n, p), dtype=torch.float32)
    befores = []
    for c in range(nc):
        befores.append(hprev)
        hprev = Ac[:, c, :, None, None] * hprev + Hc[:, c]
    h_final = hprev
    h_befores = torch.stack(befores, dim=1)  # [B, NC, H, N, P]

    y_inter = torch.einsum("bcqh,bcqhn,bchnp->bcqhp", torch.exp(L), Cc, h_befores)
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :s]
    if not normalizer:
        return y.to(x.dtype), h_final

    den_intra = scores.sum(-1).permute(0, 1, 3, 2)  # [B, NC, Q, H]
    Nc = torch.einsum("bcqh,bcqhn->bchn", w, Bc)
    nprev = n0.float() if n0 is not None else x.new_zeros((b, h, n), dtype=torch.float32)
    n_befores = []
    for c in range(nc):
        n_befores.append(nprev)
        nprev = Ac[:, c, :, None] * nprev + Nc[:, c]
    den_inter = torch.einsum(
        "bcqh,bcqhn,bchn->bcqh", torch.exp(L), Cc, torch.stack(n_befores, dim=1)
    )
    den = (den_intra + den_inter).reshape(b, nc * q, h)[:, :s]
    return y.to(x.dtype), h_final, den, nprev


@functools.lru_cache(maxsize=None)
def _smem_bytes(q: int, p: int, n: int) -> int:
    return R.bind("ssd", "ssd_smem_bytes", [R.I, R.I, R.I])(q, p, n)


@functools.lru_cache(maxsize=None)
def _wide_smem_bytes(q: int, bf16: bool) -> int:
    return R.bind("ssd", "ssd_wide_smem_bytes", [R.I, R.I])(q, int(bf16))


def wide_tensor_core_macs(b: int, s: int, h: int, n: int, p: int, chunk: int, cluster: int) -> int:
    """Multiply-adds the wide form issues to the tensor cores in one call
    from a zero state on bf16 inputs (f32 inputs run on the CUDA cores),
    at ``cluster`` blocks a cluster (``wide_launch_info``): ``ssd_cost``'s
    four terms a chunk with the split factors of ``csrc/ssd.cu`` -- the
    scores ``C B^T`` once a chunk (x 1, in whole 16 x 16 tiles over N, and
    once more for each further cluster a chunk where P/64 exceeds the
    cluster), ``scores x`` (x 3, in 32-row strips over P), ``H_c`` and
    ``C h`` (x 3 each, ``C h`` in every chunk but the first).  t is padded
    to 32 and N to a whole slice of 64."""
    q = min(chunk, s)
    qp = -(-q // 32) * 32
    tiles = (qp // 16) * (qp // 16 + 1) // 2
    strips = sum(32 * (32 * i + 32) for i in range(qp // 32))
    n = -(-n // 64) * 64  # a ragged last slice runs whole
    groups = (p // WIDE_PT) // cluster
    nc = -(-s // q)
    per_chunk = tiles * 256 * n * groups + 3 * (strips * p + qp * n * p)
    return b * h * (nc * per_chunk + (nc - 1) * 3 * qp * n * p)


def wide_launch_info(q: int, p: int, dtype=torch.bfloat16) -> dict:
    """The wide form's launch on this card at chunk ``q`` and ``p``
    columns, x, B, C and log_a in ``dtype``: blocks a cluster, clusters
    resident at once, registers and local-memory bytes (stack and spills)
    a thread, shared bytes a block."""
    bf16 = int(dtype == torch.bfloat16)
    out = (ctypes.c_int * 5)()
    fn = R.bind("ssd", "ssd_wide_info", [R.I, R.I, R.I, R.I, R.P])
    R.check(fn(q, p, bf16, bf16, ctypes.addressof(out)), "ssd_wide_info")
    keys = ("cluster_blocks", "resident_clusters", "registers_per_thread", "local_bytes_per_thread",
            "smem_bytes_per_block")
    return dict(zip(keys, list(out)))


def _strides(t: torch.Tensor, ndim: int):
    return [t.stride(i) for i in range(ndim)]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _rows_of_16_bytes(t: torch.Tensor) -> bool:
    """Every [.., :] row of ``t`` starts on a 16-byte boundary and is a
    whole number of 16-byte pieces, so the kernel stages it by 16-byte
    loads (else one element at a time)."""
    size = t.element_size()
    return (
        t.data_ptr() % 16 == 0
        and (t.shape[-1] * size) % 16 == 0
        and all((st * size) % 16 == 0 for st in t.stride()[:-1])
    )


def _narrow_fits(q: int, p: int, n: int) -> bool:
    """The first form (``ssd_fwd``) takes the shape: P a multiple of 4, N
    rounded up to 4 times P at most 1024 (one 4 x 4 tile of the state a
    thread), and its shared memory."""
    return p % 4 == 0 and (-(-n // 4)) * (p // 4) <= 256 and _smem_bytes(q, p, n) <= MAX_SMEM


def ssd(
    x: torch.Tensor,
    log_a: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    chunk: int = 128,
    normalizer: bool = False,
    n0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Batched SSD over S a multiple of ``min(chunk, S)``: returns
    (y [B,S,H,P] in x's type, h_final [B,H,N,P] f32), and with
    ``normalizer=True`` also (den [B,S,H] f32, n_final [B,H,N] f32), as
    :func:`ssd_ref`; launches ``csrc/ssd.cu`` on the current stream for
    CUDA tensors.  ``h0=None`` and ``n0=None`` mean a zero state.

    Two forms, chosen by shape: the first (``ssd_fwd``, one block a
    chunk) where it takes the shape and there is no normalizer, which
    keeps Hymba's bits; else the wide form (``ssd_wide_fwd``, one cluster
    a chunk, one block a cluster per 64 columns of P: chunk at most 128,
    P a multiple of 64, N of 32), which carries the normalizer.  A shape
    neither takes raises."""
    if x.dim() != 4 or log_a.dim() != 3 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(
            f"ssd: want x [B,S,H,P], log_a [B,S,H], B/C [B,S,H,N], got {tuple(x.shape)}, "
            f"{tuple(log_a.shape)}, {tuple(B.shape)}, {tuple(C.shape)}"
        )
    b, s, h, p = x.shape
    n = B.shape[-1]
    if tuple(log_a.shape) != (b, s, h) or tuple(B.shape[:3]) != (b, s, h):
        raise ValueError(f"ssd: shapes disagree: {tuple(x.shape)}, {tuple(log_a.shape)}, {tuple(B.shape)}")
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd: pad S = {s} to a multiple of the chunk {q} (kernels/ops.py::ssd does)")
    if h0 is not None and tuple(h0.shape) != (b, h, n, p):
        raise ValueError(f"ssd: h0 must be {(b, h, n, p)}, got {tuple(h0.shape)}")
    if n0 is not None and (not normalizer or tuple(n0.shape) != (b, h, n)):
        raise ValueError(f"ssd: n0 goes with normalizer=True and must be {(b, h, n)}, got {tuple(n0.shape)}")
    if not R.on_card(x, "ssd"):
        return ssd_ref(x, log_a, B, C, chunk=q, h0=h0, normalizer=normalizer, n0=n0)
    R.require(x, "x", 4, DTYPES)
    R.require(log_a, "log_a", 3, DTYPES)
    dev = x.device
    if any(t is not None and t.device != dev for t in (log_a, B, C, h0, n0)):
        raise ValueError(f"ssd: every operand must be on {dev}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd: x, B, C must share a dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    wide = normalizer or not _narrow_fits(q, p, n)
    if wide and (q > WIDE_Q or p % WIDE_PT or n % WIDE_NS
                 or _wide_smem_bytes(q, x.dtype == torch.bfloat16) > MAX_SMEM):
        raise ValueError(
            f"ssd: chunk {q}, P = {p}, N = {n}{' with the normalizer' if normalizer else ''}: the first "
            f"form takes P a multiple of 4 with N rounded up to 4 times P at most 1024 and no "
            f"normalizer, the wide form chunk <= {WIDE_Q}, P a multiple of {WIDE_PT} and N of "
            f"{WIDE_NS}, each within a block's shared memory")
    # the last dim must be contiguous; every other stride is passed (0 is fine)
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    h0c = None if h0 is None else h0.float().contiguous()
    if h0c is not None and h0c.data_ptr() % 16:  # the kernel reads the state 16 bytes at a time
        h0c = h0c.clone()
    nc = s // q
    y = torch.empty((b, s, h, p), device=dev, dtype=x.dtype)
    h_out = torch.empty((b, h, n, p), device=dev, dtype=torch.float32)
    # the state each chunk but the first starts from; a ticket counter and one flag a block
    states = torch.empty((nc - 1, b, h, n, p), device=dev, dtype=torch.float32)
    sync = torch.empty(1 + nc * b * h * (p // WIDE_PT if wide else 1), device=dev, dtype=torch.int32)
    vec = sum(bit for bit, t in ((1, x), (2, B), (4, C)) if _rows_of_16_bytes(t))
    strides = (*_strides(x, 3), *_strides(log_a, 3), *_strides(B, 3), *_strides(C, 3))
    flags = (int(x.dtype == torch.bfloat16), int(log_a.dtype == torch.bfloat16), vec, b, s, h, p, n, q)
    if not wide:
        fn = R.bind("ssd", "ssd_fwd", [R.P] * 9 + [R.I] * 9 + [R.L] * 12 + [R.P])
        err = fn(x.data_ptr(), log_a.data_ptr(), B.data_ptr(), C.data_ptr(), _ptr(h0c), y.data_ptr(),
                 h_out.data_ptr(), _ptr(states) if nc > 1 else None, sync.data_ptr(), *flags, *strides,
                 R.stream(dev))
        R.check(err, "ssd_fwd")
        R.count("ssd")
        return y, h_out
    den = n_out = nstates = n0c = None
    if normalizer:
        den = torch.empty((b, s, h), device=dev, dtype=torch.float32)
        n_out = torch.empty((b, h, n), device=dev, dtype=torch.float32)
        nstates = torch.empty((nc - 1, b, h, n), device=dev, dtype=torch.float32)
        n0c = None if n0 is None else n0.float().contiguous()
    fn = R.bind("ssd", "ssd_wide_fwd", [R.P] * 13 + [R.I] * 9 + [R.L] * 12 + [R.P])
    err = fn(x.data_ptr(), log_a.data_ptr(), B.data_ptr(), C.data_ptr(), _ptr(h0c), _ptr(n0c), y.data_ptr(),
             h_out.data_ptr(), _ptr(den), _ptr(n_out), _ptr(states) if nc > 1 else None,
             _ptr(nstates) if nc > 1 else None, sync.data_ptr(), *flags, *strides, R.stream(dev))
    R.check(err, "ssd_wide_fwd")
    R.count("ssd")
    return (y, h_out, den, n_out) if normalizer else (y, h_out)
