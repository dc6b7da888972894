"""Shared by the language-model parity tests (tests/test_torch_dense.py,
tests/test_torch_features.py): reduced configs of both packages, prefill
and teacher-forced decode of both on the reference's weights, and the
records that tell a routing flip or an int8 rounding flip from a fault.

A MoE model routes: a top-k near-tie can pick another expert when the
inputs differ by one rounding, and an int8 cache rounds each k and v
value to an integer step: a value on a rounding boundary can land on
either side.  Either moves that sequence's later outputs by far more
than any bar.  So every router call and every int8 cache write of both
packages is recorded; the first difference in a sequence (a primary
one, whose inputs the packages share up to rounding) must sit on a
near-tie, and the outputs are compared on the sequences no difference
has reached.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.blocks as ref_blocks
import repro.models.moe as ref_moe
from repro.configs import get_config as ref_get_config
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import serve_step as ref_serve_step
import repro_torch.models.blocks as B
import repro_torch.models.moe as M
from repro_torch.configs import get_config
from repro_torch.kernels import runtime
from repro_torch.models import init_cache, params_from_numpy, prefill, serve_step
from repro_torch.models.model import SIGLIP_DIM, prefix_tokens


def cfgs(arch, dtype="float32", **kw):
    """(reference, port) reduced configs; ``scan_layers=False`` makes the
    reference call each block eagerly, so its router calls and cache
    writes can be recorded (the port has no scan)."""
    ref = dataclasses.replace(ref_get_config(arch).reduced(), compute_dtype=dtype, scan_layers=False, **kw)
    port = dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype, scan_layers=False, **kw)
    return ref, port


def rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def port_model(cfg, ref_params, serving=False):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu", serving=serving)


def recording(monkeypatch):
    """Record, for every router call of both packages, the experts each
    token picks and the gap between its k-th and (k+1)-th probability
    (``"ref"``, ``"port"``); and every int8 cache write, ``_quantize_kv``'s
    input and output (``"qref"``, ``"qport"``)."""
    seen = {"ref": [], "port": [], "qref": [], "qport": []}
    ref_router, port_router = ref_moe.router, M.router
    ref_quantize, port_quantize = ref_blocks._quantize_kv, B._quantize_kv

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

    def ref_q(x):
        out = ref_quantize(x)
        seen["qref"].append((np.asarray(x, np.float32), np.asarray(out[0]), np.asarray(out[1])))
        return out

    def port_q(x):
        out = port_quantize(x)
        seen["qport"].append((x.float().numpy(), out[0].numpy(), out[1].numpy()))
        return out

    monkeypatch.setattr(ref_moe, "router", ref_rec)
    monkeypatch.setattr(M, "router", port_rec)
    monkeypatch.setattr(ref_blocks, "_quantize_kv", ref_q)
    monkeypatch.setattr(B, "_quantize_kv", port_q)
    return seen


def int8_flips(seen, n_layers, scale_rtol):
    """An int8 cache's writes in both packages, call by call (each layer's
    k, then v, of the prefill, then of each decode step): every scale
    within ``scale_rtol`` of the reference's in the sequences no
    difference has reached, every value within one step.  Returns
    ({sequence: first output a value that differs reaches}, the
    reference's distance from a rounding boundary, |x / scale - n - 0.5|,
    at each primary difference).  A write of the prefill reaches the first
    decode step's logits (the prefill attends over the unquantized k and
    v); a write of decode step i, that step's."""
    assert len(seen["qref"]) == len(seen["qport"])
    reached, first, dist = {}, {}, []
    for c, ((xr, qr, sr), (_, qp, sp)) in enumerate(zip(seen["qref"], seen["qport"])):
        diff = qp.astype(np.int32) - qr.astype(np.int32)
        assert np.abs(diff).max(initial=0) <= 1, c
        out_i = max(c // (2 * n_layers), 1)
        for idx in np.argwhere(diff != 0):
            row = int(idx[0])
            if first.setdefault(row, c) == c:
                y = float(xr[tuple(idx)]) / float(sr[tuple(idx[:-1])])
                dist.append(abs(y - np.floor(y) - 0.5))
            reached[row] = min(reached.get(row, out_i), out_i)
        for row in range(sr.shape[0]):
            if first.get(row, c) == c:
                np.testing.assert_allclose(sp[row], sr[row], rtol=scale_rtol, atol=0)
    return reached, dist


def serve_both(arch, dtype, prompt_len, steps, monkeypatch, seed=0, serving=False, **kw):
    """Prefill a 2-sequence prompt (``[B, S, K]`` with K codebooks, after
    random 1152-wide patch features with a vision prefix) and run
    ``steps`` teacher-forced decode steps in both packages on the
    reference's f32 weights.  Returns [(ref, port)] for the prefill's last
    hidden state, then each step's logits; the two final caches; and both
    packages' records (:func:`recording`).  With ``serving`` the port
    loads the weights in its serving form (the blocks cast on load)."""
    rcfg, cfg = cfgs(arch, dtype, **kw)
    ref_params = ref_init_params(dataclasses.replace(rcfg, compute_dtype="float32"), jax.random.PRNGKey(0))
    model = port_model(cfg, ref_params, serving=serving)
    seen = recording(monkeypatch)
    rng = np.random.default_rng(seed)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = rng.integers(0, cfg.vocab_size, (2, prompt_len + steps) + books).astype(np.int32)
    batch = {"tokens": toks[:, :prompt_len]}
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal((2, cfg.n_patches, SIGLIP_DIM)).astype(np.float32)
    extra = prefix_tokens(cfg)
    max_len = prompt_len + extra + steps
    rc = ref_init_cache(rcfg, 2, max_len)
    rh, rc = ref_prefill(rcfg, ref_params, {key: jnp.asarray(a) for key, a in batch.items()}, rc)
    c = init_cache(cfg, 2, max_len, device="cpu")
    before = runtime.launch_counts()
    h = prefill(cfg, model, {key: torch.from_numpy(a).long() if key == "tokens" else torch.from_numpy(a)
                             for key, a in batch.items()}, c)
    out = [(np.asarray(rh, np.float32), h.float().numpy())]
    for i in range(steps):
        pos = prompt_len + extra + i
        t = toks[:, prompt_len + i:prompt_len + i + 1]
        rl, rc = ref_serve_step(rcfg, ref_params, rc, jnp.asarray(t), jnp.int32(pos))
        lg = serve_step(cfg, model, c, torch.from_numpy(t).long(), pos)
        out.append((np.asarray(rl), lg.numpy()))
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    monkeypatch.undo()
    return out, rc, c, seen


def assert_f32_parity(cfg, out, ref_caches, caches, seen, tol, int8_tie):
    """f32 runs of both packages (:func:`serve_both`): every primary int8
    difference within ``int8_tie`` of a rounding boundary; the outputs
    within ``tol`` on the sequences no int8 difference has reached (at
    least half of the outputs compared); the ring positions equal, and a
    bf16/f32 cache's keys and values within ``tol`` (an int8 cache's were
    compared write by write); the routes identical, call by call."""
    reached, dist = int8_flips(seen, cfg.n_layers, tol)
    assert all(x < int8_tie for x in dist), dist
    assert bool(seen["qport"]) == bool(cfg.kv_quant)
    gated = 0
    for i, (want, got) in enumerate(out):
        rows = [r for r in range(want.shape[0]) if reached.get(r, len(out)) > i]
        gated += bool(rows)
        np.testing.assert_allclose(got[rows], want[rows], rtol=tol, atol=tol)
    assert gated >= len(out) // 2, (gated, reached)
    for rg, g in zip(ref_caches, caches):
        np.testing.assert_array_equal(g["pos"].numpy(), np.asarray(rg["pos"]))
        if not cfg.kv_quant:
            for key in ("k", "v"):
                np.testing.assert_allclose(g[key].numpy(), np.asarray(rg[key]), rtol=tol, atol=tol)
    assert len(seen["port"]) == len(seen["ref"])
    for (pi, _), (ri, _) in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(pi, ri)


def assert_bf16_as_close(exact, half, seen32, seen16, slack, flip_margin):
    """bf16 runs of both packages against the reference's f32 run
    (:func:`serve_both`): every primary routing flip of either bf16 run on
    a near-tie of the f32 run (gap below ``flip_margin``), and on the
    sequences no flip has reached the port's RMS error to the f32 result
    at most ``slack`` times the reference's own (at least half of the
    outputs compared)."""
    n_moe = len(seen32["ref"]) // len(exact) if seen32["ref"] else 0
    reached, primary_gaps = {}, []
    for who in ("ref", "port"):
        first = {}
        for call, ((i16, _), (i32, g32)) in enumerate(zip(seen16[who], seen32["ref"])):
            out_i = call // n_moe  # 0: the prefill, 1 + i: decode step i
            s = i16.shape[0] // 2
            for t in np.flatnonzero((np.sort(i16, -1) != np.sort(i32, -1)).any(-1)):
                row = int(t // s)
                if first.setdefault(row, call) == call:
                    primary_gaps.append(float(g32[t]))
                reached[row] = min(reached.get(row, out_i), out_i)
    assert all(g < flip_margin for g in primary_gaps), primary_gaps
    gated = 0
    for i, ((want, _), (ref16, port16)) in enumerate(zip(exact, half)):
        assert np.isfinite(port16).all()
        rows = [r for r in range(2) if reached.get(r, len(exact)) > i]
        if not rows:
            continue
        gated += 1
        w, r16, p16 = want[rows], ref16[rows], port16[rows]
        assert rms(p16, w) <= slack * rms(r16, w), (i, rms(p16, w), rms(r16, w))
    assert gated >= len(exact) // 2, (gated, reached)
