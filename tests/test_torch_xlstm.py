"""The port's xLSTM blocks against the JAX package's: the SSD scan with its
normalizer channel, the mLSTM and sLSTM cells, the xLSTM block, the layer
groups and caches, and prefill + greedy decode of a reduced xLSTM (the
CLI on it: tests/test_torch_launch.py).

Both packages get the same configuration and the reference's weights
(``params_from_numpy``), and their inputs are made with numpy from a seed.
On the CPU ``ops.ssd`` takes B6's plain version (``ssd_ref``, the port
of ``ssd_scan``), so these tests hold the algorithm; the CUDA kernel with
the normalizer is held to ``ssd_ref`` on the card
(tests/test_torch_gpu.py, ``chip_smoke.py`` phase 6b).

The reference's sLSTM takes a chunked, rematerialised scan when S is a
multiple of 128 above 128 and a plain scan otherwise; the port has one
loop, held to both (S = 256 and S = 300).  The mLSTM's prefill scan
always runs at chunk 128, the reference's default, whatever
``cfg.ssd_chunk`` says (Hymba's).

Tolerances, as in tests/test_torch_models.py: in f32 ``1e-5`` for one
module and ``1e-4`` for a whole model's hidden states and logits, ``2e-4``
for the scan itself (the reference's SSD bar); in bf16 the port's result
must lie as close to the reference's f32 result as the reference's own
bf16 result does (RMS error at most ``BF16_SLACK`` times the
reference's).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models import serve_step as ref_serve_step
from repro.models.blocks import xlstm_block_apply as ref_xlstm_block_apply
from repro.models.model import layer_groups as ref_layer_groups
from repro.models.ssm import mlstm_mix as ref_mlstm_mix
from repro.models.ssm import slstm_mix as ref_slstm_mix
from repro.models.ssm import ssd_decode_step as ref_ssd_decode_step
from repro.models.ssm import ssd_scan as ref_ssd_scan
from repro_torch.configs import get_config
from repro_torch.kernels import ops, runtime
from repro_torch.models import init_cache, layer_groups, prefill, serve_step
from repro_torch.models.blocks import xlstm_block_apply
from repro_torch.models.ssm import mlstm_mix, slstm_mix, ssd_decode_step

from lm_parity import assert_bf16_as_close, cfgs, port_model, rms, serve_both

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

SCAN_TOL = 2e-4
MODULE_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_SLACK = 1.25
FLIP_MARGIN = 0.02
ARCH = "xlstm-1.3b"


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16_exact(a):
    """``a`` rounded to bf16, in f32: an input both packages read alike."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


@pytest.fixture(scope="module")
def ref_params():
    rcfg, _ = cfgs(ARCH)
    return ref_init_params(rcfg, jax.random.PRNGKey(0))


def _layer(tree, group):
    return jax.tree.map(lambda a: a[0], tree["groups"][group])


# --------------------------------------------------------------- the scan
def _mlstm_like(rng, b, s, h, n):
    """Scan operands as the mLSTM makes them: v, the log of a sigmoid
    forget gate, k scaled by dh**-0.5 times the input gate e^min(i, 8),
    and q."""
    x = _np(rng, b, s, h, n)
    la = np.log(1.0 / (1.0 + np.exp(-(2.0 + _np(rng, b, s, h))))).astype(np.float32)
    gate = np.exp(np.minimum(_np(rng, b, s, h, scale=2.0), 8.0))
    B = (_np(rng, b, s, h, n) * n ** -0.5 * gate[..., None]).astype(np.float32)
    C = _np(rng, b, s, h, n)
    return x, la, B, C


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "h0_n0"])
@pytest.mark.parametrize("s,chunk", [(300, 128), (45, 16)])
def test_ssd_with_normalizer_matches_the_reference_scan(s, chunk, with_state):
    rng = np.random.default_rng(s + with_state)
    b, h, n = 2, 3, 16
    x, la, B, C = _mlstm_like(rng, b, s, h, n)
    h0 = _np(rng, b, h, n, n) if with_state else None
    n0 = _np(rng, b, h, n) if with_state else None
    want = ref_ssd_scan(x, la, B, C, chunk=chunk, h0=h0, normalizer=True, n0=n0)
    t = [torch.from_numpy(a) for a in (x, la, B, C)]
    before = runtime.launch_counts()
    got = ops.ssd(*t, chunk=chunk, normalizer=True,
                  h0=None if h0 is None else torch.from_numpy(h0),
                  n0=None if n0 is None else torch.from_numpy(n0))
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    assert [tuple(g.shape) for g in got] == [(b, s, h, n), (b, h, n, n), (b, s, h), (b, h, n)]
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCAN_TOL, atol=SCAN_TOL)
    # without the normalizer the same call gives the same y and state
    y, hf = ops.ssd(*t, chunk=chunk, h0=None if h0 is None else torch.from_numpy(h0))
    assert torch.equal(y, got[0]) and torch.equal(hf, got[1])


def test_ssd_takes_its_normalizer_state_only_with_the_normalizer():
    x = torch.zeros(1, 8, 2, 4)
    la, bc = torch.zeros(1, 8, 2), torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="n0"):
        ops.ssd(x, la, bc, bc, n0=torch.zeros(1, 2, 4))


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step_with_normalizer_matches_the_reference(dtype, in_place):
    rng = np.random.default_rng(7)
    b, h, n, p = 2, 3, 16, 8
    x, B, C = (_bf16_exact(_np(rng, b, h, d)) for d in (p, n, n))
    la = _bf16_exact(-np.abs(_np(rng, b, h)) * 0.3)
    h0, n0 = _np(rng, b, h, n, p), _np(rng, b, h, n)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = ref_ssd_decode_step(*(jnp.asarray(a, jdt) for a in (x, la, B, C)), jnp.asarray(h0),
                               normalizer=True, nz=jnp.asarray(n0))
    hs, ns = torch.from_numpy(h0.copy()), torch.from_numpy(n0.copy())
    got = ssd_decode_step(*(torch.from_numpy(a).to(tdt) for a in (x, la, B, C)), hs,
                          normalizer=True, nz=ns, in_place=in_place)
    assert got[0].dtype == tdt and got[2].dtype == torch.float32 and got[3].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=MODULE_TOL, atol=MODULE_TOL)
    # in place: the state is written where it lies; else it is left alone
    assert (got[1] is hs and got[3] is ns) == in_place
    assert torch.equal(hs, torch.from_numpy(h0)) != in_place


# ------------------------------------------------------------------ cells
def _cell_inputs(cfg, s, seed):
    return _bf16_exact(_np(np.random.default_rng(seed), 2, s, cfg.d_model))


def _mlstm_both(ref_params, dtype, s, decode, seed=3):
    rcfg, cfg = cfgs(ARCH, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    lp = jax.tree.map(lambda a: a.astype(jdt), _layer(ref_params, 0)["mix"])
    blk = port_model(cfg, ref_params).compute_blocks(tdt)[0][0].mix
    u = _cell_inputs(cfg, 1 if decode else s, seed)
    nh, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    state = None
    if decode:  # a state as a prefill leaves it
        rng = np.random.default_rng(seed + 1)
        state = (_np(rng, 2, nh, dh, dh, scale=0.3), np.abs(_np(rng, 2, nh, dh)))
    want, (wh, wn) = ref_mlstm_mix(lp, jnp.asarray(u, jdt), rcfg,
                                   state=None if state is None else tuple(jnp.asarray(a) for a in state),
                                   decode=decode)
    got, (gh, gn) = mlstm_mix(blk, torch.from_numpy(u).to(tdt), cfg,
                              state=None if state is None else tuple(torch.from_numpy(a.copy()) for a in state),
                              decode=decode)
    return [(np.asarray(w, np.float32), g.detach().float().numpy()) for w, g in ((want, got), (wh, gh), (wn, gn))]


@pytest.mark.parametrize("decode", [False, True], ids=["prefill_300", "decode"])
def test_mlstm_mix_matches_reference(ref_params, decode):
    """Prefill over S = 300 (chunks of 128 + 128 + 44) and one decode step:
    the output (f32, as the reference's promotion makes it) and both
    states.  The prefill's output is held to the scan's bar: its numerator
    is a scan sum of order 100 and its denominator cancels to near 1 in a
    quarter of the rows, so each package's f32 output lies up to ~1e-4
    from the float64 result (the reference's own 3.7e-5 at this seed)."""
    out, h, n = _mlstm_both(ref_params, "float32", 300, decode)
    for (want, got), tol in ((out, MODULE_TOL if decode else SCAN_TOL), (h, MODULE_TOL), (n, MODULE_TOL)):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("decode", [False, True], ids=["prefill_300", "decode"])
def test_mlstm_mix_bf16_as_close_to_f32_as_the_reference(ref_params, decode):
    exact = _mlstm_both(ref_params, "float32", 300, decode)
    half = _mlstm_both(ref_params, "bfloat16", 300, decode)
    for (want, _), (ref16, port16) in zip(exact, half):
        assert rms(port16, want) <= BF16_SLACK * rms(ref16, want), (rms(port16, want), rms(ref16, want))


def test_mlstm_scan_runs_at_chunk_128_whatever_ssd_chunk_says(ref_params, monkeypatch):
    chunks = []
    orig = ops.ssd

    def recording(*a, **k):
        chunks.append(k.get("chunk", 128))
        return orig(*a, **k)

    monkeypatch.setattr(ops, "ssd", recording)
    rcfg, cfg = cfgs(ARCH, ssd_chunk=32)
    lp = _layer(ref_params, 0)["mix"]
    blk = port_model(cfg, ref_params).groups[0][0].mix
    u = _cell_inputs(cfg, 200, 4)
    want, _ = ref_mlstm_mix(lp, jnp.asarray(u), rcfg)
    got, _ = mlstm_mix(blk, torch.from_numpy(u), cfg)
    assert chunks == [128]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=SCAN_TOL, atol=SCAN_TOL)


def _slstm_both(ref_params, dtype, s, decode, seed=5):
    rcfg, cfg = cfgs(ARCH, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    gi = [g.kind for g in layer_groups(cfg)].index("slstm")
    lp = jax.tree.map(lambda a: a.astype(jdt), _layer(ref_params, gi)["mix"])
    blk = port_model(cfg, ref_params).compute_blocks(tdt)[gi][0].mix
    u = _cell_inputs(cfg, 1 if decode else s, seed)
    state = None
    if decode:
        rng = np.random.default_rng(seed + 1)
        dh = cfg.d_model // cfg.n_heads
        c, h = _np(rng, 2, cfg.n_heads, dh), np.tanh(_np(rng, 2, cfg.n_heads, dh))
        state = (c, np.abs(_np(rng, 2, cfg.n_heads, dh)) + 1.0, h, _np(rng, 2, cfg.n_heads, dh))
    want, wst = ref_slstm_mix(lp, jnp.asarray(u, jdt), rcfg,
                              state=None if state is None else tuple(jnp.asarray(a) for a in state),
                              decode=decode)
    got, gst = slstm_mix(blk, torch.from_numpy(u).to(tdt), cfg,
                         state=None if state is None else tuple(torch.from_numpy(a) for a in state),
                         decode=decode)
    assert got.dtype == tdt and all(t.dtype == torch.float32 for t in gst)
    return [(np.asarray(w, np.float32), g.detach().float().numpy()) for w, g in zip((want, *wst), (got, *gst))]


SLSTM_CASES = [(256, False), (300, False), (1, True)]
SLSTM_IDS = ["chunked_path_256", "plain_path_300", "decode"]


@pytest.mark.parametrize("s,decode", SLSTM_CASES, ids=SLSTM_IDS)
def test_slstm_mix_matches_reference(ref_params, s, decode):
    """S = 256 takes the reference's chunked scan, S = 300 its plain one;
    the output and the four carries (c, n, h, m)."""
    for want, got in _slstm_both(ref_params, "float32", s, decode):
        np.testing.assert_allclose(got, want, rtol=MODULE_TOL, atol=MODULE_TOL)


@pytest.mark.parametrize("s,decode", SLSTM_CASES, ids=SLSTM_IDS)
def test_slstm_mix_bf16_as_close_to_f32_as_the_reference(ref_params, s, decode):
    exact = _slstm_both(ref_params, "float32", s, decode)
    half = _slstm_both(ref_params, "bfloat16", s, decode)
    for (want, _), (ref16, port16) in zip(exact, half):
        assert rms(port16, want) <= BF16_SLACK * rms(ref16, want), (rms(port16, want), rms(ref16, want))


# ------------------------------------------------------------------ block
@pytest.mark.parametrize("d_ff", [0, 128], ids=["no_ffn", "ffn"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_matches_reference(kind, d_ff):
    """ln1, the cell, the residual, and the optional FFN (xLSTM-1.3B has
    none; with ``d_ff > 0`` it sees the f32 residual), in f32 and in a
    prefill from the caches' initial state."""
    rcfg, cfg = cfgs(ARCH, d_ff=d_ff)
    ref_p = ref_init_params(rcfg, jax.random.PRNGKey(1))
    gi = [g.kind for g in layer_groups(cfg)].index(kind)
    lp = _layer(ref_p, gi)
    blk = port_model(cfg, ref_p).groups[gi][0]
    u = _cell_inputs(cfg, 70, 6)
    rc = jax.tree.map(lambda a: a[0], ref_init_cache(rcfg, 2, 70)[gi])
    want, wst, _ = ref_xlstm_block_apply(rcfg, None, lp, jnp.asarray(u), rc, "prefill",
                                         jnp.arange(70, dtype=jnp.int32), {}, kind=kind)
    cache = tuple(t[0] for t in init_cache(cfg, 2, 70, device="cpu")[gi])
    got = xlstm_block_apply(cfg, blk, torch.from_numpy(u), cache, "prefill")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=MODULE_TOL, atol=MODULE_TOL)
    for g, w in zip(cache, wst):  # the new state, written into the cache
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=MODULE_TOL, atol=MODULE_TOL)


# --------------------------------------------------------- groups, caches
GROUP_CASES = {
    "full": ({}, False),
    "reduced": ({}, True),
    "11_layers_every_4": ({"n_layers": 11, "slstm_every": 4}, False),
    "no_slstm": ({"slstm_every": 0}, False),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_layer_groups_equal_the_reference(case):
    kw, reduced = GROUP_CASES[case]
    cfg, rcfg = get_config(ARCH), ref_get_config(ARCH)
    if reduced:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    cfg, rcfg = dataclasses.replace(cfg, **kw), dataclasses.replace(rcfg, **kw)
    mine = [dataclasses.astuple(g) for g in layer_groups(cfg)]
    assert mine == [dataclasses.astuple(g) for g in ref_layer_groups(rcfg)]
    assert sum(g[1] for g in mine) == cfg.n_layers
    if case == "full":  # xLSTM[7:1]: six runs of 7 mLSTM layers, each followed by one sLSTM
        assert [g[:2] for g in mine] == [("mlstm", 7), ("slstm", 1)] * 6


def test_init_cache_matches_the_reference_and_is_constant_in_max_len():
    rcfg, cfg = cfgs(ARCH)
    for max_len in (9, 300):
        ref = ref_init_cache(rcfg, 2, max_len)
        mine = init_cache(cfg, 2, max_len, device="cpu")
        assert len(mine) == len(ref)
        for r, m in zip(ref, mine):
            assert isinstance(m, tuple) and len(m) == len(r)
            for a, t in zip(r, m):
                assert tuple(t.shape) == a.shape and t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        assert [tuple(t.shape) for c in mine for t in c] == \
            [tuple(t.shape) for c in init_cache(cfg, 2, 5, device="cpu") for t in c]
    # the sLSTM's carries are separate tensors, each written in place
    c, n, h, _ = init_cache(cfg, 2, 9, device="cpu")[1]
    assert len({c.data_ptr(), n.data_ptr(), h.data_ptr()}) == 3


# ------------------------------------------------------- prefill + decode
GREEDY_STEPS = 8


def _ref_run(rcfg, params, prompt, steps, tokens=None):
    """The reference's prefill and ``steps`` decode steps, greedy or fed
    ``tokens``: (last hidden state, then each step's logits; the tokens
    fed; the final caches), as float64 numpy."""
    rc = ref_init_cache(rcfg, 2, prompt.shape[1] + steps)
    h, rc = ref_prefill(rcfg, params, {"tokens": jnp.asarray(prompt)}, rc)
    outs, fed, tok = [np.asarray(h, np.float64)], [], prompt[:, -1:]
    for i in range(steps):
        fed.append(tok)
        lg, rc = ref_serve_step(rcfg, params, rc, jnp.asarray(tok), jnp.int32(prompt.shape[1] + i))
        outs.append(np.asarray(lg, np.float64))
        tok = tokens[i] if tokens is not None else np.asarray(jnp.argmax(lg, -1))[:, None].astype(np.int32)
    return outs, fed, [tuple(np.asarray(t, np.float64) for t in c) for c in rc]


def test_prefill_and_greedy_decode_match_reference_f32(ref_params):
    """A reduced xLSTM (7 mLSTM layers, one sLSTM) on a 21-token prompt:
    the same 8 greedy tokens; the prefill's last hidden state, each step's
    logits and the final caches within 1e-4 of the output's range beyond
    the reference's own f32 rounding spread (its f32 result against the
    same run at float64 parameters and compute dtype).  Two f32
    implementations differ by the rounding of each: a stack of mLSTM
    layers divides by normalizers that cancel to near 1, so the matmuls'
    f32 rounding before them reaches the logits amplified (the
    reference's f32 logits lie up to 4.4e-4 from its float64 run at this
    size, on a range of 3.3), past a flat 1e-4 between the packages."""
    rcfg, cfg = cfgs(ARCH)
    model = port_model(cfg, ref_params)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    want, fed, ref_caches = _ref_run(rcfg, ref_params, prompt, GREEDY_STEPS)
    with jax.enable_x64(True):
        wide = dataclasses.replace(rcfg, compute_dtype="float64", param_dtype="float64")
        spread_runs, _, spread_caches = _ref_run(
            wide, jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), ref_params), prompt,
            GREEDY_STEPS, tokens=fed[1:] + [fed[-1]])
    caches = init_cache(cfg, 2, 21 + GREEDY_STEPS, device="cpu")
    before = runtime.launch_counts()
    got = [prefill(cfg, model, {"tokens": torch.from_numpy(prompt).long()}, caches).double().numpy()]
    tok = prompt[:, -1:]
    for i in range(GREEDY_STEPS):
        np.testing.assert_array_equal(tok, fed[i])  # the same greedy tokens
        lg = serve_step(cfg, model, caches, torch.from_numpy(tok).long(), 21 + i)
        got.append(lg.double().numpy())
        tok = lg.argmax(-1)[:, None].numpy().astype(np.int32)
    assert runtime.launch_counts() == before  # the CPU route launches nothing
    pairs = list(zip(got, want, spread_runs))
    for c, rc, sc in zip(caches, ref_caches, spread_caches):
        c = tuple(t.double().numpy() for t in c)
        if len(c) == 4:  # sLSTM: c and n move together with m, the cell reads c / n
            c, rc, sc = ((a / b, d, e) for a, b, d, e in (c, rc, sc))
        pairs += list(zip(c, rc, sc))
    for g, w, w64 in pairs:
        spread = float(np.abs(w - w64).max())
        assert np.abs(g - w).max() <= MODEL_TOL * max(1.0, float(np.abs(w).max())) + spread, \
            (float(np.abs(g - w).max()), spread)


def test_prefill_and_decode_bf16_as_close_to_f32_as_the_reference(monkeypatch):
    exact, _, _, seen32 = serve_both(ARCH, "float32", 21, 4, monkeypatch)
    half, _, _, seen16 = serve_both(ARCH, "bfloat16", 21, 4, monkeypatch)
    assert not seen32["port"] and not seen32["qport"]  # no router, no int8 cache
    assert_bf16_as_close(exact, half, seen32, seen16, BF16_SLACK, FLIP_MARGIN)
