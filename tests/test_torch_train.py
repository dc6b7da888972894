"""The port's training substrate against the JAX package: the optimizer,
the synthetic data, checkpoints, the attention and SSD backward passes,
remat, the train step's effect on serving, and the launcher.

The contracts of ``tests/test_substrate.py``'s optimizer, data and
checkpoint tests, ``test_flash_attention_grads_match_dense`` and
``test_ssd_grads_flow`` hold on the port, and each module is also held
against the reference on the same numpy inputs.  Tolerances:

- ``adamw_update`` of both packages on the same params, grads and
  moments: ``UPDATE_RTOL`` (1e-6) of each leaf's largest magnitude (the
  same f32 arithmetic; XLA contracts ``b1 m + (1 - b1) g`` into fused
  multiply-adds where PyTorch rounds each product, which moves an
  element where the two terms cancel by a few ulps of the terms);
- the cosine schedule: 1e-6 relative;
- the token stream, the image stream and checkpoints across the
  packages: bitwise;
- gradients of the blocked attention and the SSD scan against the
  reference's (its ``_flash`` custom VJP and the autodiff of its jnp
  scan): ``GRAD_RTOL`` (1e-5) of each output's largest magnitude, f32
  sums in another order; against a dense softmax attention, the
  reference test's ``rtol=1e-3, atol=1e-4``;
- remat, and the sLSTM's checkpointed chunks, against the same forward
  without them: bitwise (the same ops recomputed in the same order).
"""
from __future__ import annotations

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as ref_ckpt
import repro.data as ref_data
from repro.configs import ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models.attention import blockwise_attention as ref_blockwise_attention
from repro.models.model import chunked_xent as ref_chunked_xent
from repro.models.ssm import slstm_mix as ref_slstm_mix
from repro.models.ssm import ssd_scan as ref_ssd_scan
from repro.optim import AdamWState as RefAdamWState
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine_schedule
import repro_torch.models.model as MODEL
import repro_torch.models.ssm as SSM
from repro_torch.checkpoint import load_checkpoint, restore, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import TokenStream, make_batch_iterator
from repro_torch.kernels import ops, runtime
from repro_torch.launch import train as T
from repro_torch.launch.steps import loss_and_grads, make_serve_step, make_train_step
from repro_torch.models import (chunked_xent, init_cache, init_params, params_from_numpy, params_to_numpy,
                                prefill)
from repro_torch.models.attention import blockwise_attention
from repro_torch.optim import AdamWState, adamw_init, adamw_update, clip_by_global_norm, cosine_schedule

from train_parity import cfgs, make_batch, on_torch

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

UPDATE_RTOL = 1e-6
GRAD_RTOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -------------------------------------------------------------- optimizer
def test_adamw_converges_on_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    for _ in range(300):
        w = params["w"].requires_grad_()
        (g,) = torch.autograd.grad(((w - target) ** 2).sum(), w)
        params, opt, _ = adamw_update(params, {"w": g}, opt, lr=5e-2, weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm({"a": torch.full((10,), 100.0)}, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(10) * 100)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)


def test_cosine_schedule_shape_and_reference_values():
    """lr 0 at step 0, the peak after warmup, the min_frac floor at the
    end, as the reference's test; every step equal to the reference's."""
    lrs = [float(cosine_schedule(s, 1e-3, 10, 100)) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1e-3, rel=1e-5)
    assert lrs[-1] == pytest.approx(1e-4, rel=1e-2)
    for s in range(0, 120, 7):
        want = float(ref_cosine_schedule(jnp.int32(s), 1e-3, 10, 100))
        got = float(cosine_schedule(torch.tensor(s, dtype=torch.int32), 1e-3, 10, 100))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


def test_adamw_update_matches_reference_on_the_same_inputs():
    """Both packages' update on the same params, grads (norm above the clip)
    and moments at step 3: new params, moments, step, grad norm."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    p = {k: _np(rng, *s) for k, s in shapes.items()}
    g = {k: _np(rng, *s, scale=2.0) for k, s in shapes.items()}
    m = {k: _np(rng, *s, scale=0.1) for k, s in shapes.items()}
    v = {k: np.abs(_np(rng, *s, scale=0.1)) for k, s in shapes.items()}
    rp, rs, rmet = ref_adamw_update(
        {k: jnp.asarray(a) for k, a in p.items()}, {k: jnp.asarray(a) for k, a in g.items()},
        RefAdamWState(jnp.int32(3), {k: jnp.asarray(a) for k, a in m.items()},
                      {k: jnp.asarray(a) for k, a in v.items()}), 1e-3)
    tp, ts, tmet = adamw_update({k: _t(a) for k, a in p.items()}, {k: _t(a) for k, a in g.items()},
                                AdamWState(torch.tensor(3, dtype=torch.int32), {k: _t(a) for k, a in m.items()},
                                           {k: _t(a) for k, a in v.items()}), 1e-3)
    assert int(ts.step) == int(rs.step) == 4
    assert float(tmet["grad_norm"]) == pytest.approx(float(rmet["grad_norm"]), rel=UPDATE_RTOL)
    assert float(rmet["grad_norm"]) > 1.0  # the clip is taken
    for k in shapes:
        for got, want in ((tp[k], rp[k]), (ts.m[k], rs.m[k]), (ts.v[k], rs.v[k])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=UPDATE_RTOL * np.abs(want).max())


def test_adamw_update_leaves_its_inputs_and_records_no_graph():
    p = {"w": torch.ones(4, requires_grad=True)}
    g = {"w": torch.full((4,), 0.5)}
    opt = adamw_init(p)
    new, opt2, _ = adamw_update(p, g, opt, lr=0.1)
    assert torch.equal(p["w"].detach(), torch.ones(4)) and int(opt.step) == 0
    assert not new["w"].requires_grad and int(opt2.step) == 1
    assert bool((new["w"] < 1).all())


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,books", [(0, 0), (3, 0), (5, 4)])
def test_token_stream_bitwise_equal_reference(seed, books):
    mine = iter(TokenStream(vocab_size=97, seq_len=24, batch_size=3, seed=seed, n_codebooks=books))
    ref = iter(ref_data.TokenStream(vocab_size=97, seq_len=24, batch_size=3, seed=seed, n_codebooks=books))
    for _ in range(3):
        a, b = next(mine), next(ref)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_token_stream_deterministic_and_learnable():
    s1 = next(iter(TokenStream(vocab_size=64, seq_len=32, batch_size=4, seed=3)))
    s2 = next(iter(TokenStream(vocab_size=64, seq_len=32, batch_size=4, seed=3)))
    np.testing.assert_array_equal(s1["tokens"], s2["tokens"])
    np.testing.assert_array_equal(s1["tokens"][:, 1:], s1["labels"][:, :-1])
    deltas = (s1["tokens"][:, 1:] - s1["tokens"][:, :-1]) % 64
    assert max(np.bincount(row).max() / row.size for row in deltas) > 0.5


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_batch_iterator_gives_the_references_batches(arch):
    """Shapes (patches with a vision prefix, codebooks), and the same
    tokens, labels and patches as the reference's iterator, through the
    prefetch thread."""
    cfg = get_config(arch).reduced()
    it = make_batch_iterator(cfg, batch_size=2, seq_len=16, seed=4, device="cpu", prefetch=2)
    ref = ref_data.make_batch_iterator(ref_get_config(arch).reduced(), batch_size=2, seq_len=16, seed=4,
                                       prefetch=0)
    for _ in range(3):
        a, b = next(it), next(ref)
        assert sorted(a) == sorted(b)
        books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        assert a["tokens"].shape == (2, 16) + books and a["tokens"].dtype == torch.int64
        if cfg.n_patches:
            assert a["patches"].shape == (2, cfg.n_patches, 1152)
        for key in a:
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
    it.close()


def test_batch_iterator_without_a_device_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_batch_iterator(get_config("smollm-360m").reduced(), 2, 8)


def test_batch_iterator_hands_a_worker_error_to_the_consumer(monkeypatch):
    import repro_torch.data.pipeline as P

    def broken(a, dev):
        raise OSError("disk gone")

    monkeypatch.setattr(P, "_to_device", broken)
    it = make_batch_iterator(get_config("smollm-360m").reduced(), 2, 8, device="cpu", prefetch=1)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


# ------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": [{"b": torch.ones(4, dtype=torch.bfloat16)}], "c": np.arange(3, dtype=np.int32)}
    path = save_checkpoint(str(tmp_path), 7, tree, metadata={"note": "x"})
    assert os.path.islink(tmp_path / "latest") and os.path.basename(path) == "step_00000007"
    arrays, manifest = load_checkpoint(str(tmp_path))
    assert manifest["step"] == 7 and manifest["metadata"] == {"note": "x"}
    assert manifest["keys"] == ["a", "c", "nested/0/b"]
    assert manifest["dtypes"]["nested/0/b"] == "bfloat16" and arrays["nested/0/b"].dtype == np.float32
    target = {"a": torch.zeros(2, 3), "nested": [{"b": torch.zeros(4, dtype=torch.bfloat16)}],
              "c": np.zeros(3, np.int32)}
    restored = restore(str(tmp_path), target)
    assert torch.equal(restored["a"], tree["a"])
    assert restored["nested"][0]["b"].dtype == torch.bfloat16 and torch.equal(restored["nested"][0]["b"],
                                                                            tree["nested"][0]["b"])
    np.testing.assert_array_equal(restored["c"], tree["c"])
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp_ckpt_")]


def test_checkpoint_shape_mismatch_and_missing_key_raise(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"a": torch.ones(2, 3)})
    with pytest.raises(ValueError):
        restore(str(tmp_path), {"a": torch.zeros(3, 2)})
    with pytest.raises(KeyError):
        restore(str(tmp_path), {"b": torch.zeros(2, 3)})


def test_reference_checkpoint_loads_in_the_port_bitwise(tmp_path):
    """The reference's ``save_checkpoint`` of its parameters (and a bf16
    leaf) restored by the port into a model and a bf16 tensor."""
    arch = "olmoe-1b-7b"
    rcfg, cfg = cfgs(arch)
    ref_params = ref_init_params(rcfg, jax.random.PRNGKey(3))
    half = jnp.asarray(_np(np.random.default_rng(1), 5, 3), jnp.bfloat16)
    ref_ckpt.save_checkpoint(str(tmp_path), 2, {"params": ref_params, "half": half})
    shell = init_params(cfg, seed=9, device="cpu")
    got = restore(str(tmp_path), {"params": params_to_numpy(cfg, shell),
                                  "half": torch.zeros(5, 3, dtype=torch.bfloat16)})
    model = params_from_numpy(cfg, got["params"], device="cpu")
    want = jax.tree.map(np.asarray, ref_params)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(params_to_numpy(cfg, model))):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))
    np.testing.assert_array_equal(got["half"].float().numpy(), np.asarray(half, np.float32))


def test_port_checkpoint_loads_in_the_reference_bitwise(tmp_path):
    """The port's ``save_checkpoint`` of a model's parameters (and a bf16
    tensor) restored by the reference's ``restore_sharded``."""
    arch = "xlstm-1.3b"
    rcfg, cfg = cfgs(arch)
    model = init_params(cfg, seed=5, device="cpu")
    half = torch.from_numpy(_np(np.random.default_rng(2), 4, 6)).to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 11, {"params": params_to_numpy(cfg, model), "half": half})
    target = {"params": jax.eval_shape(lambda: ref_init_params(rcfg, jax.random.PRNGKey(0))),
              "half": jax.ShapeDtypeStruct((4, 6), jnp.bfloat16)}
    got = ref_ckpt.restore_sharded(str(tmp_path), target)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got["params"])[0],
                            jax.tree.leaves(params_to_numpy(cfg, model))):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
    assert got["half"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["half"], np.float32), half.float().numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    rcfg, cfg = cfgs(arch)
    tree = jax.tree.map(np.asarray, ref_init_params(rcfg, jax.random.PRNGKey(0)))
    back = params_to_numpy(cfg, params_from_numpy(cfg, tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


# --------------------------------------------------------------- backward
def _dense_attention(q, k, v, pos, window=0, prefix=0):
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    qg = q.reshape(b, s, k.shape[2], g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * dh ** -0.5
    qq, kk = pos[:, None], pos[None, :]
    mask = kk <= qq
    if window:
        mask &= (qq - kk) < window
    if prefix:
        mask |= (qq < prefix) & (kk < prefix)
    w = torch.softmax(torch.where(mask, logits, -1e30), -1)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v).reshape(b, s, h, dh)


def test_flash_attention_grads_match_dense():
    """The reference test's contract: the blocked attention's gradients
    (its own backward) equal a dense softmax's under autograd."""
    rng = np.random.default_rng(7)
    s = 24
    q, k, v = (_t(_np(rng, 1, s, 4, 8, scale=0.5)), _t(_np(rng, 1, s, 2, 8, scale=0.5)), _t(_np(rng, 1, s, 2, 8)))
    pos = torch.arange(s, dtype=torch.int32)
    g1 = torch.autograd.grad((blockwise_attention(q.requires_grad_(), k.requires_grad_(), v.requires_grad_(),
                                                  pos, pos, chunk=8) ** 2).sum(), (q, k, v))
    g2 = torch.autograd.grad((_dense_attention(q, k, v, pos) ** 2).sum(), (q, k, v))
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("window,prefix", [(0, 0), (8, 0), (0, 11)], ids=["causal", "window", "prefix"])
def test_blockwise_attention_grads_match_reference(window, prefix):
    """dq, dk, dv of the port's ``_Flash`` against the reference's
    ``_flash`` custom VJP at a ragged S (37 positions in chunks of 16, so
    both pad), GQA with 2 query heads per KV head."""
    rng = np.random.default_rng(11)
    s = 37
    q, k, v, w = _np(rng, 2, s, 4, 8, scale=0.5), _np(rng, 2, s, 2, 8, scale=0.5), _np(rng, 2, s, 2, 8), \
        _np(rng, 2, s, 4, 8)
    pos = np.arange(s, dtype=np.int32)

    def ref_loss(q_, k_, v_):
        out = ref_blockwise_attention(q_, k_, v_, jnp.asarray(pos), jnp.asarray(pos), window=window,
                                      prefix=prefix, chunk=16)
        return (out * w).sum()

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = blockwise_attention(tq, tk, tv, _t(pos), _t(pos), window=window, prefix=prefix, chunk=16)
    got = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=GRAD_RTOL * np.abs(b).max())


def test_blockwise_attention_saves_no_block_scores():
    """The backward's saved tensors are the inputs, positions, output and
    log-sum-exp: nothing of the [cq, ck] score blocks' size."""
    rng = np.random.default_rng(0)
    s, chunk = 64, 16
    q = _t(_np(rng, 1, s, 2, 8)).requires_grad_()
    k, v = _t(_np(rng, 1, s, 2, 8)).requires_grad_(), _t(_np(rng, 1, s, 2, 8)).requires_grad_()
    saved = []
    pos = torch.arange(s, dtype=torch.int32)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t, lambda t: t):
        blockwise_attention(q, k, v, pos, pos, chunk=chunk)
    block = 1 * 2 * 1 * chunk * chunk
    assert saved and all(int(np.prod(sh)) < (s // chunk) ** 2 * block for sh in saved), saved


def test_ssd_grads_flow_and_match_reference():
    """The reference test's contract (gradients finite and nonzero)
    through ``ops.ssd``'s route for CPU tensors, and equal to the
    reference scan's autodiff, for x, log a, B and C."""
    rng = np.random.default_rng(7)
    b, s, h, p, n = 1, 16, 2, 4, 3
    x = _np(rng, b, s, h, p)
    log_a = -np.abs(_np(rng, b, s, h)) * 0.3
    bm, cm = _np(rng, b, s, h, n, scale=0.4), _np(rng, b, s, h, n, scale=0.4)
    w = _np(rng, b, s, h, p)
    want = jax.grad(lambda *a: (ref_ssd_scan(*a, chunk=8)[0] * w).sum(), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, log_a, bm, cm)))
    ts = [_t(a).requires_grad_() for a in (x, log_a, bm, cm)]
    y, _ = ops.ssd(*ts, chunk=8)
    got = torch.autograd.grad((y * _t(w)).sum(), ts)
    assert float(got[0].abs().sum()) > 0 and not bool(torch.isnan(got[0]).any())
    for a, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=GRAD_RTOL * np.abs(r).max())


# ------------------------------------------------------------------ remat
def test_remat_gives_the_same_gradients(monkeypatch):
    """A reduced SmolLM with ``remat=True`` (each layer of its scanned
    group checkpointed) gives the bits of ``remat=False``, and the
    checkpoint is taken once a layer."""
    _, cfg = cfgs("smollm-360m")
    batch = on_torch(make_batch(cfg))
    calls = []
    real = MODEL.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(MODEL, "checkpoint", counting)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = loss_and_grads(c, init_params(c, seed=0, device="cpu"), batch)
    assert calls.count("_train_block") == cfg.n_layers
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[False][2].items():
        assert torch.equal(out[True][2][name], g), name


def test_slstm_chunked_remat_at_256_same_gradients_as_the_reference():
    """At S = 256 the sLSTM's loop runs as two checkpointed chunks of 128
    steps: its gradients equal the unchunked loop's bit for bit, and the
    reference's (its nested ``jax.checkpoint``) within ``GRAD_RTOL`` of
    each gradient's scale (f32, the carry through 256 steps)."""
    rcfg, cfg = cfgs("xlstm-1.3b")
    ref_params = ref_init_params(rcfg, jax.random.PRNGKey(0))
    gi = [s.kind for s in MODEL.layer_groups(cfg)].index("slstm")
    lp = jax.tree.map(lambda a: a[0], ref_params["groups"][gi]["mix"])
    blk = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu").groups[gi][0].mix
    rng = np.random.default_rng(4)
    u, w = _np(rng, 2, 256, cfg.d_model), _np(rng, 2, 256, cfg.d_model)
    want = jax.grad(lambda p, x: (ref_slstm_mix(p, x, rcfg)[0] * w).sum(), argnums=(0, 1))(lp, jnp.asarray(u))
    leaves = dict(blk.named_parameters())

    def grads(chunk):
        SSM.SLSTM_REMAT_CHUNK = chunk
        x = _t(u).requires_grad_()
        y, _ = SSM.slstm_mix(blk, x, cfg)
        return torch.autograd.grad((y * _t(w)).sum(), [x, *leaves.values()])

    try:
        chunked, plain = grads(128), grads(1024)
    finally:
        SSM.SLSTM_REMAT_CHUNK = 128
    for a, b in zip(chunked, plain):
        assert torch.equal(a, b)
    for a, r in zip(chunked, [want[1]] + [want[0][k] for k in leaves]):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=GRAD_RTOL * np.abs(r).max())


# ------------------------------------------------------- serving after it
def test_prefill_after_a_train_step_sees_the_new_weights():
    """Serving in bf16 (the blocks' copy made by a first prefill), one
    train step, then a prefill and a decode step through the served step
    builder: equal to a fresh model loaded with the trained weights, and
    the copy was refreshed in place (the same modules), not remade."""
    cfg = get_config("hymba-1.5b").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)))
    max_len = 9 + MODEL.prefix_tokens(cfg) + 1
    before = prefill(cfg, model, {"tokens": toks}, init_cache(cfg, 2, max_len, device="cpu"))
    copies = [blk for grp in model.compute_blocks(torch.bfloat16) for blk in grp]
    step = make_train_step(cfg, base_lr=1e-3, warmup=0, total=10)
    batch = on_torch(make_batch(dataclasses.replace(cfg, grad_accum=1), b=2, s=16))
    model, _, _ = step(model, adamw_init(dict(model.named_parameters())), batch)
    fresh = params_from_numpy(cfg, params_to_numpy(cfg, model), device="cpu")
    outs = []
    for m in (model, fresh):
        caches = init_cache(cfg, 2, max_len, device="cpu")
        h = prefill(cfg, m, {"tokens": toks}, caches)
        logits = make_serve_step(cfg)(m, caches, toks[:, -1:], max_len - 1)
        outs.append((h, logits))
    assert [blk for grp in model.compute_blocks(torch.bfloat16) for blk in grp] == copies
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0], before)


def test_train_step_launches_no_counted_kernel_and_asks_for_the_plain_routes(monkeypatch):
    """Every SSD call of a Hymba train step takes ``backend="torch"``."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), grad_accum=1)
    backends = []
    real = ops.ssd

    def spy(*a, backend=None, **kw):
        backends.append(backend)
        return real(*a, backend=backend, **kw)

    monkeypatch.setattr(ops, "ssd", spy)
    model = init_params(cfg, seed=0, device="cpu")
    before = runtime.launch_counts()
    make_train_step(cfg, warmup=0)(model, adamw_init(dict(model.named_parameters())),
                                   on_torch(make_batch(cfg, b=2, s=16)))
    assert backends == ["torch"] * cfg.n_layers
    assert runtime.launch_counts() == before


# ------------------------------------------------------------------- loss
def test_chunked_xent_matches_reference_with_masked_labels():
    """A ragged S (padded with label -1) and masked labels: the sum and
    count, and the gradients of hidden and head, as the reference's."""
    rng = np.random.default_rng(3)
    h, w = _np(rng, 2, 37, 16), _np(rng, 16, 50, scale=0.3)
    labels = rng.integers(-1, 50, (2, 37)).astype(np.int32)
    (rs, rc), = [ref_chunked_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), 16)]
    rg = jax.grad(lambda a, b: ref_chunked_xent(a, b, jnp.asarray(labels), 16)[0], argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    ls, ct = chunked_xent(th, tw, _t(labels), 16)
    assert float(ct.detach()) == float(rc) == float((labels >= 0).sum())
    assert float(ls.detach()) == pytest.approx(float(rs), rel=1e-6)
    for a, r in zip(torch.autograd.grad(ls, (th, tw)), rg):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0, atol=GRAD_RTOL * np.abs(np.asarray(r)).max())


# --------------------------------------------------------------- launcher
def test_train_cli_trains_and_checkpoints_for_the_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "smollm-360m", "--reduced", "--device", "cpu",
                                      "--steps", "4", "--batch", "2", "--seq", "16", "--log-every", "2",
                                      "--ckpt-dir", str(tmp_path), "--ckpt-every", "4", "--seed", "1"])
    T.main()
    text = capsys.readouterr().out
    assert "params: 1.4M" in text and "step     1  loss" in text and "step     4  loss" in text
    assert "tok/s" in text and "gnorm" in text and f"checkpoint -> {tmp_path}/step_00000004" in text
    _, manifest = load_checkpoint(str(tmp_path))
    assert manifest["metadata"]["arch"] == "smollm-360m-reduced"
    rcfg = ref_get_config("smollm-360m").reduced()
    got = ref_ckpt.restore_sharded(str(tmp_path), {"params": jax.eval_shape(
        lambda: ref_init_params(rcfg, jax.random.PRNGKey(0)))})
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(got))


def test_train_cli_without_a_device_means_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "smollm-360m", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.main()
