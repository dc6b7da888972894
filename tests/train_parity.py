"""Shared by the training parity tests (tests/test_torch_train_*.py): the
loss, every gradient, the AdamW step and the accumulated step of both
packages on the reference's weights and one numpy batch, each compared
leaf by leaf in the reference's pytree layout.

Tolerances, each relative to its own scale:

- the loss and the grad norm: ``LOSS_RTOL`` (1e-5; the packages agree to
  about 1e-7 in f32);
- a gradient leaf: its largest difference at most ``GRAD_TOL`` times the
  reference leaf's largest magnitude (f32 sums in another order through
  two layers, the MoE dispatch, the SSD's chunks and the blocked
  attention's backward: up to 1.2e-5 on the attention models, with
  Hymba the largest);
- a whole train step's new parameters and moments: Adam's first step
  moves an element by ``lr g / (|g| + eps)``, about ``lr * sign(g)``.  An
  element whose (clipped) reference gradient is within the gradient bar
  ``delta`` (``GRAD_TOL`` of the leaf's scale) of 0 may take the other
  sign in the port, and one within ``sqrt(lr eps delta / PARAM_ATOL)``
  moves by ``lr eps delta / g^2`` or more when g moves by delta: each
  such element may differ by up to ``2 lr``.  Every other element is
  held to ``PARAM_ATOL`` (1e-6, where one f32 rounding of a weight of
  order 0.1 is 7e-9).  The count of elements in the first set that do
  differ by more is returned, for the test to print.

A MoE model routes: in f32 the packages route identically at these
shapes (both forwards agree to about 4e-6), and the tests assert it on
every router call of an eager forward of each, recorded as
``tests/lm_parity.py`` records the prefill's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs import get_config
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import forward, params_from_numpy, params_to_numpy
from repro_torch.models.model import SIGLIP_DIM
from repro_torch.optim import adamw_init

from lm_parity import recording

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_ATOL = 1e-6
LR = 1e-3
ADAM_EPS, ADAM_B1 = 1e-8, 0.9  # adamw_update's defaults
# the port's bf16 gradients' RMS error to the reference's f32 ones, over
# the reference's own bf16 gradients' (0.95-1.20 on the attention models)
BF16_SLACK = 1.25


def cfgs(arch, dtype="float32", **kw):
    """(reference, port) reduced configs in ``dtype``, one micro-batch a
    step unless ``grad_accum`` is given (most configs accumulate)."""
    kw = {"grad_accum": 1, **kw}
    ref = dataclasses.replace(ref_get_config(arch).reduced(), compute_dtype=dtype, **kw)
    port = dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype, **kw)
    return ref, port


def make_batch(cfg, seed=0, b=4, s=32):
    """Token ids [b, s] ([b, s, K] with codebooks), next-token labels and,
    with a vision prefix, patch features, as numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    books = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1) + books).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_patches:
        batch["patches"] = rng.standard_normal((b, cfg.n_patches, SIGLIP_DIM)).astype(np.float32)
    return batch


def ref_weights(arch):
    """The reference's reduced f32 weights (seed 0)."""
    rcfg, _ = cfgs(arch)
    return ref_init_params(rcfg, jax.random.PRNGKey(0))


def on_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def on_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def ref_loss_and_grads(rcfg, ref_params, batch):
    (loss, metrics), grads = jax.jit(
        jax.value_and_grad(lambda p: ref_loss_fn(rcfg, p, on_jax(batch)), has_aux=True)
    )(ref_params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads)


def port_loss_and_grads(cfg, ref_params, batch):
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    loss, metrics, grads = loss_and_grads(cfg, model, on_torch(batch))
    return float(loss), {k: float(v) for k, v in metrics.items()}, params_to_numpy(cfg, grads)


def leaves(tree):
    """(path, array) of a reference-layout tree, in JAX's order."""
    return [(jax.tree_util.keystr(p), np.asarray(a)) for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def grad_errors(want, got):
    """{path: max |got - want| / max |want|}; the two trees' paths equal."""
    w, g = leaves(want), leaves(got)
    assert [p for p, _ in w] == [p for p, _ in g]
    return {p: float(np.abs(b.astype(np.float64) - a).max() / max(float(np.abs(a).max()), 1e-30))
            for (p, a), (_, b) in zip(w, g)}


def assert_routes_agree(rcfg, cfg, ref_params, batch, monkeypatch):
    """Every router call of an eager f32 forward of both packages picks the
    same experts (a no-op without experts)."""
    if not cfg.n_experts:
        return
    seen = recording(monkeypatch)
    ref_forward(dataclasses.replace(rcfg, scan_layers=False), ref_params, on_jax(batch), mode="train")
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    with torch.no_grad():
        forward(cfg, model, on_torch(batch), mode="train")
    monkeypatch.undo()
    assert len(seen["port"]) == len(seen["ref"]) == cfg.n_layers - cfg.first_dense_layers
    for (pi, _), (ri, _) in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(pi, ri)


def train_steps(rcfg, cfg, ref_params, batch):
    """One train step of each package (no warmup: the first step runs at
    ``LR``) from the same weights: ({"ref", "port"}: (new params, new m,
    new v, metrics)), trees in the reference's layout."""
    step = jax.jit(ref_make_train_step(rcfg, None, base_lr=LR, warmup=0, total=100))
    rp, ropt, rm = step(ref_params, ref_adamw_init(ref_params), on_jax(batch))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    opt = adamw_init(dict(model.named_parameters()))
    model, opt, pm = make_train_step(cfg, base_lr=LR, warmup=0, total=100)(model, opt, on_torch(batch))
    assert int(opt.step) == int(ropt.step) == 1
    return {
        "ref": (jax.tree.map(np.asarray, rp), jax.tree.map(np.asarray, ropt.m),
                jax.tree.map(np.asarray, ropt.v), {k: float(v) for k, v in rm.items()}),
        "port": (params_to_numpy(cfg, model), params_to_numpy(cfg, opt.m), params_to_numpy(cfg, opt.v),
                 {k: float(v) for k, v in pm.items()}),
    }


def assert_steps_agree(out, grad_tol=GRAD_TOL):
    """The two packages' steps of :func:`train_steps`: metrics within
    ``LOSS_RTOL``; the moments within ``grad_tol`` of their leaf's scale
    (m is 0.1 of the clipped gradient, v 0.05 of its square); the new
    parameters within ``PARAM_ATOL``, or ``2 LR`` where the reference's
    m, so its clipped gradient ``m / (1 - b1)``, lies where the update is
    sensitive to a gradient error of ``grad_tol`` of the leaf's scale (the
    module's docstring).  Returns the count of such elements whose update
    differs by more than ``PARAM_ATOL``."""
    (rp, rm, rv, rmet), (pp, pm, pv, pmet) = out["ref"], out["port"]
    for key in ("loss", "xent", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(pmet[key], rmet[key], rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
    for want, got in ((rm, pm), (rv, pv)):
        errs = grad_errors(want, got)
        assert max(errs.values()) <= grad_tol, errs
    flipped = 0
    for (path, m), (_, a), (_, b) in zip(leaves(rm), leaves(rp), leaves(pp)):
        g = np.abs(m.astype(np.float64)) / (1 - ADAM_B1)
        delta = grad_tol * g.max()
        near_zero = g <= max(delta, np.sqrt(LR * ADAM_EPS * delta / PARAM_ATOL))
        diff = np.abs(b.astype(np.float64) - a)
        assert diff[~near_zero].max(initial=0) <= PARAM_ATOL, path
        assert diff[near_zero].max(initial=0) <= 2 * LR * (1 + 1e-3) + PARAM_ATOL, path
        flipped += int((diff[near_zero] > PARAM_ATOL).sum())
    return flipped


def assert_train_parity(arch, monkeypatch, capsys, grad_tol=GRAD_TOL):
    """The loss, every gradient leaf (at ``grad_tol``), the routes, one
    train step and one step accumulated over two micro-batches of the
    port against the reference's, f32, on the reference's weights."""
    rcfg, cfg = cfgs(arch)
    ref_params = ref_weights(arch)
    batch = make_batch(cfg)
    assert_routes_agree(rcfg, cfg, ref_params, batch, monkeypatch)
    rl, rmet, rg = ref_loss_and_grads(rcfg, ref_params, batch)
    pl, pmet, pg = port_loss_and_grads(cfg, ref_params, batch)
    np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)
    for key in ("xent", "aux"):
        np.testing.assert_allclose(pmet[key], rmet[key], rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
    errs = grad_errors(rg, pg)
    assert max(errs.values()) <= grad_tol, errs
    flips = {}
    for accum in (1, 2):
        rc, pc = cfgs(arch, grad_accum=accum)
        flips[accum] = assert_steps_agree(train_steps(rc, pc, ref_params, batch), grad_tol)
    with capsys.disabled():
        print(f"\n{arch}: loss {pl:.7f} (reference {rl:.7f}), worst gradient leaf "
              f"{max(errs.values()):.2e} of its scale; near-zero updates of the other sign: "
              f"{flips[1]} (one batch), {flips[2]} (two micro-batches)")


def rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def assert_bf16_grads_as_close(arch, slack=BF16_SLACK):
    """In bf16 the port's gradients lie as close to the reference's f32
    ones as the reference's own bf16 gradients do: over all leaves (each
    scaled by its f32 leaf's largest magnitude), the port's RMS error at
    most ``slack`` times the reference's.  The port's bf16 loss lies
    within ``slack`` times the reference's distance from the f32
    loss, or within one bf16 step of it (2^-8 relative), whichever is
    larger: one scalar is too few numbers for the ratio alone."""
    ref_params = ref_weights(arch)
    r32, p32 = cfgs(arch)
    r16, p16 = cfgs(arch, "bfloat16")
    batch = make_batch(p32)
    l32, _, g32 = ref_loss_and_grads(r32, ref_params, batch)
    lr16, _, gr16 = ref_loss_and_grads(r16, ref_params, batch)
    lp16, _, gp16 = port_loss_and_grads(p16, ref_params, batch)
    assert np.isfinite(lp16)
    assert abs(lp16 - l32) <= max(slack * abs(lr16 - l32), 2.0 ** -8 * abs(l32)), (lp16, lr16, l32)

    def scaled(tree):
        return np.concatenate([(a / max(float(np.abs(w).max()), 1e-30)).ravel()
                               for (_, a), (_, w) in zip(leaves(tree), leaves(g32))])

    want = scaled(g32)
    err_ref, err_port = rms(scaled(gr16), want), rms(scaled(gp16), want)
    assert err_port <= slack * err_ref, (err_port, err_ref)
