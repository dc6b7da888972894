"""The port's Mixture-of-Experts (``repro_torch.models.moe``) and MoE
blocks against the JAX package's.

Both packages get the same parameters (the reference's, carried across as
numpy) and the same inputs, made with numpy from a seed.  The reference's
MoE reaches no Pallas kernel (its experts are a batched einsum), so these
tests hold the algorithm: the router (softmax over f32 logits, top-k in
the reference's order, renormalisation only when asked, the load-balance
loss), the stable rank of each pair within its expert, the capacity
formula, pairs past capacity dropped, and the combine.  At least one case
drops pairs (a low ``capacity_factor``), and the test asserts that some
were dropped.

In f32 the two packages route identically (the experts each token picks,
in the same order, are asserted equal) and the outputs are held at
``1e-5`` for one module, the tolerance of ``tests/test_torch_models.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models.blocks import dense_block_apply as ref_dense_block_apply
from repro.models.model import layer_groups as ref_layer_groups
import repro_torch.models.moe as M
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.models.blocks import dense_block_apply
from repro_torch.models.model import layer_groups

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

MODULE_TOL = 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _moe_params(seed, d, f, e, glu):
    """The reference's ``init_moe_params`` (numpy) and the port's
    :class:`~repro_torch.models.moe.MoE` holding the same values."""
    ref = jax.tree.map(np.asarray, ref_moe.init_moe_params(jax.random.PRNGKey(seed), d, f, e,
                                                           jnp.float32, glu))
    mine = M.MoE(d, f, e, torch.float32, "cpu", glu)
    with torch.no_grad():
        for name, p in mine.named_parameters():
            p.copy_(torch.tensor(ref[name]))
    return ref, mine


def _dropped(idx, n_experts, cap):
    """Pairs past capacity, from the routed experts [T, k]."""
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=n_experts)
    return int(np.maximum(counts - cap, 0).sum())


# ----------------------------------------------------------------- router
@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "no_renorm"])
def test_router_matches_reference(renorm):
    rng = np.random.default_rng(0)
    x, w = _np(rng, 37, 48), _np(rng, 48, 8, scale=48 ** -0.5)
    rw, ridx, raux = ref_moe.router(jnp.asarray(x), jnp.asarray(w), 3, renorm=renorm)
    gw, gidx, gaux = M.router(torch.from_numpy(x), torch.from_numpy(w), 3, renorm=renorm)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx))  # the same experts, in order
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=MODULE_TOL, atol=MODULE_TOL)
    np.testing.assert_allclose(float(gaux), float(raux), rtol=MODULE_TOL, atol=MODULE_TOL)
    if renorm:
        np.testing.assert_allclose(gw.sum(-1).numpy(), 1.0, rtol=1e-6)
    else:
        assert float(gw.sum(-1).max()) < 1.0


def test_router_weights_take_the_input_dtype_and_logits_stay_f32():
    rng = np.random.default_rng(1)
    x, w = _np(rng, 5, 16), _np(rng, 16, 4)
    xb = torch.from_numpy(x).bfloat16()
    gw, gidx, _ = M.router(xb, torch.from_numpy(w), 2)
    assert gw.dtype == torch.bfloat16
    # the logits are taken on the f32 upcast of the bf16 input
    _, want, _ = M.router(xb.float(), torch.from_numpy(w), 2)
    assert torch.equal(gidx, want)


# ------------------------------------------------------ bucket positions
@pytest.mark.parametrize("case", [(64, 4, 8), (64, 4, 100), (200, 7, 20), (1, 3, 8)],
                         ids=lambda c: "x".join(map(str, c)))
def test_bucket_positions_match_reference(case):
    p, nb, cap = case
    dest = np.random.default_rng(p + nb).integers(0, nb, p).astype(np.int32)
    rpos, rvalid = ref_moe._bucket_positions(jnp.asarray(dest), nb, cap)
    pos, valid = M._bucket_positions(torch.from_numpy(dest).long(), nb, cap)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))


@pytest.mark.parametrize("pairs,e,cf", [(8, 4, 1.25), (32, 64, 1.25), (24576, 64, 1.25), (100, 4, 0.5),
                                        (64, 4, 0.3), (10, 3, 1.0)])
def test_capacity_is_the_reference_formula(pairs, e, cf):
    assert M.capacity(pairs, e, cf) == min(pairs, max(8, -(-pairs * cf // e).__int__()))


# ------------------------------------------------------------ moe_local
# (T tokens as [B, S], D, F, E, top_k, capacity_factor, act, glu, renorm)
MOE_CASES = [
    ((2, 9), 32, 48, 4, 2, 1.25, "silu", True, True),
    ((2, 9), 32, 48, 4, 2, 1.25, "silu", True, False),  # OLMoE: no renorm
    ((3, 40), 32, 24, 8, 3, 0.5, "silu", True, True),  # pairs dropped past capacity
    ((2, 64), 16, 24, 4, 2, 0.3, "gelu", False, False),  # dropped, gelu without GLU
    ((4, 1), 32, 48, 8, 3, 1.25, "silu", True, True),  # a decode step: the floor of 8
]


def _moe_id(c):
    (b, s), _, _, e, k, cf, act, glu, renorm = c
    return f"T{b}x{s}-E{e}-k{k}-cf{cf}-{act}{'-glu' if glu else ''}{'-renorm' if renorm else ''}"


@pytest.mark.parametrize("case", MOE_CASES, ids=_moe_id)
def test_moe_local_matches_reference(case):
    (b, s), d, f, e, k, cf, act, glu, renorm = case
    ref, mine = _moe_params(sum((b, s, d, f, e, k)), d, f, e, glu)
    x = _np(np.random.default_rng(b * s + e), b, s, d)
    kw = dict(top_k=k, capacity_factor=cf, act=act, glu=glu, renorm=renorm)
    want, raux = ref_moe.moe_local(jax.tree.map(jnp.asarray, ref), jnp.asarray(x), **kw)
    got, aux = M.moe_local(mine, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=MODULE_TOL, atol=MODULE_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=MODULE_TOL, atol=MODULE_TOL)
    _, idx, _ = M.router(torch.from_numpy(x).reshape(-1, d), mine.router, k, renorm)
    _, ridx, _ = ref_moe.router(jnp.asarray(x).reshape(-1, d), jnp.asarray(ref["router"]), k, renorm)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))  # f32 routes identically
    dropped = _dropped(idx, e, M.capacity(b * s * k, e, cf))
    assert dropped > 0 or cf >= 1.0, dropped  # the low factors drop


def test_dropped_pairs_contribute_nothing():
    """With capacity 8 and every token on the same two experts, only the
    first 8 tokens are served: the rest get exactly zero."""
    d, f, e = 16, 24, 4
    _, mine = _moe_params(3, d, f, e, True)
    with torch.no_grad():
        mine.router.zero_()
        mine.router[:, 1] = 10.0  # a positive input row sends everything to experts 1, then 0
    x = torch.from_numpy(np.abs(_np(np.random.default_rng(3), 1, 20, d))) + 0.1
    y, _ = M.moe_local(mine, x, top_k=2, capacity_factor=0.1)  # cap = max(8, ...) = 8
    assert M.capacity(40, e, 0.1) == 8
    assert bool((y[0, :8].abs().sum(-1) > 0).all())
    assert torch.equal(y[0, 8:], torch.zeros_like(y[0, 8:]))


def test_moe_local_reads_no_device_value_on_the_host(monkeypatch):
    """Nothing on the MoE path may sync (a CUDA graph captures it): no
    ``.item()``, ``.tolist()`` or boolean-mask indexing."""
    _, mine = _moe_params(4, 16, 24, 4, True)

    def refuse(*a, **k):
        raise AssertionError("read a device value on the host")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    monkeypatch.setattr(torch.Tensor, "nonzero", refuse)
    y, _ = M.moe_local(mine, torch.ones(2, 3, 16), top_k=2, capacity_factor=0.5)
    assert y.shape == (2, 3, 16)


# ------------------------------------------------------------ MoE blocks
def _cfgs(arch, dtype="float32", **kw):
    ref = dataclasses.replace(ref_get_config(arch).reduced(), compute_dtype=dtype, **kw)
    port = dataclasses.replace(get_config(arch).reduced(), compute_dtype=dtype, **kw)
    return ref, port


def _recording(monkeypatch):
    """Record the experts every router call of both packages picks."""
    seen = {"ref": [], "port": []}
    ref_router, port_router = ref_moe.router, M.router

    def ref_rec(*a, **k):
        out = ref_router(*a, **k)
        seen["ref"].append(np.asarray(out[1]))
        return out

    def port_rec(*a, **k):
        out = port_router(*a, **k)
        seen["port"].append(out[1].numpy())
        return out

    monkeypatch.setattr(ref_moe, "router", ref_rec)
    monkeypatch.setattr(M, "router", port_rec)
    return seen


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "olmoe-1b-7b", "moonshot-v1-16b-a3b"])
def test_layer_groups_equal_the_reference(arch):
    for reduce in (False, True):
        rcfg, cfg = ref_get_config(arch), get_config(arch)
        if reduce:
            rcfg, cfg = rcfg.reduced(), cfg.reduced()
        assert [dataclasses.asdict(g) for g in layer_groups(cfg)] == \
            [dataclasses.asdict(g) for g in ref_layer_groups(rcfg)]


# (arch, config overrides): DeepSeek (shared experts, a leading dense
# layer), OLMoE (qk_norm, no renorm), OLMoE with pairs dropped
BLOCK_CASES = [("deepseek-moe-16b", {}), ("olmoe-1b-7b", {}), ("olmoe-1b-7b", {"capacity_factor": 0.5})]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=["deepseek", "olmoe", "olmoe_dropping"])
def test_moe_block_matches_reference(case, monkeypatch):
    arch, kw = case
    rcfg, cfg = _cfgs(arch, **kw)
    ref_params = ref_init_params(rcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params), device="cpu")
    g = len(layer_groups(cfg)) - 1  # the MoE group (DeepSeek's dense group is first)
    assert layer_groups(cfg)[g].kind == "moe"
    lp = jax.tree.map(lambda a: a[0], ref_params["groups"][g])
    blk = model.groups[g][0]
    assert (blk.shared is not None) == bool(cfg.n_shared_experts)
    assert (blk.attn.q_norm is not None) == cfg.qk_norm
    seen = _recording(monkeypatch)
    rng = np.random.default_rng(5)
    x = _np(rng, 2, 70, cfg.d_model)
    pos = np.arange(70, dtype=np.int32)
    want, _, raux = ref_dense_block_apply(rcfg, None, lp, jnp.asarray(x), None, "train", jnp.asarray(pos),
                                          {"window": cfg.sliding_window})
    got, aux = dense_block_apply(cfg, blk, torch.from_numpy(x), None, "train", torch.from_numpy(pos),
                                 cfg.sliding_window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=MODULE_TOL, atol=MODULE_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=MODULE_TOL, atol=MODULE_TOL)
    assert len(seen["ref"]) == len(seen["port"]) == 1
    np.testing.assert_array_equal(seen["port"][0], seen["ref"][0])
    dropped = _dropped(seen["port"][0], cfg.n_experts, M.capacity(140 * cfg.top_k, cfg.n_experts,
                                                                  cfg.capacity_factor))
    assert dropped > 0 or cfg.capacity_factor >= 1.0, dropped  # the low factor drops


def test_deepseek_dense_group_holds_a_plain_ffn_and_the_moe_group_the_router_in_f32():
    cfg = get_config("deepseek-moe-16b").reduced()
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_init_params(
        ref_get_config("deepseek-moe-16b").reduced(), jax.random.PRNGKey(1))), device="cpu")
    dense, moe = model.groups[0][0], model.groups[1][0]
    assert dense.ffn is not None and dense.moe is None and dense.shared is None
    assert moe.ffn is None and moe.moe is not None
    assert moe.shared.w1.shape == (cfg.d_model, cfg.d_ff * cfg.n_shared_experts)
    assert moe.moe.router.dtype == torch.float32
    # the compute copy rounds every floating parameter, the router too
    cast = model.compute_blocks(torch.bfloat16)[1][0]
    assert cast.moe.router.dtype == torch.bfloat16 and cast.moe.w1.dtype == torch.bfloat16
    assert torch.equal(cast.moe.router, moe.moe.router.bfloat16())
    assert model.compute_blocks(torch.float32)[1][0] is moe  # no copy in the param dtype
