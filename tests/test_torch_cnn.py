"""The port's CNN layers and graph IR against the JAX package's.

Inputs come from ``np.random.default_rng``; weights are the reference's
``Graph.init`` output carried across with ``params_from_numpy``, so both
packages compute with identical numbers.

Graph parity is teacher-forced: every port node is fed the reference's
input tensors for that node and compared with the reference's output of
that node.  Chaining whole nets compares accumulated reordering error,
not the layers (the reference's own chained vgg16 check exceeds its bar).

Tolerance: the reference's ``RTOL, ATOL = 1e-4, 1e-5`` (tests/
test_conv_fused.py).  Both packages compute in f32 on the CPU; they only
sum in different orders.  For whole graph nodes the absolute floor is
scaled by the node's output range (``ATOL * max(1, max|y|)``): the
reordering error of a K-term f32 sum follows the size of its partial
sums, so an output near zero from a K = 2304 conv whose outputs reach
O(10) carries ~1e-5 of it (measured on VGG-16 conv4_2).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.cnn import layers as RL
from repro.cnn.graph import Graph as RefGraph
from repro.cnn.models import MODELS as REF_MODELS
from repro.kernels.backend import resolve_backend as ref_resolve_backend
from repro_torch.cnn import layers as L
from repro_torch.cnn.graph import Graph
from repro_torch.cnn.models import MODELS, PAPER_MAJOR_COUNTS
from repro_torch.cnn.params import params_from_numpy
from repro_torch.kernels.backend import resolve_backend

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("pad,stride", [(0, 1), (1, 2), (2, 3)])
def test_im2col_and_conv_match_reference(pad, stride):
    rng = np.random.default_rng(pad * 7 + stride)
    x, w, b = _np(rng, 2, 9, 8, 3), _np(rng, 3, 3, 3, 5), _np(rng, 5)
    np.testing.assert_allclose(
        L.im2col(_t(x), 3, 3, stride, pad).numpy(),
        np.asarray(RL.im2col(x, 3, 3, stride, pad)), rtol=0, atol=0,
    )
    np.testing.assert_allclose(
        L.conv2d(_t(x), _t(w), _t(b), stride=stride, pad=pad).numpy(),
        np.asarray(RL.conv2d(x, w, b, stride=stride, pad=pad)), rtol=RTOL, atol=ATOL,
    )


def test_grouped_and_depthwise_conv_match_reference():
    rng = np.random.default_rng(4)
    x = _np(rng, 1, 7, 7, 6)
    wg, b = _np(rng, 3, 3, 2, 9), _np(rng, 9)
    np.testing.assert_allclose(
        L.conv2d(_t(x), _t(wg), _t(b), pad=1, groups=3).numpy(),
        np.asarray(RL.conv2d(x, wg, b, pad=1, groups=3)), rtol=RTOL, atol=ATOL,
    )
    wd, bd = _np(rng, 3, 3, 1, 6), _np(rng, 6)
    np.testing.assert_allclose(
        L.depthwise_conv2d(_t(x), _t(wd), _t(bd), stride=2, pad=1).numpy(),
        np.asarray(RL.depthwise_conv2d(x, wd, bd, stride=2, pad=1)), rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize("window,stride,pad", [(3, 2, 0), (3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_pools_match_reference(window, stride, pad):
    rng = np.random.default_rng(window + stride + pad)
    x = _np(rng, 2, 11, 10, 3)
    np.testing.assert_array_equal(
        L.max_pool(_t(x), window, stride, pad).numpy(),
        np.asarray(RL.max_pool(x, window, stride, pad)),
    )
    # avg_pool divides by the non-padded cell count (count_include_pad=False)
    np.testing.assert_allclose(
        L.avg_pool(_t(x), window, stride, pad).numpy(),
        np.asarray(RL.avg_pool(x, window, stride, pad)), rtol=1e-6, atol=1e-6,
    )


def test_lrn_softmax_gap_dense_match_reference():
    rng = np.random.default_rng(5)
    x = _np(rng, 2, 4, 4, 9, scale=20.0)  # large enough for LRN to bite
    # lrn multiplies the window sum by alpha itself (no alpha/size)
    np.testing.assert_allclose(
        L.lrn(_t(x)).numpy(), np.asarray(RL.lrn(x)), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        L.global_avg_pool(_t(x)).numpy(), np.asarray(RL.global_avg_pool(x)), rtol=1e-6, atol=1e-6
    )
    z = _np(rng, 3, 10, scale=5.0)
    np.testing.assert_allclose(
        L.softmax(_t(z)).numpy(), np.asarray(RL.softmax(z)), rtol=1e-6, atol=1e-7
    )
    # dense flattens NHWC, so fc weights are (h, w, c)-ordered in both
    w, b = _np(rng, 144, 7), _np(rng, 7)
    np.testing.assert_allclose(
        L.dense(_t(x), _t(w), _t(b)).numpy(), np.asarray(RL.dense(x, w, b)), rtol=RTOL, atol=1e-4
    )


# ------------------------------------------------------------------- graph
@pytest.mark.parametrize("net", sorted(MODELS))
def test_graph_structure_matches_reference(net):
    g, r = MODELS[net](), REF_MODELS[net]()
    assert g.infer_shapes() == r.infer_shapes()
    assert len(g.major_nodes()) == PAPER_MAJOR_COUNTS[net]
    assert g.major_boundaries() == r.major_boundaries()
    assert g.boundary_bytes() == r.boundary_bytes()
    alloc = [[0, 1], list(range(2, len(g.major_nodes()) - 1)), [len(g.major_nodes()) - 1]]
    assert g.stage_slices(alloc) == r.stage_slices(alloc)


def test_init_uses_a_torch_generator():
    g = MODELS["alexnet"]()
    p1, p2 = g.init(seed=3, device="cpu"), g.init(seed=3, device="cpu")
    p3 = g.init(seed=4, device="cpu")
    ref = jax.eval_shape(REF_MODELS["alexnet"]().init, jax.random.PRNGKey(0))
    assert set(p1) == set(ref)
    for name in p1:
        assert tuple(p1[name]["w"].shape) == tuple(ref[name]["w"].shape)
        assert torch.equal(p1[name]["w"], p2[name]["w"])
    assert not torch.equal(p1["conv1"]["w"], p3["conv1"]["w"])


def tiny_graphs():
    """A hand-built graph touching all 11 node kinds, in both packages."""
    out = []
    for G in (Graph, RefGraph):
        g = G("tiny", (12, 12, 3))
        c1 = g.conv("c1", "input", 8, 3, stride=1)
        g.lrn("n1", c1)
        p1 = g.pool_max("p1", "n1", 3, 2, pad=1)
        a = g.slice_ch("sa", p1, 0, 4)
        b = g.slice_ch("sb", p1, 4, 8)
        ca = g.conv("ca", a, 6, 1)
        cb = g.conv("cb", b, 6, 3, stride=2, pad=2)
        cb2 = g.conv("cb2", cb, 6, 1, stride=1)
        cbp = g.pool_max("cbp", cb2, 2, 1)
        pa = g.pool_avg("pa", ca, 2, 2)
        dw = g.depthwise("dw", ca, 3, stride=2, pad=1)
        cat = g.concat("cat", [pa, dw, cbp])
        r = g.residual_add("res", cat, cat, act="relu")
        gp = g.gap("gap", r)
        f = g.fc("fc", gp, 5)
        g.softmax("prob", f)
        out.append(g)
    return out


def _ref_env(graph, params, x, backend):
    kb = ref_resolve_backend(backend)
    env = {"input": x}
    for n in graph.nodes:
        env[n.name] = graph._apply_node(n, params, env, backend=kb)
    return env


def _teacher_forced(ours: Graph, ref: RefGraph, x: np.ndarray, ref_route: str, route: str):
    params_ref = ref.init(jax.random.PRNGKey(0))
    params = params_from_numpy(
        {n: {k: np.asarray(v) for k, v in p.items()} for n, p in params_ref.items()},
        device="cpu",
    )
    env_ref = _ref_env(ref, params_ref, x, ref_route)
    kb = resolve_backend(route)
    checked = []
    with torch.no_grad():
        for n in ours.nodes:
            env = {i: _t(env_ref[i]) for i in n.inputs}
            y = ours._apply_node(n, params, env, backend=kb)
            want = np.asarray(env_ref[n.name])
            assert tuple(y.shape) == want.shape, n.name
            atol = ATOL * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(
                y.numpy(), want, rtol=RTOL, atol=atol, err_msg=f"{ours.name}:{n.name}"
            )
            checked.append(n.kind)
    return checked, kb


@pytest.mark.parametrize(
    "routes", [("xla", "torch"), ("pallas_fused", "cuda_fused"), ("pallas", "cuda")]
)
def test_tiny_graph_teacher_forced_parity(routes):
    ours, ref = tiny_graphs()
    x = _np(np.random.default_rng(0), 2, *ours.input_shape)
    kinds, kb = _teacher_forced(ours, ref, x, *routes)
    assert set(kinds) == {
        "conv", "depthwise", "fc", "pool_max", "pool_avg", "gap", "lrn",
        "concat", "add", "softmax", "slice",
    }
    if routes[1] == "cuda_fused":
        assert kb.fallbacks == {"dw": "depthwise"}


@pytest.mark.parametrize(
    "routes", [("xla", "torch"), ("pallas_fused", "cuda_fused"), ("pallas", "cuda")]
)
def test_vgg16_teacher_forced_parity(routes):
    ours, ref = MODELS["vgg16"](), REF_MODELS["vgg16"]()
    x = _np(np.random.default_rng(1), 1, *ours.input_shape)
    kinds, kb = _teacher_forced(ours, ref, x, *routes)
    assert kinds.count("conv") == 13 and kinds.count("fc") == 3
    assert kb.fallbacks == {}


@pytest.mark.parametrize("route", ["torch", "cuda_fused", "cuda"])
def test_apply_range_prunes_to_the_stage_boundary(route):
    g = MODELS["vgg16"]()
    small = Graph("vgg_small", (32, 32, 3), nodes=list(g.nodes))
    params = small.init(seed=0, device="cpu")
    x = torch.from_numpy(_np(np.random.default_rng(2), 2, 32, 32, 3))
    # the full-size fc6 takes 7*7*512 inputs; at 32x32 the net ends at 1x1
    assert small.infer_shapes()["pool5"] == (1, 1, 512)
    s1, s2 = small.stage_slices([list(range(9)), list(range(9, 16))])
    with torch.no_grad():
        mid = small.apply_range(params, {"input": x}, *s1, backend=route)
        assert list(mid) == ["conv4_2"]
        out = small.apply_range(params, mid, *s2, backend=route)
        assert list(out) == ["prob"]
        whole = small.apply(params, x, backend=route)
    assert torch.equal(out["prob"], whole)
    np.testing.assert_allclose(whole.sum(-1).numpy(), np.ones(2), rtol=1e-5)
