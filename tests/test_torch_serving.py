"""The port's serving runtime: batching, engines, PipelineServer, serve().

Outputs of the port's served pipeline must be BITWISE equal to its own
single-stage engine on the same inputs (every node is batch-elementwise
and the fused route sums in a fixed order), and close to the JAX
package's server on the same weights: ``RTOL, ATOL = 1e-4, 1e-5``, the
reference's bar (tests/test_conv_fused.py), for f32 sums taken in
another order at small K.
"""
from __future__ import annotations

import queue

import jax
import numpy as np
import pytest
import torch

from repro.cnn.graph import Graph as RefGraph
from repro.serving import serve as ref_serve
from repro_torch.cnn.graph import Graph
from repro_torch.cnn.params import params_from_numpy
from repro_torch.core.calibration import synthetic_model
from repro_torch.core.dse import pipe_it_search
from repro_torch.core.perfmodel import LayerTimePredictor
from repro_torch.core.pipeline import Pipeline, PipelinePlan
from repro_torch.core.platform import hikey970
from repro_torch.kernels import conv_fused as K
from repro_torch.serving import (
    FaultEvent,
    FaultPlan,
    PipelinedGraphEngine,
    PipelineServer,
    RecoveryPolicy,
    ServerClosed,
    SingleStageEngine,
    build_eager_stage_fns,
    build_stage_fns,
    fault_injecting_builder,
    gather,
    serve,
    split_rows,
    stack_envs,
)

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
POLICY = RecoveryPolicy(
    max_retries=2, backoff_base_s=0.001, backoff_factor=2.0,
    heartbeat_deadline_s=0.2, restart_delay_s=0.0,
)


def tiny(G=Graph):
    g = G("tiny", (16, 16, 3))
    a = g.conv("c1", "input", 8, 3)
    a = g.conv("c2", a, 8, 3, stride=2)
    a = g.conv("c3", a, 16, 1)
    a = g.pool_max("p1", a, 2, 2)
    a = g.conv("c4", a, 16, 3)
    a = g.fc("fc1", a, 24, act="relu")
    a = g.fc("fc2", a, 10)
    g.softmax("sm", a)
    return g


@pytest.fixture(scope="module")
def setup():
    ref_g = tiny(RefGraph)
    ref_params = ref_g.init(jax.random.PRNGKey(0))
    params = params_from_numpy(
        {n: {k: np.asarray(v) for k, v in p.items()} for n, p in ref_params.items()},
        device="cpu",
    )
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(8)]
    g = tiny()
    T = LayerTimePredictor(model=synthetic_model(), platform=hikey970()).time_matrix(
        g.descriptors()
    )
    plan = pipe_it_search(len(T), hikey970(), T, mode="best")
    return g, params, ref_g, ref_params, images, plan


# ---------------------------------------------------------------- batching
def test_stack_envs_pads_with_zero_rows_and_split_rows_drops_them():
    rng = np.random.default_rng(1)
    envs = [{"x": torch.from_numpy(rng.standard_normal((1, 3, 2)).astype(np.float32))} for _ in range(3)]
    out = stack_envs(envs, pad_to=5)
    assert out["x"].shape == (5, 3, 2)
    assert torch.equal(out["x"][3:], torch.zeros(2, 3, 2))
    assert torch.equal(out["x"][1:2], envs[1]["x"])
    rows = split_rows(out["x"], 3)
    assert len(rows) == 3 and all(r.shape == (1, 3, 2) for r in rows)
    assert stack_envs(envs)["x"].shape[0] == 3


def test_gather_flushes_on_size_and_on_sentinel():
    q: "queue.Queue" = queue.Queue()
    end = object()
    for i in range(5):
        q.put(i)
    assert gather(q, 3, 0.01, end) == ([0, 1, 2], False)
    q.put(end)
    assert gather(q, 3, 0.01, end) == ([3, 4], True)


# ----------------------------------------------------------------- serve()
def test_serve_tiny_matches_reference_and_single_stage(setup):
    """batch_size=1: on the CPU the plain route's library GEMMs and convs
    pick other blockings for other batch sizes, so only equal shapes are
    bitwise comparable there (the card's fused kernels are batch-invariant;
    the card test below serves at batch 4)."""
    g, params, ref_g, ref_params, images, plan = setup
    server = serve(g, device="cpu", backend="cuda_fused", params=params, batch_size=1)
    assert server.device == torch.device("cpu")
    assert server.plan.notation() == plan.notation()
    try:
        outs = server.run(images)["outputs"]
    finally:
        server.stop()
    assert len(outs) == 8 and all(o.shape == (1, 10) for o in outs)
    single = SingleStageEngine(g, params, backend="cuda_fused", device="cpu").run(images)
    for a, b in zip(outs, single["outputs"]):
        assert torch.equal(a, b)
    ref = ref_serve(ref_g, params=ref_params, backend="pallas_fused", batch_size=4)
    try:
        want = ref.run([jax.numpy.asarray(i) for i in images])["outputs"]
    finally:
        ref.stop()
    for a, b in zip(outs, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_serve_tiny_cuda_route_matches_reference_pallas_route(setup):
    """The unfused route served: the port's ``"cuda"`` against the
    reference's ``"pallas"`` on the same weights (batch_size=1, as above)."""
    g, params, ref_g, ref_params, images, _ = setup
    before = K.launch_counts()
    server = serve(g, device="cpu", backend="cuda", params=params, batch_size=1)
    try:
        outs = server.run(images)["outputs"]
    finally:
        server.stop()
    assert K.launch_counts() == before  # the CPU route launches no kernel
    single = SingleStageEngine(g, params, backend="cuda", device="cpu").run(images)
    for a, b in zip(outs, single["outputs"]):
        assert torch.equal(a, b)
    ref = ref_serve(ref_g, params=ref_params, backend="pallas", batch_size=4)
    try:
        want = ref.run([jax.numpy.asarray(i) for i in images])["outputs"]
    finally:
        ref.stop()
    for a, b in zip(outs, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_serve_with_the_eager_builder_matches_default_and_reference(setup):
    """``serve(stage_fn_builder=...)`` reaches the server (as the
    reference's ``serve`` takes it): stage functions run op by op give the
    default stage functions' bits and the reference server's outputs."""
    g, params, ref_g, ref_params, images, plan = setup
    calls = []

    def eager_builder(graph, pl):
        calls.append(pl.notation())
        return build_eager_stage_fns(graph, pl, backend="cuda_fused")

    outs = {}
    for name, builder in (("eager", eager_builder), ("default", None)):
        server = serve(g, device="cpu", backend="cuda_fused", params=params, batch_size=1,
                       stage_fn_builder=builder)
        try:
            outs[name] = server.run(images)["outputs"]
        finally:
            server.stop()
    assert calls == [plan.notation()]
    for a, b in zip(outs["eager"], outs["default"]):
        assert torch.equal(a, b)
    ref = ref_serve(ref_g, params=ref_params, backend="pallas_fused", batch_size=4)
    try:
        want = ref.run([jax.numpy.asarray(i) for i in images])["outputs"]
    finally:
        ref.stop()
    for a, b in zip(outs["eager"], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the no-CUDA refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve("vgg16")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SingleStageEngine(tiny(), {}, backend="cuda_fused")


@pytest.mark.parametrize("route", ["torch", "cuda_fused", "cuda"])
def test_pipelined_engine_matches_single_stage(setup, route):
    g, params, _, _, images, plan = setup
    single = SingleStageEngine(g, params, backend=route, device="cpu").run(images)
    piped = PipelinedGraphEngine(g, params, plan, backend=route, device="cpu")
    piped.warmup(images[0])
    res = piped.run(images)
    for a, b in zip(res["outputs"], single["outputs"]):
        assert torch.equal(a, b)
    assert res["stages"] == plan.pipeline.notation()


def test_launch_counts_untouched_on_the_cpu(setup):
    g, params, _, _, images, _ = setup
    before = K.launch_counts()
    SingleStageEngine(g, params, backend="cuda_fused", device="cpu").run(images[:2])
    assert K.launch_counts() == before


# --------------------------------------------------------------- recovery
def test_live_crash_redispatch_zero_loss(setup):
    g, params, _, _, images, plan = setup
    ref = SingleStageEngine(g, params, backend="cuda_fused", device="cpu").run(images)
    inj = FaultPlan(events=(FaultEvent("crash", stage=0, at_call=2),)).injector(POLICY)
    builder = fault_injecting_builder(
        lambda gr, pl: build_stage_fns(gr, pl, backend="cuda_fused"), inj
    )
    srv = PipelineServer(
        g, params, plan, batch_size=1, flush_timeout_s=0.0,
        stage_fn_builder=builder, recovery=POLICY, device="cpu",
    )
    with srv:
        res = srv.run(images)
    for a, b in zip(res["outputs"], ref["outputs"]):
        assert torch.equal(a, b)
    snap = srv.metrics.recovery.snapshot()
    assert inj.fired_kinds() == {"crash": 1}
    assert snap["worker_restarts"] >= 1 and snap["redispatched"] >= 1


def test_swap_plan_keeps_outputs_and_closes_cleanly(setup):
    g, params, _, _, images, plan = setup
    srv = PipelineServer(g, params, plan, batch_size=2, backend="cuda_fused", device="cpu")
    srv.warmup()
    with srv:
        first = srv.run(images[:4])["outputs"]
        n = sum(len(a) for a in plan.allocation)
        one_stage = PipelinePlan(
            pipeline=Pipeline(stages=(plan.pipeline.stages[0],)),
            allocation=(tuple(range(n)),),
        )
        srv.swap_plan(one_stage)
        assert srv.epoch == 1
        second = srv.run(images[:4])["outputs"]
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    with pytest.raises(ServerClosed):
        srv.submit(images[0])
