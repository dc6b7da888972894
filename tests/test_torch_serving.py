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


def test_device_batch_stacks_and_pads_stage_0s_input():
    from repro_torch.serving.server import device_batch

    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.standard_normal((1, 4, 4, 3)).astype(np.float32)) for _ in range(3)]
    env = device_batch(xs, torch.device("cpu"), 4)
    assert list(env) == ["input"] and env["input"].device.type == "cpu"
    assert torch.equal(env["input"], torch.cat(xs + [torch.zeros(1, 4, 4, 3)]))


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


def test_stop_never_joins_a_published_unstarted_replacement(setup, monkeypatch):
    """A stop() that lands between _recover_stage publishing a stage's
    replacement thread and starting it must not join the unstarted thread
    (``RuntimeError: cannot join thread before it is started``), and must
    join the replacement.  The replacement's start() runs the stop() on
    another thread first and gives it up to a second, so the join lands in
    that gap wherever the gap is open."""
    import threading
    import types

    import repro_torch.serving.server as server_mod

    g, params, _, _, images, plan = setup
    inj = FaultPlan(events=(FaultEvent("crash", stage=0, at_call=2),)).injector(POLICY)
    builder = fault_injecting_builder(
        lambda gr, pl: build_stage_fns(gr, pl, backend="cuda_fused"), inj
    )
    srv = PipelineServer(
        g, params, plan, batch_size=1, flush_timeout_s=0.0,
        stage_fn_builder=builder, recovery=POLICY, device="cpu",
    )
    stop_errors, replacements = [], []

    def stop_now():
        try:
            srv.stop(timeout=10.0)
        except BaseException as e:  # recorded; the assertions below read it
            stop_errors.append(e)

    class GapThread(threading.Thread):
        def start(self):
            if self.name.rsplit("-", 1)[-1].startswith("r"):  # a recovered stage's thread
                self.stopper = threading.Thread(target=stop_now, daemon=True)
                self.stopper.start()
                replacements.append(self)  # after the start: the wait below joins the stopper
                self.stopper.join(timeout=1.0)
            super().start()

    monkeypatch.setattr(server_mod, "threading",
                        types.SimpleNamespace(**{**vars(threading), "Thread": GapThread}))
    srv.start()
    tickets = [srv.submit(im) for im in images[:4]]
    for _ in range(500):
        if replacements and not replacements[0].stopper.is_alive():
            break
        threading.Event().wait(0.01)
    assert len(replacements) == 1, "the injected crash restarted no stage"
    replacements[0].stopper.join(timeout=15.0)
    assert not any(isinstance(e, RuntimeError) and "before it is started" in str(e)
                   for e in stop_errors), stop_errors
    assert not replacements[0].is_alive(), "stop() did not join the replacement thread"
    del tickets


def test_swap_warmup_never_takes_a_workers_scheduled_fault(setup):
    """swap_plan warms the next epoch while the old one serves; that warm-up
    must not consume the fault schedule's ordinals.  Here the swap comes
    before any traffic, the order that lets a warm-up reach the scheduled
    ordinal first: the crash must still fire in a worker (and be recovered),
    never out of swap_plan."""
    g, params, _, _, images, plan = setup
    ref = SingleStageEngine(g, params, backend="cuda_fused", device="cpu").run(images[:4])
    inj = FaultPlan(events=(FaultEvent("crash", stage=0, at_call=0),)).injector(POLICY)
    builder = fault_injecting_builder(
        lambda gr, pl: build_stage_fns(gr, pl, backend="cuda_fused"), inj
    )
    srv = PipelineServer(
        g, params, plan, batch_size=1, flush_timeout_s=0.0,
        stage_fn_builder=builder, recovery=POLICY, device="cpu",
    )
    with srv:
        srv.swap_plan(plan)  # warms the next epoch's stage 0 first
        assert inj.calls(0) == 0 and inj.total_fired == 0
        res = srv.run(images[:4])
    for a, b in zip(res["outputs"], ref["outputs"]):
        assert torch.equal(a, b)
    assert inj.fired_kinds() == {"crash": 1}
    assert srv.metrics.recovery.snapshot()["worker_restarts"] >= 1


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


# ---------------------------------------------------------------- span log
def _phases(stage):
    """A stage's phases of one micro-batch, in order (no device span on the CPU)."""
    mid = ["wait", "fill", "stack"] if stage == 0 else ["wait"]
    return [f"stage{stage}.{p}" for p in mid + ["launch", "sync", "handoff"]]


def _spans_by_batch(records):
    by = {}
    for s in records:
        got = by.setdefault((s.stage, s.micro_batch), {})
        assert s.name not in got, f"{s.name} twice for micro-batch {s.micro_batch}"
        got[s.name] = s
    return by


def test_span_log_gives_each_micro_batch_one_id_and_its_phases_in_order(setup):
    g, params, _, _, images, plan = setup
    n_stages = len(plan.allocation)
    assert n_stages >= 2
    srv = PipelineServer(g, params, plan, batch_size=2, backend="cuda_fused", device="cpu")
    log = srv.metrics.start_spans(256)
    with srv:
        srv.run(images)
    assert srv.metrics.stop_spans() is log and srv.metrics.spans is None
    by = _spans_by_batch(log.records())
    batches = srv.metrics.stages[0].batches
    assert sorted({mb for _, mb in by}) == list(range(batches))
    assert sorted(by) == [(st, mb) for st in range(n_stages) for mb in range(batches)]
    for (stage, mb), got in by.items():
        phases = [got[name] for name in _phases(stage)]
        assert sorted(got) == sorted([f"stage{stage}"] + _phases(stage))
        assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
        parent = got[f"stage{stage}"]
        assert parent.start_ns <= phases[0].start_ns and phases[-1].end_ns <= parent.end_ns
        assert len({s.ident for s in got.values()}) == 1
        assert not any(s.redispatched for s in got.values())
    assert log.dropped == 0


def test_span_log_off_records_nothing_and_reads_no_clock(setup, monkeypatch):
    import threading
    import time as time_mod

    from repro_torch.serving import metrics as metrics_mod

    g, params, _, _, images, plan = setup
    srv = PipelineServer(g, params, plan, batch_size=2, backend="cuda_fused", device="cpu",
                         name="spans-off")
    srv.warmup()
    readers = []  # the threads that read the nanosecond clock
    real = time_mod.perf_counter_ns
    monkeypatch.setattr(
        time_mod, "perf_counter_ns",
        lambda: readers.append(threading.current_thread().name) or real(),
    )
    monkeypatch.setattr(metrics_mod.SpanLog, "__init__", lambda *a: pytest.fail("a span log was made"))
    with srv:
        outs = srv.run(images)["outputs"]
    assert len(outs) == len(images) and srv.metrics.spans is None
    assert not [name for name in readers if name.startswith("spans-off")]
    assert srv.metrics.stages[0].batches > 0


def test_span_log_counts_drops_past_capacity_and_does_not_grow(setup):
    g, params, _, _, images, plan = setup
    n_stages = len(plan.allocation)
    srv = PipelineServer(g, params, plan, batch_size=2, backend="cuda_fused", device="cpu")
    log = srv.metrics.start_spans(3)
    with srv:
        srv.run(images)
    srv.metrics.stop_spans()
    batches = srv.metrics.stages[0].batches
    written = batches * sum(1 + len(_phases(st)) for st in range(n_stages))
    records = log.records()
    assert len(records) == 3 * n_stages  # one buffer a stage thread, full
    assert log.dropped == written - len(records)
    assert all(len({s.stage for s in records if s.ident == t}) == 1 for t in {s.ident for s in records})


def test_span_log_keeps_a_redispatched_micro_batchs_id_and_marks_its_spans(setup):
    g, params, _, _, images, plan = setup
    n_stages = len(plan.allocation)
    inj = FaultPlan(events=(FaultEvent("crash", stage=0, at_call=2),)).injector(POLICY)
    builder = fault_injecting_builder(
        lambda gr, pl: build_stage_fns(gr, pl, backend="cuda_fused"), inj
    )
    srv = PipelineServer(
        g, params, plan, batch_size=1, flush_timeout_s=0.0,
        stage_fn_builder=builder, recovery=POLICY, device="cpu",
    )
    log = srv.metrics.start_spans(256)
    with srv:
        srv.run(images)
    srv.metrics.stop_spans()
    assert inj.fired_kinds() == {"crash": 1}
    records = log.records()
    by = _spans_by_batch(records)
    # the crashed call's micro-batch (stage 0's third) ran again under its id
    assert {(s.stage, s.micro_batch) for s in records if s.redispatched} == {(0, 2)}
    assert sorted(by[(0, 2)]) == sorted(
        ["stage0"] + [n for n in _phases(0) if n not in ("stage0.wait", "stage0.fill")]
    )
    assert sorted(mb for st, mb in by if st == n_stages - 1) == list(range(len(images)))
