"""The port's closed control loop: adaptive re-planning and the governor.

Every test of tests/test_adaptive.py, and the controller and monitor
degrade/rejoin tests of tests/test_faults.py, on the port's
``repro_torch.serving`` at the reference's tiny graph, plus parity tests
that feed the same seeded inputs to both packages.  The controller,
calibrator, detector, governor and the simulator-backed harnesses are
pure Python in both, so their trajectories must be IDENTICAL: the same
``ReplanEvent`` sequence, calibrated matrix and ``{throughput, power_w}``
records, compared with ``==``.

Live servers run the ``cuda_fused`` route's plain version on the CPU at
micro-batch 1: their outputs must be bitwise equal to the port's
single-stage engine (on the CPU the library convs pick other blockings
at other batch sizes, so only equal shapes are bitwise comparable) and
within ``rtol=1e-4, atol=1e-5`` of the reference's, the reference's bar
(tests/test_adaptive.py).  Monitors are stepped by hand, except in
``test_monitor_failure_surfaces_on_stop`` (its own deadline) and the
slow end-to-end test.
"""
from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.serving as ref_serving
from repro.cnn.graph import Graph as RefGraph
from repro.core.calibration import synthetic_model as ref_synthetic_model
from repro.core.descriptors import conv_descriptor as ref_conv_descriptor
from repro_torch.cnn.graph import Graph
from repro_torch.cnn.params import params_from_numpy
from repro_torch.core import (
    Availability,
    LayerTimePredictor,
    SimulatedClock,
    evaluate,
    evaluate_frequencies,
    exhaustive_search,
    hikey970,
    pipe_it_search,
    power_aware_search,
    predict_latency,
    scale_core_type,
)
from repro_torch.core.calibration import synthetic_model
from repro_torch.core.descriptors import conv_descriptor
from repro_torch.core.pipeline import stage_time
from repro_torch.serving import (
    AdaptiveConfig,
    AdaptiveController,
    AdaptiveMonitor,
    Backpressure,
    DriftDetector,
    DriftingMatrix,
    DvfsGovernor,
    OnlineCalibrator,
    OpenLoopServing,
    PipelinedGraphEngine,
    PipelineServer,
    QueueController,
    QueuePolicy,
    ServerClosed,
    ServingError,
    SimulatedServing,
    SingleStageEngine,
    StageObservation,
    attach_adaptive,
    delayed_stage_fn_builder,
    governed_stage_fn_builder,
    run_adaptive_loop,
    run_governed_loop,
    mmpp_trace,
    run_slo_governed_loop,
    serve,
)

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
ROUTE = "cuda_fused"  # its plain version on CPU tensors
PLAT = hikey970()
REF_PLAT = ref_core.hikey970()


def _net(n=12, conv=conv_descriptor):
    return [conv(f"c{i}", 56, 64, 3, 64) for i in range(n)]


def _matrix(descs):
    return LayerTimePredictor(model=synthetic_model(), platform=PLAT).time_matrix(descs)


def _ref_matrix(descs):
    return ref_core.LayerTimePredictor(
        model=ref_synthetic_model(), platform=REF_PLAT
    ).time_matrix(descs)


def tiny_graph(G=Graph):
    g = G("tiny", (16, 16, 3))
    a = g.conv("c1", "input", 8, 3)
    a = g.conv("c2", a, 8, 3, stride=2)
    a = g.depthwise("d1", a)
    a = g.conv("c3", a, 16, 1)
    a = g.pool_max("p1", a, 2, 2)
    a = g.conv("c4", a, 16, 3)
    a = g.gap("gap", a)
    a = g.fc("fc", a, 10)
    g.softmax("sm", a)
    return g


@pytest.fixture(scope="module")
def tiny():
    """The port's graph on the reference's weights, 24 seeded images, the
    port's single-stage outputs (the bitwise bar) and the reference's (the
    tolerance bar), the time matrix and the DSE's plan."""
    ref_g = tiny_graph(RefGraph)
    ref_params = ref_g.init(jax.random.PRNGKey(0))
    params = params_from_numpy(
        {n: {k: np.asarray(v) for k, v in p.items()} for n, p in ref_params.items()},
        device="cpu",
    )
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(24)]
    ref_eng = ref_serving.SingleStageEngine(ref_g, ref_params)
    ref_eng.warmup(jnp.asarray(images[0]))
    want = [np.asarray(o) for o in ref_eng.run([jnp.asarray(i) for i in images])["outputs"]]
    g = tiny_graph()
    single = SingleStageEngine(g, params, backend=ROUTE, device="cpu").run(images)["outputs"]
    T = _matrix(g.descriptors())
    assert T == _ref_matrix(ref_g.descriptors())
    plan = pipe_it_search(len(g.descriptors()), PLAT, T, mode="best")
    return g, params, images, (single, want), T, plan


def _assert_outputs(refs, outs, index=lambda i: i):
    single, want = refs
    for i, o in enumerate(outs):
        j = index(i)
        assert torch.equal(o, single[j]), f"output {i} differs from the single-stage engine"
        np.testing.assert_allclose(o.numpy(), want[j], rtol=RTOL, atol=ATOL)


def _server(g, params, plan, **kw):
    kw.setdefault("backend", ROUTE)
    return PipelineServer(g, params, plan, device="cpu", **kw)


# ------------------------------------------------------------- calibrator
def test_calibrator_converges_to_true_correction():
    T = _matrix(_net(6))
    cal = OnlineCalibrator(T, alpha=0.5)
    layers = tuple(range(6))
    true = scale_core_type(T, "B", 2.0)
    obs = [StageObservation(("B", 4), layers, sum(r[("B", 4)] for r in true))]
    for _ in range(12):
        cal.observe(obs)
    assert cal.correction["B"] == pytest.approx(2.0, rel=1e-3)
    # unobserved core type keeps the prior
    assert "s" not in cal.correction
    M = cal.matrix()
    assert M[0][("B", 1)] == pytest.approx(2.0 * T[0][("B", 1)], rel=1e-3)
    assert M[0][("s", 1)] == T[0][("s", 1)]


def test_calibrator_rebase_snaps_to_window():
    T = _matrix(_net(4))
    cal = OnlineCalibrator(T, alpha=0.1)  # slow EWMA
    layers = tuple(range(4))
    obs = [StageObservation(("B", 2), layers, 3.0 * sum(r[("B", 2)] for r in T))]
    cal.observe(obs)
    assert cal.correction["B"] < 1.5  # EWMA barely moved...
    cal.rebase(obs)
    assert cal.correction["B"] == pytest.approx(3.0, rel=1e-9)  # ...rebase did


def test_calibrator_ignores_degenerate_observations():
    T = _matrix(_net(4))
    cal = OnlineCalibrator(T)
    cal.observe([StageObservation(("B", 1), (), 1.0)])  # empty stage
    cal.observe([StageObservation(("B", 1), (0,), 0.0)])  # no time
    assert cal.correction == {}


# --------------------------------------------------------------- detector
def test_drift_detector_debounces():
    det = DriftDetector(threshold=0.2, patience=2)
    assert not det.update(1.0, 1.5)  # first hit: not yet
    assert not det.update(1.0, 1.1)  # back in band: streak broken
    assert not det.update(1.0, 1.5)
    assert det.update(1.0, 1.6)  # two consecutive: trigger
    assert det.last_deviation == pytest.approx(0.6)
    det.reset()
    assert not det.update(1.0, 1.5)


# --------------------------------------- deterministic closed loop (sim)
@pytest.mark.parametrize("drift_core", ["B", "s"])
def test_adaptive_recovers_from_2x_cluster_slowdown(drift_core):
    """2x slowdown of one cluster: the loop re-plans and recovers >= 80% of
    the oracle throughput, on a SimulatedClock, deterministically."""
    T = _matrix(_net(12))
    plan0 = pipe_it_search(12, PLAT, T, mode="best")

    def run():
        clock = SimulatedClock()
        env = SimulatedServing(T, PLAT, clock=clock)
        ctrl = AdaptiveController(prior=T, plan=plan0, platform=PLAT)
        run_adaptive_loop(ctrl, env, rounds=2)  # settled: no spurious swaps
        assert ctrl.swaps == 0
        env.inject_drift(drift_core, 2.0)
        tp_static = env.throughput(plan0)
        run_adaptive_loop(ctrl, env, rounds=8)
        return ctrl, env, clock, tp_static

    ctrl, env, clock, tp_static = run()
    oracle = pipe_it_search(12, PLAT, env.truth.T, mode="best")
    tp_adaptive = env.throughput(ctrl.plan)
    assert ctrl.swaps >= 1
    assert tp_adaptive >= 0.80 * env.throughput(oracle)
    assert tp_adaptive > tp_static
    assert clock.now() > 0
    ctrl2, _, clock2, _ = run()  # deterministic across runs
    assert ctrl2.plan == ctrl.plan and clock2.now() == clock.now()


def test_controller_rejects_unprofitable_swap():
    """A uniform slowdown of everything changes no relative balance: the
    detector fires but the gain is ~1, so the plan stays."""
    T = _matrix(_net(10))
    plan0 = pipe_it_search(10, PLAT, T, mode="best")
    env = SimulatedServing(T, PLAT)
    ctrl = AdaptiveController(prior=T, plan=plan0, platform=PLAT)
    env.inject_drift("B", 2.0)
    env.inject_drift("s", 2.0)
    run_adaptive_loop(ctrl, env, rounds=6)
    assert ctrl.swaps == 0
    assert any(not e.swapped for e in ctrl.history)  # re-planned, rejected


# ------------------------------------------------- parity with the reference
def _events(ctrl):
    return [
        (e.round, e.deviation, e.old_plan.notation(), e.new_plan.notation(),
         e.predicted_gain, e.swapped)
        for e in ctrl.history
    ]


@pytest.mark.parametrize("drift_core", ["B", "s"])
def test_simulated_loop_under_2x_drift_is_the_references(drift_core):
    """The same 12-layer matrix, plan and 2x drift through both packages'
    SimulatedServing + run_adaptive_loop: identical events, calibrated
    matrix, throughput trajectory and simulated clock."""
    out = []
    for core, serving, matrix, conv, plat in (
        (None, None, _matrix, conv_descriptor, PLAT),
        (ref_core, ref_serving, _ref_matrix, ref_conv_descriptor, REF_PLAT),
    ):
        search = pipe_it_search if core is None else core.pipe_it_search
        Clock = SimulatedClock if core is None else core.SimulatedClock
        Env = SimulatedServing if serving is None else serving.SimulatedServing
        Ctrl = AdaptiveController if serving is None else serving.AdaptiveController
        loop = run_adaptive_loop if serving is None else serving.run_adaptive_loop
        T = matrix(_net(12, conv))
        clock = Clock()
        env = Env(T, plat, clock=clock)
        ctrl = Ctrl(prior=T, plan=search(12, plat, T, mode="best"), platform=plat)
        traj = loop(ctrl, env, rounds=2)
        env.inject_drift(drift_core, 2.0)
        traj += loop(ctrl, env, rounds=8)
        out.append((_events(ctrl), ctrl.calibrator.matrix(), ctrl.calibrator.correction,
                    traj, clock.now(), ctrl.plan.notation(), ctrl.swaps))
    assert out[0][-1] >= 1  # the drift made a swap
    assert out[0] == out[1]


def test_governed_loop_under_a_throttle_is_the_references():
    """A power-capped controller and governor, 3 governed rounds, a
    throttle to 40% of the envelope, 3 more: identical {throughput,
    power_w} trajectories, clocks and events in both packages."""
    out = []
    for core, serving, matrix, conv, plat in (
        (None, None, _matrix, conv_descriptor, PLAT),
        (ref_core, ref_serving, _ref_matrix, ref_conv_descriptor, REF_PLAT),
    ):
        pas = power_aware_search if core is None else core.power_aware_search
        Ctrl = AdaptiveController if serving is None else serving.AdaptiveController
        Gov = DvfsGovernor if serving is None else serving.DvfsGovernor
        Env = SimulatedServing if serving is None else serving.SimulatedServing
        loop = run_governed_loop if serving is None else serving.run_governed_loop
        T = matrix(_net(12, conv))
        envelope = plat.max_power_w()
        pplan = pas(12, plat, T, mode="best", power_cap_w=envelope)
        ctrl = Ctrl(prior=T, plan=pplan.plan, platform=plat, power_cap_w=envelope)
        gov = Gov(plat, ctrl)
        env = Env(T, plat)
        traj = loop(gov, env, rounds=3)
        got = gov.throttle(0.40 * envelope)
        traj += loop(gov, env, rounds=3)
        out.append((traj, gov.stage_freqs, got.notation(), _events(ctrl), gov.snapshot()))
    assert out[0] == out[1]


def _gt_tiny():
    from benchmarks.common import gt_time_matrix, tiny_graph as bench_tiny

    return gt_time_matrix(bench_tiny("tinyA", 8).descriptors())


def _mmpp_as_the_reference(*args, **kw):
    """The port's MMPP trace, held equal to the reference generator's on
    the same arguments, so both packages' tests run on the same arrivals."""
    trace = mmpp_trace(*args, **kw)
    want = ref_serving.mmpp_trace(*args, **kw)
    assert (trace.times, trace.kind, trace.meta) == (want.times, want.kind, want.meta)
    return trace


def test_slo_governed_loop_on_an_mmpp_trace_is_the_references():
    """One seeded MMPP trace, drawn by each package from its own
    generator (the two traces are equal), through both packages'
    SLO-aware governor with admission: identical per-window records."""
    T = _gt_tiny()
    n = len(T)
    traces = []
    out = []
    for core, serving, plat in ((None, None, PLAT), (ref_core, ref_serving, REF_PLAT)):
        search = pipe_it_search if core is None else core.pipe_it_search
        latency = predict_latency if core is None else core.predict_latency
        S = ref_serving if serving is not None else None
        plan = search(n, plat, T, mode="best")
        cap = plan.throughput(T)
        trace = (S.mmpp_trace if S else mmpp_trace)(0.1 * cap, 0.45 * cap, duration_s=30.0,
                                                    calm_s=5.0, burst_s=3.0, seed=5)
        traces.append((trace.times, trace.kind, trace.meta))
        slo_s = 0.004
        ctrl = (S.AdaptiveController if S else AdaptiveController)(
            prior=T, plan=plan, platform=plat, objective="min_energy",
            slo_p99_s=slo_s, arrival_rate=0.1 * cap,
        )
        gov = (S.DvfsGovernor if S else DvfsGovernor)(plat, ctrl, server=None)
        worst = plat.freq_scale("B", plat.freq_levels("B")[0])
        admission = (S.QueueController if S else QueueController)(
            (S.QueuePolicy if S else QueuePolicy)(slo_p99_s=slo_s, shed_headroom=0.9),
            base_latency_s=latency(plan, T, plat, 1e-9).base_latency_s * worst,
            service_s=worst / cap,
        )
        loop = S.run_slo_governed_loop if S else run_slo_governed_loop
        Env = S.OpenLoopServing if S else OpenLoopServing
        out.append(loop(gov, Env(T, plat), trace, window_s=1.0, admission=admission))
    assert traces[0] == traces[1]
    assert any(r["n_arrivals"] for r in out[0])
    assert out[0] == out[1]


# ----------------------------------------------------- live hot-swap path
def test_hot_swap_drops_nothing_outputs_equal(tiny):
    """Swap mid-stream; every ticket resolves (none dropped) with the
    single-stage engine's bits."""
    g, params, images, refs, T, plan_a = tiny
    plan_b = pipe_it_search(
        len(g.descriptors()), PLAT, scale_core_type(T, "B", 2.0), mode="best"
    )
    assert plan_b != plan_a  # the swap must actually change the allocation
    srv = _server(g, params, plan_a, batch_size=1, flush_timeout_s=0.005)
    srv.start()
    srv.warmup()
    tickets = []

    def feed():
        for img in images:
            tickets.append(srv.submit(img))
            time.sleep(0.002)

    feeder = threading.Thread(target=feed)
    feeder.start()
    time.sleep(0.02)
    srv.swap_plan(plan_b)  # mid-stream: old epoch drains, new epoch serves
    feeder.join(timeout=60.0)
    assert not feeder.is_alive()
    outs = [t.result(timeout=60.0) for t in tickets]
    srv.stop()
    assert len(outs) == len(images)  # nothing dropped
    assert srv.epoch == 1
    assert srv.plan == plan_b
    assert srv.metrics.completed == len(images)
    assert len(srv.metrics.stage_history) == 1  # old epoch archived
    _assert_outputs(refs, outs)


def test_nonblocking_submit_during_swap_sheds_load(tiny):
    """While swap_plan holds the ingress seal, submit(block=False) raises
    Backpressure at once, and every ticket admitted before the seal
    completes."""
    g, params, images, refs, T, plan0 = tiny
    truth = DriftingMatrix(T)
    srv = _server(
        g, params, plan0, batch_size=1, flush_timeout_s=0.0, queue_depth=4,
        stage_fn_builder=delayed_stage_fn_builder(truth, scale=500.0, backend=ROUTE),
    )
    srv.start()
    tickets = [srv.submit(img) for img in images[:4]]  # in-flight backlog
    swap_done = threading.Event()

    def do_swap():
        srv.swap_plan(plan0, warmup=False)  # slow drain: sleepy stages
        swap_done.set()

    t = threading.Thread(target=do_swap, daemon=True)
    t.start()
    deadline = time.perf_counter() + 30.0
    while not srv._submit_lock.locked() and time.perf_counter() < deadline:
        time.sleep(0.001)
    assert srv._submit_lock.locked()  # the seal is on: drain in progress
    t0 = time.perf_counter()
    with pytest.raises(Backpressure):
        srv.submit(images[4], block=False)
    assert time.perf_counter() - t0 < 1.0  # shed immediately, no stall
    t.join(timeout=60.0)
    assert swap_done.is_set()
    _assert_outputs(refs, [tk.result(timeout=60.0) for tk in tickets])
    srv.stop()


def test_swap_plan_validates_partition(tiny):
    g, params, images, refs, T, plan = tiny
    srv = _server(g, params, plan, batch_size=2)
    bad = pipe_it_search(3, PLAT, T[:3], mode="merge")  # wrong layer count
    with pytest.raises(ValueError):
        srv.swap_plan(bad, warmup=False)


def test_swap_plan_after_stop_raises(tiny):
    g, params, images, refs, T, plan = tiny
    srv = _server(g, params, plan, batch_size=2)
    srv.start()
    srv.stop()
    with pytest.raises(ServerClosed):
        srv.swap_plan(plan, warmup=False)


def test_swap_before_start_takes_effect_on_start(tiny):
    g, params, images, refs, T, plan_a = tiny
    plan_b = pipe_it_search(
        len(g.descriptors()), PLAT, scale_core_type(T, "s", 2.0), mode="best"
    )
    srv = _server(g, params, plan_a, batch_size=1, flush_timeout_s=0.005)
    srv.swap_plan(plan_b, warmup=False)  # cold swap: no workers yet
    assert srv.epoch == 1
    with srv:
        outs = srv.run(images[:6])["outputs"]
    _assert_outputs(refs, outs)


# ------------------------------------------- monitor on a live fake board
def test_delayed_builder_reads_truth_at_every_call(tiny):
    """The scripted delay is ``scale * stage_time(truth)`` per call, read
    at the call: a drift of ``truth`` after the stage functions were
    built (and, on the card, captured) changes the next call's delay."""
    g, params, images, refs, T, plan = tiny
    truth = DriftingMatrix(T)
    slept = []
    fns = delayed_stage_fn_builder(truth, scale=3.0, sleep=slept.append, backend=ROUTE)(g, plan)
    for drift in (None, "B"):
        if drift is not None:
            truth.scale(drift, 2.0)
        env = {"input": torch.from_numpy(images[0])}
        for fn in fns:
            env = fn(params, env)
        assert torch.equal(next(iter(env.values())), refs[0][0])
    want = [3.0 * stage_time(T, tuple(a), st) for a, st in zip(plan.allocation, plan.pipeline.stages)]
    drifted = [w * (2.0 if st[0] == "B" else 1.0) for w, st in zip(want, plan.pipeline.stages)]
    assert slept[: len(fns)] == pytest.approx(want, rel=1e-12)
    assert slept[len(fns):] == pytest.approx(drifted, rel=1e-12)
    assert any(st[0] == "B" for st in plan.pipeline.stages)


def test_monitor_closed_loop_on_live_server(tiny):
    """Drive the monitor by hand: a fake-stage board (real outputs +
    ground-truth delays) drifts 2x on the Big cluster; the sampled loop
    calibrates, detects, re-plans and hot-swaps, and every output of the
    stream keeps its bits."""
    g, params, images, refs, T, plan0 = tiny
    truth = DriftingMatrix(T)
    srv = _server(
        g, params, plan0, batch_size=1, flush_timeout_s=0.0, queue_depth=4,
        stage_fn_builder=delayed_stage_fn_builder(truth, scale=100.0, backend=ROUTE),
    )
    cfg = AdaptiveConfig(alpha=0.5, threshold=0.3, patience=1, min_gain=1.02, min_items=4)
    ctrl = AdaptiveController(prior=T, plan=plan0, platform=PLAT, config=cfg)
    monitor = AdaptiveMonitor(srv, ctrl)  # not started: stepped manually
    outs = []
    with srv:
        srv.warmup()
        outs.extend(srv.run(images[:8])["outputs"])
        monitor.step()  # absorbs static bias (compute time atop the delays)
        base_swaps = ctrl.swaps
        truth.scale("B", 2.0)  # the board's Big cluster slows 2x
        for _ in range(6):
            outs.extend(srv.run(images[:8])["outputs"])
            if monitor.step() is not None:
                break
        assert ctrl.swaps > base_swaps  # drift produced a real hot-swap
        assert srv.plan == ctrl.plan and srv.epoch >= 1
        outs.extend(srv.run(images[:8])["outputs"])  # post-swap traffic
    _assert_outputs(refs, outs, index=lambda i: i % 8)


def test_monitor_failure_surfaces_on_stop(tiny):
    """If the control loop dies on repeated errors, stop() raises."""
    g, params, images, refs, T, plan0 = tiny
    srv = _server(g, params, plan0, batch_size=2)
    ctrl = AdaptiveController(
        prior=T, plan=plan0, platform=PLAT, config=AdaptiveConfig(interval_s=0.01)
    )
    monitor = AdaptiveMonitor(srv, ctrl)

    def boom():
        raise RuntimeError("control-loop boom")

    monitor.sample = boom
    srv.monitor = monitor
    srv.start()
    monitor.start()
    deadline = time.perf_counter() + 15.0
    while monitor.error is None and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert monitor.error is not None
    with pytest.raises(ServingError, match="adaptive monitor failed"):
        srv.stop()
    assert not monitor._thread.is_alive()


def test_serve_adaptive_attaches_a_monitor_that_stop_ends(tiny):
    """serve(adaptive=True) on the CPU: the monitor's prior is the planning
    matrix, its thread runs until stop(), and the served bits hold."""
    g, params, images, refs, T, plan0 = tiny
    cfg = AdaptiveConfig(interval_s=0.05)
    server = serve(g, params=params, platform=PLAT, time_matrix=T, batch_size=1,
                   backend=ROUTE, device="cpu", adaptive=True, adaptive_config=cfg)
    try:
        monitor = server.monitor
        assert monitor.controller.config is cfg and monitor._thread.is_alive()
        assert monitor.controller.calibrator.prior == T
        assert server.plan == plan0 and server.governor is None
        outs = server.run(images[:4])["outputs"]
    finally:
        server.stop()
    assert not monitor._thread.is_alive() and monitor.error is None
    _assert_outputs(refs, outs)


# --------------------------------------------------- degrade + rejoin
def test_controller_degrade_and_rejoin(tiny):
    _, _, _, _, T, plan = tiny
    ctrl = AdaptiveController(prior=T, plan=plan, platform=PLAT)
    deg = ctrl.degrade({"B": 4})
    assert ctrl.degraded
    assert all(ct == "s" for ct, _ in deg.pipeline.stages)
    oracle = exhaustive_search(len(T), PLAT.subset({"s": 4}), T)
    assert deg.throughput(T) >= 0.90 * oracle.throughput(T)
    verdict = evaluate(deg, T, PLAT.subset({"s": 4}),
                       constraints=(Availability.from_platform(PLAT.subset({"s": 4})),))
    assert verdict.binding != "availability"
    restored = ctrl.rejoin()
    assert restored == plan and not ctrl.degraded and ctrl.lost == {}


def test_controller_degrade_validation(tiny):
    _, _, _, _, T, plan = tiny
    ctrl = AdaptiveController(prior=T, plan=plan, platform=PLAT)
    with pytest.raises(ValueError):
        ctrl.degrade({"gpu": 1})  # unknown core type
    with pytest.raises(ValueError):
        ctrl.degrade({"B": -1})
    with pytest.raises(ValueError):
        ctrl.rejoin()  # no preceding degrade


def test_monitor_degrade_reverts_belief_on_swap_failure(tiny, monkeypatch):
    """A failed hot-swap leaves the controller's belief on the running
    truth — no half-degraded state — and the server serves on."""
    g, params, images, refs, T, plan = tiny
    srv = _server(g, params, plan, batch_size=1, flush_timeout_s=0.0)
    try:
        srv.start()
        monitor = attach_adaptive(srv, T, PLAT, start=False)
        ctrl = monitor.controller

        def boom(*a, **k):
            raise RuntimeError("swap refused")

        monkeypatch.setattr(srv, "swap_plan", boom)
        with pytest.raises(RuntimeError, match="swap refused"):
            monitor.degrade({"B": 4})
        assert ctrl.plan == plan and srv.plan == plan
        assert not ctrl.degraded and ctrl.lost == {}
        assert ctrl.platform is ctrl.full_platform
        out = srv.submit(images[0]).result(timeout=30.0)
        _assert_outputs(refs, [out])
    finally:
        srv.stop()


# --------------------------------------------- governor / throttle
def test_governor_normalizes_dvfs_so_downclocking_is_not_drift():
    """A down-clocked board must not read as cluster drift: the governed
    loop runs at reduced clocks with zero swaps, while raw observations
    would have triggered."""
    T = _matrix(_net(12))
    cap = 0.55 * 6.6
    pplan = power_aware_search(12, PLAT, T, mode="best", power_cap_w=cap)
    ctrl = AdaptiveController(prior=T, plan=pplan.plan, platform=PLAT, power_cap_w=cap)
    gov = DvfsGovernor(PLAT, ctrl)
    run_governed_loop(gov, SimulatedServing(T, PLAT), rounds=6)
    assert ctrl.swaps == 0  # down-clocked != drifted
    ctrl2 = AdaptiveController(prior=T, plan=pplan.plan, platform=PLAT)
    env2 = SimulatedServing(T, PLAT)
    fired = False
    for _ in range(6):
        obs = env2.observe(ctrl2.plan, stage_freqs=pplan.stage_freqs)
        fired = fired or ctrl2.detector.update(
            ctrl2.plan.bottleneck(ctrl2.T_planned), max(o.service_s for o in obs)
        )
    assert fired


def test_governor_throttle_replans_under_new_cap_simulated():
    """A mid-stream cap drop re-plans under the new cap; the applied clocks
    satisfy it on the ground truth, deterministically."""
    T = _matrix(_net(12))
    envelope = PLAT.max_power_w()
    new_cap = 0.40 * envelope

    def trajectory():
        pplan = power_aware_search(12, PLAT, T, mode="best", power_cap_w=envelope)
        ctrl = AdaptiveController(prior=T, plan=pplan.plan, platform=PLAT, power_cap_w=envelope)
        gov = DvfsGovernor(PLAT, ctrl)
        clock = SimulatedClock()
        env = SimulatedServing(T, PLAT, clock=clock)
        run_governed_loop(gov, env, rounds=3)
        pre_power = env.power(ctrl.plan, gov.stage_freqs)
        assert pre_power > new_cap  # the drop is binding
        gov.throttle(new_cap)
        traj = run_governed_loop(gov, env, rounds=3)
        post_power = env.power(ctrl.plan, gov.stage_freqs)
        return ctrl, gov, clock.now(), pre_power, post_power, traj

    ctrl, gov, t_end, pre, post, traj = trajectory()
    assert ctrl.power_cap_w == new_cap
    assert gov.power_plan.feasible
    assert post <= new_cap * 1.001
    assert gov.throttle_events == 1
    assert all(r["power_w"] <= new_cap * 1.001 for r in traj)
    ctrl2, gov2, t_end2, pre2, post2, traj2 = trajectory()
    assert (t_end2, pre2, post2) == (t_end, pre, post)
    assert gov2.power_plan.stage_freqs == gov.power_plan.stage_freqs


def test_governor_throttle_live_server_zero_drops_outputs_bitwise(tiny):
    """A mid-stream cap drop hot-swaps the allocation; zero tickets are
    dropped and every output is bitwise equal to a same-plan engine of
    either epoch (and to the single-stage engine)."""
    g, params, images, refs, T, _plan = tiny
    n = len(g.descriptors())
    truth = DriftingMatrix(T)
    envelope = PLAT.max_power_w()
    cap0 = 1.05 * envelope
    pplan0 = power_aware_search(n, PLAT, T, mode="best", power_cap_w=cap0)
    new_cap = 0.08 * envelope  # deep throttle: the optimum moves to Small
    pplan1 = power_aware_search(n, PLAT, T, mode="best", power_cap_w=new_cap)
    assert pplan1.plan != pplan0.plan  # the throttle must force a hot-swap
    ctrl = AdaptiveController(prior=T, plan=pplan0.plan, platform=PLAT, power_cap_w=cap0)
    gov = DvfsGovernor(PLAT, ctrl)
    srv = _server(
        g, params, pplan0.plan, batch_size=1, flush_timeout_s=0.0, queue_depth=4,
        stage_fn_builder=governed_stage_fn_builder(truth, gov, scale=20.0, backend=ROUTE),
    )
    gov.server = srv
    srv.governor = gov
    srv.start()
    srv.warmup()
    tickets = []

    def feed():
        for img in images:
            tickets.append(srv.submit(img))
            time.sleep(0.002)

    feeder = threading.Thread(target=feed)
    feeder.start()
    time.sleep(0.02)
    got = gov.throttle(new_cap)  # mid-stream: drain-and-switch epoch swap
    feeder.join(timeout=60.0)
    outs = [t.result(timeout=60.0) for t in tickets]
    srv.stop()
    assert len(outs) == len(images)  # zero dropped
    assert srv.epoch == 1 and srv.plan == pplan1.plan
    assert got.feasible and got.avg_power_w <= new_cap * (1 + 1e-9)
    assert gov.stage_freqs == pplan1.stage_freqs
    per_plan = []
    for pp in (pplan0, pplan1):
        eng = PipelinedGraphEngine(g, params, pp.plan, backend=ROUTE, device="cpu")
        eng.warmup(images[0])
        per_plan.append(eng.run(images)["outputs"])
    for i, o in enumerate(outs):
        assert any(torch.equal(o, r[i]) for r in per_plan), f"image {i}"
    _assert_outputs(refs, outs)


def test_governor_throttle_unthrottles_on_cap_raise():
    T = _matrix(_net(10))
    envelope = PLAT.max_power_w()
    low = power_aware_search(10, PLAT, T, mode="best", power_cap_w=0.35 * envelope)
    ctrl = AdaptiveController(prior=T, plan=low.plan, platform=PLAT, power_cap_w=0.35 * envelope)
    gov = DvfsGovernor(PLAT, ctrl)
    restored = gov.throttle(1.05 * envelope)  # thermal headroom returns
    uncapped = pipe_it_search(10, PLAT, T, mode="best")
    assert restored.throughput >= 0.90 * uncapped.throughput(T)


def test_governor_requires_power_aware_controller():
    T = _matrix(_net(6))
    plan = pipe_it_search(6, PLAT, T, mode="best")
    ctrl = AdaptiveController(prior=T, plan=plan, platform=PLAT)
    with pytest.raises(ValueError):
        DvfsGovernor(PLAT, ctrl)


@pytest.mark.slow
def test_serve_adaptive_end_to_end(tiny):
    """Fully threaded serve(adaptive=True): the background monitor alone
    detects a mid-stream 2x drift and hot-swaps, with no drops."""
    g, params, images, refs, T, plan0 = tiny
    truth = DriftingMatrix(T)
    server = serve(
        g, params=params, platform=PLAT, time_matrix=T, batch_size=1,
        flush_timeout_s=0.0, queue_depth=4, device="cpu", backend=ROUTE,
        stage_fn_builder=delayed_stage_fn_builder(truth, scale=100.0, backend=ROUTE),
        adaptive=True,
        adaptive_config=AdaptiveConfig(alpha=0.5, threshold=0.3, patience=1,
                                       min_gain=1.02, interval_s=0.1, min_items=4),
    )
    try:
        server.run(images)  # settle + give the monitor a calibration window
        time.sleep(0.3)
        truth.scale("B", 2.0)
        swaps0 = server.monitor.controller.swaps
        deadline = time.perf_counter() + 30.0
        while server.monitor.controller.swaps == swaps0 and time.perf_counter() < deadline:
            server.run(images)
        assert server.monitor.controller.swaps > swaps0
        outs = server.run(images)["outputs"]  # post-swap correctness
        _assert_outputs(refs, outs)
    finally:
        server.stop()


# ------------------------------------------- queue-aware control plane
def test_queue_controller_admission_and_counters():
    ctrl = QueueController(QueuePolicy(slo_p99_s=0.1, shed_headroom=0.9),
                           base_latency_s=0.04, service_s=0.01)
    assert ctrl.should_admit(0.04)
    assert not ctrl.should_admit(0.06)
    assert ctrl.should_admit(0.05)
    assert (ctrl.admitted, ctrl.shed) == (2, 1)
    cb = ctrl.admit_callback()
    assert cb(123.0, 0.0) and not cb(456.0, 1.0)
    assert (ctrl.admitted, ctrl.shed) == (3, 2)


def test_queue_controller_rate_ewma_and_utilization():
    ctrl = QueueController(QueuePolicy(slo_p99_s=1.0, rate_alpha=0.5),
                           base_latency_s=0.1, service_s=0.01)
    assert ctrl.utilization == 0.0
    for k in range(1, 11):
        ctrl.observe_arrival(k * 0.02)  # steady 50/s
    assert ctrl.rate_hat == pytest.approx(50.0, rel=0.05)
    assert ctrl.utilization == pytest.approx(0.5, rel=0.05)


def test_queue_controller_flush_timeout_clamps():
    pol = QueuePolicy(slo_p99_s=0.1, min_flush_s=0.001, max_flush_s=0.02, flush_fraction=0.1)
    ctrl = QueueController(pol, base_latency_s=0.04, service_s=0.01)
    assert ctrl.flush_timeout() == pytest.approx(0.006)
    for k in range(1, 30):
        ctrl.observe_arrival(k * 0.005)  # 200/s against 100/s capacity
    assert ctrl.utilization >= 1.0
    assert ctrl.flush_timeout() == pol.max_flush_s
    tight = QueueController(QueuePolicy(slo_p99_s=0.05, min_flush_s=0.001),
                            base_latency_s=0.049, service_s=0.001)
    assert tight.flush_timeout() == 0.001


def test_queue_controller_batch_recommendation():
    ctrl = QueueController(QueuePolicy(slo_p99_s=1.0), base_latency_s=0.1, service_s=0.01)
    assert ctrl.recommended_batch(4) == 2  # idle: halve
    for k in range(1, 30):
        ctrl.observe_arrival(k * 0.0125)  # 80/s -> utilization 0.8
    assert ctrl.recommended_batch(4) == 8  # pressed: double
    assert ctrl.recommended_batch(8, max_batch=8) == 8
    with pytest.raises(ValueError):
        QueueController(QueuePolicy(slo_p99_s=1.0), base_latency_s=0.1, service_s=0.0)


def test_controller_set_load_is_frequency_only_and_slo_safe():
    T = _gt_tiny()
    n = len(T)
    plan = pipe_it_search(n, PLAT, T, mode="best")
    cap = plan.throughput(T)
    slo_s = 0.004
    ctrl = AdaptiveController(prior=T, plan=plan, platform=PLAT, objective="min_energy",
                              slo_p99_s=slo_s, arrival_rate=0.1 * cap)
    calm_pplan = ctrl.power_plan
    burst = 0.45 * cap
    pplan = ctrl.set_load(burst)
    assert pplan.plan == plan  # frequency-only: no drain, no re-split
    assert pplan.feasible and pplan.p99_s <= slo_s
    calm_at_burst = evaluate_frequencies(plan, T, PLAT, calm_pplan.stage_freqs,
                                         slo_p99_s=slo_s, arrival_rate=burst)
    assert calm_at_burst.p99_s is None or calm_at_burst.p99_s > slo_s
    with pytest.raises(ValueError):
        ctrl.set_load(0.0)
    with pytest.raises(ValueError):
        AdaptiveController(prior=T, plan=plan, platform=PLAT).set_load(1.0)


def test_slo_governor_never_downclocks_into_violation():
    """MMPP burst/calm: every window's simulated p99 stays under the SLO
    with the SLO-aware governor, while min-energy clocking without the
    SLO violates it in bursts; deterministic."""
    T = _gt_tiny()
    n = len(T)
    plan = pipe_it_search(n, PLAT, T, mode="best")
    cap = plan.throughput(T)
    slo_s, window_s = 0.004, 1.0
    trace = _mmpp_as_the_reference(0.1 * cap, 0.45 * cap, duration_s=60.0,
                                   calm_s=5.0, burst_s=3.0, seed=5)

    def slo_run():
        ctrl = AdaptiveController(prior=T, plan=plan, platform=PLAT, objective="min_energy",
                                  slo_p99_s=slo_s, arrival_rate=0.1 * cap)
        gov = DvfsGovernor(PLAT, ctrl, server=None)
        worst = PLAT.freq_scale("B", PLAT.freq_levels("B")[0])
        admission = QueueController(
            QueuePolicy(slo_p99_s=slo_s, shed_headroom=0.9),
            base_latency_s=predict_latency(plan, T, PLAT, 1e-9).base_latency_s * worst,
            service_s=worst / cap,
        )
        return run_slo_governed_loop(gov, OpenLoopServing(T, PLAT), trace,
                                     window_s=window_s, admission=admission)

    recs = slo_run()
    active = [r for r in recs if r["n_arrivals"]]
    assert max(r["p99_s"] for r in active) <= slo_s
    assert sum(r["shed"] for r in recs) <= 0.01 * trace.n
    assert len({tuple(r["freqs_ghz"]) for r in active}) > 1
    assert recs == slo_run()  # deterministic

    ctrl_u = AdaptiveController(prior=T, plan=plan, platform=PLAT,
                                objective="min_energy", power_cap_w=100.0)
    gov_u = DvfsGovernor(PLAT, ctrl_u, server=None)
    env_u = OpenLoopServing(T, PLAT)
    unc = []
    for w in range(int(trace.duration_s / window_s) + 1):
        arrivals = trace.window(w * window_s, (w + 1) * window_s)
        r = env_u.window(plan, arrivals, window_s=window_s, stage_freqs=gov_u.stage_freqs)
        if arrivals:
            unc.append(r.latency_p99_s)
    assert max(unc) > 2.0 * slo_s


def test_cap_throttle_during_burst_no_dropped_tickets():
    """A cap drop mid-burst re-plans without losing a queued ticket."""
    T = _gt_tiny()
    n = len(T)
    envelope = PLAT.max_power_w()
    pplan = power_aware_search(n, PLAT, T, mode="best", power_cap_w=envelope)
    ctrl = AdaptiveController(prior=T, plan=pplan.plan, platform=PLAT, power_cap_w=envelope)
    gov = DvfsGovernor(PLAT, ctrl, server=None)
    env = OpenLoopServing(T, PLAT)
    cap = pplan.plan.throughput(T)
    trace = _mmpp_as_the_reference(0.1 * cap, 0.5 * cap, duration_s=30.0,
                                   calm_s=4.0, burst_s=6.0, seed=3)
    window_s = 1.0
    new_cap = 0.40 * envelope
    done = shed = 0
    throttled_at = None
    for w in range(int(trace.duration_s / window_s) + 1):
        t0 = w * window_s
        arrivals = trace.window(t0, t0 + window_s)
        if throttled_at is None and any(
            s <= t0 < e and r > 0.2 * cap for s, e, r in trace.meta["phases"]
        ):
            assert gov.power_plan.avg_power_w > new_cap
            gov.throttle(new_cap)
            throttled_at = t0
        res = env.window(ctrl.plan, arrivals, window_s=window_s, stage_freqs=gov.stage_freqs)
        done += len(res.finish_times)
        shed += res.shed
    assert throttled_at is not None
    assert gov.throttle_events == 1
    assert ctrl.power_cap_w == new_cap
    assert gov.power_plan.feasible
    assert shed == 0
    assert done == trace.n
    assert gov.power_plan.avg_power_w <= new_cap * 1.001
