"""The port's power path at the serving level, and its plans with clocks.

The serving-level cases of tests/test_power.py on ``repro_torch``: a
``min_throughput`` alone arms the power path, a cap on a platform that
models no power is refused, and the min-energy adaptive gain is
sign-safe.  Beside them: ``serve(power_cap_w=...)`` plans and clocks
equal to the reference's ``serve`` on the same graph and matrix; a plan
with clocks that either package's ``PlanStore`` writes loads in the
other; a throttle's new plan is persisted with its own clocks; and a
resumed adaptive or power-aware server measures its prior as a cold one
does.  The planning code is pure Python in both packages, so plans,
clocks and gains are compared with ``==``.  The clocks and watts are
``hikey970()``'s modeled ones; nothing here reads or sets a clock of the
host.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.serving as ref_serving
from repro.cnn.graph import Graph as RefGraph
import repro_torch.serving.planner as planner_mod
from repro_torch.cnn.graph import Graph
from repro_torch.cnn.params import params_from_numpy
from repro_torch.core import (
    LayerTimePredictor,
    assign_frequencies,
    hikey970,
    partition_search,
    pipe_it_search,
    power_aware_search,
)
from repro_torch.core.calibration import synthetic_model
from repro_torch.core.descriptors import conv_descriptor
from repro_torch.core.plan import Plan
from repro_torch.kernels.autotune import ConvAutotuner, descriptor_key
from repro_torch.serving import (
    AdaptiveController,
    PlanStore,
    SimulatedServing,
    host_platform,
    run_adaptive_loop,
    serve,
)

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

ROUTE = "cuda_fused"
PLAT = hikey970()
REF_PLAT = ref_core.hikey970()


def _net(n=10, conv=conv_descriptor):
    return [conv(f"c{i}", 56, 64, 3, 64) for i in range(n)]


def _matrix(descs, plat=PLAT):
    return LayerTimePredictor(model=synthetic_model(), platform=plat).time_matrix(descs)


def tiny_graph(G=Graph, name="tinyP", ch=8):
    """``benchmarks/common.py::tiny_graph``, built in either package."""
    g = G(name, (16, 16, 3))
    a = g.conv("c1", "input", ch, 3)
    a = g.conv("c2", a, ch, 3, stride=2)
    a = g.conv("c3", a, 2 * ch, 1)
    a = g.pool_max("p1", a, 2, 2)
    a = g.conv("c4", a, 2 * ch, 3)
    a = g.gap("gap", a)
    a = g.fc("fc", a, 10)
    g.softmax("sm", a)
    return g


@pytest.fixture(scope="module")
def tiny():
    ref_g = tiny_graph(RefGraph)
    ref_params = ref_g.init(jax.random.PRNGKey(0))
    params = params_from_numpy(
        {n: {k: np.asarray(v) for k, v in p.items()} for n, p in ref_params.items()},
        device="cpu",
    )
    g = tiny_graph()
    T = _matrix(g.descriptors())
    return g, params, ref_g, ref_params, T


def _serve(g, params, T, **kw):
    return serve(g, params=params, platform=PLAT, time_matrix=T, batch_size=1,
                 backend=ROUTE, device="cpu", **kw)


def test_serve_min_throughput_alone_arms_power_path(tiny):
    """serve(min_throughput=...) without a cap arms the DVFS path: a
    governor whose plan meets the floor, at bookkeeping clocks."""
    g, params, _, _, T = tiny
    peak = pipe_it_search(len(T), PLAT, T, mode="best").throughput(T)
    server = _serve(g, params, T, min_throughput=0.5 * peak)
    try:
        assert server.governor is not None
        pp = server.governor.power_plan
        assert pp is not None and pp.feasible
        assert pp.throughput >= 0.5 * peak * (1 - 1e-9)
        assert not server.governor.physical_clocks
        assert server.monitor is not None and server.monitor._thread is None
        assert server.plan == pp.plan
    finally:
        server.stop()


@pytest.mark.parametrize(
    "kwargs",
    [dict(power_cap_w=0.5 * 6.6), dict(power_objective="throughput_per_watt"),
     dict(min_throughput=1.0)],
    ids=lambda kw: next(iter(kw)),
)
def test_serve_power_path_is_the_references(tiny, kwargs):
    """The same graph, matrix and power options through both packages'
    serve(): the same plan, clocks and modeled figures on the governor."""
    g, params, ref_g, ref_params, T = tiny
    server = _serve(g, params, T, **kwargs)
    try:
        got = server.governor.snapshot()
        got_plan = server.plan.notation()
    finally:
        server.stop()
    ref = ref_serving.serve(ref_g, params=ref_params, platform=REF_PLAT, time_matrix=T,
                            batch_size=1, **kwargs)
    try:
        want = ref.governor.snapshot()
        want_plan = ref.plan.notation()
    finally:
        ref.stop()
    assert (got, got_plan) == (want, want_plan)


def test_cap_on_powerless_platform_is_rejected_not_vacuous(tiny):
    """A cap against a platform that models zero power would be met
    trivially; the DSE and serve() refuse it (host_platform models none)."""
    plat = hikey970(dvfs=False)
    T = _matrix(_net(6), plat)
    plan = pipe_it_search(6, plat, T, mode="best")
    with pytest.raises(ValueError, match="models no power"):
        power_aware_search(6, plat, T, mode="best", power_cap_w=3.0)
    with pytest.raises(ValueError, match="models no power"):
        assign_frequencies(plan, T, plat, power_cap_w=3.0)
    with pytest.raises(ValueError, match="models no power"):
        partition_search({"a": T}, plat, power_cap_w=3.0)
    g, params, _, _, _ = tiny
    with pytest.raises(ValueError, match="models no power"):
        serve(g, params=params, platform=host_platform(2), batch_size=1,
              backend=ROUTE, device="cpu", power_cap_w=3.0)


def test_min_energy_adaptive_gain_is_sign_safe():
    """Under "min_energy" the objective is negative; the swap gate still
    reads gains as ratios near 1, identically in both packages."""
    histories = []
    for core, serving, conv, plat in (
        (None, None, conv_descriptor, PLAT),
        (ref_core, ref_serving, ref_core.conv_descriptor, REF_PLAT),
    ):
        descs = _net(12, conv)
        if core is None:
            T = _matrix(descs)
            plan0 = pipe_it_search(12, plat, T, mode="best")
            Ctrl, Env, loop = AdaptiveController, SimulatedServing, run_adaptive_loop
        else:
            from repro.core.calibration import synthetic_model as ref_synthetic_model

            T = core.LayerTimePredictor(model=ref_synthetic_model(), platform=plat).time_matrix(descs)
            plan0 = core.pipe_it_search(12, plat, T, mode="best")
            Ctrl, Env, loop = serving.AdaptiveController, serving.SimulatedServing, serving.run_adaptive_loop
        ctrl = Ctrl(prior=T, plan=plan0, platform=plat, objective="min_energy",
                    min_throughput=0.4 * plan0.throughput(T))
        env = Env(T, plat)
        env.inject_drift("B", 2.0)  # the energy-optimal allocation moves
        loop(ctrl, env, rounds=8)
        assert ctrl.history  # the detector fired and a re-plan was evaluated
        gains = [e.predicted_gain for e in ctrl.history]
        assert all(0.0 < g < 1e3 for g in gains)
        assert ctrl.power_plan is not None and ctrl.power_plan.objective < 0.0
        histories.append((gains, [e.new_plan.notation() for e in ctrl.history],
                          ctrl.power_plan.stage_freqs))
    assert histories[0] == histories[1]


def test_plan_with_clocks_round_trips_across_packages(tmp_path):
    """A power-aware plan saved with its clocks by either package's
    PlanStore loads, clocks and all, in the other."""
    T = _matrix(_net(8))
    pplan = power_aware_search(8, PLAT, T, mode="best", power_cap_w=3.0)
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    PlanStore(port_path).save_plan(pplan.plan, epoch=3, stage_freqs=pplan.stage_freqs)
    ref_serving.PlanStore(str(ref_path)).save_plan(
        ref_core.Plan.from_dict(Plan.from_legacy(pplan.plan).to_dict()),
        epoch=3, stage_freqs=pplan.stage_freqs,
    )
    for path in (port_path, ref_path):
        got = PlanStore(path).load_plan()
        ref_got = ref_serving.PlanStore(str(path)).load_plan()
        assert got.stage_freqs == tuple(pplan.stage_freqs) == ref_got.stage_freqs
        assert got.as_pipeline_plan() == pplan.plan
        assert got.to_dict() == ref_got.to_dict()
        assert PlanStore(path).load()["epoch"] == 3


def test_throttle_persists_the_new_plan_with_its_clocks(tiny, tmp_path):
    """serve(power_cap_w=, plan_store=) persists the startup plan with the
    governor's clocks; a throttle that changes the stages persists the new
    plan with the new clocks (the swap saves before the governor applies
    them, so the store takes the controller's)."""
    g, params, _, _, T = tiny
    n = len(T)
    envelope = PLAT.max_power_w()
    cap0, cap1 = 1.05 * envelope, 0.5 * envelope
    p0 = power_aware_search(n, PLAT, T, mode="best", power_cap_w=cap0)
    p1 = power_aware_search(n, PLAT, T, mode="best", power_cap_w=cap1)
    assert p1.plan.pipeline.p != p0.plan.pipeline.p  # the throttle changes the stages
    path = tmp_path / "lkg.json"
    server = _serve(g, params, T, power_cap_w=cap0, plan_store=path)
    try:
        saved = PlanStore(path).load_plan()
        assert saved.as_pipeline_plan() == p0.plan and saved.stage_freqs == p0.stage_freqs
        server.governor.throttle(cap1)
        assert server.epoch == 1 and server.plan == p1.plan
        assert server.governor.stage_freqs == p1.stage_freqs
        saved = PlanStore(path).load_plan()
        assert saved.as_pipeline_plan() == p1.plan and saved.stage_freqs == p1.stage_freqs
        assert PlanStore(path).load()["epoch"] == 1
    finally:
        server.stop()


@pytest.mark.parametrize("options", [dict(adaptive=True), dict(power_cap_w=3.0), {}],
                         ids=["adaptive", "power_cap_w", "static"])
def test_resumed_server_measures_its_prior_as_a_cold_one(tiny, tmp_path, monkeypatch, options):
    """With the adaptive loop or the power path on, serve(resume_from=)
    measures the routes the time matrix is made from, so a resumed
    server's prior is a cold one's; a resumed static server measures
    nothing.  The measurements are faked (fixed seconds per layer), and
    the resumed server gets a tuner on an empty cache."""
    g, params, _, _, _ = tiny
    fake = {descriptor_key(d): 1e-3 * (i + 1) for i, d in enumerate(g.descriptors())}
    calls = []

    def measure(graph, kb, tuner):
        calls.append(graph.name)
        return dict(fake)

    monkeypatch.setattr(planner_mod, "measure_graph_routes", measure)
    path = tmp_path / "lkg.json"

    def start(cache, **kw):
        tuner = ConvAutotuner(cache_path=str(tmp_path / cache), device="cpu")
        return serve(g, params=params, platform=PLAT, batch_size=1, backend=ROUTE,
                     device="cpu", tuner=tuner, adaptive_config=None, **options, **kw)

    cold = start("cold.json", plan_store=path)
    try:
        cold_prior = cold.monitor.controller.calibrator.prior if cold.monitor else None
    finally:
        cold.stop()
    assert calls == [g.name]
    resumed = start("resumed.json", resume_from=path)
    try:
        assert resumed.plan == cold.plan
        if options:
            assert calls == [g.name] * 2
            assert resumed.monitor.controller.calibrator.prior == cold_prior
            assert cold_prior == LayerTimePredictor(
                model=synthetic_model(), platform=PLAT, measured=fake
            ).time_matrix(g.descriptors())
        else:
            assert calls == [g.name] and resumed.monitor is None
    finally:
        resumed.stop()
