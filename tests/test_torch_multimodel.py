"""The port's multi-model co-serving: registry, two-level partition,
router and admission, partition hot swap, the global re-partition loop
and the time-sliced baseline.

Every test of tests/test_multimodel.py, the partition tests of
tests/test_faults.py, the concurrency stress test of tests/test_serving.py
and the interrupt tests of tests/test_serving_bugfixes.py, on the port's
``repro_torch.serving`` at the reference's tiny graphs (16x16 inputs),
plus parity tests that feed the same seeded inputs to both packages.  The
DSE, the partition search and the controller are pure Python in both, so
their results must be IDENTICAL: the same shares, inner plans, objective,
``PartitionEvent`` sequence, compared with ``==``.

Live servers run on the CPU (``device="cpu"``).  At micro-batch 1 their
outputs must be bitwise equal to the port's single-stage engine (on the
CPU the library convs pick other blockings at other batch sizes, so only
equal shapes are bitwise comparable) and within ``rtol=1e-4, atol=1e-5``
of the reference's, the reference's bar (tests/test_multimodel.py);
served at micro-batch 2 they are held to that bar against the port's
single-stage engine, as the reference holds its own.  Every live test
feeds through ``run()``, which throttles, or sizes its admission bounds
so that nothing sheds under load.
"""
from __future__ import annotations

import json
import logging
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as ref_serving
from repro.cnn.graph import Graph as RefGraph
from repro.cnn.models import MODELS as REF_MODELS
from repro.core import hikey970 as ref_hikey970
from repro.core import partition_search as ref_partition_search
from repro_torch.cnn.graph import Graph
from repro_torch.cnn.models import MODELS
from repro_torch.cnn.params import params_from_numpy
from repro_torch.core import (
    CoreType,
    HeteroPlatform,
    enumerate_shares,
    hikey970,
    partition_objective,
    partition_search,
)
from repro_torch.core.calibration import scale_core_type
from repro_torch.kernels.autotune import ConvAutotuner, descriptor_key
from repro_torch.serving import (
    AdaptiveConfig,
    AdmissionError,
    AutoPlanner,
    Backpressure,
    FaultEvent,
    FaultPlan,
    ModelEntry,
    ModelRegistry,
    MultiModelServer,
    PartitionController,
    PipelinedGraphEngine,
    PlanStore,
    RecoveryPolicy,
    SingleStageEngine,
    StageObservation,
    TimeSlicedEngine,
    attach_partition_adaptive,
    build_stage_fns,
    fault_injecting_builder,
    host_platform,
    serve,
)

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
PLAT = hikey970()
POLICY = RecoveryPolicy(
    max_retries=2, backoff_base_s=0.001, backoff_factor=2.0,
    heartbeat_deadline_s=0.2, restart_delay_s=0.0,
)


def tiny(name: str, ch: int = 8, G=Graph) -> Graph:
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


def _numpy_params(ref_params):
    return {n: {k: np.asarray(v) for k, v in p.items()} for n, p in ref_params.items()}


def _images(seed: int, n: int = 8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def duo():
    """Two tiny models (the reference's weights carried across), a
    shared image set, and the reference's own registry of the same."""
    ref_reg = ref_serving.ModelRegistry()
    ref_reg.add("a", tiny("a", 8, RefGraph), weight=2.0)
    ref_reg.add("b", tiny("b", 12, RefGraph))
    reg = ModelRegistry.coerce({
        e.name: ModelEntry(
            name=e.name, graph=tiny(e.name, 8 if e.name == "a" else 12),
            params=params_from_numpy(_numpy_params(e.params), "cpu"), weight=e.weight,
        )
        for e in ref_reg
    })
    return reg, _images(0), ref_reg


def _single_outputs(reg, name, images):
    eng = SingleStageEngine(reg[name].graph, reg[name].params, device="cpu")
    eng.warmup(images[0])
    return eng.run(images)["outputs"]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------- share enumeration
def test_enumerate_shares_disjoint_and_complete():
    shares = enumerate_shares(PLAT, 2)
    assert len(shares) == 23  # 5*5 compositions minus the two empty-share ones
    for assignment in shares:
        totals = {"B": 0, "s": 0}
        for share in assignment:
            assert sum(n for _, n in share) >= 1  # every model gets a core
            for ct, n in share:
                totals[ct] += n
        assert totals == {"B": 4, "s": 4}  # disjoint and complete


def test_enumerate_shares_rejects_impossible():
    with pytest.raises(ValueError):
        enumerate_shares(PLAT, 9)  # more models than cores
    with pytest.raises(ValueError):
        enumerate_shares(PLAT, 0)


# ------------------------------------------------------------------ objective
def test_partition_objective_weights_and_slos():
    assert partition_objective([2.0, 3.0]) == pytest.approx(5.0)
    assert partition_objective([2.0, 3.0], [10.0, 1.0]) == pytest.approx(23.0)
    feasible = partition_objective([2.0, 3.0], None, [1.0, 1.0])
    infeasible = partition_objective([2.0, 0.5], None, [1.0, 1.0])
    assert feasible == pytest.approx(5.0)  # met SLOs cost nothing
    assert infeasible < 0 < feasible  # any feasible outranks any infeasible
    closer = partition_objective([2.0, 0.9], None, [1.0, 1.0])
    assert infeasible < closer < feasible
    assert partition_objective([2.0, 3.0], fairness="max-min") == pytest.approx(2.0)
    assert partition_objective(
        [2.0, 3.0], [10.0, 1.0], fairness="max-min"
    ) == pytest.approx(3.0)
    with pytest.raises(ValueError):
        partition_objective([1.0], fairness="nope")


def test_search_ranks_feasible_above_huge_infeasible():
    """Feasibility is lexicographic in the search, not a finite penalty."""
    plat = HeteroPlatform("b3", (CoreType("B", 3, 1.0),))
    instances = {
        "fast": [{("B", 1): 2e-12, ("B", 2): 1e-12, ("B", 3): 1e-12}],
        "slo": [{("B", 1): 1.0, ("B", 2): 0.5, ("B", 3): 0.5}],
    }
    part = partition_search(instances, plat, slo_rates={"slo": 1.5})
    assert part.feasible
    assert part["slo"].throughput >= 1.5
    assert part["fast"].share.total_cores() == 1  # paid for feasibility


def test_partition_search_maxmin_balances_capacity(duo):
    reg, _, _ = duo
    Ts = AutoPlanner(platform=PLAT, mode="best").time_matrices(reg.graphs())
    psum = partition_search(Ts, PLAT)
    pmin = partition_search(Ts, PLAT, fairness="max-min")
    assert min(pmin.throughputs().values()) >= min(psum.throughputs().values())


# ----------------------------------------------------- partition integration
def test_partition_search_returns_valid_disjoint_plans(duo):
    reg, _, _ = duo
    part = AutoPlanner(platform=PLAT, mode="best").partition(reg.graphs(), weights=reg.weights())
    assert part.names == ["a", "b"]
    totals = {"B": 0, "s": 0}
    for mp in part.assignments:
        n_layers = len(reg[mp.name].graph.descriptors())
        flat = [l for stage in mp.plan.allocation for l in stage]
        assert flat == list(range(n_layers))  # inner plan partitions layers
        mp.plan.pipeline.validate_against(mp.share)  # and fits its share
        for ct in mp.share.core_types:
            totals[ct.name] += ct.count
        assert mp.throughput > 0
    assert totals == {"B": 4, "s": 4}
    assert part.objective == pytest.approx(
        partition_objective([part["a"].throughput, part["b"].throughput], [2.0, 1.0])
    )


def test_partition_search_slo_floor_shifts_capacity(duo):
    reg, _, _ = duo
    Ts = AutoPlanner(platform=PLAT, mode="best").time_matrices(reg.graphs())
    free = partition_search(Ts, PLAT)
    alone = partition_search({"b": Ts["b"]}, PLAT)
    slo = (free["b"].throughput + alone["b"].throughput) / 2
    bound = partition_search(Ts, PLAT, slo_rates={"b": slo})
    assert free["b"].throughput < slo  # the SLO really binds
    assert bound.feasible
    assert bound["b"].throughput >= slo
    assert bound["a"].throughput <= free["a"].throughput  # paid by "a"


def test_partition_search_rejects_unknown_weight_slo_names(duo):
    reg, _, _ = duo
    Ts = AutoPlanner(platform=PLAT, mode="best").time_matrices(reg.graphs())
    with pytest.raises(ValueError):
        partition_search(Ts, PLAT, slo_rates={"a-typo": 1.0})
    with pytest.raises(ValueError):
        partition_search(Ts, PLAT, weights={"nope": 2.0})


@pytest.mark.parametrize("plat", ["hikey970", "host4"])
@pytest.mark.parametrize("fairness", ["sum", "max-min"])
def test_partition_matches_reference(duo, plat, fairness):
    """The same two-level plan from both packages' ``AutoPlanner.partition``:
    shares, inner plans, throughputs and objective, compared with ``==``."""
    reg, _, ref_reg = duo
    platform, ref_platform = (
        (hikey970(), ref_hikey970()) if plat == "hikey970"
        else (host_platform(4), ref_serving.host_platform(4))
    )
    got = AutoPlanner(platform=platform).partition(
        reg.graphs(), weights=reg.weights(), fairness=fairness)
    want = ref_serving.AutoPlanner(platform=ref_platform).partition(
        ref_reg.graphs(), weights=ref_reg.weights(), fairness=fairness)
    assert got.notation() == want.notation() and got.names == want.names
    for n in want.names:
        assert got[n].plan.allocation == want[n].plan.allocation
        assert got[n].plan.pipeline.stages == want[n].plan.pipeline.stages
        assert [(c.name, c.count) for c in got[n].share.core_types] == [
            (c.name, c.count) for c in want[n].share.core_types]
    assert got.throughputs() == want.throughputs()
    assert got.objective == want.objective and got.feasible == want.feasible


def test_vgg16_and_mobilenet_partition_matches_reference_on_host4():
    """The pair the card co-serves, planned on ``host_platform(4)`` from
    the synthetic model by both packages (graphs only, no weights)."""
    graphs = {n: MODELS[n]() for n in ("vgg16", "mobilenet")}
    ref_graphs = {n: REF_MODELS[n]() for n in ("vgg16", "mobilenet")}
    got = AutoPlanner(platform=host_platform(4)).partition(graphs)
    want = ref_serving.AutoPlanner(platform=ref_serving.host_platform(4)).partition(ref_graphs)
    assert got.notation() == want.notation()
    assert got.throughputs() == want.throughputs() and got.objective == want.objective


# ------------------------------------------------------------------- registry
def test_registry_coerce_forms():
    g = tiny("x")
    params = g.init(seed=1, device="cpu")
    reg = ModelRegistry.coerce(
        {
            "zoo": "squeezenet",  # zoo name
            "graph": g,  # bare graph (params auto-init)
            "entry": ModelEntry(name="entry", graph=g, params=params, weight=3.0),
            "kwargs": {"graph": g, "weight": 2.0, "slo_rate": 1.5},
        },
        device="cpu",
    )
    assert reg.names == ["zoo", "graph", "entry", "kwargs"]
    assert reg["zoo"].graph.name == "squeezenet"
    assert reg["graph"].params is not None
    assert reg["graph"].params["c1"]["w"].device == torch.device("cpu")
    assert reg["entry"].weight == 3.0 and reg["entry"].params is params
    assert reg.slo_rates()["kwargs"] == 1.5
    assert ModelRegistry.coerce(reg) is reg  # idempotent


def test_registry_rejects_bad_entries():
    reg = ModelRegistry()
    reg.add("a", tiny("a"), device="cpu")
    with pytest.raises(ValueError):
        reg.add("a", tiny("a2"), device="cpu")  # duplicate name
    with pytest.raises(KeyError):
        reg.add("nope-not-a-zoo-model", device="cpu")
    with pytest.raises(ValueError):
        reg.add("w", tiny("w"), weight=0.0, device="cpu")


def test_registry_makes_params_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the no-CUDA refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelRegistry().add("a", tiny("a"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve({"a": tiny("a"), "b": tiny("b", 12)})


# ------------------------------------------------------------- serving router
def test_multimodel_server_isolates_and_matches_baselines(duo):
    reg, images, _ = duo
    planner = AutoPlanner(platform=PLAT, mode="best", device="cpu")
    with planner.build_multi(reg, batch_size=2, flush_timeout_s=0.005) as mm:
        res = mm.run({"a": images, "b": images}, timeout=120.0)
    for name in ("a", "b"):
        for x, y in zip(_single_outputs(reg, name, images), res["outputs"][name]):
            _close(x, y)
    m = res["metrics"]
    assert m["completed"] == 2 * len(images)
    assert m["models"]["a"]["completed"] == len(images)
    assert m["models"]["b"]["completed"] == len(images)
    assert m["router"]["a"]["admitted"] == len(images)
    assert m["router"]["a"]["rejected"] == 0
    assert m["aggregate_throughput_img_s"] > 0


def test_coserved_outputs_match_reference_single_stage(duo):
    """Batch 1, the reference's weights: bitwise equal to the port's
    single-stage engine, within the reference's bar of its single-stage
    engine."""
    reg, images, ref_reg = duo
    mm = serve(reg, device="cpu", backend="cuda_fused", batch_size=1, flush_timeout_s=0.0)
    try:
        res = mm.run({"a": images, "b": images}, timeout=120.0)
    finally:
        mm.stop()
    for name in ("a", "b"):
        eng = SingleStageEngine(reg[name].graph, reg[name].params, backend="cuda_fused", device="cpu")
        for x, y in zip(eng.run(images)["outputs"], res["outputs"][name]):
            assert torch.equal(x, y)
        ref = ref_serving.SingleStageEngine(ref_reg[name].graph, ref_reg[name].params)
        want = ref.run([jnp.asarray(i) for i in images])["outputs"]
        for x, y in zip(want, res["outputs"][name]):
            _close(x, y.numpy())


def test_router_unknown_model_and_admission_bound(duo):
    reg, images, _ = duo
    planner = AutoPlanner(platform=PLAT, mode="best", device="cpu")
    mm = planner.build_multi(reg, batch_size=1, max_inflight=2, warmup=False)
    try:
        with pytest.raises(KeyError):
            mm.submit("nope", images[0])
        srv = mm.server("a")
        srv._started = True  # freeze: no workers consume the ingress
        mm.submit("a", images[0], block=False)
        mm.submit("a", images[1], block=False)
        with pytest.raises(AdmissionError):
            mm.submit("a", images[2], block=False)
        assert mm.router.rejected("a") == 1
        assert mm.router.admitted("a") == 2
        # "b" is unaffected by "a" hitting its bound (isolation)
        t = mm.submit("b", images[0])
        assert t.result(timeout=60.0) is not None
        srv._spawn_workers()  # let "a"'s queued images drain for shutdown
    finally:
        mm.stop()


def test_max_inflight_validation(duo):
    reg, _, _ = duo
    part = AutoPlanner(platform=PLAT, mode="best").partition(reg.graphs())
    with pytest.raises(ValueError):
        MultiModelServer(reg, part, max_inflight={"a-typo": 4}, device="cpu")
    with pytest.raises(ValueError):
        MultiModelServer(reg, part, max_inflight=0, device="cpu")
    with pytest.raises(ValueError):
        MultiModelServer(reg, part, max_inflight={"a": -1}, device="cpu")
    mm = MultiModelServer(reg, part, max_inflight={"a": 4}, device="cpu")  # "b" unbounded
    try:
        assert mm._max_inflight == {"a": 4, "b": None}
        assert all(s.device == torch.device("cpu") for s in mm.servers.values())
    finally:
        mm.stop()


def test_swap_partition_rejects_wrong_model_set(duo):
    reg, _, _ = duo
    planner = AutoPlanner(platform=PLAT, mode="best")
    part = planner.partition(reg.graphs())
    only_a = ModelRegistry()
    only_a.add("a", reg["a"].graph, reg["a"].params)
    part_a = planner.partition(only_a.graphs())
    mm = MultiModelServer(reg, part, batch_size=1, device="cpu")
    try:
        with pytest.raises(ValueError):
            mm.swap_partition(part_a)
    finally:
        mm.stop()


def test_swap_partition_mid_stream_no_drops(duo, tmp_path):
    """Batch 1: every ticket across the swap keeps its single-stage bits,
    and the store holds the new partition."""
    reg, images, _ = duo
    Ts = AutoPlanner(platform=PLAT, mode="best").time_matrices(reg.graphs())
    part1 = partition_search(Ts, PLAT, weights={"a": 5.0, "b": 1.0})
    part2 = partition_search(Ts, PLAT, weights={"a": 1.0, "b": 5.0})
    assert part1.plans() != part2.plans()  # the swap changes something
    mm = MultiModelServer(reg, part1, batch_size=1, queue_depth=4, device="cpu")
    mm.plan_store = PlanStore(tmp_path / "part.json")
    try:
        mm.start()
        tickets = []
        for i, img in enumerate(images):
            tickets.append(("a", i, mm.submit("a", img)))
            tickets.append(("b", i, mm.submit("b", img)))
            if i == 2:
                mm.swap_partition(part2)
        assert mm.partition_epoch == 1
        refs = {n: _single_outputs(reg, n, images) for n in ("a", "b")}
        for name, i, t in tickets:
            assert torch.equal(refs[name][i], t.result(timeout=60.0))
        assert mm.metrics()["completed"] == 2 * len(images)
        assert mm.plan_store.load_partition(PLAT).plans() == part2.plans()
    finally:
        mm.stop()


def test_admission_bound_strict_under_concurrent_clients(duo):
    """The in-flight bound is check-and-reserve: N racing clients must
    never exceed it."""
    reg, images, _ = duo
    part = AutoPlanner(platform=PLAT, mode="best").partition(reg.graphs())
    mm = MultiModelServer(reg, part, batch_size=1, queue_depth=8, max_inflight=2, device="cpu")
    try:
        srv = mm.server("a")
        srv._started = True  # freeze: nothing drains, admissions only grow
        admitted, rejected = [], []
        gate = threading.Event()

        def client(i):
            gate.wait(10.0)
            try:
                admitted.append(mm.submit("a", images[0], block=False))
            except AdmissionError:
                rejected.append(i)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
        assert len(admitted) == 2  # exactly the bound, never exceeded
        assert len(rejected) == 6
        assert mm.router.admitted("a") == 2 and mm.router.rejected("a") == 6
        srv._spawn_workers()  # drain for a clean stop
    finally:
        mm.stop()


def test_run_throttles_instead_of_raising_under_admission_bound(duo):
    reg, images, _ = duo
    planner = AutoPlanner(platform=PLAT, mode="best", device="cpu")
    with planner.build_multi(reg, batch_size=1, max_inflight=2) as mm:
        res = mm.run({"a": images, "b": images}, timeout=120.0)
    assert res["metrics"]["completed"] == 2 * len(images)
    for name in ("a", "b"):
        assert len(res["outputs"][name]) == len(images)


def test_run_times_out_instead_of_hanging_on_stalled_pipeline(duo):
    reg, images, _ = duo
    part = AutoPlanner(platform=PLAT, mode="best").partition(reg.graphs())
    mm = MultiModelServer(reg, part, batch_size=1, queue_depth=1, device="cpu")
    try:
        for srv in mm.servers.values():
            srv._started = True  # freeze: ingress fills and never drains
        t0 = time.perf_counter()
        with pytest.raises(Backpressure):
            mm.run({"a": images, "b": images}, timeout=1.0)
        assert time.perf_counter() - t0 < 30.0  # bounded, not hung
        for srv in mm.servers.values():
            srv._spawn_workers()  # drain the queued images for clean stop
    finally:
        mm.stop()


def test_attach_partition_adaptive_inherits_server_fairness(duo):
    reg, _, _ = duo
    planner = AutoPlanner(platform=PLAT, mode="best", device="cpu")
    priors = planner.time_matrices(reg.graphs())
    mm = planner.build_multi(reg, batch_size=1, warmup=False, fairness="max-min")
    try:
        monitor = attach_partition_adaptive(mm, priors, PLAT, start=False)
        assert monitor.controller.fairness == "max-min"
        override = attach_partition_adaptive(mm, priors, PLAT, fairness="sum", start=False)
        assert override.controller.fairness == "sum"
    finally:
        mm.stop()


# --------------------------------------------------- global re-partitioning
def _observations_for(partition, truths, Obs=StageObservation):
    """What a monitor window would report if ``truths`` were the board."""
    out = {}
    for mp in partition.assignments:
        times = mp.plan.stage_times(truths[mp.name])
        out[mp.name] = [
            Obs(stage=stage, layers=tuple(layers), service_s=t, items=16)
            for stage, layers, t in zip(mp.plan.pipeline.stages, mp.plan.allocation, times)
        ]
    return out


def test_partition_controller_global_repartition_on_one_models_drift(duo):
    reg, _, _ = duo
    priors = AutoPlanner(platform=PLAT, mode="best").time_matrices(reg.graphs())
    part = partition_search(priors, PLAT)
    ctrl = PartitionController(
        priors, part, PLAT,
        config=AdaptiveConfig(threshold=0.25, patience=2, min_gain=1.02),
    )
    truths = {n: [dict(r) for r in priors[n]] for n in priors}
    for _ in range(3):
        assert ctrl.step(_observations_for(ctrl.partition, truths)) is None
    assert ctrl.swaps == 0
    truths["a"] = scale_core_type(scale_core_type(truths["a"], "B", 3.0), "s", 3.0)
    new = None
    for _ in range(6):
        new = ctrl.step(_observations_for(ctrl.partition, truths)) or new
    assert new is not None and ctrl.swaps >= 1
    ev = next(e for e in ctrl.history if e.swapped)
    assert "a" in ev.triggered_by
    old_tps = [ev.old_partition[n].plan.throughput(truths[n]) for n in ("a", "b")]
    new_tps = [ev.new_partition[n].plan.throughput(truths[n]) for n in ("a", "b")]
    assert partition_objective(new_tps) > partition_objective(old_tps)


def _event_rows(history):
    return [
        (e.round, e.triggered_by, e.old_partition.notation(), e.new_partition.notation(),
         e.predicted_gain, e.swapped)
        for e in history
    ]


@pytest.mark.parametrize("fairness", ["sum", "max-min"])
def test_partition_controller_matches_reference(duo, fairness):
    """The same drifted observation windows fed to both packages'
    controllers: the same events, gains, partitions and calibrated
    matrices, step by step, then the same degrade and rejoin."""
    from repro.core.calibration import scale_core_type as ref_scale

    reg, _, ref_reg = duo
    priors = AutoPlanner(platform=PLAT).time_matrices(reg.graphs())
    ref_priors = ref_serving.AutoPlanner(platform=ref_hikey970()).time_matrices(ref_reg.graphs())
    assert priors == ref_priors
    cfg = dict(threshold=0.25, patience=2, min_gain=1.02)
    ctrl = PartitionController(
        priors, partition_search(priors, PLAT, fairness=fairness), PLAT,
        config=AdaptiveConfig(**cfg), fairness=fairness, weights=reg.weights())
    ref_ctrl = ref_serving.PartitionController(
        ref_priors, ref_partition_search(ref_priors, ref_hikey970(), fairness=fairness),
        ref_hikey970(), config=ref_serving.AdaptiveConfig(**cfg), fairness=fairness,
        weights=ref_reg.weights())
    truths = {n: [dict(r) for r in priors[n]] for n in priors}
    for w in range(10):
        if w == 2:
            truths["a"] = scale_core_type(scale_core_type(truths["a"], "B", 3.0), "s", 3.0)
            assert truths["a"] == ref_scale(ref_scale(
                [dict(r) for r in ref_priors["a"]], "B", 3.0), "s", 3.0)
        if w == 6:
            truths["b"] = scale_core_type(truths["b"], "s", 2.5)
        got = ctrl.step(_observations_for(ctrl.partition, truths))
        want = ref_ctrl.step(_observations_for(ref_ctrl.partition, truths,
                                               ref_serving.StageObservation))
        assert (got is None) == (want is None)
        assert ctrl.partition.notation() == ref_ctrl.partition.notation()
    assert ctrl.swaps == ref_ctrl.swaps
    if fairness == "sum":  # the drift of "a" moves the utilitarian split
        assert ctrl.swaps >= 1
    assert _event_rows(ctrl.history) == _event_rows(ref_ctrl.history)
    for n in priors:
        assert ctrl.calibrators[n].matrix() == ref_ctrl.calibrators[n].matrix()
    assert ctrl.degrade({"B": 4}).notation() == ref_ctrl.degrade({"B": 4}).notation()
    assert ctrl.rejoin().notation() == ref_ctrl.rejoin().notation()
    assert _event_rows(ctrl.history) == _event_rows(ref_ctrl.history)


def test_partition_controller_throttle_replans_under_new_cap(duo):
    reg, _, _ = duo
    planner = AutoPlanner(platform=PLAT, mode="best")
    graphs = {n: reg[n].graph for n in reg.names}
    Ts = planner.time_matrices(graphs)
    part = planner.partition(graphs, Ts, power_cap_w=PLAT.max_power_w())
    ctrl = PartitionController(priors=Ts, partition=part, platform=PLAT,
                               power_cap_w=PLAT.max_power_w())
    new_cap = 0.3 * PLAT.max_power_w()
    candidate = ctrl.throttle(new_cap)
    assert ctrl.power_cap_w == new_cap
    assert candidate.feasible
    assert candidate.total_power_w <= new_cap * (1 + 1e-9)
    assert ctrl.history and ctrl.history[-1].triggered_by == ("power_cap",)


def test_partition_controller_degrade_and_rejoin(duo):
    reg, _, _ = duo
    Ts = AutoPlanner(platform=PLAT, mode="best").time_matrices(reg.graphs())
    part = partition_search(Ts, PLAT)
    ctrl = PartitionController(Ts, part, PLAT)
    deg = ctrl.degrade({"B": 4})
    assert ctrl.degraded
    for mp in deg.assignments:
        assert all(ct == "s" for ct, _ in mp.plan.pipeline.stages)
        assert all(ct.name == "s" for ct in mp.share.core_types)
    restored = ctrl.rejoin()
    assert restored.plans() == part.plans() and not ctrl.degraded


# ------------------------------------------------------- the time-sliced baseline
def test_time_sliced_engine_matches_reference(duo):
    """Round-robin slices of ``quantum`` through per-model full-width
    engines: the same slice count as the reference's, outputs bitwise
    equal to the port's single-stage engine and within the reference's
    bar of the reference's time-sliced outputs."""
    reg, images, ref_reg = duo
    planner = AutoPlanner(platform=PLAT, device="cpu")
    ref_planner = ref_serving.AutoPlanner(platform=ref_hikey970())
    engines, ref_engines = {}, {}
    for n in reg.names:
        engines[n] = PipelinedGraphEngine(reg[n].graph, reg[n].params, planner.plan(reg[n].graph),
                                          backend="cuda_fused", device="cpu")
        ref_engines[n] = ref_serving.PipelinedGraphEngine(
            ref_reg[n].graph, ref_reg[n].params, ref_planner.plan(ref_reg[n].graph))
    streams = {"a": images, "b": images[:5]}
    ts = TimeSlicedEngine(engines, quantum=3)
    ts.warmup({n: images[0] for n in reg.names})
    got = ts.run(streams)
    ref_ts = ref_serving.TimeSlicedEngine(ref_engines, quantum=3)
    want = ref_ts.run({n: [jnp.asarray(i) for i in s] for n, s in streams.items()})
    assert got["slices"] == want["slices"] == 3 + 2
    assert got["quantum"] == 3 and got["throughput"] > 0
    for n, s in streams.items():
        single = SingleStageEngine(reg[n].graph, reg[n].params, backend="cuda_fused",
                                   device="cpu").run(s)["outputs"]
        assert len(got["outputs"][n]) == len(s)
        for x, y, r in zip(got["outputs"][n], single, want["outputs"][n]):
            assert torch.equal(x, y)
            _close(r, x.numpy())
    with pytest.raises(ValueError):
        TimeSlicedEngine(engines, quantum=0)
    with pytest.raises(ValueError):
        TimeSlicedEngine({})


# ------------------------------------------------------------- one-call serve
def test_serve_dict_returns_multimodel_server(duo):
    reg, images, _ = duo
    mm = serve({"a": reg["a"].graph, "b": reg["b"].graph}, device="cpu",
               batch_size=2, flush_timeout_s=0.005)
    try:
        assert isinstance(mm, MultiModelServer)
        assert sorted(mm.servers) == ["a", "b"]
        assert mm.device == torch.device("cpu")
        out = mm.submit("a", images[0]).result(timeout=60.0)
        assert out.shape == (1, 10)
    finally:
        mm.stop()


def test_serve_dict_adaptive_attaches_partition_monitor(duo):
    reg, images, _ = duo
    mm = serve(
        {"a": reg["a"].graph, "b": reg["b"].graph},
        device="cpu",
        batch_size=1,
        adaptive=True,
        adaptive_config=AdaptiveConfig(interval_s=0.05),
    )
    try:
        assert mm.monitor is not None
        mm.run({"a": images[:4], "b": images[:4]}, timeout=120.0)
        obs = mm.monitor.sample()  # per-model windows flow after traffic
        assert set(obs) == {"a", "b"}
    finally:
        mm.stop()
    assert mm.monitor.error is None


def test_serve_dict_forwards_admission_and_fairness(duo):
    reg, images, _ = duo
    mm = serve({"a": reg["a"].graph, "b": reg["b"].graph}, device="cpu",
               batch_size=1, max_inflight=2, fairness="max-min")
    try:
        assert mm._max_inflight == {"a": 2, "b": 2}
        assert mm.fairness == "max-min"
        res = mm.run({"a": images[:4], "b": images[:4]}, timeout=120.0)  # throttles
        assert res["metrics"]["completed"] == 8
    finally:
        mm.stop()


def test_serve_dict_power_cap_partitions_under_machine_cap(duo):
    reg, images, _ = duo
    cap = 0.5 * PLAT.max_power_w()
    mm = serve({"a": reg["a"].graph, "b": reg["b"].graph}, device="cpu",
               platform=PLAT, batch_size=1, power_cap_w=cap)
    try:
        assert mm.partition.feasible
        assert mm.partition.total_power_w <= cap * (1 + 1e-9)
        for mp in mm.partition.assignments:
            assert mp.power is not None and mp.power.feasible
            assert mp.power.stage_freqs
        assert mm.submit("a", images[0]).result(timeout=60.0) is not None
    finally:
        mm.stop()


def test_serve_single_model_rejects_multi_only_options(duo):
    reg, _, _ = duo
    with pytest.raises(ValueError):
        serve(reg["a"].graph, device="cpu", max_inflight=4)
    with pytest.raises(ValueError):
        serve(reg["a"].graph, device="cpu", fairness="max-min")
    with pytest.raises(ValueError):
        serve({"a": reg["a"].graph}, device="cpu", min_throughput=1.0)
    with pytest.raises(ValueError):
        serve({"a": reg["a"].graph}, device="cpu", time_matrix=[{}])


def test_serve_empty_dict_raises():
    with pytest.raises(ValueError):
        serve({}, device="cpu")


# ------------------------------------------------- unwind-path observability
def test_exit_logs_stop_failure_once_and_caller_exception_survives(duo, caplog, monkeypatch):
    reg, _, _ = duo
    part = AutoPlanner(platform=PLAT, mode="best").partition(reg.graphs())
    mm = MultiModelServer(reg, part, device="cpu")
    real_stop = mm.stop

    def boom(timeout=30.0):
        raise RuntimeError("shutdown exploded")

    monkeypatch.setattr(mm, "stop", boom)
    caplog.set_level(logging.ERROR, logger="repro_torch.serving.multimodel")
    try:
        with pytest.raises(ValueError, match="original failure"):
            with mm:
                raise ValueError("original failure")
    finally:
        real_stop()
    records = [
        r for r in caplog.records
        if r.name == "repro_torch.serving.multimodel" and "stop() raised" in r.getMessage()
    ]
    assert len(records) == 1
    msg = records[0].getMessage()
    assert "a,b" in msg and "ValueError" in msg
    assert records[0].exc_info is not None


def test_exit_without_caller_exception_propagates_stop_failure(duo, monkeypatch):
    reg, _, _ = duo
    part = AutoPlanner(platform=PLAT, mode="best").partition(reg.graphs())
    mm = MultiModelServer(reg, part, device="cpu")
    real_stop = mm.stop

    def boom(timeout=30.0):
        raise RuntimeError("shutdown exploded")

    monkeypatch.setattr(mm, "stop", boom)
    try:
        with pytest.raises(RuntimeError, match="shutdown exploded"):
            with mm:
                pass
    finally:
        real_stop()


# -------------------------------------------------- interrupts in unwinds
@pytest.fixture()
def duo_server(duo):
    """An UNSTARTED two-model server whose inner ``swap_plan`` / ``stop``
    the interrupt tests replace."""
    reg, _, _ = duo
    Ts = AutoPlanner(platform=PLAT, mode="best").time_matrices(reg.graphs())
    part = partition_search(Ts, PLAT)
    return MultiModelServer(reg, part, queue_depth=2, device="cpu"), part


def test_swap_partition_ki_mid_swap_rolls_back_then_propagates(duo_server):
    mm, part = duo_server
    calls = []
    first, second = part.names[0], part.names[1]

    def fake_swap_first(plan, timeout=60.0):
        calls.append(plan)
        mm.servers[first].plan = plan

    def fake_swap_second(plan, timeout=60.0):
        raise KeyboardInterrupt

    mm.servers[first].swap_plan = fake_swap_first
    mm.servers[second].swap_plan = fake_swap_second
    mm.servers[first].plan = None
    mm.servers[second].plan = None
    with pytest.raises(KeyboardInterrupt):
        mm.swap_partition(part)
    assert calls == [part[first].plan, part[first].plan]
    assert mm.partition is part and mm.partition_epoch == 0


def test_swap_partition_ki_during_rollback_reraised_after_unwind(duo_server):
    mm, part = duo_server
    rolled_back = []
    first, second = part.names[0], part.names[1]
    swap_err = ValueError("swap exploded")

    def fake_swap_first(plan, timeout=60.0):
        if not rolled_back:  # forward pass
            rolled_back.append("forward")
            mm.servers[first].plan = plan
            return
        raise KeyboardInterrupt  # rollback pass

    def fake_swap_second(plan, timeout=60.0):
        raise swap_err

    mm.servers[first].swap_plan = fake_swap_first
    mm.servers[second].swap_plan = fake_swap_second
    mm.servers[first].plan = None
    mm.servers[second].plan = None
    with pytest.raises(KeyboardInterrupt) as excinfo:
        mm.swap_partition(part)
    assert excinfo.value.__cause__ is swap_err
    assert mm.partition is part and mm.partition_epoch == 0


def test_stop_prefers_interrupt_over_earlier_error(duo_server):
    mm, part = duo_server
    stopped = []
    first, second = part.names[0], part.names[1]

    def stop_first(timeout=10.0):
        stopped.append(first)
        raise ValueError("worker died earlier")

    def stop_second(timeout=10.0):
        stopped.append(second)
        raise KeyboardInterrupt

    mm.servers[first].stop = stop_first
    mm.servers[second].stop = stop_second
    with pytest.raises(KeyboardInterrupt):
        mm.stop()
    assert stopped == [first, second]


# ------------------------------------------------ faults and persistence
def test_multimodel_mid_swap_rollback_under_crash(duo, monkeypatch):
    """A partition swap that fails while a worker crash is being recovered
    rolls the already-swapped models back: the partition keeps describing
    what runs and no ticket is dropped or duplicated."""
    reg, _, _ = duo
    images = _images(3)
    Ts = AutoPlanner(platform=PLAT, mode="best").time_matrices(reg.graphs())
    part1 = partition_search(Ts, PLAT, weights={"a": 5.0, "b": 1.0})
    part2 = partition_search(Ts, PLAT, weights={"a": 1.0, "b": 5.0})
    changed = [mp.name for mp in part2.assignments if mp.plan != part1[mp.name].plan]
    assert len(changed) >= 2  # the rollback path needs a swapped prefix
    fplan = FaultPlan(events=(FaultEvent("crash", stage=0, at_call=2, model="a"),))
    builders = {
        n: fault_injecting_builder(build_stage_fns, fplan.injector(POLICY, model=n))
        for n in reg.names
    }
    mm = MultiModelServer(reg, part1, batch_size=1, flush_timeout_s=0.0, queue_depth=4,
                          stage_fn_builders=builders, recovery=POLICY, device="cpu")
    try:
        mm.start()
        tickets = []
        for i, img in enumerate(images[:4]):  # the crash fires in here
            tickets.append(("a", i, mm.submit("a", img)))
            tickets.append(("b", i, mm.submit("b", img)))
        victim = changed[-1]  # fails AFTER earlier models already swapped
        monkeypatch.setattr(
            mm.servers[victim], "swap_plan",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("mid-swap fault")),
        )
        with pytest.raises(RuntimeError, match="mid-swap fault"):
            mm.swap_partition(part2)
        monkeypatch.undo()
        assert mm.partition is part1 and mm.partition_epoch == 0
        for mp in part1.assignments:
            assert mm.servers[mp.name].plan == mp.plan
        for i, img in enumerate(images[4:], start=4):
            tickets.append(("a", i, mm.submit("a", img)))
            tickets.append(("b", i, mm.submit("b", img)))
        refs = {n: _single_outputs(reg, n, images) for n in reg.names}
        for name, i, t in tickets:
            assert torch.equal(refs[name][i], t.result(timeout=60.0))
        assert mm.metrics()["completed"] == 2 * len(images)  # no loss/dup
        assert mm.server("a").metrics.recovery.snapshot()["worker_restarts"] >= 1
    finally:
        mm.stop()


def test_plan_store_partition_round_trip(duo, tmp_path):
    reg, _, _ = duo
    Ts = AutoPlanner(platform=PLAT, mode="best").time_matrices(reg.graphs())
    part = partition_search(Ts, PLAT)
    store = PlanStore(tmp_path / "part.json")
    store.save_partition(part, epoch=1)
    back = store.load_partition(PLAT)
    assert back is not None
    assert back.plans() == part.plans()
    assert back.throughputs() == pytest.approx(part.throughputs())
    assert store.load_plan() is None  # wrong kind
    # a platform without the persisted cores -> cold start, not an error
    assert store.load_partition(PLAT.subset({"s": 4})) is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_partition_file_loads_in_the_other_package(duo, tmp_path, writer):
    """A partition file written by either package loads in the other with
    the same shares, plans, throughputs and objective."""
    reg, _, ref_reg = duo
    part = AutoPlanner(platform=PLAT).partition(reg.graphs(), weights=reg.weights())
    ref_part = ref_serving.AutoPlanner(platform=ref_hikey970()).partition(
        ref_reg.graphs(), weights=ref_reg.weights())
    path = tmp_path / "part.json"
    if writer == "port":
        PlanStore(path).save_partition(part, epoch=2)
        back, want = ref_serving.PlanStore(path).load_partition(ref_hikey970()), ref_part
    else:
        ref_serving.PlanStore(path).save_partition(ref_part, epoch=2)
        back, want = PlanStore(path).load_partition(PLAT), part
    assert back is not None
    assert back.notation() == want.notation()
    assert back.throughputs() == want.throughputs()
    assert back.objective == want.objective
    assert json.loads(path.read_text())["epoch"] == 2


def test_serve_multi_resume_from_skips_partition_search(duo, tmp_path, monkeypatch):
    reg, images, _ = duo
    path = tmp_path / "lkg_mm.json"
    mm = serve(reg, device="cpu", batch_size=1, flush_timeout_s=0.0, warmup=False,
               plan_store=path)
    try:
        saved = mm.partition.plans()
        baseline = mm.submit("b", images[0]).result(timeout=60.0)
    finally:
        mm.stop()
    assert path.exists()

    import repro_torch.serving.planner as planner_mod

    def no_search(*a, **k):
        raise AssertionError("resume_from must skip the partition DSE")

    monkeypatch.setattr(planner_mod, "partition_search", no_search)
    mm2 = serve(reg, device="cpu", batch_size=1, flush_timeout_s=0.0, warmup=False,
                resume_from=path)
    try:
        assert mm2.partition.plans() == saved
        assert torch.equal(mm2.submit("b", images[0]).result(timeout=60.0), baseline)
    finally:
        mm2.stop()


@pytest.mark.parametrize("case", ["cold", "resumed", "resumed_adaptive"])
def test_resumed_multi_server_measures_only_for_a_prior(duo, tmp_path, case):
    """Routes are measured when the time matrices are needed: the cold
    partition DSE, or the adaptive loop's priors on resume; a resumed
    static server measures nothing."""
    reg, _, _ = duo
    path = tmp_path / "lkg.json"
    if case != "cold":
        warm = serve(reg, device="cpu", batch_size=1, warmup=False, plan_store=path)
        warm.stop()
    tuner = ConvAutotuner(cache_path=str(tmp_path / "cache.json"), device="cpu")
    mm = serve(reg, device="cpu", backend="cuda_fused", batch_size=1, warmup=False,
               tuner=tuner, resume_from=None if case == "cold" else path,
               adaptive=case == "resumed_adaptive")
    try:
        n_keys = len({descriptor_key(d) for e in reg for d in e.graph.descriptors()})
        want = 0 if case == "resumed" else n_keys
        assert tuner.timings_run == want
        assert len(tuner.route_seconds("cuda_fused")) == want
    finally:
        mm.stop()


def test_partition_is_planned_on_the_routes_that_serve(duo, tmp_path):
    """A tuner that also holds another route's (faster) times must not
    lend them to the plan: the partition is the one made from the served
    route's measurements alone."""
    reg, _, _ = duo
    tuner = ConvAutotuner(cache_path=str(tmp_path / "cache.json"), device="cpu")
    for e in reg:  # a bogus, far faster "torch" route for every layer
        for d in e.graph.descriptors():
            tuner._entries.setdefault(descriptor_key(d), {"swept": False, "candidates": 0}) \
                .setdefault("routes", {})["torch"] = 1e-12 if e.name == "a" else 1.0
    mm = serve(reg, device="cpu", backend="cuda_fused", batch_size=1, warmup=False, tuner=tuner)
    try:
        served = AutoPlanner(platform=PLAT, measured=tuner.route_seconds("cuda_fused"))
        want = served.partition(reg.graphs(), weights=reg.weights())
        assert mm.partition.notation() == want.notation()
        assert mm.partition.throughputs() == want.throughputs()
    finally:
        mm.stop()


# ------------------------------------------- multi-model concurrency stress
def test_multimodel_stress_concurrent_clients_with_repartition(duo):
    """N client threads per model hammer the router while the global
    partition hot-swaps mid-stream: zero dropped tickets, zero duplicated
    completions, and every output bitwise equal to the single-stage
    engine (micro-batch 1)."""
    reg, _, _ = duo
    n_clients, n_images = 3, 14
    rng = np.random.default_rng(7)
    images = {
        n: [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(n_images)]
        for n in reg.names
    }
    refs = {n: _single_outputs(reg, n, images[n]) for n in reg.names}
    Ts = AutoPlanner(platform=PLAT, mode="best").time_matrices(reg.graphs())
    partitions = [
        partition_search(Ts, PLAT, weights={"a": 5.0, "b": 1.0}),
        partition_search(Ts, PLAT, weights={"a": 1.0, "b": 5.0}),
    ]
    assert partitions[0].plans() != partitions[1].plans()
    mm = MultiModelServer(reg, partitions[0], batch_size=1, flush_timeout_s=0.002,
                          queue_depth=4, device="cpu")
    results, errors = {}, []
    lock = threading.Lock()
    start_gate = threading.Event()

    def client(name, cid):
        try:
            start_gate.wait(10.0)
            tickets = [(i, mm.submit(name, img, timeout=120.0)) for i, img in enumerate(images[name])]
            for i, t in tickets:
                out = t.result(timeout=120.0)
                with lock:
                    key = (name, cid, i)
                    assert key not in results  # no duplicated completion
                    results[key] = out
        except BaseException as e:  # noqa: BLE001 — surfaced by the assert
            errors.append((name, cid, e))

    threads = [
        threading.Thread(target=client, args=(name, cid), daemon=True)
        for name in reg.names for cid in range(n_clients)
    ]
    try:
        mm.start()
        for t in threads:
            t.start()
        start_gate.set()
        for k in range(1, 4):
            time.sleep(0.05)
            mm.swap_partition(partitions[k % 2])
        for t in threads:
            t.join(timeout=180.0)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert len(results) == len(reg.names) * n_clients * n_images
        snap = mm.metrics()
        assert snap["completed"] == len(results)
        assert snap["partition_epoch"] == 3
        for name in reg.names:
            assert snap["router"][name]["admitted"] == n_clients * n_images
        for (name, _, i), out in results.items():
            assert torch.equal(out, refs[name][i])
    finally:
        mm.stop()
