"""The port's last-known-good plan persistence, held to tests/test_faults.py's
persistence contracts on the CPU, and to the JAX package's PlanStore:
a file either package writes loads in the other as the same plan or
partition.  Also the server's ``crash()``: in-flight tickets fail and
``stop()`` re-raises.

Outputs are compared bitwise: a resumed server runs the same stage
functions on the same weights and micro-batch shape as the one that
persisted its plan.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.core.dse import partition_search as ref_partition_search
from repro.core.pipeline import Pipeline as RefPipeline
from repro.core.pipeline import PipelinePlan as RefPipelinePlan
from repro.core.platform import hikey970 as ref_hikey970
from repro.serving.persistence import PlanStore as RefPlanStore
from repro_torch.cnn.graph import Graph
from repro_torch.core.calibration import synthetic_model
from repro_torch.core.dse import exhaustive_search, partition_search, pipe_it_search
from repro_torch.core.perfmodel import LayerTimePredictor
from repro_torch.core.pipeline import Pipeline, PipelinePlan
from repro_torch.core.platform import hikey970
from repro_torch.kernels.autotune import ConvAutotuner
from repro_torch.serving import PipelineServer, PlanStore, ServingError, serve

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

PLAT = hikey970()


def tiny_graph(name: str = "tiny", ch: int = 8) -> Graph:
    g = Graph(name, (16, 16, 3))
    a = g.conv("c1", "input", ch, 3)
    a = g.conv("c2", a, ch, 3, stride=2)
    a = g.conv("c3", a, 2 * ch, 1)
    a = g.pool_max("p1", a, 2, 2)
    a = g.conv("c4", a, 2 * ch, 3)
    a = g.gap("gap", a)
    a = g.fc("fc", a, 10)
    g.softmax("sm", a)
    return g


def matrix(g):
    return LayerTimePredictor(model=synthetic_model(), platform=PLAT).time_matrix(g.descriptors())


@pytest.fixture(scope="module")
def setup():
    g = tiny_graph()
    params = g.init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(6)]
    T = matrix(g)
    plan = pipe_it_search(len(T), PLAT, T, mode="best")
    return g, params, images, T, plan


def _as_tuples(plan):
    return tuple(map(tuple, plan.pipeline.stages)), tuple(map(tuple, plan.allocation))


# ------------------------------------------------------------ round trips
def test_plan_store_plan_round_trip(setup, tmp_path):
    _, _, _, _, plan = setup
    store = PlanStore(tmp_path / "plan.json")
    store.save_plan(plan, epoch=3)
    ir = store.load_plan()
    assert ir is not None and ir.as_pipeline_plan() == plan
    assert store.load()["epoch"] == 3
    assert store.load_partition(PLAT) is None  # wrong kind


def test_plan_store_partition_round_trip(tmp_path):
    Ts = {"a": matrix(tiny_graph("a", 8)), "b": matrix(tiny_graph("b", 12))}
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


def test_plan_store_unreadable_and_stale_files(tmp_path):
    missing = PlanStore(tmp_path / "absent.json")
    assert missing.load() is None and missing.load_plan() is None
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{not json")
    assert PlanStore(corrupt).load() is None
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": 999, "kind": "plan"}))
    assert PlanStore(stale).load() is None
    assert PlanStore.coerce(str(stale)).path == str(stale)


# ----------------------------------------------------- across the packages
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plan_file_loads_in_the_other_package(setup, tmp_path, writer):
    _, _, _, _, plan = setup
    stages, allocation = _as_tuples(plan)
    ref_plan = RefPipelinePlan(pipeline=RefPipeline(stages=stages), allocation=allocation)
    path = tmp_path / "plan.json"
    if writer == "reference":
        RefPlanStore(path).save_plan(ref_plan, epoch=2)
        back = PlanStore(path).load_plan()
        assert back is not None and back.as_pipeline_plan() == plan
    else:
        PlanStore(path).save_plan(plan, epoch=2)
        back = RefPlanStore(path).load_plan()
        assert back is not None and back.as_pipeline_plan() == ref_plan
    assert json.loads(path.read_text())["epoch"] == 2


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_partition_file_loads_in_the_other_package(tmp_path, writer):
    graphs = {"a": tiny_graph("a", 8), "b": tiny_graph("b", 12)}
    Ts = {n: matrix(g) for n, g in graphs.items()}
    path = tmp_path / "part.json"
    if writer == "reference":
        part = ref_partition_search(Ts, ref_hikey970())
        RefPlanStore(path).save_partition(part, epoch=1)
        back = PlanStore(path).load_partition(PLAT)
    else:
        part = partition_search(Ts, PLAT)
        PlanStore(path).save_partition(part, epoch=1)
        back = RefPlanStore(path).load_partition(ref_hikey970())
    assert back is not None
    assert [(n, _as_tuples(p)) for n, p in back.plans().items()] == [
        (n, _as_tuples(p)) for n, p in part.plans().items()]
    assert back.throughputs() == pytest.approx(part.throughputs())


# ------------------------------------------------------ the server and serve
def test_serve_resume_from_skips_search(setup, tmp_path, monkeypatch):
    g, params, images, T, _ = setup
    path = tmp_path / "lkg.json"
    srv = serve(g, device="cpu", params=params, time_matrix=T, batch_size=1,
                flush_timeout_s=0.0, warmup=False, plan_store=path)
    try:
        baseline = srv.submit(images[0]).result(timeout=30.0)
        saved_plan = srv.plan
    finally:
        srv.stop()
    assert path.exists()

    import repro_torch.serving.planner as planner_mod

    def no_search(*a, **k):
        raise AssertionError("resume_from must skip the DSE")

    monkeypatch.setattr(planner_mod, "pipe_it_search", no_search)
    srv2 = serve(g, device="cpu", params=params, batch_size=1, flush_timeout_s=0.0,
                 warmup=False, resume_from=path)
    try:
        assert srv2.plan == saved_plan
        assert torch.equal(srv2.submit(images[0]).result(timeout=30.0), baseline)
    finally:
        srv2.stop()


def test_serve_resume_from_an_unusable_file_is_a_cold_start(setup, tmp_path):
    g, params, images, T, plan = setup
    bad = tmp_path / "bad.json"
    bad.write_text("{torn")
    srv = serve(g, device="cpu", params=params, time_matrix=T, batch_size=1,
                flush_timeout_s=0.0, warmup=False, resume_from=bad)
    srv.stop()
    assert srv.plan == plan


def test_tuned_serve_then_resume_serves_the_same_outputs_without_a_dse(
        setup, tmp_path, monkeypatch):
    """serve(tuner=..., plan_store=...) plans from measured routes and
    persists; serve(resume_from=...) serves that plan, same outputs, with
    no second DSE (and no second measurement: the tuner is warm)."""
    import repro_torch.serving.planner as planner_mod

    g, params, images, _, _ = setup
    path = tmp_path / "lkg.json"
    tuner = ConvAutotuner(cache_path=str(tmp_path / "tune.json"), device="cpu", repeats=1)
    calls = []
    real = planner_mod.pipe_it_search

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(planner_mod, "pipe_it_search", counting)
    kw = dict(device="cpu", params=params, backend="cuda_fused", tuner=tuner, batch_size=2)
    srv = serve(g, plan_store=path, **kw)
    try:
        first = srv.run(images)["outputs"]
    finally:
        srv.stop()
    assert len(calls) == 1 and tuner.timings_run == len(g.descriptors())
    assert PlanStore(path).load_plan().as_pipeline_plan() == srv.plan
    srv2 = serve(g, resume_from=path, **kw)
    try:
        second = srv2.run(images)["outputs"]
    finally:
        srv2.stop()
    assert len(calls) == 1 and tuner.timings_run == len(g.descriptors())
    assert srv2.plan == srv.plan
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_resume_measures_no_route(setup, tmp_path):
    """A resumed server plans nothing, so a cold tuner times no route."""
    g, params, _, T, plan = setup
    path = tmp_path / "lkg.json"
    PlanStore(path).save_plan(plan)
    tuner = ConvAutotuner(cache_path=str(tmp_path / "tune.json"), device="cpu", repeats=1)
    srv = serve(g, device="cpu", params=params, backend="cuda_fused", tuner=tuner,
                batch_size=1, warmup=False, resume_from=path)
    srv.stop()
    assert srv.plan == plan
    assert tuner.timings_run == 0 and tuner.route_seconds() == {}


def test_swap_persists_last_known_good(setup, tmp_path):
    """Every successful hot-swap overwrites the store with the new plan."""
    g, params, images, T, plan = setup
    srv = PipelineServer(g, params, plan, batch_size=1, flush_timeout_s=0.0, device="cpu")
    srv.plan_store = PlanStore(tmp_path / "lkg.json")
    try:
        srv.start()
        other = exhaustive_search(len(T), PLAT.subset({"s": 4}), T)
        assert other != plan
        srv.swap_plan(other)
        ir = srv.plan_store.load_plan()
        assert ir is not None and ir.as_pipeline_plan() == other
        assert srv.plan_store.load()["epoch"] == 1
        n = sum(len(a) for a in plan.allocation)
        one = PipelinePlan(pipeline=Pipeline(stages=(plan.pipeline.stages[0],)),
                           allocation=(tuple(range(n)),))
        srv.swap_plan(one)
        assert srv.plan_store.load_plan().as_pipeline_plan() == one
        assert srv.submit(images[0]).result(timeout=30.0).shape == (1, 10)
    finally:
        srv.stop()


def test_a_failing_store_never_fails_the_swap(setup, tmp_path, caplog):
    """Persistence is best effort: a store that cannot write is logged and
    the swap (and serving) go on."""
    g, params, images, T, plan = setup
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    srv = PipelineServer(g, params, plan, batch_size=1, flush_timeout_s=0.0, device="cpu")
    srv.plan_store = PlanStore(blocker / "lkg.json")  # its directory is a file
    try:
        srv.start()
        other = exhaustive_search(len(T), PLAT.subset({"s": 4}), T)
        with caplog.at_level("ERROR"):
            srv.swap_plan(other)
        assert srv.plan == other and srv.epoch == 1
        assert "persistence failed" in caplog.text
        assert srv.submit(images[0]).result(timeout=30.0).shape == (1, 10)
    finally:
        srv.stop()


@pytest.mark.parametrize("reason", [None, "custom"])
def test_crash_fails_in_flight_tickets_and_stop_reraises(setup, reason):
    g, params, images, _, plan = setup
    # a flush timeout the test never reaches: the tickets wait in stage 0's
    # gather for a full micro-batch when the crash comes
    srv = PipelineServer(g, params, plan, batch_size=8, flush_timeout_s=60.0, device="cpu")
    error = None if reason is None else RuntimeError("board lost")
    srv.start()
    tickets = [srv.submit(img) for img in images[:3]]
    srv.crash(error)
    for t in tickets:
        with pytest.raises(ServingError, match="pipeline worker failed"):
            t.result(timeout=30.0)
    with pytest.raises(ServingError if error is None else RuntimeError,
                       match="simulated crash" if error is None else "board lost"):
        srv.stop()
    with pytest.raises(ServingError):
        srv.submit(images[0])
