"""The port's autotuner and measured routes, held to tests/test_autotune.py's
contracts on the CPU, and to the JAX package's tuner and planner.

On the CPU the tuner records the fused conv's shape heuristic (variant
-1, ``swept=False``) and times the serving routes with
``time.perf_counter``; the sweep over B1's tile variants, CUDA-event
timing and the refusal under a CUDA-graph capture are held on the card
(tests/test_torch_gpu.py).  Time matrices built from the same measured
layer times must equal the reference's to ``rtol=1e-12`` (the same float
arithmetic on the same inputs; only the summation of a few terms could
differ), and the DSE must pick the same plan.
"""
from __future__ import annotations

import json
import math
import sys
import threading

import numpy as np
import pytest
import torch

from repro.cnn.graph import Graph as RefGraph
from repro.cnn.models import MODELS as REF_MODELS
from repro.kernels.autotune import ConvAutotuner as RefTuner
from repro.kernels.autotune import descriptor_key as ref_descriptor_key
from repro.kernels.backend import measure_graph_routes as ref_measure_graph_routes
from repro.kernels.backend import resolve_backend as ref_resolve_backend
from repro.serving.planner import AutoPlanner as RefPlanner
from repro_torch.cnn.graph import Graph
from repro_torch.cnn.models import MODELS
from repro_torch.core.descriptors import conv_descriptor
from repro_torch.core.platform import hikey970
from repro_torch.kernels import autotune as A
from repro_torch.kernels.autotune import (
    ConvAutotuner,
    TileConfig,
    candidate_variants,
    descriptor_key,
)
from repro_torch.kernels.backend import measure_graph_routes, resolve_backend
from repro_torch.serving import AutoPlanner, build_eager_stage_fns, host_platform, serve

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

TINY = conv_descriptor("tiny", 8, 4, 3, 8, stride=1)
PLATFORM = A.CPU_PLATFORM


@pytest.fixture(autouse=True)
def _hermetic_env(monkeypatch):
    """No test reads a cache file named by the caller's environment."""
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_SWEEP", raising=False)


def tuner(path, **kw) -> ConvAutotuner:
    return ConvAutotuner(cache_path=str(path), device="cpu", repeats=1, **kw)


def mixed(G=Graph):
    """Every kind of major node: convs (one 1x1, one strided), a depthwise
    conv, a grouped conv and two fc layers."""
    g = G("mixed", (12, 12, 4))
    a = g.conv("c1", "input", 8, 3)
    a = g.depthwise("dw", a, 3, stride=2)
    a = g.conv("g1", a, 8, 3, groups=2)
    a = g.conv("c2", a, 16, 1)
    a = g.gap("gap", a)
    a = g.fc("fc1", a, 12, act="relu")
    a = g.fc("fc2", a, 5)
    g.softmax("sm", a)
    return g


# ----------------------------------------------------------------- keys
@pytest.mark.parametrize("net", sorted(MODELS))
def test_descriptor_keys_equal_the_reference(net):
    ours = [descriptor_key(d) for d in MODELS[net]().descriptors()]
    theirs = [ref_descriptor_key(d) for d in REF_MODELS[net]().descriptors()]
    assert ours == theirs


def test_candidate_variants_put_the_heuristic_first():
    assert candidate_variants(4) == [TileConfig(v) for v in (-1, 0, 1, 2, 3)]
    assert TileConfig(2).as_kwargs() == {"variant": 2}


# ---------------------------------------------------------- the device
def test_sweep_only_where_the_kernel_runs(tmp_path):
    t = tuner(tmp_path / "t.json")
    assert not t.sweep and t.platform == PLATFORM and t.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tuner(tmp_path / "t.json", sweep=True)


def test_tuner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the no-CUDA refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ConvAutotuner()


# ------------------------------------------------------------ the cache
def test_cache_round_trip_with_unswept_entries(tmp_path):
    cache = tmp_path / "tune.json"
    t1 = tuner(cache)
    cfg = t1.tune(TINY)
    assert cfg == TileConfig(-1)
    assert t1.timings_run == 0  # nothing is timed off the card
    entry = t1.entry(TINY)
    assert entry["swept"] is False and entry["candidates"] == 0 and entry["time_s"] is None
    t2 = tuner(cache)
    assert t2.tune(TINY) == cfg and t2.timings_run == 0
    data = json.loads(cache.read_text())
    assert data["version"] == 1
    assert descriptor_key(TINY) in data["platforms"][PLATFORM]


def test_route_measurement_cached(tmp_path):
    cache = tmp_path / "tune.json"
    t = tuner(cache)
    calls = []
    t.measure_route(TINY, lambda: calls.append(1))
    assert t.timings_run == 1 and len(calls) == 2  # warm + 1 timed rep
    t.measure_route(TINY, lambda: calls.append(1))
    assert t.timings_run == 1 and len(calls) == 2  # cache hit, fn never called
    t2 = tuner(cache)
    assert t2.measure_route(TINY, lambda: (_ for _ in ()).throw(AssertionError)) > 0
    assert t2.timings_run == 0
    assert descriptor_key(TINY) in t2.route_seconds()


def test_route_measurements_are_keyed_per_backend_route(tmp_path):
    """A "cuda" measurement is never served as the "cuda_fused" time for
    the same geometry (they are different kernels)."""
    t = tuner(tmp_path / "tune.json")
    t.measure_route(TINY, lambda: None, route="cuda")
    assert t.measured_route(TINY, "cuda_fused") is None
    t.measure_route(TINY, lambda: None, route="cuda_fused")
    assert t.timings_run == 2
    assert descriptor_key(TINY) in t.route_seconds("cuda")
    assert descriptor_key(TINY) in t.route_seconds("cuda_fused")
    both = t.entry(TINY)["routes"]
    assert t.route_seconds()[descriptor_key(TINY)] == min(both.values())


def test_route_only_entry_does_not_suppress_the_variant(tmp_path):
    """measure_route first (no variant), then tune(): the entry gains its
    variant and keeps its routes (the sweep itself: tests/test_torch_gpu.py)."""
    t = tuner(tmp_path / "tune.json")
    t.measure_route(TINY, lambda: None, route="cuda")
    assert "variant" not in t.entry(TINY)
    assert t.tune(TINY) == TileConfig(-1)
    entry = t.entry(TINY)
    assert entry["variant"] == -1 and "cuda" in entry["routes"]


def test_a_pick_timed_at_another_batch_is_a_miss(tmp_path):
    """The variant is timed at the serving micro-batch (the kernel's own
    choice follows M = B*OH*OW), so a tuner for another batch re-picks,
    keeping the entry's routes."""
    cache = tmp_path / "tune.json"
    t1 = tuner(cache)
    t1.measure_route(TINY, lambda: None, route="cuda")
    t1.tune(TINY)
    assert t1.entry(TINY)["batch"] == 1
    t4 = tuner(cache, batch=4)
    assert t4.tune(TINY) == TileConfig(-1)
    entry = t4.entry(TINY)
    assert entry["batch"] == 4 and entry["variant"] == -1 and "cuda" in entry["routes"]
    assert tuner(cache, batch=4).entry(TINY)["batch"] == 4
    with pytest.raises(ValueError, match="batch"):
        tuner(cache, batch=0)


# ----------------------------------------------------- cache robustness
@pytest.mark.parametrize(
    "payload",
    [
        b"",  # empty file
        b"not json at all {{{",  # garbage
        b'{"version": 1, "platforms": {"torch-cpu": {"k": {"variant": 1',  # truncated
        b"[1, 2, 3]",  # valid JSON, wrong top-level type
        b'{"version": 1, "platforms": []}',  # platforms not a dict
        b'{"version": 1, "platforms": {"torch-cpu": 7}}',  # platform not a dict
        b'{"version": 1, "platforms": {"torch-cpu": {"k": 3}}}',  # entry damaged
    ],
    ids=["empty", "garbage", "truncated", "wrong-type", "platforms-list",
         "platform-scalar", "entry-scalar"],
)
def test_corrupt_cache_falls_back_to_retiming(tmp_path, payload):
    cache = tmp_path / "tune.json"
    cache.write_bytes(payload)
    t = tuner(cache)
    assert t.entry(TINY) is None  # damaged content discarded, not raised
    assert t.measure_route(TINY, lambda: None, route="cuda") > 0
    assert t.timings_run == 1  # fell back to a real timing
    t.save()
    t2 = tuner(cache)  # the rewritten file is valid again and round-trips
    assert t2.measured_route(TINY, "cuda") is not None
    assert t2.timings_run == 0


@pytest.mark.parametrize("field", ["routes", "variant"])
def test_damaged_field_inside_a_healthy_entry(tmp_path, field):
    """A non-dict ``routes`` or a non-integer ``variant`` is dropped on load
    (re-time or re-pick, never raise), and save() rebuilds a valid file
    when merging over the damaged original."""
    cache = tmp_path / "tune.json"
    bad = {"routes": 7, "variant": "fast"}[field]
    cache.write_text(json.dumps({"version": 1, "platforms": {PLATFORM: {descriptor_key(TINY): {
        "swept": True, "candidates": 5, field: bad}}}}))
    t = tuner(cache)
    assert field not in t.entry(TINY)
    assert t.measure_route(TINY, lambda: None, route="cuda") > 0
    assert t.tune(TINY) == TileConfig(-1)
    t2 = tuner(cache)
    assert t2.measured_route(TINY, "cuda") is not None
    assert t2.entry(TINY)["variant"] == -1
    assert sorted(t2.route_seconds()) == [descriptor_key(TINY)]


def test_concurrent_tuner_writers_never_corrupt(tmp_path):
    """Two tuners (one cache file) interleaving saves: no exception, the
    file stays valid JSON, and whatever a race lost is re-timed."""
    cache = tmp_path / "tune.json"
    descs = [conv_descriptor(f"l{i}", 8 + 2 * i, 4, 3, 8) for i in range(6)]
    tuners = [tuner(cache) for _ in range(2)]
    errors = []

    def writer(t, mine):
        try:
            for d in mine:
                t.measure_route(d, lambda: None, route="cuda")  # save() per call
        except BaseException as e:  # noqa: BLE001 — the test asserts none
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t, descs[i::2])) for i, t in enumerate(tuners)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and not errors
    data = json.loads(cache.read_text())  # one writer's complete JSON
    assert isinstance(data["platforms"], dict)
    t3 = tuner(cache)
    for d in descs:
        assert t3.measure_route(d, lambda: None, route="cuda") > 0
    t4 = tuner(cache)  # save() merges: every geometry is persisted now
    assert all(t4.measured_route(d, "cuda") is not None for d in descs)


def test_save_merges_peers_routes(tmp_path):
    """Writer B saving after writer A keeps A's routes for a key both hold."""
    cache = tmp_path / "tune.json"
    a, b = tuner(cache), tuner(cache)  # b loaded empty
    a.measure_route(TINY, lambda: None, route="cuda")
    b.measure_route(TINY, lambda: None, route="cuda_fused")
    merged = tuner(cache)
    assert merged.measured_route(TINY, "cuda") is not None
    assert merged.measured_route(TINY, "cuda_fused") is not None


def test_one_tuner_shared_by_threads_keeps_every_entry(tmp_path):
    """A server's stage threads and swap_plan's prepare phase use one tuner
    at once: with more threads than cores and a short switch interval,
    every geometry is tuned and measured exactly once."""
    t = tuner(tmp_path / "tune.json")
    descs = [conv_descriptor(f"l{i}", 8 + i, 4, 3, 8) for i in range(8)]
    errors = []

    def worker():
        try:
            for d in descs:
                t.tune(d)
                t.measure_route(d, lambda: None, route="cuda_fused")
        except BaseException as e:  # noqa: BLE001 — the test asserts none
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors
    assert t.timings_run == len(descs)  # one measurement per geometry, no lost update
    back = tuner(tmp_path / "tune.json")
    assert all(back.entry(d)["variant"] == -1 and back.measured_route(d, "cuda_fused")
               for d in descs)


# ------------------------------------------- the two packages keep apart
def test_the_port_never_reads_the_jax_tuners_file(tmp_path, monkeypatch):
    jax_file, port_file = tmp_path / "jax.json", tmp_path / "port.json"
    # even an entry under the port's own platform key is not read from there
    jax_file.write_text(json.dumps({"version": 1, "platforms": {PLATFORM: {
        descriptor_key(TINY): {"variant": 3, "swept": True, "candidates": 5}}}}))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(jax_file))
    assert ConvAutotuner(device="cpu").cache_path == A._DEFAULT_CACHE
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(port_file))
    t = ConvAutotuner(device="cpu")
    assert t.cache_path == str(port_file) and t.entry(TINY) is None
    assert A._DEFAULT_CACHE != RefTuner(sweep=False).cache_path


def test_two_packages_tuners_on_one_file_never_adopt_each_others_entries(tmp_path):
    cache = tmp_path / "shared.json"
    ref = RefTuner(cache_path=str(cache), sweep=False, repeats=1)
    ref.tune(TINY)
    ref.measure_route(TINY, lambda: None, route="xla")
    port = tuner(cache)
    assert port.entry(TINY) is None  # "cpu" is the JAX tuner's key, not the port's
    port.measure_route(TINY, lambda: None, route="cuda")
    port.tune(TINY)
    ref2 = RefTuner(cache_path=str(cache), sweep=False, repeats=1)
    assert set(ref2.entry(TINY)["routes"]) == {"xla"}  # its entry survived the port's save
    assert "variant" not in ref2.entry(TINY)
    assert set(tuner(cache).entry(TINY)["routes"]) == {"cuda"}
    assert "bm" not in tuner(cache).entry(TINY)


# ------------------------------------------------------ measured routes
@pytest.mark.parametrize("route", ["torch", "cuda", "cuda_fused"])
def test_measure_graph_routes_keys_equal_the_reference(tmp_path, route):
    ref_route = {"torch": "xla", "cuda": "pallas", "cuda_fused": "pallas_fused"}[route]
    t = tuner(tmp_path / "tune.json")
    ours = measure_graph_routes(mixed(), resolve_backend(route, tuner=t), t)
    rt = RefTuner(cache_path=str(tmp_path / "ref.json"), sweep=False, repeats=1)
    theirs = ref_measure_graph_routes(mixed(RefGraph), ref_resolve_backend(ref_route, tuner=rt), rt)
    assert sorted(ours) == sorted(theirs)
    assert all(v > 0 and math.isfinite(v) for v in ours.values())
    assert set(t.route_seconds(route)) == set(ours)
    # the fused route's convs are tuned first; the others tune nothing
    tuned = [d for d in mixed().descriptors() if t.entry(d) and "variant" in t.entry(d)]
    want = [d.name for d in mixed().descriptors() if d.kind == "conv" and d.groups == 1]
    assert [d.name for d in tuned] == (want if route == "cuda_fused" else [])


def test_shared_tuner_across_models_times_a_geometry_once(tmp_path):
    def g1():
        g = Graph("g1", (16, 16, 3))
        a = g.conv("c1", "input", 8, 3)  # shared geometry
        a = g.conv("c2", a, 8, 3)
        a = g.gap("gap", a)
        g.fc("fc", a, 10)
        return g

    def g2():
        g = Graph("g2", (16, 16, 3))
        a = g.conv("x1", "input", 8, 3)  # the geometry of g1.c1
        a = g.conv("x2", a, 16, 1)
        a = g.gap("gap", a)
        g.fc("fc", a, 10)
        return g

    t = tuner(tmp_path / "tune.json")
    kb = resolve_backend("torch", tuner=t)
    measure_graph_routes(g1(), kb, t)
    after_first = t.timings_run
    measure_graph_routes(g2(), kb, t)
    unique = {descriptor_key(d) for d in g2().descriptors()} - {
        descriptor_key(d) for d in g1().descriptors()}
    assert t.timings_run == after_first + len(unique)


def test_stage_builders_tune_every_fused_conv_before_any_call(tmp_path):
    """Tuning happens where the stage functions are built (serve(), and
    swap_plan's prepare phase), so a CUDA-graph capture only ever hits."""
    t = tuner(tmp_path / "tune.json")
    g = mixed()
    plan = AutoPlanner(platform=host_platform(2)).plan(g)
    build_eager_stage_fns(g, plan, backend=resolve_backend("cuda_fused", tuner=t))
    convs = [d for d in g.descriptors() if d.kind == "conv" and d.groups == 1]
    assert all(t.entry(d)["variant"] == -1 for d in convs)
    others = [d for d in g.descriptors() if d not in convs]
    assert all(t.entry(d) is None for d in others)


# -------------------------------------------------- planning from them
def test_planner_time_matrix_and_plan_equal_the_reference(tmp_path):
    """The port's AutoPlanner(tuner=...) and the reference's
    AutoPlanner(measured=...) on the same measured layer times give the
    same time matrix and the same plan; without measurements as well."""
    t = tuner(tmp_path / "tune.json")
    g = MODELS["squeezenet"]()
    measure_graph_routes(g, resolve_backend("cuda_fused", tuner=t), t)
    measured = t.route_seconds()
    assert len(measured) == len({descriptor_key(d) for d in g.descriptors()})
    ref_g = REF_MODELS["squeezenet"]()
    for port_planner, ref_planner in (
        (AutoPlanner(mode="best", tuner=t), RefPlanner(mode="best", measured=measured)),
        (AutoPlanner(mode="best"), RefPlanner(mode="best")),
    ):
        T, T_ref = port_planner.time_matrix(g), ref_planner.time_matrix(ref_g)
        assert len(T) == len(T_ref) == len(g.descriptors())
        for row, ref_row in zip(T, T_ref):
            assert sorted(row) == sorted(ref_row)
            for stage, v in row.items():
                assert v == pytest.approx(ref_row[stage], rel=1e-12)
        plan, ref_plan = port_planner.plan(g, T), ref_planner.plan(ref_g, T_ref)
        assert plan.notation() == ref_plan.notation()
        assert [tuple(a) for a in plan.allocation] == [tuple(a) for a in ref_plan.allocation]
    baseline = AutoPlanner(mode="best").time_matrix(g)
    assert any(not math.isclose(T_m, T_b, rel_tol=1e-6)
               for row_m, row_b in zip(AutoPlanner(tuner=t).time_matrix(g), baseline)
               for T_m, T_b in zip(row_m.values(), row_b.values()))


# ---------------------------------------------------------------- serve
def test_serve_with_a_tuner_measures_the_route_that_serves(tmp_path):
    g = mixed()
    rng = np.random.default_rng(3)
    images = [rng.standard_normal((1, 12, 12, 4)).astype(np.float32) for _ in range(3)]
    t = tuner(tmp_path / "tune.json")
    server = serve(g, device="cpu", tuner=t, platform=host_platform(2), batch_size=1, seed=2)
    try:
        assert server.backend.for_node("c1") == "torch"  # a tuner without a backend
        assert set(t.route_seconds("torch")) == {descriptor_key(d) for d in g.descriptors()}
        outs = server.run(images)["outputs"]
    finally:
        server.stop()
    before = t.timings_run
    again = serve(g, device="cpu", tuner=t, platform=host_platform(2), batch_size=1,
                  params=server.params)
    try:
        assert t.timings_run == before  # a warm tuner times nothing
        assert again.plan == server.plan
        for a, b in zip(again.run(images)["outputs"], outs):
            assert torch.equal(a, b)
    finally:
        again.stop()


def test_serve_autotune_uses_the_ports_cache_variable(tmp_path, monkeypatch):
    cache = tmp_path / "env.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(cache))
    g = mixed()
    server = serve(g, device="cpu", autotune=True, backend="cuda_fused", batch_size=2,
                   warmup=False)
    server.stop()
    routes = json.loads(cache.read_text())["platforms"][PLATFORM]
    assert {descriptor_key(d) for d in g.descriptors()} == set(routes)
    assert all("cuda_fused" in e["routes"] for e in routes.values())
    # the tile variant is picked at the served micro-batch
    assert {routes[descriptor_key(d)]["batch"] for d in g.descriptors()
            if d.kind == "conv" and d.groups == 1} == {2}


def test_serve_skips_measurements_under_a_pinned_time_matrix(tmp_path):
    g = mixed()
    t = tuner(tmp_path / "tune.json")
    T = AutoPlanner(platform=host_platform(2)).time_matrix(g)
    server = serve(g, device="cpu", tuner=t, backend="cuda_fused", time_matrix=T,
                   platform=host_platform(2), batch_size=1, warmup=False)
    server.stop()
    assert t.timings_run == 0 and t.route_seconds() == {}
    # the fused convs are still tuned (variant recorded) for the stages
    assert all(t.entry(d)["variant"] == -1 for d in g.descriptors()
               if d.kind == "conv" and d.groups == 1)
