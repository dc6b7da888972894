"""The port's open-loop load generation: seeded arrival traces and the
``run_open_loop`` driver.

Every test of tests/test_loadgen.py, on the port's ``repro_torch.serving``
at the reference's tiny graph (16x16 inputs), plus parity tests with the
JAX package.  The generators are pure Python over a private
``random.Random(seed)`` in both packages, so one seed must give the
IDENTICAL trace (``times``, ``kind`` and ``meta`` compared with ``==``),
and a trace saved by either package must load in the other.

Live servers run on the CPU (``device="cpu"``).  At micro-batch 1 an
open-loop run's outputs must be bitwise equal to the port's single-stage
engine (on the CPU the library convs pick other blockings at other batch
sizes, so only equal shapes are bitwise comparable) and within
``rtol=1e-4, atol=1e-5`` of the reference's single-stage engine, the
reference's bar.  ``run_open_loop`` returns only a report, so the
outputs are read through a thin wrapper around the server that records
each submitted ticket with its image; the live tests size the ingress so
that nothing sheds under load.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as ref_serving
from repro.cnn.graph import Graph as RefGraph
from repro_torch.cnn.graph import Graph
from repro_torch.cnn.params import params_from_numpy
from repro_torch.core import Pipeline, PipelinePlan
from repro_torch.serving import (
    ArrivalTrace,
    PipelineServer,
    QueueController,
    QueuePolicy,
    SingleStageEngine,
    diurnal_trace,
    mmpp_trace,
    poisson_trace,
    run_open_loop,
)
import repro_torch.serving as port_serving

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _generators(S):
    """The reference test's generators, drawn from package ``S``."""
    return {
        "poisson": lambda seed: S.poisson_trace(50.0, n=200, seed=seed),
        "mmpp": lambda seed: S.mmpp_trace(
            20.0, 80.0, duration_s=5.0, calm_s=1.0, burst_s=0.5, seed=seed
        ),
        "diurnal": lambda seed: S.diurnal_trace(
            10.0, 60.0, period_s=2.0, duration_s=4.0, seed=seed
        ),
    }


GENERATORS = _generators(port_serving)


# ------------------------------------------------------------- determinism
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_same_seed_same_trace(name):
    gen = GENERATORS[name]
    a, b = gen(7), gen(7)
    assert a.times == b.times
    assert a.kind == b.kind
    assert a.meta == b.meta


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_different_seed_different_trace(name):
    gen = GENERATORS[name]
    assert gen(1).times != gen(2).times


def test_poisson_count_and_rate():
    tr = poisson_trace(100.0, n=5000, seed=3)
    assert tr.n == 5000
    assert tr.kind == "poisson"
    # offered rate concentrates around nominal (CLT: ~1.4% sd at n=5000)
    assert tr.offered_rate() == pytest.approx(100.0, rel=0.05)
    tr2 = poisson_trace(100.0, duration_s=50.0, seed=3)
    assert tr2.duration_s <= 50.0
    assert tr2.n == pytest.approx(5000, rel=0.1)


def test_mmpp_phases_cover_duration():
    tr = GENERATORS["mmpp"](5)
    phases = tr.meta["phases"]
    assert phases[0][0] == 0.0
    assert phases[-1][1] == pytest.approx(5.0)
    for (_, e0, r0), (s1, _, r1) in zip(phases, phases[1:]):
        assert s1 == e0  # contiguous
        assert {r0, r1} == {20.0, 80.0}  # strictly alternating
    # every arrival lands inside the declared duration
    assert all(0.0 <= t <= 5.0 for t in tr.times)


def test_diurnal_mass_concentrates_at_peak():
    tr = diurnal_trace(5.0, 100.0, period_s=10.0, duration_s=10.0, seed=1)
    trough = len(tr.window(0.0, 2.5)) + len(tr.window(7.5, 10.0))
    peak = len(tr.window(2.5, 7.5))
    assert peak > 2 * trough


# ------------------------------------------------------------ trace algebra
def test_window_half_open():
    tr = ArrivalTrace(times=(0.0, 1.0, 2.0, 3.0))
    assert tr.window(1.0, 3.0) == (1.0, 2.0)
    assert tr.window(0.0, 10.0) == tr.times
    assert tr.window(5.0, 6.0) == ()


def test_windows_partition_trace():
    tr = GENERATORS["poisson"](9)
    stitched = []
    for w in range(50):
        stitched.extend(tr.window(w * 0.5, (w + 1) * 0.5))
    assert tuple(stitched) == tr.times


def test_scaled_dilates_time():
    tr = poisson_trace(50.0, n=100, seed=2)
    slow = tr.scaled(4.0)
    assert slow.n == tr.n
    assert slow.offered_rate() == pytest.approx(tr.offered_rate() / 4.0)
    assert slow.meta["time_scale"] == 4.0
    with pytest.raises(ValueError):
        tr.scaled(0.0)


def test_scaled_provenance_composes():
    """Repeated scaling records the CUMULATIVE dilation, not the last
    factor — the replay meta must reconstruct the original timeline."""
    tr = poisson_trace(50.0, n=50, seed=6)
    twice = tr.scaled(2.0).scaled(3.0)
    assert twice.meta["time_scale"] == pytest.approx(6.0)
    assert twice.times[-1] == pytest.approx(tr.times[-1] * 6.0)
    # other meta keys survive the rescale
    assert twice.meta["rate"] == tr.meta["rate"]


# ------------------------------------------------------- degenerate traces
def test_empty_trace_offers_zero_load():
    tr = ArrivalTrace(times=())
    assert tr.duration_s == 0.0
    assert tr.offered_rate() == 0.0  # documented: no arrivals, no load
    assert tr.window(0.0, 1.0) == ()
    assert tr.scaled(2.0).times == ()


def test_zero_duration_trace_offered_rate_raises():
    # a single arrival at t=0 (span 0) used to report ~1e12 img/s
    with pytest.raises(ValueError, match="zero-duration"):
        ArrivalTrace(times=(0.0,)).offered_rate()
    # an instantaneous burst is just as undefined
    with pytest.raises(ValueError, match="zero-duration"):
        ArrivalTrace(times=(0.0, 0.0, 0.0)).offered_rate()


def test_single_arrival_positive_span_is_fine():
    tr = ArrivalTrace(times=(5.0,))
    assert tr.offered_rate() == pytest.approx(0.2)


def test_window_rejects_inverted_bounds():
    tr = ArrivalTrace(times=(0.0, 1.0))
    with pytest.raises(ValueError, match="end < start"):
        tr.window(2.0, 1.0)
    assert tr.window(1.0, 1.0) == ()  # empty-but-valid window


# ------------------------------------------------------------- JSON replay
def test_json_round_trip():
    tr = GENERATORS["mmpp"](11)
    back = ArrivalTrace.from_json(tr.to_json())
    assert back == tr


def test_save_load_round_trip(tmp_path):
    tr = GENERATORS["diurnal"](4)
    path = str(tmp_path / "trace.json")
    tr.save(path)
    back = ArrivalTrace.load(path)
    assert back == tr
    assert back.kind == "diurnal"


def test_replay_defaults():
    back = ArrivalTrace.from_json('{"times": [0.5, 1.5]}')
    assert back.kind == "replay"
    assert back.meta == {}
    assert back.times == (0.5, 1.5)


# -------------------------------------------------------------- validation
def test_validation_errors():
    with pytest.raises(ValueError):
        ArrivalTrace(times=(1.0, 0.5))  # descending
    with pytest.raises(ValueError):
        ArrivalTrace(times=(-1.0, 0.5))  # negative
    with pytest.raises(ValueError):
        poisson_trace(0.0, n=10)
    with pytest.raises(ValueError):
        poisson_trace(1.0)  # neither duration nor n
    with pytest.raises(ValueError):
        poisson_trace(1.0, duration_s=1.0, n=10)  # both
    with pytest.raises(ValueError):
        mmpp_trace(0.0, 1.0, duration_s=1.0, calm_s=1.0, burst_s=1.0)
    with pytest.raises(ValueError):
        mmpp_trace(1.0, 2.0, duration_s=0.0, calm_s=1.0, burst_s=1.0)
    with pytest.raises(ValueError):
        diurnal_trace(5.0, 1.0, period_s=1.0, duration_s=1.0)  # peak < base


# ------------------------------------------------- parity with the reference
PARITY_SEEDS = (0, 3, 11, 2024)


@pytest.mark.parametrize("seed", PARITY_SEEDS)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_trace_is_the_references(name, seed):
    """One seed, one trace: the port's generator gives the reference's
    arrival times, kind and provenance, exactly."""
    got = GENERATORS[name](seed)
    want = _generators(ref_serving)[name](seed)
    assert got.times == want.times
    assert got.kind == want.kind
    assert got.meta == want.meta


@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_duration_bounded_and_scaled_traces_are_the_references(seed):
    pairs = [
        (poisson_trace(30.0, duration_s=3.0, seed=seed),
         ref_serving.poisson_trace(30.0, duration_s=3.0, seed=seed)),
        (mmpp_trace(5.0, 40.0, duration_s=3.0, calm_s=0.5, burst_s=0.2, seed=seed).scaled(0.5),
         ref_serving.mmpp_trace(5.0, 40.0, duration_s=3.0, calm_s=0.5, burst_s=0.2,
                                seed=seed).scaled(0.5)),
    ]
    for got, want in pairs:
        assert (got.times, got.kind, got.meta) == (want.times, want.kind, want.meta)
        assert got.window(0.5, 1.5) == want.window(0.5, 1.5)
        assert got.offered_rate() == want.offered_rate()


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_saved_trace_loads_in_the_other_package(tmp_path, writer, name):
    mine, other = (
        (port_serving, ref_serving) if writer == "port" else (ref_serving, port_serving)
    )
    tr = _generators(mine)[name](5)
    path = str(tmp_path / "trace.json")
    tr.save(path)
    back = other.ArrivalTrace.load(path)
    assert (back.times, back.kind, back.meta) == (tr.times, tr.kind, tr.meta)
    assert other.ArrivalTrace.from_json(tr.to_json()).times == tr.times


# ----------------------------------------------------------- live driver
def _tiny_graph(G=Graph) -> Graph:
    g = G("tiny", (16, 16, 3))
    a = g.conv("c1", "input", 8, 3)
    a = g.conv("c2", a, 8, 3, stride=2)
    a = g.gap("gap", a)
    a = g.fc("fc", a, 10)
    g.softmax("sm", a)
    return g


@pytest.fixture(scope="module")
def live():
    """The port's tiny graph on the reference's weights, and images."""
    ref_g = _tiny_graph(RefGraph)
    ref_params = ref_g.init(jax.random.PRNGKey(0))
    numpy_params = {n: {k: np.asarray(v) for k, v in p.items()} for n, p in ref_params.items()}
    g = _tiny_graph()
    params = params_from_numpy(numpy_params, "cpu")
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(4)]
    return g, params, images, (ref_g, ref_params)


def _one_stage(g):
    return PipelinePlan(Pipeline((("B", 4),)), (tuple(range(len(g.descriptors()))),))


class _Recording:
    """A server seen through ``run_open_loop``'s interface: submits are
    passed on, and each ticket is recorded with its image's index."""

    def __init__(self, server, images):
        self.server = server
        self.index = {id(x): i for i, x in enumerate(images)}
        self.tickets = []

    def ingress_depth(self):
        return self.server.ingress_depth()

    def set_batching(self, **kw):
        self.server.set_batching(**kw)

    def submit(self, image, *, block=True):
        ticket = self.server.submit(image, block=block)
        self.tickets.append((self.index[id(image)], ticket))
        return ticket


def test_run_open_loop_live(live):
    g, params, images, _ = live
    trace = poisson_trace(40.0, n=12, seed=0)
    with PipelineServer(g, params, _one_stage(g), batch_size=2,
                        flush_timeout_s=0.005, device="cpu") as srv:
        srv.warmup()
        report = run_open_loop(srv, trace, images, result_timeout_s=60.0)
    assert report.offered == 12
    assert report.completed == report.submitted
    assert report.completed + report.shed_backpressure == 12
    assert report.shed_admission == 0
    assert len(report.latencies_s) == report.completed
    assert all(x > 0.0 for x in report.latencies_s)
    assert report.latency_p50_s <= report.latency_p99_s
    assert report.goodput > 0.0


def test_run_open_loop_admission_shedding(live):
    g, params, images, _ = live
    # an SLO no real server can meet: the controller sheds everything
    ctrl = QueueController(
        QueuePolicy(slo_p99_s=1e-9, shed_headroom=1.0),
        base_latency_s=1.0,
        service_s=0.01,
    )
    trace = poisson_trace(100.0, n=10, seed=1)
    with PipelineServer(g, params, _one_stage(g), batch_size=2, device="cpu") as srv:
        report = run_open_loop(srv, trace, images, controller=ctrl)
    assert report.shed_admission == 10
    assert report.submitted == report.completed == 0
    assert ctrl.shed == 10


def test_run_open_loop_validation(live):
    g, params, images, _ = live
    trace = poisson_trace(1.0, n=1)
    with pytest.raises(ValueError):
        run_open_loop(None, trace, [])
    with pytest.raises(ValueError):
        run_open_loop(None, trace, images, timescale=0.0)


@pytest.mark.parametrize("controlled", [False, True], ids=["plain", "queue_controller"])
def test_open_loop_outputs_equal_single_stage_and_the_reference(live, controlled):
    """Micro-batch 1, a two-stage plan: every admitted arrival completes,
    each output bitwise equal to the port's single-stage engine on its
    image and within the reference's bar of the reference's engine.  With
    a generous SLO the queue controller admits everything and retunes the
    flush timeout on the way."""
    g, params, images, (ref_g, ref_params) = live
    n = len(g.descriptors())
    plan = PipelinePlan(Pipeline((("B", 2), ("s", 2))), (tuple(range(2)), tuple(range(2, n))))
    trace = poisson_trace(60.0, n=24, seed=4)
    ctrl = (QueueController(QueuePolicy(slo_p99_s=30.0), base_latency_s=0.01, service_s=0.01)
            if controlled else None)
    with PipelineServer(g, params, plan, batch_size=1, flush_timeout_s=0.0, queue_depth=32,
                        backend="cuda_fused", device="cpu") as srv:
        srv.warmup()
        rec = _Recording(srv, images)
        report = run_open_loop(rec, trace, images, controller=ctrl, result_timeout_s=60.0)
    assert report.offered == trace.n
    assert report.shed_admission == report.shed_backpressure == 0
    assert report.submitted == report.completed == len(rec.tickets) == trace.n
    assert [i for i, _ in rec.tickets] == [z % len(images) for z in range(trace.n)]
    single = SingleStageEngine(g, params, backend="cuda_fused", device="cpu").run(images)["outputs"]
    ref = ref_serving.SingleStageEngine(ref_g, ref_params).run([jnp.asarray(x) for x in images])
    for i, t in rec.tickets:
        got = t.result(timeout=0)
        assert torch.equal(got, single[i])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref["outputs"][i]), rtol=RTOL, atol=ATOL)
