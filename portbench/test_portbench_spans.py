"""The span log beside the device trace (``spans.py``) and the span
metrics' readers, on synthetic spans and operations with known answers
(CPU)."""
import functools
import time

import pytest

from portbench import bench, spans as S, traffic
from portbench.trace import DeviceOp
from repro_torch.serving import metrics

OFF = 1_000_000_000  # the profiler's clock, this far past perf_counter_ns
METRICS = ("stage_device_balance.offline", "handoff_p50_ms.offline", "ingress_gather_share.offline")


def Span(name, mb, stage, thread, a, b):
    return metrics.Span(name, mb, stage, thread, a, b)


def _call(tid, corr, a, b=None, name="cudaGraphLaunch"):
    return S.RuntimeCall(name, a + OFF, (b if b is not None else a + 100) + OFF, tid, corr)


def _op(a, b, corr, stream=7):
    return DeviceOp(a + OFF, b + OFF, "k", True, corr, stream)


def test_clock_offset_is_the_unix_clock_less_perf_counter():
    want = time.time_ns() - time.perf_counter_ns()
    assert abs(S.clock_offset() - want) < 5_000_000


def test_a_span_names_its_thread_as_the_profiler_does():
    # kineto's resource id of a runtime call: the pthread id's low 32 bits, signed
    span = metrics.Span("stage0.launch", 0, 0, 0x7FAECF9FF6C0, 0, 1)
    assert S.thread_of(span) == -811600192 & S.THREAD_MASK


def test_mapped_launch_spans_hold_the_graph_launches_of_their_thread():
    spans = [Span("stage0.launch", 0, 0, 100, 1000, 2000), Span("stage0.launch", 1, 0, 100, 5000, 6000),
             Span("stage0.sync", 0, 0, 100, 2000, 4000)]
    calls = [_call(100, 1, 1500, 1600), _call(100, 2, 5100, 5200),
             _call(200, 3, 1500, 1600),  # another thread: not inside
             _call(100, 4, 2300, 2400),  # in the sync, 0.4 us past the launch span
             _call(100, 5, 2500, 2600, name="cudaLaunchKernel"),  # not a graph launch
             _call(100, 6, 9000, 9100)]  # outside the window
    got = S.clock_check(S.shifted(spans, OFF), calls, OFF, OFF + 8000)
    assert got == {"graph_launches": 4, "inside_share": 0.5, "median_residual_us": 0.0,
                   "median_lead_us": pytest.approx(0.3)}
    unmapped = S.clock_check(spans, calls, OFF, OFF + 8000)
    assert unmapped["inside_share"] == 0.0 and unmapped["median_residual_us"] == pytest.approx(OFF * 1e-3, rel=1e-5)


def _idle_scene():
    """Window [0, 120 us]: device busy 55 us; gaps of 10, 20, 20, 5 and 10 us."""
    ops = [_op(0, 10_000, 1), _op(20_000, 30_000, 2), _op(50_000, 60_000, 3, stream=9),
           _op(80_000, 90_000, 4), _op(95_000, 100_000, 5), _op(110_000, 120_000, 6)]
    calls = [_call(100, 2, 19_000), _call(200, 3, 49_000), _call(100, 4, 79_000), _call(100, 5, 94_000)]
    spans = [
        Span("stage0", 0, 0, 100, 8_000, 31_000),
        Span("stage0.stack", 0, 0, 100, 9_000, 12_000),
        Span("stage0.launch", 0, 0, 100, 12_000, 21_000),
        Span("stage0", 1, 0, 100, 85_000, 99_000),
        Span("stage1", 0, 1, 200, 25_000, 60_000),
        Span("stage1.launch", 0, 1, 200, 45_000, 51_000),
    ]
    pauses = [(70_000 + OFF, 75_000 + OFF), (89_000 + OFF, 96_000 + OFF)]
    return ops, calls, S.shifted(spans, OFF), pauses


def test_each_idle_gap_goes_to_the_span_its_launching_thread_had_open():
    ops, calls, spans, pauses = _idle_scene()
    got = S.idle_by_span(ops, calls, spans, pauses, OFF, OFF + 120_000)
    # the gap at 60-80 us began outside a collection and holds one of 5 us
    want = {"stage1": 20e-6, S.BETWEEN: 15e-6, "stage0.stack": 10e-6, S.UNTRACED: 10e-6, S.GC: 10e-6}
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(65e-6)
    # a gap begun in a collection that outlasts it: the rest goes to the open span
    got = S.idle_by_span(ops, calls, spans, [(89_000 + OFF, 93_000 + OFF)], OFF, OFF + 120_000)
    assert got[S.GC] == pytest.approx(3e-6) and got["stage0"] == pytest.approx(2e-6)


def test_each_stage_finds_its_stream_and_its_busy_seconds():
    ops, calls, spans, _ = _idle_scene()
    assert S.stage_streams(spans, calls, ops) == {0: 7, 1: 9}
    got = S.stage_device_seconds(spans, calls, ops, OFF, OFF + 120_000)
    # every op on stream 7, its launcher traced or not; the window cuts none
    assert got == pytest.approx({0: 45e-6, 1: 10e-6})
    assert S.stage_device_seconds(spans, calls, ops, OFF + 5_000, OFF + 55_000) == pytest.approx({0: 15e-6, 1: 5e-6})
    # a stage whose thread launched nothing the trace shows has no stream
    stage2 = spans + S.shifted([Span("stage2", 0, 2, 300, 60_000, 70_000)], OFF)
    assert S.stage_device_seconds(stage2, calls, ops, OFF, OFF + 120_000)[2] is None


def _pipeline_spans():
    """Three micro-batches through two stages; the window is [0, 1 ms]."""
    k = 1000
    out = []
    for mb, (w, f, sync_end, l1, h1_end, s1_end) in enumerate([
        ((-100 * k, 50 * k), (50 * k, 100 * k), 380 * k, 400 * k, 480 * k, 500 * k),
        ((300 * k, 310 * k), (310 * k, 320 * k), 600 * k, 700 * k, 790 * k, 800 * k),
        ((900 * k, 1100 * k), (1100 * k, 1110 * k), 1150 * k, 1200 * k, 1290 * k, 1300 * k),
    ]):
        out += [
            Span("stage0.wait", mb, 0, 1, *w), Span("stage0.fill", mb, 0, 1, *f),
            Span("stage0.sync", mb, 0, 1, sync_end - 10 * k, sync_end),
            Span("stage1.launch", mb, 1, 2, l1, l1 + 5 * k),
            Span("stage1.handoff", mb, 1, 2, h1_end - 5 * k, h1_end),
            Span("stage1", mb, 1, 2, l1 - 10 * k, s1_end),
        ]
    return out


def _cell():
    return bench.Cell.of(bench.load_spec(), "vgg16.offline.card.b32", "vgg16", "offline.card.b32")


def _run(spans=None, device_s=None):
    cell = _cell()
    run = bench.Run(cell, traffic.Window("offline", t0=0.0, t1=0.001), cell.counts.layers(), 32, 1.0)
    if spans is not None:
        run.spans = spans
    if device_s is not None:
        run.stage_device_s = device_s
    return run


def test_the_span_metrics_read_their_known_answers():
    run = _run(_pipeline_spans(), {0: 3.0, 1: 2.0})
    got = {m: bench.load_reader("layers", m).read(run) for m in METRICS}
    # device: the mean of 3 and 2 s over 3 s
    # handoff: 400 - 380 us; 700 - max(600, 480) us; the third starts past the window
    # gather: 50 + 50 us of the first, 10 + 10 of the second, 100 of the third's wait, in 1 ms
    assert got == pytest.approx({"stage_device_balance.offline": 2.5 / 3,
                                 "handoff_p50_ms.offline": 0.02,
                                 "ingress_gather_share.offline": 22.0})
    assert sorted(S.handoff_delays_ns(run.spans, 0, 1_000_000)) == [20_000, 100_000]


@pytest.mark.parametrize("spans,device_s", [(None, None), ([], {})], ids=["no_span_log", "empty"])
def test_the_span_metrics_find_nothing_without_spans(spans, device_s):
    run = _run(spans, device_s)
    assert all(bench.load_reader("layers", m).read(run) is None for m in METRICS)


def test_device_balance_needs_every_stages_device_seconds():
    assert S.stage_device_balance({0: 3.0, 1: None}) is None
    assert S.stage_device_balance({0: 0.0, 1: 0.0}) is None
    assert S.stage_device_balance({0: 2.0}) == 1.0


def test_spantrace_hands_the_readers_what_it_captured():
    """``spantrace.py``'s run: made by the harness in the window's stead,
    it gives the span metrics the captured spans and device seconds, and
    its metrics are entries ``BENCHMARK.json`` could take as they are."""
    from portbench import spantrace as T

    capture = T.Capture(16)
    capture.records, capture.device_s = _pipeline_spans(), {0: 3.0, 1: 2.0}
    cell = _cell()
    run = functools.partial(T.SpanRun, capture=capture)(
        cell, traffic.Window("offline", t0=0.0, t1=0.001), cell.counts.layers(), 32, 1.0)
    assert capture.run is run
    got = {m["name"]: bench.load_reader("layers", m["name"]).read(run) for m in T.SPAN_METRICS}
    assert got == pytest.approx({"stage_device_balance.offline": 2.5 / 3, "handoff_p50_ms.offline": 0.02,
                                 "ingress_gather_share.offline": 22.0})
    keys = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    spec = bench.load_spec()
    assert all(set(m) == keys for m in T.SPAN_METRICS)
    assert not {m["name"] for m in T.SPAN_METRICS} & {m["name"] for m in spec["per_layer"]}
    assert {m["layer"] for m in T.SPAN_METRICS} - {m["layer"] for m in spec["per_layer"]} == {"ingress"}


def test_the_collection_timer_outlasts_the_windows_close(monkeypatch):
    """A full collection runs finalizers, during which the harness's
    thread can close the window: the tracer's stop leaves the collection
    timer on, so a collection begun in the window is timed to its end,
    and reading the trace turns the timer off."""
    import gc

    from portbench import spantrace as T

    monkeypatch.setattr(bench.Tracer, "start", lambda self: None)
    monkeypatch.setattr(bench.Tracer, "stop", lambda self: None)
    monkeypatch.setattr(bench.Tracer, "events", lambda self: ([], {}))
    monkeypatch.setattr(S, "runtime_calls", lambda prof: [])
    capture = T.Capture(16)
    monkeypatch.setattr(capture, "read_trace", lambda ops, calls: None)
    capture.server = type("Server", (), {"metrics": metrics.ServerMetrics(["s0", "s1"])})()
    tracer = T.SpanTracer(capture)
    tracer.start()
    tracer.stop()
    assert capture.pauses._note in gc.callbacks
    gc.collect()
    assert capture.pauses.spans and capture.pauses.spans[-1][0] == 2
    tracer.events()
    assert capture.pauses._note not in gc.callbacks
