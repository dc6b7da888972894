"""The readers and the traffic schedule on synthetic windows (CPU)."""
import random

import pytest

from portbench import bench, trace, traffic
from portbench import yardstick as Y


def _offline(done_times, t0=0.0, t1=10.0):
    w = traffic.Window("offline", t0=t0, t1=t1)
    for i, t in enumerate(done_times):
        r = traffic.Request(i, i % 4, due=t - 0.05, submitted=t - 0.05, done_at=t, output=object())
        w.requests.append(r)
    return w


def _run(window):
    cell = bench.Cell.of(bench.load_spec(), "vgg16.offline.card.b32", "vgg16", "offline.card.b32")
    return bench.Run(cell, window, cell.counts.layers(), 32, 1.0)


def _poisson(latencies, stall_at=None, stall_s=0.0):
    w = traffic.Window("poisson", t0=0.0, t1=10.0)
    for i, lat in enumerate(latencies):
        due = i * 0.01
        done = due + lat
        if stall_at is not None and due >= stall_at:
            done = max(done, stall_at + stall_s + lat)
        w.requests.append(traffic.Request(i, 0, due=due, submitted=due, done_at=done, output=object()))
    return w


def test_a_stall_lowers_the_rate_and_raises_the_p95():
    img = bench.load_reader("e2e", "img_per_s")
    p95 = bench.load_reader("e2e", "p95_ms")
    steady = [0.01 * i for i in range(1, 1000)]
    stalled = [t if t < 5.0 else t + 2.0 for t in steady]
    assert img.read(_run(_offline(stalled))) < img.read(_run(_offline(steady)))
    lat = [0.02] * 1000
    calm, hit = _poisson(lat), _poisson(lat, stall_at=4.0, stall_s=1.0)
    assert p95.read(_run(hit)) > p95.read(_run(calm)) == pytest.approx(20.0)


def test_queue_wait_is_the_median_ingress_wait_in_ms():
    w = _poisson([0.02] * 5)
    for r, q in zip(w.requests, (0.001, 0.004, 0.002, None, 0.003)):
        r.queued_s = q
    assert bench.load_reader("layers", "queue_wait_p50_ms.server").read(_run(w)) == pytest.approx(2.0)


def test_a_miss_sits_above_every_latency():
    w = _poisson([0.02] * 100)
    for r in w.requests[:6]:
        r.output, r.shed = None, True
    assert bench.load_reader("e2e", "p95_ms").read(_run(w)) == pytest.approx(1e3 * (10.0 + traffic.DRAIN_S))


def test_poisson_schedule_offers_every_seed_the_same_gaps():
    mix = {"rate": 500.0, "preroll_s": 1.0, "postroll_s": 0.25}
    a, win_a = traffic.schedule(mix, 10.0, 1)
    b, win_b = traffic.schedule(mix, 10.0, 2**31 + 7)
    assert win_a == win_b == (1.0, 11.0)
    assert len(a) == len(b) == 500 + 5000 + 125
    assert sum(w for _, w in a) == sum(w for _, w in b) == 5000
    assert a != b and a[-1][0] == pytest.approx(11.25) == b[-1][0]


def test_gaps_are_one_set_in_the_seeds_order_filling_their_segment():
    g, h = traffic.gaps(1000, 2.0, random.Random(0)), traffic.gaps(1000, 2.0, random.Random(1))
    assert sum(g) == pytest.approx(2.0) and min(g) > 0
    assert g != h and sorted(g) == pytest.approx(sorted(h))


def test_trace_summary_reads_busy_time_and_names_gaps():
    ms = 1_000_000
    ops = [trace.DeviceOp(0, 4 * ms, "k1", True, 1), trace.DeviceOp(2 * ms, 5 * ms, "k2", True, 2),
           trace.DeviceOp(7 * ms, 8 * ms, "Memcpy HtoD", False, 3, 7), trace.DeviceOp(9 * ms, 12 * ms, "k1", True, 4)]
    calls = {3: trace.HostCall("cudaMemcpyAsync", 6 * ms)}
    s = trace.summarize(ops, calls, 1 * ms, 10 * ms)
    assert s["window_s"] == pytest.approx(9e-3)
    assert s["busy_s"] == pytest.approx(6e-3)  # [1,5] + [7,8] + [9,10]
    assert s["kernel_busy_s"] == pytest.approx(5e-3)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"cudaMemcpyAsync@stream7": 2e-3, "no_traced_host_call": 1e-3})
    assert dict(s["breakdown"]["device_ops"])["k1"] == pytest.approx(4e-3)


def test_layer_readers_find_nothing_without_a_trace():
    run = _run(_offline([0.01 * i for i in range(1, 100)]))
    for name in ("kernel_roofline.offline", "mfu.offline", "device_idle_share.offline"):
        assert bench.load_reader("layers", name).read(run) is None


def test_roofline_and_mfu_stay_under_their_peaks_on_a_busy_window():
    run = _run(_offline([0.01 * i for i in range(1, 1000)]))
    run.trace = {"busy_s": 10.0, "kernel_busy_s": 10.0, "window_s": 10.0}
    roof = bench.load_reader("layers", "kernel_roofline.offline").read(run)
    mfu = bench.load_reader("layers", "mfu.offline").read(run)
    _, bound = Y.totals(run.layers, 32)
    assert roof == pytest.approx(100 * 999 * bound / 32 / 10.0)
    # 30.94 GFLOP an image
    assert mfu == pytest.approx(100 * 999 * 30.94052864e9 / (10.0 * 989e12))
    assert 0 < roof < 100 and 0 < mfu < 100


def test_the_pool_stays_where_the_mix_puts_its_ingress():
    cell = bench.Cell.of(bench.load_spec(), "vgg16.offline.card.b32", "vgg16", "offline.card.b32")
    cell.config["input"], cell.mix["pool"] = [8, 8, 3], 5
    card = bench.pool_images(cell, 2**31 + 1, "cpu")
    cell.mix["ingress"] = "host"
    host = bench.pool_images(cell, 2**31 + 1, "cpu")
    assert len(card) == len(host) == 5 and all(a.equal(b) for a, b in zip(card, host))
    cell.mix["ingress"] = "pinned"
    with pytest.raises(ValueError):
        bench.pool_images(cell, 2**31 + 1, "cpu")
