"""Open-loop load generation: seedable arrival traces + a trace driver.

The paper's evaluation (and our closed-loop benchmarks) measure
*saturation* throughput: the next image is submitted the moment the
pipeline can take it, so the load adapts to the server and queues never
build.  Production traffic is the opposite — an **open-loop** process:
arrivals happen whether or not the board is ready, and the latency an
operator answers for is queue wait + pipeline time at the tail.  This
module generates those arrival processes, deterministically:

* :func:`poisson_trace`   — homogeneous Poisson at ``rate`` img/s.
* :func:`mmpp_trace`      — 2-state Markov-modulated Poisson (calm/burst
  phases with exponential dwells) — the bursty-traffic stressor.
* :func:`diurnal_trace`   — inhomogeneous Poisson with a sinusoidal
  day-curve, generated by thinning.
* :class:`ArrivalTrace`   — the value all of them produce: an ascending
  tuple of absolute arrival times + provenance metadata, JSON
  round-trippable for replay (``save``/``load``).

One trace drives BOTH execution paths identically:

* ``simulate(plan, T, platform, arrival_s=trace.times)`` — the
  discrete-event simulator (deterministic ground truth; what
  tests/benchmarks assert against).
* :func:`run_open_loop` — the live :class:`~repro_torch.serving.server.
  PipelineServer`: submissions are paced to the trace's arrival times
  (optionally time-scaled), full queues shed via ``Backpressure``, and an
  optional queue-aware controller (``serving.adaptive.QueueController``)
  gets to refuse admissions and retune the flush timeout.

Every generator takes a ``seed`` and uses a private ``random.Random`` —
the same seed always yields the identical trace (tests/test_loadgen.py).

The port's copy of ``repro/serving/loadgen.py``.  The generators are pure
Python over the same draws, so one seed gives the JAX package's trace,
time for time, and a trace saved by either package loads in the other.
:func:`run_open_loop` paces the port's server: on the card each submit
copies its image to the device before it enqueues it, and the pacing
thread shares the interpreter lock with the stage workers, so a
submission can land after its arrival time (never before).
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .metrics import percentile
from .server import Backpressure, PipelineServer, Ticket


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """An open-loop arrival process: ascending absolute times (seconds).

    ``kind`` and ``meta`` record provenance (generator + parameters) so a
    saved trace documents the experiment that produced it.
    """

    times: Tuple[float, ...]
    kind: str = "replay"
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        for a, b in zip(self.times, self.times[1:]):
            if b < a:
                raise ValueError("arrival times must be ascending")
        if self.times and self.times[0] < 0.0:
            raise ValueError("arrival times must be >= 0")

    @property
    def n(self) -> int:
        return len(self.times)

    @property
    def duration_s(self) -> float:
        return self.times[-1] if self.times else 0.0

    def offered_rate(self) -> float:
        """Mean offered load over the trace's span (img/s).

        An empty trace offers no load: 0.0 (documented value, not an
        error, so "no arrivals this window" reads as zero demand).  A
        non-empty trace whose span is zero (a single arrival at t=0, or
        an instantaneous burst) has no finite mean rate — that used to
        silently return ``n / 1e-12`` (~1e12 img/s) and poison any
        control law fed from it; it now raises ``ValueError``.
        """
        if not self.times:
            return 0.0
        if self.duration_s <= 0.0:
            raise ValueError(
                f"offered_rate() undefined for a zero-duration trace "
                f"({self.n} arrival(s) all at t=0); scale or window the "
                f"trace to a positive span first"
            )
        return self.n / self.duration_s

    def window(self, start_s: float, end_s: float) -> Tuple[float, ...]:
        """Arrivals with start_s <= t < end_s (for windowed control loops)."""
        if end_s < start_s:
            raise ValueError(f"window [{start_s}, {end_s}) has end < start")
        return tuple(t for t in self.times if start_s <= t < end_s)

    def scaled(self, factor: float) -> "ArrivalTrace":
        """Uniformly dilate time (factor > 1 slows the trace down).

        Provenance composes: ``meta["time_scale"]`` is the CUMULATIVE
        dilation relative to the original trace, so
        ``tr.scaled(2).scaled(3)`` records 6.0 — an earlier version
        overwrote the key with the last factor, losing the provenance
        the replay files exist to carry.
        """
        if factor <= 0.0:
            raise ValueError(f"scale factor {factor} <= 0")
        cumulative = float(self.meta.get("time_scale", 1.0)) * factor
        return ArrivalTrace(
            times=tuple(t * factor for t in self.times),
            kind=self.kind,
            meta={**self.meta, "time_scale": cumulative},
        )

    # ---------------------------------------------------------- JSON replay
    def to_json(self) -> str:
        return json.dumps(
            {"kind": self.kind, "meta": self.meta, "times": list(self.times)}
        )

    @classmethod
    def from_json(cls, text: str) -> "ArrivalTrace":
        d = json.loads(text)
        return cls(
            times=tuple(float(t) for t in d["times"]),
            kind=str(d.get("kind", "replay")),
            meta=dict(d.get("meta", {})),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "ArrivalTrace":
        with open(path) as f:
            return cls.from_json(f.read())


# ------------------------------------------------------------- generators
def poisson_trace(
    rate: float,
    *,
    duration_s: Optional[float] = None,
    n: Optional[int] = None,
    seed: int = 0,
) -> ArrivalTrace:
    """Homogeneous Poisson arrivals at ``rate`` img/s: i.i.d. exponential
    gaps.  Give either a duration or an arrival count."""
    if rate <= 0.0:
        raise ValueError(f"rate {rate} <= 0")
    if (duration_s is None) == (n is None):
        raise ValueError("give exactly one of duration_s / n")
    rng = random.Random(seed)
    times: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate)
        if duration_s is not None and t > duration_s:
            break
        times.append(t)
        if n is not None and len(times) >= n:
            break
    return ArrivalTrace(
        times=tuple(times),
        kind="poisson",
        meta={"rate": rate, "seed": seed, "duration_s": duration_s, "n": n},
    )


def mmpp_trace(
    calm_rate: float,
    burst_rate: float,
    *,
    duration_s: float,
    calm_s: float,
    burst_s: float,
    seed: int = 0,
) -> ArrivalTrace:
    """2-state Markov-modulated Poisson process: the trace alternates calm
    and burst phases with exponentially-distributed dwell times (means
    ``calm_s`` / ``burst_s``), emitting Poisson arrivals at the phase's
    rate.  Generated by thinning against the envelope rate, so phase
    switches mid-gap are handled exactly.  Phase intervals are recorded in
    ``meta["phases"]`` as ``[start, end, rate]`` triples — the governor
    tests use them to check behaviour inside a known burst.
    """
    if min(calm_rate, burst_rate) <= 0.0:
        raise ValueError("rates must be > 0")
    if min(calm_s, burst_s, duration_s) <= 0.0:
        raise ValueError("durations must be > 0")
    rng = random.Random(seed)
    # phase schedule first (its own draws), then thinning over it
    phases: List[List[float]] = []
    t, calm = 0.0, True
    while t < duration_s:
        dwell = rng.expovariate(1.0 / (calm_s if calm else burst_s))
        end = min(t + dwell, duration_s)
        phases.append([t, end, calm_rate if calm else burst_rate])
        t, calm = end, not calm
    envelope = max(calm_rate, burst_rate)

    def rate_at(when: float) -> float:
        for s, e, r in phases:
            if s <= when < e:
                return r
        return phases[-1][2]

    times: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(envelope)
        if t > duration_s:
            break
        if rng.random() < rate_at(t) / envelope:
            times.append(t)
    return ArrivalTrace(
        times=tuple(times),
        kind="mmpp",
        meta={
            "calm_rate": calm_rate, "burst_rate": burst_rate,
            "calm_s": calm_s, "burst_s": burst_s,
            "duration_s": duration_s, "seed": seed, "phases": phases,
        },
    )


def diurnal_trace(
    base_rate: float,
    peak_rate: float,
    *,
    period_s: float,
    duration_s: float,
    seed: int = 0,
) -> ArrivalTrace:
    """Inhomogeneous Poisson with a sinusoidal intensity (trough at t=0,
    peak at half-period) — a compressed day curve, by thinning."""
    if not 0.0 < base_rate <= peak_rate:
        raise ValueError("need 0 < base_rate <= peak_rate")
    if min(period_s, duration_s) <= 0.0:
        raise ValueError("durations must be > 0")
    rng = random.Random(seed)

    def rate_at(when: float) -> float:
        phase = 0.5 * (1.0 - math.cos(2.0 * math.pi * when / period_s))
        return base_rate + (peak_rate - base_rate) * phase

    times: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak_rate)
        if t > duration_s:
            break
        if rng.random() < rate_at(t) / peak_rate:
            times.append(t)
    return ArrivalTrace(
        times=tuple(times),
        kind="diurnal",
        meta={
            "base_rate": base_rate, "peak_rate": peak_rate,
            "period_s": period_s, "duration_s": duration_s, "seed": seed,
        },
    )


# ----------------------------------------------------------- live driver
@dataclasses.dataclass
class OpenLoopReport:
    """What one open-loop run against the live server produced."""

    offered: int  # arrivals in the trace
    submitted: int  # admitted into the ingress queue
    completed: int
    shed_admission: int  # refused by the queue-aware controller
    shed_backpressure: int  # refused by a full ingress queue
    duration_s: float
    latencies_s: List[float]  # per-completed-ticket, includes queue wait

    @property
    def latency_p50_s(self) -> float:
        return percentile(self.latencies_s, 50)

    @property
    def latency_p95_s(self) -> float:
        return percentile(self.latencies_s, 95)

    @property
    def latency_p99_s(self) -> float:
        return percentile(self.latencies_s, 99)

    @property
    def goodput(self) -> float:
        return self.completed / max(self.duration_s, 1e-12)


def run_open_loop(
    server: PipelineServer,
    trace: ArrivalTrace,
    images: Sequence[Any],
    *,
    controller: Optional[Any] = None,
    timescale: float = 1.0,
    result_timeout_s: float = 120.0,
) -> OpenLoopReport:
    """Pace ``trace`` into a live server: submission z happens at wall
    offset ``trace.times[z] * timescale``, never earlier, whether or not
    the pipeline kept up — the open-loop contract.

    Images are drawn round-robin from ``images``.  A full ingress queue
    sheds (``Backpressure``, non-blocking submit); ``controller`` (duck-
    typed: ``serving.adaptive.QueueController``) may additionally refuse
    admission from the predicted queue wait and retune the server's flush
    timeout as load moves.  Latencies are measured per ticket from its
    enqueue timestamp to its done-callback, so queue wait is included.
    """
    if not images:
        raise ValueError("need at least one image to serve")
    if timescale <= 0.0:
        raise ValueError(f"timescale {timescale} <= 0")
    done: List[Tuple[Ticket, float]] = []
    pending: List[Ticket] = []

    def on_done(t: Ticket, _done=done) -> None:
        _done.append((t, time.perf_counter()))

    shed_admission = shed_backpressure = submitted = 0
    t0 = time.perf_counter()
    for z, arrival in enumerate(trace.times):
        delay = t0 + arrival * timescale - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        now = time.perf_counter()
        if controller is not None:
            controller.observe_arrival(now - t0)
            wait_pred = server.ingress_depth() * controller.service_s
            if not controller.should_admit(wait_pred):
                shed_admission += 1
                continue
            server.set_batching(flush_timeout_s=controller.flush_timeout())
        try:
            ticket = server.submit(images[z % len(images)], block=False)
        except Backpressure:
            shed_backpressure += 1
            continue
        submitted += 1
        pending.append(ticket)
        ticket.add_done_callback(on_done)
    for ticket in pending:
        ticket.result(timeout=result_timeout_s)
    duration = time.perf_counter() - t0
    latencies = [
        (finished - t.submitted_at) / timescale for t, finished in done
    ]
    return OpenLoopReport(
        offered=trace.n,
        submitted=submitted,
        completed=len(done),
        shed_admission=shed_admission,
        shed_backpressure=shed_backpressure,
        duration_s=duration / timescale,
        latencies_s=latencies,
    )
