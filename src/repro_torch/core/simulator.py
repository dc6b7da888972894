"""Discrete-event simulator for a layer-level pipeline (paper §III-B).

Validates the steady-state throughput formula (Eq. 12) including pipeline
fill/drain and inter-stage activation transfer over the cluster boundary
(the CCI on big.LITTLE, an ICI hop between TPU stage groups).

Model: each stage is a server with a single-slot output register; image z
can start on stage i once (a) stage i finished image z-1 and (b) stage i-1
has delivered image z (service + boundary transfer when the stage's core
type differs — same-cluster handoffs stay inside the shared L2 and are
free, which is precisely the paper's motivation for layer-level splits).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence

from .pipeline import PipelinePlan, TimeMatrix
from .platform import HeteroPlatform
from .queueing import empirical_percentile


class SimulatedClock:
    """A virtual monotone clock for deterministic control-loop runs.

    The adaptive runtime (serving/adaptive.py) periodically samples a
    clock; under test the discrete-event simulator advances this one by
    each round's makespan instead of waiting wall time, so every run of
    the calibrate -> detect -> re-plan loop is exactly reproducible.
    The interface is the subset of ``time`` the runtime uses: ``now()``
    (a perf_counter analogue) and ``sleep()`` (which simply advances).
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("clock cannot go backwards")
        with self._lock:
            self._now += dt
            return self._now

    def sleep(self, dt: float) -> None:
        self.advance(max(dt, 0.0))


@dataclasses.dataclass
class SimResult:
    makespan_s: float
    steady_throughput: float  # from the last half of the stream
    overall_throughput: float  # n_images / makespan
    stage_busy_s: List[float]
    finish_times: List[float]
    # DVFS / power accounting (0.0 when the platform has no power model or
    # no stage_freqs were assigned): active energy over the whole stream
    # and its average over the makespan — the quantities power caps and
    # the throughput/watt objective are stated in.
    energy_j: float = 0.0
    avg_power_w: float = 0.0
    # Open-loop accounting (present for closed-loop runs too: with all
    # arrivals at t=0 the "latency" of image z includes waiting behind its
    # z-1 predecessors, i.e. the saturation sojourn time).
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    latency_p50_s: float = 0.0
    latency_p95_s: float = 0.0
    latency_p99_s: float = 0.0
    shed: int = 0  # arrivals rejected by the admission callback
    # stage_free at the end of the run: the queue state to carry into the
    # next simulation window (``simulate(initial_free=...)``) so windowed
    # control loops see backlogs survive across control decisions.
    stage_free_s: List[float] = dataclasses.field(default_factory=list)
    # Fault injection accounting (``simulate(faults=...)``): scheduled
    # events that fired and the total downtime (backoffs, restarts,
    # stalls) they added on top of useful service time.
    fault_events: int = 0
    fault_delay_s: float = 0.0


def simulate(
    plan: PipelinePlan,
    T: TimeMatrix,
    platform: HeteroPlatform,
    n_images: int = 50,
    boundary_bytes: Optional[Sequence[int]] = None,
    stage_freqs: Optional[Sequence[Optional[float]]] = None,
    arrival_s: Optional[Sequence[float]] = None,
    initial_free: Optional[Sequence[float]] = None,
    admit: Optional[Callable[[float, float], bool]] = None,
    faults=None,
) -> SimResult:
    """Simulate ``n_images`` flowing through the pipeline.

    ``boundary_bytes[i]`` is the activation size crossing the boundary
    between stage i and i+1 (0 => same cluster / negligible).

    ``stage_freqs`` assigns each stage an OPP of its cluster (see
    ``platform.freq_levels``): service times scale by ``(f_max/f)^kappa``
    and each stage's busy time is charged the cluster's active power at
    that OPP, filling ``SimResult.energy_j``/``avg_power_w`` — the
    simulator-side ground truth the power-aware DSE is validated against.

    ``arrival_s`` switches the run open-loop: an ascending sequence of
    absolute arrival times (e.g. ``serving.loadgen.poisson_trace().times``)
    replaces the closed-loop "enter as soon as stage 0 frees up" rule, and
    ``SimResult`` reports per-image latency (finish - arrival) percentiles
    — the ground truth ``core.queueing.predict_latency`` is validated
    against.  ``n_images`` is ignored when a trace is given.

    ``initial_free`` seeds per-stage busy-until times (from a previous
    window's ``stage_free_s``) so windowed control loops carry queue state.
    ``admit(arrival_time, predicted_wait_s)`` is consulted per arrival;
    returning False sheds the image (counted in ``SimResult.shed``) —
    the hook the queue-aware admission controller plugs into.

    ``faults`` injects a deterministic fault schedule: a
    ``serving.faults.FaultPlan`` (or a pre-built ``FaultInjector`` —
    duck-typed on ``.injector()``/``.sim_delay()`` so ``core`` never
    imports the serving package).  Each stage invocation consults the
    injector and pays the recovery delay its policy implies (retry
    backoffs, restart + re-dispatch, stall detection) — the same
    per-stage invocation ordinals the live wrapped stage fns consume,
    so a scenario reproduces identically in both worlds.  No image is
    ever lost: faults only delay; ``SimResult.fault_events`` /
    ``fault_delay_s`` account for them.
    """
    p = plan.pipeline.p
    service = plan.stage_times(T)
    stage_power = [0.0] * p
    if stage_freqs is not None:
        if len(stage_freqs) != p:
            raise ValueError(f"{len(stage_freqs)} stage_freqs for {p} stages")
        service = [
            t * platform.freq_scale(stage[0], f)
            for t, stage, f in zip(service, plan.pipeline.stages, stage_freqs)
        ]
        stage_power = [
            platform.active_power_w(stage[0], stage[1], f)
            for stage, f in zip(plan.pipeline.stages, stage_freqs)
        ]
    if boundary_bytes is None:
        boundary_bytes = [0] * max(p - 1, 0)

    transfer = []
    for i in range(p - 1):
        (ta, _), (tb, _) = plan.pipeline.stages[i], plan.pipeline.stages[i + 1]
        nbytes = boundary_bytes[i]
        # Same-cluster handoff stays in the shared L2: no CCI crossing.
        transfer.append(platform.transfer_time(nbytes) if ta != tb and nbytes else 0.0)

    if arrival_s is None:
        # Closed loop: every image is already waiting at t=0; image z
        # enters stage 0 the moment it frees up (start = max(0, free)).
        arrivals: Sequence[float] = [0.0] * n_images
    else:
        arrivals = list(arrival_s)
        for a, b in zip(arrivals, arrivals[1:]):
            if b < a:
                raise ValueError("arrival_s must be ascending")
        if arrivals and arrivals[0] < 0.0:
            raise ValueError("arrival times must be >= 0")

    # stage_free[i] = time stage i finishes its current image
    if initial_free is not None:
        if len(initial_free) != p:
            raise ValueError(f"{len(initial_free)} initial_free for {p} stages")
        stage_free = [float(x) for x in initial_free]
    else:
        stage_free = [0.0] * p
    finish: List[float] = []
    latencies: List[float] = []
    busy = [0.0] * p
    shed = 0
    # Duck-typed fault schedule: FaultPlan grows a fresh injector per
    # run; a caller-built injector is used as-is (shared counters).
    inj = None
    if faults is not None:
        inj = faults.injector() if hasattr(faults, "injector") else faults
    fault_delay = 0.0

    for a in arrivals:
        if admit is not None and not admit(a, max(stage_free[0] - a, 0.0)):
            shed += 1
            continue
        t = a
        for i in range(p):
            extra = inj.sim_delay(i) if inj is not None else 0.0
            start = max(t, stage_free[i])
            # Injected downtime (retries, restart + re-dispatch, stalls)
            # extends this image's occupancy of the stage but is not
            # useful busy time (occupancy/energy stay service-based).
            end = start + service[i] + extra
            busy[i] += service[i]
            fault_delay += extra
            stage_free[i] = end
            t = end + (transfer[i] if i < p - 1 else 0.0)
        finish.append(t)
        latencies.append(t - a)

    n_done = len(finish)
    makespan = finish[-1] if finish else 0.0
    half = max(1, n_done // 2)
    if n_done > half:
        steady = (n_done - half) / max(finish[-1] - finish[half - 1], 1e-12)
    else:
        steady = n_done / max(makespan, 1e-12)
    energy = sum(pw * b for pw, b in zip(stage_power, busy))
    return SimResult(
        makespan_s=makespan,
        steady_throughput=steady,
        overall_throughput=n_done / max(makespan, 1e-12),
        stage_busy_s=busy,
        finish_times=finish,
        energy_j=energy,
        avg_power_w=energy / max(makespan, 1e-12),
        latencies_s=latencies,
        latency_p50_s=empirical_percentile(latencies, 50.0),
        latency_p95_s=empirical_percentile(latencies, 95.0),
        latency_p99_s=empirical_percentile(latencies, 99.0),
        shed=shed,
        stage_free_s=list(stage_free),
        fault_events=inj.total_fired if inj is not None else 0,
        fault_delay_s=fault_delay,
    )
