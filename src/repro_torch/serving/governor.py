"""DvfsGovernor — the runtime half of frequency- and power-aware planning.

The power-aware DSE (``repro_torch.core.dse.power_aware_search``) emits a
:class:`~repro_torch.core.dse.PowerAwarePlan`: a layer allocation plus a
per-stage OPP assignment in which non-bottleneck stages are down-clocked
to the slack-matched level (a stage never clocks above what the
bottleneck needs).  This module *applies* that assignment to a running
:class:`~repro_torch.serving.server.PipelineServer` and keeps it true as the
world changes:

* **Application** — on real silicon this writes
  ``scaling_setspeed``/``userspace`` per cluster; this container has no
  asymmetric DVFS silicon, so frequencies are simulated through the same
  speed-factor mechanism the fake-stage boards use
  (:func:`governed_stage_fn_builder` scales each stage's scripted delay
  by the cluster's ``(f_max/f)^kappa`` factor, live — a clock change
  takes effect on the very next micro-batch, no rebuild).  Recorded in
  DESIGN.md §7 as a hardware-adaptation assumption.
* **Observation normalization** — a down-clocked stage is slower *by
  design*; before its measured service times reach the
  :class:`~repro_torch.serving.adaptive.OnlineCalibrator` they are divided by
  the stage's assigned frequency scale, so the calibrated matrix stays
  in f_max units and DVFS cannot masquerade as cluster drift (the
  pre-DVFS loop treated exactly this as an unmodeled disturbance).
* **Throttle events** — ``throttle(new_cap_w)`` is the thermal/battery
  interrupt: the controller re-plans *unconditionally* under the new cap
  on its current calibrated belief (no min-gain gate — the old plan may
  be infeasible under the new envelope), the server hot-swaps via the
  drain-and-switch epoch protocol if the layer allocation changed, and
  the new clocks apply either way.

The drift loop itself stays in
:class:`~repro_torch.serving.adaptive.AdaptiveMonitor`; constructed with
``governor=...`` it normalizes every window and re-applies clocks after
every control decision (frequency-only retunes need no drain).  Wire-up
is :func:`attach_governor`, or ``serve(power_cap_w=...)``.

The port's copy of ``repro/serving/governor.py``.  It controls no clock
of the card: the clocks and watts are the planning platform's modeled
ones (``hikey970()``'s OPP tables), and ``serve(power_cap_w=...)`` runs
the stage functions at full speed (``physical_clocks=False``).
:func:`governed_stage_fn_builder` differs from the reference's as
:func:`~repro_torch.serving.adaptive.delayed_stage_fn_builder` does: it
takes ``backend=``, and on the card its delay is a sleep kernel on the
stage's stream, outside the captured graph.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..core.dse import PowerAwarePlan
from ..core.pipeline import TimeMatrix, stage_time
from ..core.platform import HeteroPlatform, StageConfig
from .adaptive import (
    AdaptiveConfig,
    AdaptiveController,
    AdaptiveMonitor,
    StageDelay,
    StageObservation,
)
from .engine import build_stage_fns
from .server import PipelineServer

__all__ = [
    "DvfsGovernor",
    "attach_governor",
    "governed_stage_fn_builder",
    "run_governed_loop",
    "run_slo_governed_loop",
]


class DvfsGovernor:
    """Owns the live per-stage frequency assignment of one pipeline.

    ``server`` may be ``None`` for simulator-backed runs (the discrete-
    event loop has no pipeline to drain; ``throttle`` then only updates
    the controller's belief and the applied clocks).

    ``physical_clocks`` states whether the stage executables actually HONOR
    the governor's clocks — true on real cpufreq silicon and on the
    governed fake boards (:func:`governed_stage_fn_builder` /
    ``SimulatedServing.observe(stage_freqs=...)``), false when the plan's
    OPPs are planning bookkeeping over full-speed real compute (the
    ``serve(power_cap_w=...)`` default off-board).  Only physical clocks
    may be normalized out of observations — dividing full-speed
    measurements by a fictitious scale would corrupt the calibrator.
    """

    def __init__(
        self,
        platform: HeteroPlatform,
        controller: AdaptiveController,
        server: Optional[PipelineServer] = None,
        physical_clocks: bool = True,
    ):
        if not controller.power_aware:
            raise ValueError(
                "DvfsGovernor needs a power-aware AdaptiveController "
                "(power_cap_w set or objective='throughput_per_watt')"
            )
        self.platform = platform
        self.controller = controller
        self.server = server
        self.physical_clocks = physical_clocks
        self._lock = threading.Lock()
        self._pplan: Optional[PowerAwarePlan] = controller.power_plan
        self.throttle_events = 0

    # ------------------------------------------------------------ clocks
    @property
    def power_plan(self) -> Optional[PowerAwarePlan]:
        with self._lock:
            return self._pplan

    @property
    def power_cap_w(self) -> Optional[float]:
        return self.controller.power_cap_w

    @property
    def stage_freqs(self):
        with self._lock:
            return self._pplan.stage_freqs if self._pplan is not None else ()

    def apply(self, pplan: PowerAwarePlan) -> None:
        """Install a new frequency assignment (the 'write to cpufreq').

        Off-board this is pure bookkeeping read live by
        :func:`governed_stage_fn_builder` closures and
        :meth:`normalize` — effective from the next micro-batch."""
        with self._lock:
            self._pplan = pplan

    def _scale_of(self, layers, stage: StageConfig) -> float:
        with self._lock:
            pplan = self._pplan
        if pplan is None:
            return 1.0
        for al, st, f in zip(
            pplan.plan.allocation, pplan.plan.pipeline.stages, pplan.stage_freqs
        ):
            if st == stage and tuple(al) == tuple(layers):
                return self.platform.freq_scale(st[0], f)
        return 1.0  # stage not in the governed plan (mid-swap window)

    # ------------------------------------------------------ observations
    def normalize(
        self, observations: Sequence[StageObservation]
    ) -> List[StageObservation]:
        """Divide out each stage's assigned frequency scale so service
        times reach the calibrator in f_max units.  A no-op when the
        clocks are not physical (bookkeeping-only plans over full-speed
        compute measure true f_max times already)."""
        if not self.physical_clocks:
            return list(observations)
        out: List[StageObservation] = []
        for o in observations:
            s = self._scale_of(o.layers, o.stage)
            out.append(
                dataclasses.replace(o, service_s=o.service_s / s)
                if s != 1.0
                else o
            )
        return out

    # ---------------------------------------------------------- SLO load
    def set_load(self, arrival_rate: float) -> PowerAwarePlan:
        """The arrival rate moved: retune clocks so the p99 SLO still
        holds at the new load, and apply them.

        Frequency-only (no drain, no swap): the layer allocation stays;
        ``AdaptiveController.set_load`` re-runs the slack-matched
        frequency assignment with the M/D/1 p99 (base latency + waiting
        quantile at ``arrival_rate``) folded into feasibility — so a calm
        phase may down-clock for energy, but a burst *forces* the clocks
        back up before the queue can build.  This is the 'never
        down-clock into an SLO violation' contract: feasibility at the
        CURRENT rate is checked before energy is optimized."""
        pplan = self.controller.set_load(arrival_rate)
        self.apply(pplan)
        return pplan

    # ---------------------------------------------------------- throttle
    def throttle(self, power_cap_w: Optional[float]) -> PowerAwarePlan:
        """A thermal/battery event moved the power envelope: re-plan under
        the new cap NOW and hot-swap if the layer allocation changed.

        Zero tickets are dropped — the swap is the same drain-and-switch
        epoch protocol every adaptive re-plan uses.  Raising the cap back
        un-throttles through the identical path."""
        ctrl = self.controller
        prev_plan, prev_pplan, prev_swaps = ctrl.plan, ctrl.power_plan, ctrl.swaps
        prev_cap = ctrl.power_cap_w
        candidate = ctrl.replan_under_cap(power_cap_w)
        if self.server is not None and candidate.plan != self.server.plan:
            try:
                self.server.swap_plan(candidate.plan)
            except BaseException:
                # Server still runs the old plan: revert the WHOLE belief —
                # plan, clocks, cap, and the history record — so every
                # surface (snapshot, history, swaps) describes what actually
                # runs (same contract as AdaptiveMonitor.step's failure
                # path).  The cap change is still physically in force; the
                # caller sees the raise and re-issues throttle() once the
                # server is healthy.
                ctrl.plan, ctrl.power_plan, ctrl.swaps = (
                    prev_plan, prev_pplan, prev_swaps,
                )
                ctrl.power_cap_w = prev_cap
                if ctrl.history:
                    ctrl.history[-1] = dataclasses.replace(
                        ctrl.history[-1], swapped=False
                    )
                raise
        self.apply(candidate)
        self.throttle_events += 1
        return candidate

    # ------------------------------------------------------------ report
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            pplan = self._pplan
        if pplan is None:
            return {"power_cap_w": self.power_cap_w, "plan": None}
        return {
            "power_cap_w": self.power_cap_w,
            "objective": pplan.objective_name,
            "plan": pplan.notation(),
            "stage_freqs_ghz": [
                None if f is None else round(f / 1e9, 3)
                for f in pplan.stage_freqs
            ],
            "predicted_throughput": pplan.throughput,
            "predicted_avg_power_w": pplan.avg_power_w,
            "predicted_energy_per_image_j": pplan.energy_per_image_j,
            "feasible": pplan.feasible,
            "throttle_events": self.throttle_events,
        }


def governed_stage_fn_builder(
    truth,
    governor: DvfsGovernor,
    scale: float = 1.0,
    sleep: Callable[[float], None] = time.sleep,
    backend=None,
):
    """Fake-stage mode with LIVE frequency scaling: the off-board analogue
    of per-cluster DVFS.

    Like :func:`~repro_torch.serving.adaptive.delayed_stage_fn_builder`, but
    each stage's scripted delay is further multiplied by the governor's
    *current* ``(f_max/f)^kappa`` factor for that stage — so down-clocking
    slows the board immediately (and only timing-wise: outputs stay
    numerically identical to single-stage execution)."""
    delay = StageDelay(sleep)

    def builder(graph, plan):
        real_fns = build_stage_fns(graph, plan, backend=backend)
        fns = []
        for fn, layers, stage in zip(
            real_fns, plan.allocation, plan.pipeline.stages
        ):
            def delayed(params, env, _fn=fn, _layers=tuple(layers), _stage=stage):
                out = _fn(params, env)
                delay(
                    scale
                    * stage_time(truth.T, _layers, _stage)
                    * governor._scale_of(_layers, _stage),
                    next(iter(out.values())),
                )
                return out

            fns.append(delayed)
        return fns

    return builder


def run_governed_loop(
    governor: DvfsGovernor,
    env,
    rounds: int,
    on_swap=None,
) -> List[Dict[str, float]]:
    """Drive the governed control loop against a
    :class:`~repro_torch.serving.adaptive.SimulatedServing` board for
    ``rounds``: observe at the governed clocks, normalize, step the
    controller, re-apply.  Returns per-round ``{throughput, power_w}`` of
    whatever (plan, clocks) were active during each round — the
    deterministic harness behind the governor tests and
    ``benchmarks/power_aware.py``."""
    ctrl = governor.controller
    trajectory: List[Dict[str, float]] = []
    for r in range(rounds):
        pplan = governor.power_plan
        freqs = pplan.stage_freqs if pplan is not None else None
        observations = env.observe(ctrl.plan, stage_freqs=freqs)
        trajectory.append(
            {"throughput": env.last_throughput, "power_w": env.last_power_w}
        )
        new_plan = ctrl.step(governor.normalize(observations))
        if ctrl.power_plan is not None:
            governor.apply(ctrl.power_plan)
        if new_plan is not None and on_swap is not None:
            on_swap(r, new_plan)
    return trajectory


def run_slo_governed_loop(
    governor: DvfsGovernor,
    env,
    trace,
    window_s: float,
    admission=None,
) -> List[Dict[str, Any]]:
    """Windowed SLO-aware DVFS against an open-loop arrival trace.

    Drives an :class:`~repro_torch.serving.adaptive.OpenLoopServing` board
    through ``trace`` in ``window_s`` chunks.  Each window: measure the
    window's offered rate, retune clocks for it (:meth:`DvfsGovernor.
    set_load` — SLO feasibility before energy), then run the window's
    arrivals through the simulator at those clocks, carrying queue state
    into the next window.  ``admission`` (a ``serving.adaptive.
    QueueController``) optionally sheds at the door via
    ``simulate(admit=...)``.

    The rate fed to ``set_load`` is the *current* window's — a same-
    window oracle rather than a trailing estimate.  That is deliberate
    for the deterministic harness (tests compare SLO-aware vs
    unconstrained clocking under identical information); a live governor
    gets the previous window's EWMA instead and covers the lag with
    ``slo_headroom``.  Returns one record per window:
    ``{t0_s, rate, n_arrivals, p99_s, power_w, freqs_ghz, shed, done}``.
    """
    ctrl = governor.controller
    records: List[Dict[str, Any]] = []
    n_windows = int(trace.duration_s / window_s) + 1
    for w in range(n_windows):
        start, end = w * window_s, (w + 1) * window_s
        arrivals = trace.window(start, end)
        if arrivals:
            governor.set_load(len(arrivals) / window_s)
        result = env.window(
            ctrl.plan,
            arrivals,
            window_s=window_s,
            stage_freqs=governor.stage_freqs,
            admit=admission.admit_callback() if admission is not None else None,
        )
        records.append(
            {
                "t0_s": start,
                "rate": len(arrivals) / window_s,
                "n_arrivals": len(arrivals),
                "p99_s": result.latency_p99_s,
                "power_w": result.avg_power_w,
                "freqs_ghz": [
                    None if f is None else round(f / 1e9, 3)
                    for f in governor.stage_freqs
                ],
                "shed": result.shed,
                "done": len(result.finish_times),
            }
        )
    return records


def attach_governor(
    server: PipelineServer,
    prior: TimeMatrix,
    platform: HeteroPlatform,
    *,
    power_cap_w: Optional[float] = None,
    objective: str = "throughput",
    min_throughput: Optional[float] = None,
    slo_p99_s: Optional[float] = None,
    arrival_rate: Optional[float] = None,
    mode: str = "best",
    config: Optional[AdaptiveConfig] = None,
    physical_clocks: bool = False,
    start: bool = True,
) -> DvfsGovernor:
    """Wire the power-aware closed loop onto a running server
    (``serve(power_cap_w=...)``): a power-aware
    :class:`~repro_torch.serving.adaptive.AdaptiveController`, an
    :class:`~repro_torch.serving.adaptive.AdaptiveMonitor` that normalizes
    observations through the governor, and the governor itself on
    ``server.governor`` (``server.monitor`` holds the loop, so
    ``server.stop()`` shuts it down as usual).

    ``physical_clocks`` defaults to False here because the default serve()
    path runs real full-speed stage functions — the plan's OPPs are
    planning bookkeeping, so observations must NOT be divided by the
    assigned frequency scale.  Pass True when the stage functions honor
    the clocks (``governed_stage_fn_builder`` or real cpufreq).

    ``slo_p99_s`` + ``arrival_rate`` make the loop SLO-aware: every
    frequency decision (initial, drift retune, throttle re-plan,
    ``set_load``) must keep predicted p99 = base latency + M/D/1 wait
    under the budget before it may save energy."""
    controller = AdaptiveController(
        prior=prior,
        plan=server.plan,
        platform=platform,
        mode=mode,
        config=config,
        power_cap_w=power_cap_w,
        objective=objective,
        min_throughput=min_throughput,
        slo_p99_s=slo_p99_s,
        arrival_rate=arrival_rate,
    )
    governor = DvfsGovernor(
        platform, controller, server=server, physical_clocks=physical_clocks
    )
    monitor = AdaptiveMonitor(server, controller, governor=governor)
    server.monitor = monitor
    server.governor = governor
    if start:
        monitor.start()
    return governor
