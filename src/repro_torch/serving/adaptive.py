"""Online adaptive re-planning — closing the paper's open loop.

Pipe-it computes its plan once, offline, from the Eq. 5/8 *predicted*
time matrix; the paper's own Table III reports up to ~15% prediction
error, and on a real board the truth also *drifts* (DVFS, thermal
throttling, co-runners slowing one cluster).  The serving runtime
already measures exactly what the planner consumed as input — per-stage
service times (metrics.py, the empirical Eq. 10) — so this module feeds
them back:

    observe -> calibrate -> detect drift -> re-plan -> hot-swap

* :class:`OnlineCalibrator` — folds observed per-stage service times
  into the time matrix as per-core-type EWMA corrections over the
  Eq. 5/8 prior.  A stage observation only constrains the *sum* of its
  layers' times, so the correction is per core type (cluster), which is
  also the paper's dominant error mode: whole-cluster mis-prediction.
* :class:`DriftDetector` — triggers when the observed bottleneck-stage
  time has diverged from the plan's own prediction beyond a relative
  threshold for ``patience`` consecutive samples (debounced so one noisy
  micro-batch cannot force a re-plan).
* :class:`AdaptiveController` — on a trigger, re-runs the full DSE
  (``pipe_it_search``, Algorithms 1-3) on the calibrated matrix and
  adopts the new plan only if its predicted throughput (Eq. 12) beats
  the current plan's by ``min_gain`` — re-planning is cheap, swapping
  drains the pipeline, so the swap must pay for itself.
* :class:`AdaptiveMonitor` — the runtime attachment: a daemon thread
  that samples a live :class:`~repro_torch.serving.server.PipelineServer`'s
  stage counters, steps the controller, and hot-swaps via
  ``server.swap_plan`` (the drain-and-switch epoch protocol — no
  in-flight ticket is ever dropped).

Under an open-loop arrival process (serving/loadgen.py) the queue, not
the pipeline, owns the tail — so the control plane also grows
queue-state-aware actuators:

* :class:`QueueController` — per-request admission shedding (refuse
  work whose predicted completion already busts the p99 budget) and
  load-adaptive micro-batching (flush timeout sized to the SLO slack,
  batch size to the estimated utilization), driven by the same M/D/1
  arithmetic the SLO planner used (core/queueing.py).
* ``AdaptiveController(slo_p99_s=..., arrival_rate=...)`` — threads the
  p99 budget through every frequency decision (initial assignment,
  ``set_load`` retunes, cap re-plans), so SLO-aware DVFS never
  down-clocks into a predicted violation.

Determinism for tests: :class:`SimulatedServing` runs the same control
loop against the discrete-event simulator (core/simulator.py) on a
:class:`~repro_torch.core.simulator.SimulatedClock` — observed stage times
come from a ground-truth matrix that tests drift at will, so every
calibrate/detect/re-plan trajectory is exactly reproducible.
:class:`OpenLoopServing` is its open-loop sibling: trace windows through
the simulator with queue-state carry between control decisions.
:func:`delayed_stage_fn_builder` is the live-server analogue (fake-stage
mode): real outputs, scripted service delays.

The port's copy of ``repro/serving/adaptive.py``, on the port's own
``core/``, ``engine`` and ``server``.  It differs in the fake-stage
builder alone: :func:`delayed_stage_fn_builder` takes ``backend=`` for
the stage functions it wraps (CUDA graphs of the kernel routes on the
card), and on the card its delay is a sleep kernel on the stage's stream
(:class:`StageDelay`), outside the captured graph, so that it adds to the
stage's observed busy time and follows ``truth`` after the capture.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.calibration import apply_correction, scale_core_type
from ..core.dse import (
    PowerAwarePlan,
    assign_frequencies,
    pipe_it_search,
    power_aware_search,
)
from ..core.pipeline import PipelinePlan, TimeMatrix, stage_time
from ..core.plan import Availability, evaluate
from ..core.platform import HeteroPlatform, StageConfig
from ..core.simulator import SimulatedClock, simulate
from .engine import build_stage_fns
from .server import PipelineServer, ServerClosed


@dataclasses.dataclass(frozen=True)
class StageObservation:
    """One stage's measured behaviour over a sampling window.

    ``service_s`` is the *per-image* service time (busy seconds / items),
    directly comparable to Eq. 10's ``T_{L_i}^{P_i}``.
    """

    stage: StageConfig
    layers: Tuple[int, ...]
    service_s: float
    items: int = 1


class OnlineCalibrator:
    """EWMA per-core-type correction of the Eq. 5/8 prior time matrix.

    For every observed stage, the ratio observed/predicted updates the
    correction factor of the stage's core type:

        c_ct <- (1 - alpha) * c_ct + alpha * (T_obs / T_pred)

    ``matrix()`` then returns ``T'[l][(ct, n)] = T[l][(ct, n)] * c_ct``.
    Unobserved core types keep their prior (c = 1).
    """

    def __init__(self, prior: TimeMatrix, alpha: float = 0.4):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.prior: List[Dict[StageConfig, float]] = [dict(row) for row in prior]
        self.alpha = alpha
        self.correction: Dict[str, float] = {}

    @property
    def n_layers(self) -> int:
        return len(self.prior)

    def observe(self, observations: Sequence[StageObservation]) -> None:
        for obs in observations:
            if not obs.layers or obs.service_s <= 0.0:
                continue
            predicted = stage_time(self.prior, obs.layers, obs.stage)
            if predicted <= 0.0:
                continue
            ratio = obs.service_s / predicted
            core_type = obs.stage[0]
            old = self.correction.get(core_type, 1.0)
            self.correction[core_type] = (1 - self.alpha) * old + self.alpha * ratio

    def rebase(self, observations: Sequence[StageObservation]) -> None:
        """Change-point reset: snap corrections to the latest window.

        The EWMA tracks slow drift; once the detector has *confirmed* a
        sustained shift (``patience`` consecutive out-of-band windows),
        the pre-drift memory is stale by definition — keeping it would
        make the re-plan land between the old and new operating points.
        So the controller rebases: each observed core type's correction
        becomes the mean observed/predicted ratio of this window alone.
        """
        ratios: Dict[str, List[float]] = {}
        for obs in observations:
            if not obs.layers or obs.service_s <= 0.0:
                continue
            predicted = stage_time(self.prior, obs.layers, obs.stage)
            if predicted <= 0.0:
                continue
            ratios.setdefault(obs.stage[0], []).append(obs.service_s / predicted)
        for core_type, rs in ratios.items():
            self.correction[core_type] = sum(rs) / len(rs)

    def matrix(self) -> List[Dict[StageConfig, float]]:
        """The calibrated time matrix (prior x current corrections)."""
        return apply_correction(self.prior, self.correction)


@dataclasses.dataclass
class DriftDetector:
    """Debounced relative-deviation trigger on the bottleneck stage.

    ``update`` returns True once the observed bottleneck time has
    deviated from the planned prediction by more than ``threshold``
    (relative) for ``patience`` consecutive samples.  The caller resets
    after acting.
    """

    threshold: float = 0.25
    patience: int = 2
    last_deviation: float = 0.0
    _hits: int = 0

    def update(self, predicted_s: float, observed_s: float) -> bool:
        self.last_deviation = abs(observed_s - predicted_s) / max(
            predicted_s, 1e-12
        )
        if self.last_deviation > self.threshold:
            self._hits += 1
        else:
            self._hits = 0
        return self._hits >= self.patience

    def reset(self) -> None:
        self._hits = 0


@dataclasses.dataclass(frozen=True)
class ReplanEvent:
    """One controller decision that re-ran the DSE (swap or rejection)."""

    round: int
    deviation: float
    old_plan: PipelinePlan
    new_plan: PipelinePlan
    predicted_gain: float  # new/old Eq. 12 throughput on the calibrated T
    swapped: bool


@dataclasses.dataclass
class AdaptiveConfig:
    """Knobs of the control loop (defaults tuned for the benchmarks)."""

    alpha: float = 0.4  # calibrator EWMA weight
    threshold: float = 0.25  # drift trigger: relative bottleneck deviation
    patience: int = 2  # consecutive out-of-band samples before re-plan
    min_gain: float = 1.05  # required predicted speedup to hot-swap
    interval_s: float = 0.25  # monitor sampling period (live servers)
    min_items: int = 1  # min new items per stage for a valid sample


class AdaptiveController:
    """Calibrate -> detect -> re-plan; the policy half of the loop.

    Owns the belief state: the calibrated matrix, the matrix the current
    plan was planned against (``T_planned``), and the current plan.  One
    ``step(observations)`` folds a sample in and returns the new
    :class:`PipelinePlan` when a hot-swap is warranted, else None.
    """

    def __init__(
        self,
        prior: TimeMatrix,
        plan: PipelinePlan,
        platform: HeteroPlatform,
        mode: str = "best",
        config: Optional[AdaptiveConfig] = None,
        power_cap_w: Optional[float] = None,
        objective: str = "throughput",
        min_throughput: Optional[float] = None,
        slo_p99_s: Optional[float] = None,
        arrival_rate: Optional[float] = None,
        slo_headroom: float = 0.85,
    ):
        self.config = config or AdaptiveConfig()
        self.calibrator = OnlineCalibrator(prior, alpha=self.config.alpha)
        self.detector = DriftDetector(
            threshold=self.config.threshold, patience=self.config.patience
        )
        self.platform = platform
        self.mode = mode
        self.plan = plan
        self.T_planned: TimeMatrix = self.calibrator.matrix()
        # DVFS dimension (serving/governor.py drives these): when a power
        # cap or a per-watt objective is set, re-plans run the power-aware
        # search and `power_plan` carries the current per-stage OPPs.
        self.power_cap_w = power_cap_w
        self.objective = objective
        self.min_throughput = min_throughput
        # SLO dimension (ROADMAP item 4): an end-to-end p99 budget at the
        # currently-believed open-loop arrival rate.  The budget handed to
        # the DSE is ``slo_headroom * slo_p99_s`` — the margin absorbs
        # queueing-model error so "feasible" clocks are not shown
        # violating the SLO by the simulator (tests pin this).
        if slo_p99_s is not None and arrival_rate is None:
            raise ValueError("slo_p99_s requires arrival_rate")
        if not 0.0 < slo_headroom <= 1.0:
            raise ValueError(f"slo_headroom {slo_headroom} outside (0, 1]")
        self.slo_p99_s = slo_p99_s
        self.arrival_rate = arrival_rate
        self.slo_headroom = slo_headroom
        self.power_plan: Optional[PowerAwarePlan] = None
        if self.power_aware:
            self.power_plan = assign_frequencies(
                plan, self.T_planned, platform, power_cap_w, objective,
                min_throughput, self._slo_budget(), self._slo_rate(),
            )
        self.rounds = 0
        self.swaps = 0
        # Bounded: an oscillating environment re-plans forever and a
        # persistent server must not grow memory with uptime.
        self.history: Deque[ReplanEvent] = collections.deque(maxlen=256)
        # Degraded-mode state (serving/faults.py cluster loss): the full
        # machine, the per-core-type losses currently in effect, and the
        # plan to restore on rejoin.  ``platform`` always reflects what
        # the DSE may use — the surviving subset while degraded.
        self.full_platform = platform
        self.lost: Dict[str, int] = {}
        self._pre_degrade: Optional[
            Tuple[PipelinePlan, Optional[PowerAwarePlan]]
        ] = None

    @property
    def degraded(self) -> bool:
        return self._pre_degrade is not None

    def degrade(self, lost: Dict[str, int]) -> PipelinePlan:
        """Permanent core loss: re-plan on the surviving sub-platform.

        ``lost`` maps core-type name -> cores just lost (cumulative with
        any earlier loss).  Re-runs the full DSE on the calibrated matrix
        restricted to ``full_platform.subset(surviving)`` and returns the
        degraded plan — validated against the IR's :class:`Availability`
        constraint so a plan demanding dead cores can never be adopted.
        No min-gain gate: like :meth:`replan_under_cap`, the old plan may
        simply be unschedulable, and availability beats hysteresis."""
        merged = dict(self.lost)
        for core_type, n in lost.items():
            if n < 0:
                raise ValueError(f"lost {n} {core_type!r} cores < 0")
            merged[core_type] = merged.get(core_type, 0) + n
        surviving = {
            ct.name: ct.count - merged.get(ct.name, 0)
            for ct in self.full_platform.core_types
        }
        for core_type, n in merged.items():
            if not any(ct.name == core_type for ct in self.full_platform.core_types):
                raise ValueError(f"unknown core type {core_type!r}")
        degraded = self.full_platform.subset(
            {k: v for k, v in surviving.items() if v > 0}
        )
        if self._pre_degrade is None:
            self._pre_degrade = (self.plan, self.power_plan)
        self.lost = merged
        self.platform = degraded
        T_new = self.calibrator.matrix()
        self.T_planned = T_new
        self.detector.reset()
        if self.power_aware:
            candidate = power_aware_search(
                self.calibrator.n_layers, degraded, T_new, mode=self.mode,
                power_cap_w=self.power_cap_w, objective=self.objective,
                min_throughput=self.min_throughput,
                slo_p99_s=self._slo_budget(), arrival_rate=self._slo_rate(),
            )
            new_plan = candidate.plan
            self.power_plan = candidate
        else:
            new_plan = pipe_it_search(
                self.calibrator.n_layers, degraded, T_new, mode=self.mode
            )
        verdict = evaluate(
            new_plan, T_new, degraded,
            constraints=(Availability.from_platform(degraded),),
        )
        if verdict.binding == "availability":
            raise RuntimeError(
                f"degraded re-plan still demands lost cores: {new_plan}"
            )
        old = self.plan
        self.history.append(
            ReplanEvent(
                round=self.rounds,
                deviation=0.0,  # not drift-triggered: the machine shrank
                old_plan=old,
                new_plan=new_plan,
                predicted_gain=new_plan.throughput(T_new)
                / max(old.throughput(T_new), 1e-12),
                swapped=new_plan != old,
            )
        )
        if new_plan != old:
            self.swaps += 1
        self.plan = new_plan
        return new_plan

    def rejoin(self) -> PipelinePlan:
        """Lost cores came back: restore the remembered pre-fault plan
        (the contract: rejoin returns to the original operating
        point; drift since then re-triggers the normal loop)."""
        if self._pre_degrade is None:
            raise ValueError("rejoin() without a preceding degrade()")
        plan, power_plan = self._pre_degrade
        self._pre_degrade = None
        self.lost = {}
        self.platform = self.full_platform
        T_new = self.calibrator.matrix()
        self.T_planned = T_new
        self.detector.reset()
        old = self.plan
        self.history.append(
            ReplanEvent(
                round=self.rounds,
                deviation=0.0,
                old_plan=old,
                new_plan=plan,
                predicted_gain=plan.throughput(T_new)
                / max(old.throughput(T_new), 1e-12),
                swapped=plan != old,
            )
        )
        if plan != old:
            self.swaps += 1
        self.plan = plan
        self.power_plan = power_plan
        return plan

    @property
    def power_aware(self) -> bool:
        return (
            self.power_cap_w is not None
            or self.objective != "throughput"
            or self.min_throughput is not None
            or self.slo_p99_s is not None
        )

    def _slo_budget(self) -> Optional[float]:
        """The margined p99 budget the DSE is held to (None = no SLO)."""
        if self.slo_p99_s is None:
            return None
        return self.slo_p99_s * self.slo_headroom

    def _slo_rate(self) -> Optional[float]:
        return None if self.slo_p99_s is None else self.arrival_rate

    def set_load(self, arrival_rate: float) -> PowerAwarePlan:
        """The measured open-loop rate moved: re-slack-match the current
        plan's clocks so the SLO stays feasible at the NEW rate (e.g. an
        MMPP burst needs the clocks an energy objective would otherwise
        down-shift).  Frequency-only — no pipeline drain, no min-gain
        gate; the governor applies the returned assignment live."""
        if arrival_rate <= 0.0:
            raise ValueError(f"arrival_rate {arrival_rate} <= 0")
        if self.slo_p99_s is None:
            raise ValueError("set_load needs an SLO-aware controller")
        self.arrival_rate = arrival_rate
        pplan = assign_frequencies(
            self.plan, self.T_planned, self.platform, self.power_cap_w,
            self.objective, self.min_throughput,
            self._slo_budget(), self._slo_rate(),
        )
        self.power_plan = pplan
        return pplan

    def replan_under_cap(
        self, power_cap_w: Optional[float]
    ) -> PowerAwarePlan:
        """Throttle-event path (the governor's half of the loop): the power
        envelope changed NOW — e.g. thermal firmware dropped the cap — so
        re-plan unconditionally on the current calibrated belief under the
        new cap.  No min-gain gate: the old plan may simply be infeasible
        under the new envelope, and a cap *raise* should un-throttle
        promptly.  Returns the new :class:`PowerAwarePlan`; the caller
        (``DvfsGovernor``) applies frequencies and hot-swaps if the layer
        allocation changed."""
        self.power_cap_w = power_cap_w
        T_new = self.calibrator.matrix()
        self.T_planned = T_new
        candidate = power_aware_search(
            self.calibrator.n_layers, self.platform, T_new, mode=self.mode,
            power_cap_w=power_cap_w, objective=self.objective,
            min_throughput=self.min_throughput,
            slo_p99_s=self._slo_budget(), arrival_rate=self._slo_rate(),
        )
        self.detector.reset()
        swapped = candidate.plan != self.plan
        old_tp = self.plan.throughput(T_new)
        self.history.append(
            ReplanEvent(
                round=self.rounds,
                deviation=0.0,  # not drift-triggered: the envelope moved
                old_plan=self.plan,
                new_plan=candidate.plan,
                predicted_gain=candidate.throughput / max(old_tp, 1e-12),
                swapped=swapped,
            )
        )
        self.plan = candidate.plan
        self.power_plan = candidate
        if swapped:
            self.swaps += 1
        return candidate

    def step(
        self, observations: Sequence[StageObservation]
    ) -> Optional[PipelinePlan]:
        self.rounds += 1
        self.calibrator.observe(observations)
        current = {
            (tuple(layers), stage)
            for layers, stage in zip(
                self.plan.allocation, self.plan.pipeline.stages
            )
        }
        relevant = [
            o.service_s
            for o in observations
            if (o.layers, o.stage) in current and o.service_s > 0.0
        ]
        if not relevant:
            return None
        observed_bottleneck = max(relevant)
        predicted_bottleneck = self.plan.bottleneck(self.T_planned)
        if not self.detector.update(predicted_bottleneck, observed_bottleneck):
            return None
        deviation = self.detector.last_deviation
        self.detector.reset()
        # Confirmed change-point: re-plan from a belief rebased on the
        # sustained recent window, and measure future drift against it so
        # the same shift is not re-triggered against a stale prediction.
        self.calibrator.rebase(observations)
        T_new = self.calibrator.matrix()
        self.T_planned = T_new
        if self.power_aware:
            return self._power_step(T_new, deviation)
        candidate = pipe_it_search(
            self.calibrator.n_layers, self.platform, T_new, mode=self.mode
        )
        gain = candidate.throughput(T_new) / max(
            self.plan.throughput(T_new), 1e-12
        )
        swapped = gain >= self.config.min_gain and candidate != self.plan
        self.history.append(
            ReplanEvent(
                round=self.rounds,
                deviation=deviation,
                old_plan=self.plan,
                new_plan=candidate,
                predicted_gain=gain,
                swapped=swapped,
            )
        )
        if not swapped:
            return None
        self.plan = candidate
        self.swaps += 1
        return candidate

    def _power_step(
        self, T_new: TimeMatrix, deviation: float
    ) -> Optional[PipelinePlan]:
        """The power-aware half of :meth:`step`: candidates are ranked by
        the DVFS objective (capped throughput or throughput/watt), and the
        kept plan's clocks are re-slack-matched either way — a frequency
        retune needs no pipeline drain, so it is never gated on
        ``min_gain``."""
        keep = assign_frequencies(
            self.plan, T_new, self.platform, self.power_cap_w,
            self.objective, self.min_throughput,
            self._slo_budget(), self._slo_rate(),
        )
        candidate = power_aware_search(
            self.calibrator.n_layers, self.platform, T_new, mode=self.mode,
            power_cap_w=self.power_cap_w, objective=self.objective,
            min_throughput=self.min_throughput,
            slo_p99_s=self._slo_budget(), arrival_rate=self._slo_rate(),
        )
        if keep.objective > 0.0:
            gain = candidate.objective / max(keep.objective, 1e-12)
        else:
            # "min_energy" scores are negative joules (bigger = better):
            # gain must still read "x1.2 = 20% better", so invert the ratio
            # on the negative axis (keep=-1.0J, candidate=-0.8J -> 1.25).
            gain = keep.objective / min(candidate.objective, -1e-12)
        swapped = (
            candidate.plan != self.plan
            and (gain >= self.config.min_gain or (candidate.feasible and not keep.feasible))
        )
        self.history.append(
            ReplanEvent(
                round=self.rounds,
                deviation=deviation,
                old_plan=self.plan,
                new_plan=candidate.plan,
                predicted_gain=gain,
                swapped=swapped,
            )
        )
        if not swapped:
            self.power_plan = keep  # free retune: clocks follow the belief
            return None
        self.plan = candidate.plan
        self.power_plan = candidate
        self.swaps += 1
        return candidate.plan


# ---------------------------------------------------------------------------
# Live-server attachment
# ---------------------------------------------------------------------------

class ServerSampler:
    """Epoch-aware delta sampler over one server's per-stage counters.

    Turns a :class:`PipelineServer`'s monotone stage counters into
    per-window :class:`StageObservation` deltas (per-image busy seconds
    over the items newly completed in the window).  Counter baselines reset on
    every epoch bump because a hot-swap replaces the stage structure and
    its metrics objects.  Shared by the single-model
    :class:`AdaptiveMonitor` and the multi-model partition monitor
    (serving/multimodel.py), which runs one sampler per co-resident
    model.
    """

    def __init__(self, server: PipelineServer, min_items: int = 1):
        self.server = server
        self.min_items = min_items
        self._seen_epoch = -1
        self._base: List[Tuple[float, int]] = []

    def sample(self) -> List[StageObservation]:
        if self.server.epoch != self._seen_epoch:
            self._seen_epoch = self.server.epoch
            self._base = [(0.0, 0) for _ in self.server.metrics.stages]
        plan = self.server.plan
        stages = self.server.metrics.stages
        if len(stages) != plan.pipeline.p or len(stages) != len(self._base):
            return []  # raced with a concurrent swap; next window is clean
        out: List[StageObservation] = []
        for i, m in enumerate(stages):
            busy, items = m.totals()  # consistent pair vs. the worker
            base_busy, base_items = self._base[i]
            d_items = items - base_items
            if d_items < self.min_items:
                continue
            self._base[i] = (busy, items)
            out.append(
                StageObservation(
                    stage=plan.pipeline.stages[i],
                    layers=tuple(plan.allocation[i]),
                    service_s=(busy - base_busy) / d_items,
                    items=d_items,
                )
            )
        return out


class AdaptiveMonitor:
    """Background control loop over a live :class:`PipelineServer`.

    Every ``interval_s`` it turns the server's per-stage counters into
    :class:`StageObservation` deltas (per-image busy time over the new
    items in the window), steps the controller, and on a re-plan calls
    ``server.swap_plan`` — the epoch protocol guarantees no in-flight
    ticket is dropped.  Counter baselines reset on every epoch bump
    because the stage structure (and its metrics objects) changed.
    """

    def __init__(
        self,
        server: PipelineServer,
        controller: AdaptiveController,
        interval_s: Optional[float] = None,
        governor=None,
    ):
        self.server = server
        self.controller = controller
        # Optional serving/governor.py attachment: observations are
        # normalized back to f_max before calibration (a down-clocked
        # stage must not read as cluster drift) and every control decision
        # re-applies the planned per-stage OPPs.
        self.governor = governor
        self.interval_s = (
            interval_s
            if interval_s is not None
            else controller.config.interval_s
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sampler = ServerSampler(
            server, min_items=controller.config.min_items
        )
        # Last exception seen by the background loop (None while healthy).
        # Transient faults are retried; after max_failures consecutive
        # ones the loop gives up and PipelineServer.stop() raises this —
        # adaptation must not silently degrade to static planning.
        # Server-closed shutdowns are normal and not recorded.
        self.error: Optional[BaseException] = None
        self.max_failures = 3
        self._consecutive_failures = 0

    def sample(self) -> List[StageObservation]:
        """One observation window (public so tests can drive it directly)."""
        return self._sampler.sample()

    def step(self) -> Optional[PipelinePlan]:
        """Sample + control + (maybe) hot-swap; returns the swapped plan."""
        observations = self.sample()
        if not observations:
            return None
        if self.governor is not None:
            observations = self.governor.normalize(observations)
        prev_plan, prev_swaps = self.controller.plan, self.controller.swaps
        prev_pplan = self.controller.power_plan
        new_plan = self.controller.step(observations)
        if new_plan is None:
            if self.governor is not None and self.controller.power_plan is not None:
                # frequency-only retune: no drain, just new clocks
                self.governor.apply(self.controller.power_plan)
            return None
        try:
            self.server.swap_plan(new_plan)
        except BaseException:
            # The server still runs the old plan (a prepare-phase failure
            # changes no server state): revert the controller's belief so
            # it keeps filtering observations against what actually runs
            # and will re-attempt the swap on the next trigger.
            self.controller.plan = prev_plan
            self.controller.swaps = prev_swaps
            self.controller.power_plan = prev_pplan
            if self.controller.history:
                self.controller.history[-1] = dataclasses.replace(
                    self.controller.history[-1], swapped=False
                )
            raise
        if self.governor is not None and self.controller.power_plan is not None:
            self.governor.apply(self.controller.power_plan)
        return new_plan

    def _degraded_transition(self, transition) -> PipelinePlan:
        """Run a controller degrade/rejoin and hot-swap the result; on ANY
        failure (search or swap) restore the whole controller belief —
        plan, platform, loss state, history — so the controller keeps
        describing what actually runs.  The same revert-on-swap-failure
        idiom as :meth:`step` / the governor's throttle."""
        c = self.controller
        snap = (
            c.plan, c.swaps, c.power_plan, c.platform, dict(c.lost),
            c._pre_degrade, list(c.history),
        )
        try:
            new_plan = transition()
            if new_plan != self.server.plan:
                self.server.swap_plan(new_plan)
        except BaseException:
            (c.plan, c.swaps, c.power_plan, c.platform, c.lost,
             c._pre_degrade, history) = snap
            c.history = collections.deque(history, maxlen=c.history.maxlen)
            raise
        if self.governor is not None and c.power_plan is not None:
            self.governor.apply(c.power_plan)
        return new_plan

    def degrade(self, lost: Dict[str, int]) -> PipelinePlan:
        """Cluster/core loss detected: re-plan on the survivors and swap."""
        return self._degraded_transition(lambda: self.controller.degrade(lost))

    def rejoin(self) -> PipelinePlan:
        """Lost cores returned: restore the pre-fault plan and swap."""
        return self._degraded_transition(self.controller.rejoin)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
                self._consecutive_failures = 0
                self.error = None  # recovered: a past hiccup is not a failure
            except ServerClosed:
                return  # normal shutdown race
            except Exception as e:  # noqa: BLE001 — daemon must not spray
                # swap_plan re-raises the raw worker error (not always a
                # ServingError); keep it observable instead of dying mute.
                self.error = e
                self._consecutive_failures += 1
                if (
                    self._consecutive_failures >= self.max_failures
                    or self.server._closed
                ):
                    return

    def start(self) -> "AdaptiveMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="pipe-adaptive", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)


def attach_adaptive(
    server: PipelineServer,
    prior: TimeMatrix,
    platform: HeteroPlatform,
    mode: str = "best",
    config: Optional[AdaptiveConfig] = None,
    start: bool = True,
) -> AdaptiveMonitor:
    """Wire the closed loop onto a running server (``serve(adaptive=True)``).

    The monitor is stored as ``server.monitor`` so ``server.stop()``
    shuts the control loop down before draining the pipeline.
    """
    controller = AdaptiveController(
        prior=prior,
        plan=server.plan,
        platform=platform,
        mode=mode,
        config=config,
    )
    monitor = AdaptiveMonitor(server, controller)
    server.monitor = monitor
    if start:
        monitor.start()
    return monitor


# ---------------------------------------------------------------------------
# Deterministic harnesses (simulator-backed and fake-stage modes)
# ---------------------------------------------------------------------------

class DriftingMatrix:
    """Mutable ground-truth time matrix; tests scale a cluster mid-run."""

    def __init__(self, T: TimeMatrix):
        self.T: List[Dict[StageConfig, float]] = [dict(row) for row in T]

    def scale(self, core_type: str, factor: float) -> None:
        self.T = scale_core_type(self.T, core_type, factor)


class SimulatedServing:
    """The serving side of the control loop, simulator-backed.

    Stands in for a live ``PipelineServer``: ``observe(plan)`` runs the
    discrete-event simulator against a (driftable) ground-truth matrix,
    advances a :class:`SimulatedClock` by the round's makespan, and
    returns the per-stage observations a monitor window would have
    produced.  Zero wall time, zero threads, bit-for-bit reproducible.
    """

    def __init__(
        self,
        truth: TimeMatrix,
        platform: HeteroPlatform,
        n_images_per_round: int = 64,
        clock: Optional[SimulatedClock] = None,
    ):
        self.truth = DriftingMatrix(truth)
        self.platform = platform
        self.n_images_per_round = n_images_per_round
        self.clock = clock if clock is not None else SimulatedClock()
        # Steady-state throughput / power of the plan most recently
        # observe()d — saves callers a second identical simulate() per round.
        self.last_throughput = 0.0
        self.last_power_w = 0.0
        self.last_energy_j = 0.0

    def inject_drift(self, core_type: str, factor: float) -> None:
        """One cluster becomes uniformly ``factor`` x slower from now on."""
        self.truth.scale(core_type, factor)

    def observe(
        self,
        plan: PipelinePlan,
        stage_freqs: Optional[Sequence[Optional[float]]] = None,
    ) -> List[StageObservation]:
        """One sampling window; ``stage_freqs`` runs the board's clusters
        at the governor's assigned OPPs (frequency-dependent stage times
        and modeled power come from core/simulator.py)."""
        result = simulate(
            plan, self.truth.T, self.platform,
            n_images=self.n_images_per_round, stage_freqs=stage_freqs,
        )
        self.clock.advance(result.makespan_s)
        self.last_throughput = result.steady_throughput
        self.last_power_w = result.avg_power_w
        self.last_energy_j = result.energy_j
        times = plan.stage_times(self.truth.T)
        if stage_freqs is not None:
            times = [
                t * self.platform.freq_scale(stage[0], f)
                for t, stage, f in zip(times, plan.pipeline.stages, stage_freqs)
            ]
        return [
            StageObservation(
                stage=stage,
                layers=tuple(layers),
                service_s=t,
                items=self.n_images_per_round,
            )
            for stage, layers, t in zip(
                plan.pipeline.stages, plan.allocation, times
            )
        ]

    def throughput(
        self,
        plan: PipelinePlan,
        stage_freqs: Optional[Sequence[Optional[float]]] = None,
    ) -> float:
        """Steady-state throughput of ``plan`` on the CURRENT truth."""
        return simulate(
            plan, self.truth.T, self.platform,
            n_images=self.n_images_per_round, stage_freqs=stage_freqs,
        ).steady_throughput

    def power(
        self,
        plan: PipelinePlan,
        stage_freqs: Optional[Sequence[Optional[float]]] = None,
    ) -> float:
        """Modeled average active power of ``plan`` on the CURRENT truth."""
        return simulate(
            plan, self.truth.T, self.platform,
            n_images=self.n_images_per_round, stage_freqs=stage_freqs,
        ).avg_power_w


def run_adaptive_loop(
    controller: AdaptiveController,
    env: SimulatedServing,
    rounds: int,
    on_swap: Optional[Callable[[int, PipelinePlan], None]] = None,
) -> List[float]:
    """Drive controller vs. simulator for ``rounds``; returns per-round
    throughput of whatever plan was active during each round."""
    trajectory: List[float] = []
    for r in range(rounds):
        observations = env.observe(controller.plan)
        trajectory.append(env.last_throughput)  # plan active this round
        new_plan = controller.step(observations)
        if new_plan is not None and on_swap is not None:
            on_swap(r, new_plan)
    return trajectory


class OpenLoopServing:
    """Trace-driven open-loop counterpart of :class:`SimulatedServing`.

    Windows of an arrival trace (absolute times) run through the
    discrete-event simulator with per-stage queue state carried across
    windows (``SimResult.stage_free_s`` → ``simulate(initial_free=...)``),
    so a backlog built during a burst is still there when the next
    control decision runs — the property that makes windowed SLO control
    testable.  Because both arrivals and the carry are absolute times,
    windowing is exact: simulating a trace window-by-window under an
    unchanged plan is bit-identical to simulating it in one call
    (tests/test_queueing.py pins this).

    A plan change between windows follows drain-and-switch semantics: the
    new pipeline's stages start free at the OLD pipeline's drain time —
    in-flight work finishes first, nothing is dropped — matching the live
    server's epoch protocol.
    """

    def __init__(
        self,
        truth: TimeMatrix,
        platform: HeteroPlatform,
        clock: Optional[SimulatedClock] = None,
    ):
        self.truth = DriftingMatrix(truth)
        self.platform = platform
        self.clock = clock if clock is not None else SimulatedClock()
        self._free: Optional[List[float]] = None
        self._shape = None
        self.last_result = None

    def inject_drift(self, core_type: str, factor: float) -> None:
        self.truth.scale(core_type, factor)

    def window(
        self,
        plan: PipelinePlan,
        arrivals: Sequence[float],
        *,
        window_s: float,
        stage_freqs: Optional[Sequence[Optional[float]]] = None,
        admit=None,
    ):
        """Run one control window of absolute ``arrivals`` under ``plan``
        (at ``stage_freqs`` clocks), carrying queue state; advances the
        clock by ``window_s``.  Returns the window's ``SimResult``."""
        shape = (plan.pipeline.stages, plan.allocation)
        if self._free is None or shape != self._shape:
            drain = max(self._free) if self._free else 0.0
            self._free = [drain] * plan.pipeline.p
            self._shape = shape
        result = simulate(
            plan, self.truth.T, self.platform,
            arrival_s=list(arrivals), stage_freqs=stage_freqs,
            initial_free=self._free, admit=admit,
        )
        self._free = list(result.stage_free_s)
        self.clock.advance(window_s)
        self.last_result = result
        return result


@dataclasses.dataclass
class QueuePolicy:
    """Knobs of the queue-aware admission/batching controller."""

    slo_p99_s: float  # end-to-end tail budget the controller defends
    shed_headroom: float = 1.0  # admit while predicted e2e <= headroom*slo
    min_flush_s: float = 0.0
    max_flush_s: float = 0.05
    flush_fraction: float = 0.1  # fraction of the SLO slack spent batching
    rate_alpha: float = 0.3  # EWMA weight of the arrival-rate estimate


class QueueController:
    """Queue-state-aware admission shedding + batching adaptation.

    The runtime closure of the queueing model: where the DSE uses
    ``predict_latency`` to CHOOSE a plan, this controller uses the same
    arithmetic per request to protect the chosen plan's SLO —

    * **Admission** (:meth:`should_admit`): a request whose predicted
      completion (queue wait + base pipeline latency) already exceeds the
      budget is refused at the door.  Serving it would waste bottleneck
      time on a guaranteed SLO miss AND push every queued request further
      past the budget — shedding one doomed request protects many.
    * **Flush timeout** (:meth:`flush_timeout`): the size-or-deadline
      batching deadline is paid by every request on the latency path, so
      it is sized to a fraction of the SLO slack; under overload
      (estimated rho >= 1) it opens to the maximum — batching throughput
      is all that drains the queue.
    * **Batch size** (:meth:`recommended_batch`): grows when estimated
      utilization runs hot, shrinks when the line is idle.

    ``service_s`` is the per-image bottleneck service time and
    ``base_latency_s`` the zero-queue pipeline latency of the ACTIVE plan
    (update via :meth:`update_plan` after a hot-swap).  The live path
    (``serving.loadgen.run_open_loop``) calls ``observe_arrival`` /
    ``should_admit`` per request; the simulator path plugs
    ``should_admit`` straight into ``simulate(admit=...)`` — one policy,
    both execution paths.
    """

    def __init__(
        self,
        policy: QueuePolicy,
        base_latency_s: float,
        service_s: float,
    ):
        if service_s <= 0.0:
            raise ValueError(f"service_s {service_s} <= 0")
        self.policy = policy
        self.base_latency_s = base_latency_s
        self.service_s = service_s
        self.rate_hat = 0.0
        self._last_arrival: Optional[float] = None
        self.admitted = 0
        self.shed = 0

    def update_plan(self, base_latency_s: float, service_s: float) -> None:
        """Re-point the controller at a new plan's latency geometry."""
        if service_s <= 0.0:
            raise ValueError(f"service_s {service_s} <= 0")
        self.base_latency_s = base_latency_s
        self.service_s = service_s

    @property
    def utilization(self) -> float:
        return self.rate_hat * self.service_s

    def observe_arrival(self, now_s: float) -> None:
        """EWMA the arrival rate from inter-arrival gaps."""
        if self._last_arrival is not None:
            gap = now_s - self._last_arrival
            if gap > 0.0:
                a = self.policy.rate_alpha
                self.rate_hat = (1 - a) * self.rate_hat + a / gap
        self._last_arrival = now_s

    def should_admit(self, queue_wait_s: float, _arrival_s: float = 0.0) -> bool:
        """Admit iff predicted completion fits the (headroomed) budget.

        Signature doubles as ``simulate(admit=...)``'s
        ``(arrival, predicted_wait)`` callback — the simulator passes
        (arrival, wait) positionally, the live path passes wait alone —
        so both paths shed by the identical rule."""
        wait = max(queue_wait_s, _arrival_s) if _arrival_s else queue_wait_s
        ok = (
            wait + self.base_latency_s
            <= self.policy.shed_headroom * self.policy.slo_p99_s
        )
        if ok:
            self.admitted += 1
        else:
            self.shed += 1
        return ok

    def admit_callback(self):
        """The ``simulate(admit=...)`` adapter: (arrival, wait) -> bool."""

        def admit(_arrival_s: float, predicted_wait_s: float) -> bool:
            return self.should_admit(predicted_wait_s)

        return admit

    def flush_timeout(self) -> float:
        """Deadline for the size-or-deadline micro-batch trigger."""
        p = self.policy
        if self.utilization >= 1.0:
            return p.max_flush_s
        slack = max(0.0, p.shed_headroom * p.slo_p99_s - self.base_latency_s)
        return min(p.max_flush_s, max(p.min_flush_s, p.flush_fraction * slack))

    def recommended_batch(self, current: int, max_batch: int = 8) -> int:
        """Batch-size recommendation from estimated utilization: hot lines
        amortize overhead across more images, idle lines stop paying
        padding FLOPs.  The caller applies it via
        ``PipelineServer.set_batching`` (one compile blip per new shape)."""
        if self.utilization > 0.75:
            return min(max(current * 2, 1), max_batch)
        if self.utilization < 0.25:
            return max(current // 2, 1)
        return current


class StageDelay:
    """A scripted service delay that adds to a stage's observed busy time.

    ``delay(seconds, like)`` calls ``sleep`` (the host's, by default) when
    ``like`` (a tensor of the stage's output) lies on the CPU.  On a CUDA
    tensor it enqueues ``torch.cuda._sleep`` on the current stream, the
    stage worker's, after the stage's kernels: the worker synchronises
    that stream before it stops the stage's clock, so the delay adds to
    the stage's busy time, where a host sleep would overlap the kernels
    already queued.  The sleep kernel's rate (clock cycles a second) is
    measured once, with CUDA events, at the first delay on the card.
    """

    def __init__(self, sleep: Callable[[float], None] = time.sleep):
        self.sleep = sleep
        self._cycles_per_s: Optional[float] = None
        self._lock = threading.Lock()

    def cycles_per_s(self, device: torch.device) -> float:
        with self._lock:
            if self._cycles_per_s is None:
                self._cycles_per_s = _sleep_kernel_rate(device)
            return self._cycles_per_s

    def __call__(self, seconds: float, like: torch.Tensor) -> None:
        if not like.is_cuda:
            self.sleep(seconds)
            return
        cycles = int(seconds * self.cycles_per_s(like.device))
        if cycles > 0:
            torch.cuda._sleep(cycles)


def _sleep_kernel_rate(device: torch.device, cycles: int = 20_000_000) -> float:
    """Clock cycles a second of ``torch.cuda._sleep`` on ``device``: the
    second of two sleeps on a side stream, timed with CUDA events."""
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        for _ in range(2):  # the first launch loads the kernel
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(cycles)
            end.record()
    end.synchronize()
    return cycles / (start.elapsed_time(end) / 1e3)


def delayed_stage_fn_builder(
    truth: DriftingMatrix,
    scale: float = 1.0,
    sleep: Callable[[float], None] = time.sleep,
    backend=None,
):
    """Fake-stage mode for a LIVE server: real outputs, scripted timing.

    Returns a ``stage_fn_builder`` for :class:`PipelineServer` that wraps
    the real stage functions (``build_stage_fns(graph, plan,
    backend=backend)``: CUDA graphs on the card) with a delay of
    ``scale * stage_time(truth.T, layers, stage)`` (:class:`StageDelay`;
    ``sleep`` on the CPU) — so the threaded runtime behaves (timing-wise)
    like the ground-truth board, outputs stay identical to single-stage
    execution, and a test can drift ``truth`` mid-run and watch the whole
    loop (metrics -> calibrator -> detector -> re-plan -> hot-swap)
    respond for real.  The delay runs outside the captured graph, so it
    reads ``truth`` at every call.
    """
    delay = StageDelay(sleep)

    def builder(graph, plan: PipelinePlan):
        real_fns = build_stage_fns(graph, plan, backend=backend)
        fns = []
        for fn, layers, stage in zip(
            real_fns, plan.allocation, plan.pipeline.stages
        ):
            def delayed(params, env, _fn=fn, _layers=tuple(layers), _stage=stage):
                out = _fn(params, env)
                delay(
                    scale * stage_time(truth.T, _layers, _stage),
                    next(iter(out.values())),
                )
                return out

            fns.append(delayed)
        return fns

    return builder
