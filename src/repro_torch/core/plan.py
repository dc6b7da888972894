"""Unified plan IR and the single evaluator every search ranks through.

PRs 4-6 grew the DSE one dimension at a time — pipeline x allocation
(:class:`~.pipeline.PipelinePlan`), per-stage DVFS
(:class:`~.dse.PowerAwarePlan`), tail-latency SLOs
(:class:`~.dse.SloPlan`) and multi-model cluster shares
(:class:`~.dse.ModelPlan`/:class:`~.dse.PartitionPlan`) — each with its
own ad-hoc score/feasibility convention.  This module collapses the
point in the design space to ONE frozen, JSON-serialisable value
(:class:`Plan`) and the ranking to ONE code path (:func:`evaluate`):

* **Objectives** are pluggable functions ``PlanMetrics -> tuple`` whose
  return value is compared lexicographically (first element is the
  reported scalar score, later elements break ties).  The built-ins in
  :data:`OBJECTIVES` reproduce the legacy scores bit-for-bit
  (tests/test_plan_ir.py pins this on the ground-truth matrices).
* **Constraints** are pluggable predicates that either pass or report a
  ``(severity, tail)`` violation.  An :class:`Evaluation`'s ``rank`` is
  ``(2, *objective)`` when every constraint passes, else
  ``(severity, *tail)`` of the most severe violation — so a feasible
  plan beats any infeasible one, and infeasible plans order by *why*
  they fail (a blown power cap ranks by proximity to the envelope; a
  missed throughput floor ranks by best effort).  This is exactly the
  feasibility-first lexicographic idiom the legacy ``_power_rank_key`` /
  ``_slo_rank_key`` / partition share keys implemented three separate
  times (DESIGN.md §9 has the migration map).
* **Backends**: ``backend="model"`` scores analytically (Eq. 10/12 stage
  times, the §7 power model, the §8 M/D/1 tail); ``backend="simulate"``
  reuses :func:`core.simulator.simulate` as the ground-truth evaluator —
  same metrics struct, same objectives, same constraints, so a model
  score and its simulator cross-check can never diverge structurally.

The aggregate multi-model scoring (fairness modes + SLO shortfalls)
lives here too (:func:`partition_parts` / :func:`partition_rank_key`),
so ``partition_search``'s share ranking is the same machinery.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from .pipeline import Allocation, Pipeline, PipelinePlan, TimeMatrix
from .platform import HeteroPlatform, StageConfig
from .queueing import LatencyPrediction, predict_latency
from .simulator import simulate

#: Per-stage OPP choice; None marks a fixed-clock cluster's single level.
FreqAssignment = Tuple[Optional[float], ...]

#: ((core_type, count), ...) — one model's disjoint slice of the cluster.
Share = Tuple[Tuple[str, int], ...]

#: Relative-shortfall penalty that ranks every SLO-feasible assignment above
#: every infeasible one while keeping infeasible ones ordered by how close
#: they come (best-effort under overload).
SLO_PENALTY = 1e9


# --------------------------------------------------------------------- the IR
@dataclasses.dataclass(frozen=True)
class Plan:
    """One point of the full design space, in every dimension the DSE has.

    ``stages``/``allocation`` are the paper's pipeline x layer-split
    (always present); the remaining fields are the beyond-paper axes and
    default to "not planned": ``stage_freqs`` (per-stage OPP, None inside
    the tuple = fixed-clock cluster), ``model``/``share`` (which
    co-resident model this plan serves and on which cluster slice).
    Frozen + hashable + JSON round-trippable so plans can be cache keys,
    golden fixtures, and wire payloads.
    """

    stages: Tuple[StageConfig, ...]
    allocation: Allocation
    stage_freqs: Optional[FreqAssignment] = None
    model: Optional[str] = None
    share: Optional[Share] = None

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "stages", tuple((str(ct), int(n)) for ct, n in self.stages)
        )
        object.__setattr__(
            self, "allocation", tuple(tuple(int(x) for x in a) for a in self.allocation)
        )
        if len(self.allocation) != len(self.stages):
            raise ValueError(
                f"{len(self.allocation)} allocation groups for "
                f"{len(self.stages)} stages"
            )
        if self.stage_freqs is not None:
            object.__setattr__(self, "stage_freqs", tuple(self.stage_freqs))
            if len(self.stage_freqs) != len(self.stages):
                raise ValueError(
                    f"{len(self.stage_freqs)} stage_freqs for "
                    f"{len(self.stages)} stages"
                )
        if self.share is not None:
            object.__setattr__(
                self, "share", tuple((str(ct), int(n)) for ct, n in self.share)
            )

    # ------------------------------------------------------------- views
    @property
    def p(self) -> int:
        return len(self.stages)

    @property
    def pipeline(self) -> Pipeline:
        return Pipeline(stages=self.stages)

    def as_pipeline_plan(self) -> PipelinePlan:
        """The legacy throughput-only view (drops the extra dimensions)."""
        return PipelinePlan(self.pipeline, self.allocation)

    def with_freqs(self, stage_freqs: Optional[Sequence[Optional[float]]]) -> "Plan":
        return dataclasses.replace(
            self,
            stage_freqs=None if stage_freqs is None else tuple(stage_freqs),
        )

    def notation(self) -> str:
        """Human notation across every planned dimension, e.g.
        ``alexnet@B4-s2-s2 [1,5][6,7][8,8] @ fix/1.84GHz/1.84GHz``."""
        text = self.as_pipeline_plan().notation()
        if self.stage_freqs is not None:
            freqs = "/".join(
                "fix" if f is None else f"{f / 1e9:.2f}GHz"
                for f in self.stage_freqs
            )
            text = f"{text}  @ {freqs}"
        if self.model is not None:
            text = f"{self.model}@{text}"
        return text

    # ------------------------------------------------------- JSON round-trip
    def to_dict(self) -> Dict[str, Any]:
        return {
            "stages": [list(s) for s in self.stages],
            "allocation": [list(a) for a in self.allocation],
            "stage_freqs": (
                None if self.stage_freqs is None else list(self.stage_freqs)
            ),
            "model": self.model,
            "share": None if self.share is None else [list(s) for s in self.share],
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Plan":
        return cls(
            stages=tuple((ct, n) for ct, n in d["stages"]),
            allocation=tuple(tuple(a) for a in d["allocation"]),
            stage_freqs=(
                None
                if d.get("stage_freqs") is None
                else tuple(d["stage_freqs"])
            ),
            model=d.get("model"),
            share=(
                None
                if d.get("share") is None
                else tuple((ct, n) for ct, n in d["share"])
            ),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, text: str) -> "Plan":
        return cls.from_dict(json.loads(text))

    # ------------------------------------------------------ legacy adapters
    @classmethod
    def from_legacy(cls, obj: Any) -> "Plan":
        """Convert any of the four legacy plan types (duck-typed, so this
        module never imports ``core.dse``):

        * ``ModelPlan``     -> model + share + inner plan (+ DVFS if any)
        * ``PowerAwarePlan``-> plan + stage_freqs
        * ``SloPlan``       -> plan (the SLO lives in the constraints)
        * ``PipelinePlan``  -> stages + allocation
        """
        if hasattr(obj, "name") and hasattr(obj, "share") and hasattr(obj, "plan"):
            inner = obj.plan
            power = getattr(obj, "power", None)
            return cls(
                stages=inner.pipeline.stages,
                allocation=inner.allocation,
                stage_freqs=None if power is None else tuple(power.stage_freqs),
                model=obj.name,
                share=tuple(
                    (ct.name, ct.count) for ct in obj.share.core_types
                ),
            )
        if hasattr(obj, "plan") and hasattr(obj, "stage_freqs"):
            return cls(
                stages=obj.plan.pipeline.stages,
                allocation=obj.plan.allocation,
                stage_freqs=tuple(obj.stage_freqs),
            )
        if hasattr(obj, "plan") and hasattr(obj, "prediction"):
            return cls(
                stages=obj.plan.pipeline.stages,
                allocation=obj.plan.allocation,
            )
        if hasattr(obj, "pipeline") and hasattr(obj, "allocation"):
            return cls(stages=obj.pipeline.stages, allocation=obj.allocation)
        raise TypeError(f"cannot build a Plan from {type(obj).__name__}")


# ------------------------------------------------------------------- metrics
@dataclasses.dataclass(frozen=True)
class PlanMetrics:
    """Everything an objective or constraint may score a plan on.

    Filled by either backend of :func:`evaluate`; ``prediction`` is the
    full analytic M/D/1 record (model backend with an ``arrival_rate``),
    while ``p99_s`` alone is also set by the simulator backend (measured
    tail, no analytic structure behind it).
    """

    stage_times_s: Tuple[float, ...]  # per-stage service at the plan's OPPs
    cycle_s: float  # max stage time (clamped) — Eq. 12 denominator
    throughput: float  # 1 / cycle_s (img/s)
    energy_per_image_j: float  # sum_i P_i * t_i (0 when no DVFS dimension)
    avg_power_w: float  # energy / cycle
    p99_s: Optional[float] = None  # end-to-end p99 (None: latency-blind)
    prediction: Optional[LatencyPrediction] = None
    backend: str = "model"
    # The plan's stage shapes ((core_type, n_cores) per stage) — what
    # placement-sensitive constraints (:class:`Availability`) check.
    # None only for hand-built metrics that predate the field.
    stages: Optional[Tuple[StageConfig, ...]] = None
    # The plan's reserved cluster slice (Plan.share), when the plan was
    # carved by a partition/fleet search — what :class:`Placement` checks
    # in preference to the (possibly smaller) stage demand.
    share: Optional[Share] = None

    @property
    def stable(self) -> bool:
        return True if self.prediction is None else self.prediction.stable

    @property
    def utilization(self) -> float:
        return 0.0 if self.prediction is None else self.prediction.utilization


# ---------------------------------------------------------------- objectives
#: An objective maps metrics to a lexicographic score tuple; element 0 is
#: the reported scalar score, the rest break ties.  Higher is better.
Objective = Callable[[PlanMetrics], Tuple[float, ...]]


def _obj_throughput(m: PlanMetrics) -> Tuple[float, ...]:
    """Max img/s; ties to the cooler plan."""
    return (m.throughput, -m.avg_power_w)


def _obj_throughput_per_watt(m: PlanMetrics) -> Tuple[float, ...]:
    """Max img/s per modeled watt.  Zero MODELED watts (fixed-clock
    clusters) reads as 'free' throughput: the epsilon floor makes such
    plans dominate powered ones (consistent with the model's claim that
    they cost nothing) while ranking among themselves by img/s — so on a
    fully fixed-clock platform the ordering degrades to plain throughput."""
    return (m.throughput / max(m.avg_power_w, 1e-12), -m.avg_power_w)


def _obj_min_energy(m: PlanMetrics) -> Tuple[float, ...]:
    """Min J/image.  Same zero-watts convention: zero modeled joules
    outranks any positive energy; among free plans, more img/s first (the
    tiny positive scale keeps every zero-energy score above every
    -energy one)."""
    e = m.energy_per_image_j
    return ((-e if e > 0.0 else m.throughput * 1e-15), -m.avg_power_w)


def _obj_slo_throughput(m: PlanMetrics) -> Tuple[float, ...]:
    """Max img/s, ties to the lower predicted tail — the feasible-side
    ordering of the SLO-aware search (requires ``arrival_rate``)."""
    p99 = m.p99_s if m.p99_s is not None else 0.0
    return (m.throughput, -p99)


OBJECTIVES: Dict[str, Objective] = {
    "throughput": _obj_throughput,
    "throughput_per_watt": _obj_throughput_per_watt,
    "min_energy": _obj_min_energy,
    "slo_throughput": _obj_slo_throughput,
}

#: Objective names whose score needs a latency prediction.
_NEEDS_RATE = frozenset({"slo_throughput"})


# --------------------------------------------------------------- constraints
#: A violation is ``(severity, tail)``: lower severity = worse failure
#: class; the tail orders plans *within* that failure class (higher is
#: better, i.e. closer to feasible / better best-effort).  Severities are
#: chosen so ``(2, *objective)`` (feasible) always wins.
Violation = Tuple[int, Tuple[float, ...]]


@dataclasses.dataclass(frozen=True)
class PowerCap:
    """Average modeled active power must stay under ``cap_w``.

    A violation is a *safety* failure (severity 0): violators rank by
    least power first — closest to the envelope — not by score."""

    cap_w: float
    tolerance: float = 1e-9
    name: str = dataclasses.field(default="power_cap", repr=False)

    def violation(
        self, m: PlanMetrics, score: Tuple[float, ...]
    ) -> Optional[Violation]:
        if m.avg_power_w <= self.cap_w * (1 + self.tolerance):
            return None
        return (0, (-m.avg_power_w, score[0]))


@dataclasses.dataclass(frozen=True)
class MinThroughput:
    """Eq. 12 throughput must reach ``floor`` img/s (the iso-throughput /
    SLO-rate deployment).  Missing the floor with the cap intact means
    demand outstrips capacity — best effort is to run as FAST as the
    envelope allows (severity 1, throughput-first tail), not to idle at
    minimum clocks."""

    floor: float
    tolerance: float = 1e-9
    name: str = dataclasses.field(default="min_throughput", repr=False)

    def violation(
        self, m: PlanMetrics, score: Tuple[float, ...]
    ) -> Optional[Violation]:
        if m.throughput >= self.floor * (1 - self.tolerance):
            return None
        return (1, (m.throughput, -m.avg_power_w))


@dataclasses.dataclass(frozen=True)
class SloP99:
    """Capacity-style p99 budget (the power-aware search's convention):
    predicted end-to-end p99 must be within ``slo_p99_s``.  A violation
    ranks like a missed throughput floor — run as fast as allowed
    (severity 1) — because on the DVFS axis a blown tail means the clocks
    are too LOW, and more speed is the remedy."""

    slo_p99_s: float
    tolerance: float = 1e-9
    name: str = dataclasses.field(default="slo_p99", repr=False)

    def violation(
        self, m: PlanMetrics, score: Tuple[float, ...]
    ) -> Optional[Violation]:
        if m.p99_s is None:
            raise ValueError(
                "SloP99 needs a latency estimate — pass arrival_rate to "
                "evaluate() (model backend) or arrival_s (simulate backend)"
            )
        if m.p99_s <= self.slo_p99_s * (1 + self.tolerance):
            return None
        return (1, (m.throughput, -m.avg_power_w))


@dataclasses.dataclass(frozen=True)
class TailSlo:
    """Tail-first p99 budget (the latency-aware search's convention):
    feasible only when the queue is *stable* and p99 fits within
    ``headroom * slo_p99_s`` (the margin absorbs M/D/1-vs-simulator model
    error).  Stable-but-over plans rank closest-to-budget first
    (severity 1); unstable plans rank last, least-overloaded first
    (severity 0)."""

    slo_p99_s: float
    headroom: float = 1.0
    name: str = dataclasses.field(default="tail_slo", repr=False)

    def violation(
        self, m: PlanMetrics, score: Tuple[float, ...]
    ) -> Optional[Violation]:
        if m.p99_s is None:
            raise ValueError(
                "TailSlo needs a latency estimate — pass arrival_rate to "
                "evaluate() (model backend) or arrival_s (simulate backend)"
            )
        if m.stable and m.p99_s <= self.headroom * self.slo_p99_s:
            return None
        if m.stable:
            return (1, (-m.p99_s, m.throughput))
        return (0, (-m.utilization, m.throughput))


@dataclasses.dataclass(frozen=True)
class Availability:
    """The plan must fit on the cores that are still alive.

    The degraded-mode constraint (serving/faults.py): after a permanent
    core/cluster loss, ``alive`` holds the surviving per-core-type
    counts, and any plan whose stages demand more cores of a type than
    survive cannot execute at all — a *safety* failure (severity 0, like
    :class:`PowerCap`).  Violators rank by fewest dead cores demanded
    (closest to schedulable), then by score.  Build from the surviving
    sub-platform with :meth:`from_platform` (the same
    ``HeteroPlatform.subset`` the degraded re-plan searches over).
    """

    alive: Tuple[Tuple[str, int], ...]
    name: str = dataclasses.field(default="availability", repr=False)

    @classmethod
    def from_platform(cls, platform: HeteroPlatform) -> "Availability":
        return cls(
            alive=tuple((ct.name, ct.count) for ct in platform.core_types)
        )

    def violation(
        self, m: PlanMetrics, score: Tuple[float, ...]
    ) -> Optional[Violation]:
        if m.stages is None:
            raise ValueError(
                "Availability needs PlanMetrics.stages — score the plan "
                "through evaluate(), which records stage shapes"
            )
        demand: Dict[str, int] = {}
        for core_type, n in m.stages:
            demand[core_type] = demand.get(core_type, 0) + n
        alive = dict(self.alive)
        missing = sum(
            max(0, n - alive.get(core_type, 0))
            for core_type, n in demand.items()
        )
        if missing == 0:
            return None
        return (0, (-float(missing), score[0]))


@dataclasses.dataclass(frozen=True)
class Placement:
    """The plan must fit on one named board of a fleet.

    The fleet axis of :class:`Availability` (core/fleet.py): ``alive``
    holds the board's per-core-type counts, and a replica plan whose
    reserved cluster share (``PlanMetrics.share``, falling back to the
    stage demand for share-less plans) exceeds them cannot be placed
    there — a safety failure (severity 0).  Violators rank by fewest
    missing cores (closest to placeable), then by score.  Build from a
    board's platform with :meth:`for_board`.
    """

    board: str
    alive: Tuple[Tuple[str, int], ...]
    name: str = dataclasses.field(default="placement", repr=False)

    @classmethod
    def for_board(cls, board: str, platform: HeteroPlatform) -> "Placement":
        return cls(
            board=board,
            alive=tuple((ct.name, ct.count) for ct in platform.core_types),
        )

    def violation(
        self, m: PlanMetrics, score: Tuple[float, ...]
    ) -> Optional[Violation]:
        if m.share is not None:
            demand = {str(ct): int(n) for ct, n in m.share}
        elif m.stages is not None:
            demand = {}
            for core_type, n in m.stages:
                demand[core_type] = demand.get(core_type, 0) + n
        else:
            raise ValueError(
                "Placement needs PlanMetrics.share or .stages — score the "
                "plan through evaluate(), which records both"
            )
        alive = dict(self.alive)
        missing = sum(
            max(0, n - alive.get(core_type, 0))
            for core_type, n in demand.items()
        )
        if missing == 0:
            return None
        return (0, (-float(missing), score[0]))


# ----------------------------------------------------------------- evaluator
@dataclasses.dataclass(frozen=True)
class Evaluation:
    """The unified verdict: metrics + score + feasibility + rank.

    ``rank`` is the ONLY thing searches compare: ``(2, *score)`` when
    feasible, else ``(severity, *tail)`` of the most severe violated
    constraint.  Built so that for any two candidates of the same search,
    ``a.rank > b.rank`` iff the legacy rank key preferred ``a``."""

    plan: Plan
    metrics: PlanMetrics
    objective_name: str
    score: Tuple[float, ...]
    rank: Tuple[float, ...]
    feasible: bool
    binding: Optional[str] = None  # name of the most severe violated constraint


def evaluate(
    plan: Union[Plan, Any],
    T: TimeMatrix,
    platform: HeteroPlatform,
    *,
    objective: Union[str, Objective] = "throughput",
    constraints: Sequence[Any] = (),
    arrival_rate: Optional[float] = None,
    boundary_bytes: Optional[Sequence[int]] = None,
    backend: str = "model",
    n_images: int = 256,
    arrival_s: Optional[Sequence[float]] = None,
) -> Evaluation:
    """Score one plan — the single entry point every search ranks through.

    ``objective`` is a name from :data:`OBJECTIVES` or any callable
    ``PlanMetrics -> tuple``; ``constraints`` is any sequence of objects
    with ``violation(metrics, score) -> Optional[(severity, tail)]``
    (:class:`PowerCap`, :class:`MinThroughput`, :class:`SloP99`,
    :class:`TailSlo`, or user-defined).  ``backend="model"`` is the
    analytic path (what the searches iterate); ``backend="simulate"``
    re-scores the same plan through the discrete-event simulator
    (``arrival_s`` switches it open-loop), so ground-truth cross-checks
    share the objectives/constraints with the search itself.

    Legacy plan objects are accepted and converted via
    :meth:`Plan.from_legacy`.
    """
    if not isinstance(plan, Plan):
        plan = Plan.from_legacy(plan)
    if isinstance(objective, str):
        try:
            obj_fn = OBJECTIVES[objective]
        except KeyError:
            raise ValueError(
                f"unknown objective {objective!r}; one of "
                f"{tuple(OBJECTIVES)} (or pass a callable)"
            ) from None
        obj_name = objective
        if objective in _NEEDS_RATE and arrival_rate is None and arrival_s is None:
            raise ValueError(f"objective {objective!r} requires arrival_rate")
    else:
        obj_fn = objective
        obj_name = getattr(objective, "__name__", "custom")
    pplan = plan.as_pipeline_plan()

    if backend == "model":
        base = pplan.stage_times(T)
        if plan.stage_freqs is None:
            times = list(base)
        else:
            times = [
                t * platform.freq_scale(stage[0], f)
                for t, stage, f in zip(base, plan.stages, plan.stage_freqs)
            ]
        cycle = max(max(times), 1e-12)
        freqs = plan.stage_freqs or (None,) * plan.p
        energy = sum(
            platform.active_power_w(stage[0], stage[1], f) * t
            for stage, f, t in zip(plan.stages, freqs, times)
        )
        prediction = None
        p99 = None
        if arrival_rate is not None:
            prediction = predict_latency(
                pplan,
                T,
                platform,
                arrival_rate,
                stage_freqs=plan.stage_freqs,
                boundary_bytes=boundary_bytes,
            )
            p99 = prediction.p99_s
        metrics = PlanMetrics(
            stage_times_s=tuple(times),
            cycle_s=cycle,
            throughput=1.0 / cycle,
            energy_per_image_j=energy,
            avg_power_w=energy / cycle,
            p99_s=p99,
            prediction=prediction,
            backend="model",
            stages=tuple(plan.stages),
            share=plan.share,
        )
    elif backend == "simulate":
        res = simulate(
            pplan,
            T,
            platform,
            n_images=n_images,
            boundary_bytes=boundary_bytes,
            stage_freqs=plan.stage_freqs,
            arrival_s=arrival_s,
        )
        n_done = max(len(res.finish_times), 1)
        tp = res.steady_throughput
        metrics = PlanMetrics(
            stage_times_s=tuple(res.stage_busy_s),
            cycle_s=(1.0 / tp) if tp > 0.0 else math.inf,
            throughput=tp,
            energy_per_image_j=res.energy_j / n_done,
            avg_power_w=res.avg_power_w,
            p99_s=res.latency_p99_s if arrival_s is not None else None,
            prediction=None,
            backend="simulate",
            stages=tuple(plan.stages),
            share=plan.share,
        )
    else:
        raise ValueError(f"unknown backend {backend!r}; 'model' or 'simulate'")

    score = tuple(obj_fn(metrics))
    worst: Optional[Tuple[int, Tuple[float, ...], str]] = None
    for c in constraints:
        v = c.violation(metrics, score)
        if v is None:
            continue
        sev, tail = v
        nm = getattr(c, "name", type(c).__name__)
        if worst is None or sev < worst[0]:
            worst = (sev, tail, nm)
    if worst is None:
        return Evaluation(
            plan=plan,
            metrics=metrics,
            objective_name=obj_name,
            score=score,
            rank=(2,) + score,
            feasible=True,
        )
    sev, tail, nm = worst
    return Evaluation(
        plan=plan,
        metrics=metrics,
        objective_name=obj_name,
        score=score,
        rank=(sev,) + tuple(tail),
        feasible=False,
        binding=nm,
    )


# ------------------------------------------- multi-model aggregate objectives
#: fairness mode -> aggregator over the weighted per-model throughputs.
#: "sum" is utilitarian (machine-wide goodput), "max-min" egalitarian
#: (the worst model's weighted rate; set w_m = 1/demand_m to equalise
#: heterogeneous demands).
FAIRNESS: Dict[str, Callable[[Sequence[float]], float]] = {
    "sum": sum,
    "max-min": min,
}


def partition_parts(
    throughputs: Sequence[float],
    weights: Optional[Sequence[float]] = None,
    slo_rates: Optional[Sequence[float]] = None,
    fairness: str = "sum",
) -> Tuple[float, float]:
    """(aggregate score, total relative SLO shortfall) for one cluster-share
    assignment — the two components every partition ranking is built from."""
    m = len(throughputs)
    ws = list(weights) if weights is not None else [1.0] * m
    slos = list(slo_rates) if slo_rates is not None else [0.0] * m
    if len(ws) != m or len(slos) != m:
        raise ValueError("weights/slo_rates must match throughputs")
    if fairness not in FAIRNESS:
        raise ValueError(f"unknown fairness {fairness!r}")
    score = FAIRNESS[fairness]([w * tp for w, tp in zip(ws, throughputs)])
    shortfall = sum(
        max(0.0, 1.0 - tp / slo)
        for tp, slo in zip(throughputs, slos)
        if slo > 0.0
    )
    return score, shortfall


def partition_score(
    throughputs: Sequence[float],
    weights: Optional[Sequence[float]] = None,
    slo_rates: Optional[Sequence[float]] = None,
    fairness: str = "sum",
) -> float:
    """The scalar reported form: score minus :data:`SLO_PENALTY` per unit
    of relative shortfall (searches rank via :func:`partition_rank_key`,
    which is immune to throughputs outscaling the finite penalty)."""
    score, shortfall = partition_parts(throughputs, weights, slo_rates, fairness)
    return score - SLO_PENALTY * shortfall


def partition_rank_key(
    score: float, shortfall: float, power_ok: bool = True
) -> Tuple[Any, ...]:
    """Lexicographic share-assignment rank: feasibility (every SLO floor
    met AND every share under its power slice) beats any score, then
    least total miss, then score — the same feasibility-then-score idiom
    :func:`evaluate` uses for single plans."""
    return (shortfall == 0.0 and power_ok, -shortfall, score)
