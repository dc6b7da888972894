"""Design-space exploration — the paper's Algorithms 1-3, implemented
faithfully.

* :func:`find_split`  — Algorithm 1: water-flow split of a contiguous layer
  range between two adjacent stages.
* :func:`work_flow`   — Algorithm 2: iterate find_split over all adjacent
  stage pairs until the allocation stabilises.
* :func:`merge_stage` — Algorithm 3: start from one-core-per-stage and merge
  adjacent same-type stages while Eq. 14 predicts an improvement.

The paper's pseudocode for Algorithm 3 "break"s a cluster loop on the first
unhelpful merge; its worked examples (ResNet50 -> B4-s2-s2, MobileNet ->
B2-B2-s3-s1) show that after an unhelpful merge the search *advances to the
next adjacent pair* within the cluster rather than abandoning it — we
implement that semantics (stay on a pair after a successful merge so a
grown stage can keep absorbing, advance past an unhelpful one).

An exhaustive search over (pipeline x contiguous split) is provided for
small instances; tests use it to bound the heuristic's optimality gap.

Beyond the paper, this module also implements the *two-level* partition
DSE for multi-model co-serving (:func:`partition_search`): the cluster is
first partitioned into disjoint core *shares*, one per co-resident model,
then ``pipe_it_search`` balances each model's layers within its share —
"partition clusters across models, then partition layers within each
share".  Assignments are scored by an aggregate objective (weighted sum
of per-model Eq. 12 throughputs, with per-model SLO throughput floors);
:func:`exhaustive_partition` is the oracle for small instances.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .pipeline import (
    Allocation,
    Pipeline,
    PipelinePlan,
    TimeMatrix,
    contiguous_allocation,
    enumerate_pipelines,
    stage_time,
)
from .plan import (
    SLO_PENALTY,
    Evaluation,
    FreqAssignment,
    MinThroughput,
    Plan,
    PowerCap,
    Share,
    SloP99,
    TailSlo,
    partition_parts,
    partition_rank_key,
    partition_score,
)
from .plan import evaluate as evaluate_plan
from .platform import HeteroPlatform, StageConfig
from .queueing import LatencyPrediction


def find_split(
    layers: Sequence[int],
    T: TimeMatrix,
    stage_a: StageConfig,
    stage_b: StageConfig,
    rule: str = "paper",
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Algorithm 1: split ``layers`` (ordered) between adjacent stages.

    All work starts on the faster stage ``stage_a``; layers flow one at a
    time from the tail of ``stage_a`` to the head of ``stage_b``.

    rule="paper":  move while the donor stage would remain the bottleneck
      (the paper's exact condition — conservative: it can stop one move
      short of the best split).
    rule="minmax": move while the move strictly reduces
      max(t_left, t_right).  Because t_left is monotonically decreasing
      and t_right monotonically increasing in the number of moved layers,
      the max is unimodal and this greedy rule finds the *optimal*
      contiguous two-way split.  Beyond-paper improvement (DESIGN.md §2).
    """
    left = list(layers)
    right: List[int] = []
    t_left = stage_time(T, left, stage_a)
    t_right = 0.0
    while left:
        lj = left[-1]
        t_left_new = t_left - T[lj][stage_a]
        t_right_new = t_right + T[lj][stage_b]
        if rule == "paper":
            helpful = t_left_new > t_right_new
        elif rule == "minmax":
            helpful = max(t_left_new, t_right_new) < max(t_left, t_right)
        else:
            raise ValueError(f"unknown rule {rule!r}")
        if helpful:  # move of l_j is helpful
            left.pop()
            right.insert(0, lj)
            t_left, t_right = t_left_new, t_right_new
        else:  # further flow of workload will not be helpful
            break
    return tuple(left), tuple(right)


def work_flow(
    pipeline: Pipeline,
    layers: Sequence[int],
    T: TimeMatrix,
    max_rounds: int = 100,
    rule: str = "paper",
) -> Allocation:
    """Algorithm 2: iterative pairwise rebalancing until a fixed point."""
    p = pipeline.p
    alloc: List[Tuple[int, ...]] = [tuple(layers)] + [()] * (p - 1)
    old: Optional[List[Tuple[int, ...]]] = None
    rounds = 0
    while alloc != old and rounds < max_rounds:
        old = list(alloc)
        for i in range(p - 1):
            pool = tuple(alloc[i]) + tuple(alloc[i + 1])
            li, lj = find_split(
                pool, T, pipeline.stages[i], pipeline.stages[i + 1], rule=rule
            )
            alloc[i], alloc[i + 1] = li, lj
        rounds += 1
    return tuple(alloc)


def _plan(pipeline: Pipeline, alloc: Allocation) -> PipelinePlan:
    return PipelinePlan(pipeline=pipeline, allocation=alloc)


def merge_stage(
    layers: Sequence[int],
    platform: HeteroPlatform,
    T: TimeMatrix,
) -> PipelinePlan:
    """Algorithm 3: stage-configuration search by merging.

    Starts from an ``(H_B + H_s)``-stage pipeline of single cores (Big
    stages first), rebalances with work_flow, then greedily merges adjacent
    same-type stages while Eq. 14 holds.
    """
    stages: List[StageConfig] = []
    for ct in platform.core_types:
        stages.extend([(ct.name, 1)] * ct.count)
    pipeline = Pipeline(stages=tuple(stages))
    alloc = work_flow(pipeline, layers, T)

    def eq14_merge_helpful(i: int) -> bool:
        """Eq. 14: merged stage beats the slower of the two originals."""
        (ta, ca), (tb, cb) = pipeline.stages[i], pipeline.stages[i + 1]
        merged: StageConfig = (ta, ca + cb)
        t_merged = stage_time(T, alloc[i] + alloc[i + 1], merged)
        t_i = stage_time(T, alloc[i], pipeline.stages[i])
        t_j = stage_time(T, alloc[i + 1], pipeline.stages[i + 1])
        return t_merged < max(t_i, t_j)

    i = 0
    while i < pipeline.p - 1:
        (ta, _), (tb, _) = pipeline.stages[i], pipeline.stages[i + 1]
        if ta != tb:  # cluster boundary: never mix core types in a stage
            i += 1
            continue
        if eq14_merge_helpful(i):
            new_stages = list(pipeline.stages)
            merged = (ta, new_stages[i][1] + new_stages[i + 1][1])
            new_stages[i : i + 2] = [merged]
            pipeline = Pipeline(stages=tuple(new_stages))
            alloc = work_flow(pipeline, layers, T)
            # stay at i: the grown stage may keep absorbing its neighbour
        else:
            i += 1

    # Drop stages that received no layers (their cores stay idle; the
    # paper's final configurations never contain empty stages).
    kept = [
        (st, al)
        for st, al in zip(pipeline.stages, alloc)
        if al
    ]
    pipeline = Pipeline(stages=tuple(st for st, _ in kept))
    alloc = tuple(al for _, al in kept)
    return _plan(pipeline, alloc)


def _sweep_plans(
    n_layers: int, platform: HeteroPlatform, T: TimeMatrix
) -> List[PipelinePlan]:
    """The sweep-mode candidate set: every pipeline (plus the
    single-cluster degenerates), work_flow(minmax)-balanced, empty stages
    dropped.  Shared by :func:`pipeline_sweep` (throughput ranking) and
    the power-aware search (its own objective) so both always explore the
    SAME design space."""
    layers = list(range(n_layers))
    plans: List[PipelinePlan] = []
    h = platform.total_cores()
    for p in range(1, h + 1):
        pipes = (
            enumerate_pipelines(platform, p)
            if p > 1
            else [Pipeline(stages=((ct.name, ct.count),)) for ct in platform.core_types]
        )
        for pipeline in pipes:
            alloc = work_flow(pipeline, layers, T, rule="minmax")
            kept = [(st, al) for st, al in zip(pipeline.stages, alloc) if al]
            plans.append(
                _plan(
                    Pipeline(stages=tuple(st for st, _ in kept)),
                    tuple(al for _, al in kept),
                )
            )
    return plans


def pipeline_sweep(
    n_layers: int,
    platform: HeteroPlatform,
    T: TimeMatrix,
) -> PipelinePlan:
    """Beyond-paper mode: the number of distinct *pipelines* is small
    (Eq. 1 gives 64 on the 4+4 platform) — the exponential blow-up is in
    the split points, which ``work_flow`` resolves heuristically.  Running
    work_flow on every pipeline is cheap and never worse than Algorithm 3
    (recorded in DESIGN.md §2 / EXPERIMENTS.md §Perf as an improvement).

    Candidates are ranked through the unified evaluator (``core.plan``);
    ``max`` keeps the first of rank-equal candidates, matching the
    pre-IR ``tp > best_tp`` loop exactly."""
    return max(
        _sweep_plans(n_layers, platform, T),
        key=lambda plan: evaluate_plan(Plan.from_legacy(plan), T, platform).rank,
    )


def pipe_it_search(
    n_layers: int,
    platform: HeteroPlatform,
    T: TimeMatrix,
    mode: str = "merge",
    *,
    power_cap_w: Optional[float] = None,
    objective: str = "throughput",
    slo_p99_ms: Optional[float] = None,
    arrival_rate: Optional[float] = None,
) -> PipelinePlan:
    """The Pipe-it DSE entry point (paper §VI).

    mode="merge"  — the paper's Algorithm 3 (faithful).
    mode="sweep"  — beyond-paper work_flow-over-all-pipelines.
    mode="best"   — run both, return the higher-throughput plan.

    With ``power_cap_w`` set (watts of modeled average active power) or
    ``objective="throughput_per_watt"``, the search gains the DVFS
    dimension and returns a :class:`PowerAwarePlan` (plan + per-stage OPP
    assignment) instead of a bare :class:`PipelinePlan` — see
    :func:`power_aware_search`.

    With ``slo_p99_ms``/``arrival_rate`` set (an end-to-end p99 budget in
    ms and the open-loop Poisson rate in img/s), candidates are ranked by
    SLO feasibility BEFORE throughput — the serving regime, where the
    throughput-optimal deep pipeline is often the tail-latency-worst plan
    — and the result is a :class:`SloPlan` (see
    :func:`latency_aware_search`).  Combined with the power arguments the
    SLO becomes an extra feasibility constraint on the DVFS search (a
    :class:`PowerAwarePlan` whose clocks never drop below what the tail
    budget needs).
    """
    if slo_p99_ms is not None and arrival_rate is None:
        raise ValueError("slo_p99_ms requires arrival_rate")
    if power_cap_w is not None or objective != "throughput":
        return power_aware_search(
            n_layers, platform, T, mode=mode,
            power_cap_w=power_cap_w, objective=objective,
            slo_p99_s=None if slo_p99_ms is None else slo_p99_ms / 1e3,
            arrival_rate=arrival_rate,
        )
    if slo_p99_ms is not None:
        return latency_aware_search(
            n_layers, platform, T,
            arrival_rate=arrival_rate, slo_p99_s=slo_p99_ms / 1e3, mode=mode,
        )
    if mode == "merge":
        return merge_stage(list(range(n_layers)), platform, T)
    if mode == "sweep":
        return pipeline_sweep(n_layers, platform, T)
    if mode == "best":
        a = merge_stage(list(range(n_layers)), platform, T)
        b = pipeline_sweep(n_layers, platform, T)
        ra = evaluate_plan(Plan.from_legacy(a), T, platform).rank
        rb = evaluate_plan(Plan.from_legacy(b), T, platform).rank
        return a if ra >= rb else b
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# Frequency- and power-aware planning: the DVFS dimension of the DSE
# ---------------------------------------------------------------------------
#
# The paper plans only for peak img/s at an implicit fixed clock; edge
# deployments plan under power/thermal envelopes (Synergy 1804.00706, PICO
# 2206.08662).  This section adds per-stage frequency assignment on top of
# the (pipeline x allocation) search: every stage picks an OPP from its
# cluster's table (platform.py), stage times scale by (f_max/f)^kappa, and
# plans are ranked by `objective` subject to an average-power cap
#
#     P_avg = sum_i P_i(f_i) * t_i(f_i) / max_i t_i(f_i)
#
# (each stage is busy t_i out of every cycle max_i t_i; idle power is not
# modeled — DESIGN.md §7).  The assignment search is exact without being
# exhaustive: for any target cycle time tau, the power-minimal assignment
# clocks each stage at the LOWEST OPP meeting tau (power is monotone in f),
# and the optimal tau equals some stage's time at some OPP — so scanning
# the n_stages x n_OPP candidate taus covers the whole Pareto frontier.
# "Race to idle" (everything at f_max) is always emitted as a candidate;
# under the convex V(f) curve it loses to pace-to-bottleneck on energy,
# which is exactly the trade the benchmark quantifies.

#: "throughput" — max img/s (under the cap); "throughput_per_watt" — max
#: img/s per modeled watt; "min_energy" — min energy per image subject to
#: ``min_throughput`` (the iso-throughput / SLO-rate deployment: pace every
#: stage to the demand, not to the silicon's peak).
POWER_OBJECTIVES = ("throughput", "throughput_per_watt", "min_energy")


@dataclasses.dataclass(frozen=True)
class PowerAwarePlan:
    """A pipeline plan plus its per-stage frequency (DVFS) assignment."""

    plan: PipelinePlan
    stage_freqs: FreqAssignment
    throughput: float  # Eq. 12 at the assigned frequencies (img/s)
    avg_power_w: float  # modeled average active power over a cycle
    energy_per_image_j: float  # sum_i P_i * t_i
    objective: float  # the ranked score under `objective_name`
    objective_name: str = "throughput"
    power_cap_w: Optional[float] = None
    feasible: bool = True  # avg_power_w <= power_cap_w (True when uncapped)
    # SLO dimension (None when the search was latency-blind): predicted
    # end-to-end p99 at the assigned clocks under Poisson arrivals at
    # ``arrival_rate`` (core.queueing), and the budget it was held to.
    # ``feasible`` additionally requires p99_s <= slo_p99_s when set.
    p99_s: Optional[float] = None
    slo_p99_s: Optional[float] = None
    arrival_rate: Optional[float] = None
    # The unified-evaluator record this shim was scored by (core.plan);
    # None only on hand-constructed instances.
    evaluation: Optional[Evaluation] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    def notation(self) -> str:
        freqs = "/".join(
            "fix" if f is None else f"{f / 1e9:.2f}GHz" for f in self.stage_freqs
        )
        return f"{self.plan.notation()}  @ {freqs}"

    def plan_ir(self) -> Plan:
        """This point of the design space as the unified IR."""
        return Plan.from_legacy(self)


def stage_times_at(
    plan: PipelinePlan,
    T: TimeMatrix,
    platform: HeteroPlatform,
    stage_freqs: FreqAssignment,
) -> List[float]:
    """Per-stage service times with each stage at its assigned OPP."""
    if len(stage_freqs) != plan.pipeline.p:
        raise ValueError(
            f"{len(stage_freqs)} stage_freqs for {plan.pipeline.p} stages"
        )
    return [
        stage_time(T, layers, stage) * platform.freq_scale(stage[0], f)
        for layers, stage, f in zip(
            plan.allocation, plan.pipeline.stages, stage_freqs
        )
    ]


def max_freqs(plan: PipelinePlan, platform: HeteroPlatform) -> FreqAssignment:
    """The race-to-idle assignment: every stage at its cluster's top OPP."""
    return tuple(
        (platform.freq_levels(ct) or (None,))[-1]
        for ct, _ in plan.pipeline.stages
    )


def evaluate_frequencies(
    plan: PipelinePlan,
    T: TimeMatrix,
    platform: HeteroPlatform,
    stage_freqs: FreqAssignment,
    power_cap_w: Optional[float] = None,
    objective: str = "throughput",
    min_throughput: Optional[float] = None,
    slo_p99_s: Optional[float] = None,
    arrival_rate: Optional[float] = None,
) -> PowerAwarePlan:
    """Score one (plan, frequency assignment) point of the design space.

    With ``slo_p99_s``/``arrival_rate`` set, the M/D/1 tail model
    (core.queueing) predicts end-to-end p99 at these clocks — base latency
    (sum of scaled stage times) plus the bottleneck's p99 queue wait at
    the offered rate — and folds it into ``feasible``.  This is what
    makes SLO-aware DVFS "never down-clock into an SLO violation": a
    slower OPP that still meets the cap but pushes predicted p99 past the
    budget is simply infeasible.
    """
    if objective not in POWER_OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; one of {POWER_OBJECTIVES}"
        )
    if (slo_p99_s is None) != (arrival_rate is None):
        raise ValueError("slo_p99_s and arrival_rate must be set together")
    if len(stage_freqs) != plan.pipeline.p:
        raise ValueError(
            f"{len(stage_freqs)} stage_freqs for {plan.pipeline.p} stages"
        )
    constraints = []
    if power_cap_w is not None:
        constraints.append(PowerCap(power_cap_w))
    if min_throughput is not None:
        constraints.append(MinThroughput(min_throughput))
    if slo_p99_s is not None:
        constraints.append(SloP99(slo_p99_s))
    ev = evaluate_plan(
        Plan(
            stages=plan.pipeline.stages,
            allocation=plan.allocation,
            stage_freqs=tuple(stage_freqs),
        ),
        T,
        platform,
        objective=objective,
        constraints=constraints,
        arrival_rate=arrival_rate,
    )
    m = ev.metrics
    return PowerAwarePlan(
        plan=plan,
        stage_freqs=tuple(stage_freqs),
        throughput=m.throughput,
        avg_power_w=m.avg_power_w,
        energy_per_image_j=m.energy_per_image_j,
        objective=ev.score[0],
        objective_name=objective,
        power_cap_w=power_cap_w,
        feasible=ev.feasible,
        p99_s=m.p99_s if slo_p99_s is not None else None,
        slo_p99_s=slo_p99_s,
        arrival_rate=arrival_rate,
        evaluation=ev,
    )


def _require_power_model(
    platform: HeteroPlatform, power_cap_w: Optional[float]
) -> None:
    """A cap against a platform that models zero power would be *trivially*
    satisfied — every plan draws 0 modeled watts — which silently tells the
    caller their envelope is enforced when it was never evaluated."""
    if power_cap_w is not None and platform.max_power_w() <= 0.0:
        raise ValueError(
            f"power_cap_w={power_cap_w} on platform {platform.name!r}, which "
            "models no power (no OPP tables / zero capacitance) — the cap "
            "would be vacuously met; use a DVFS platform like hikey970()"
        )


def _power_rank_key(
    p: PowerAwarePlan,
    power_cap_w: Optional[float] = None,
    min_throughput: Optional[float] = None,
):
    """Feasible beats infeasible; among feasible, best objective then
    least power.  Infeasible candidates rank by WHY they are infeasible:
    a cap violation is a safety problem (least power first — closest to
    the envelope), but a missed throughput floor with the cap intact
    means demand outstrips capacity — best effort there is to run as
    FAST as the cap allows, not to idle at minimum clocks.

    Since the plan-IR migration this ordering lives in ``core.plan``
    (severity-0 :class:`~.plan.PowerCap` vs severity-1
    :class:`~.plan.MinThroughput`/:class:`~.plan.SloP99` tails); this
    shim returns the stored :class:`~.plan.Evaluation` rank and only
    reconstructs the key for hand-built instances."""
    if p.evaluation is not None:
        return p.evaluation.rank
    if p.feasible:
        return (2, p.objective, -p.avg_power_w)
    cap_ok = power_cap_w is None or p.avg_power_w <= power_cap_w * (1 + 1e-9)
    if cap_ok:  # only the min_throughput floor is missed
        return (1, p.throughput, -p.avg_power_w)
    return (0, -p.avg_power_w, p.objective)


def assign_frequencies(
    plan: PipelinePlan,
    T: TimeMatrix,
    platform: HeteroPlatform,
    power_cap_w: Optional[float] = None,
    objective: str = "throughput",
    min_throughput: Optional[float] = None,
    slo_p99_s: Optional[float] = None,
    arrival_rate: Optional[float] = None,
) -> PowerAwarePlan:
    """Optimal per-stage OPP assignment for a fixed (pipeline, allocation).

    Scans the candidate cycle times (every stage's time at every OPP —
    the only values the optimum can take) and, per candidate tau, clocks
    each stage at the lowest OPP meeting tau (slack-matched: a stage
    never clocks above what the bottleneck needs).  Exact versus
    :func:`exhaustive_frequency_assignment` because per-stage power is
    monotone in f and stages are independent given tau.  The race-to-idle
    (all-f_max) assignment is always a candidate; ``min_throughput`` adds
    the iso-throughput floor (pace to the demand rate, not the silicon).
    """
    _require_power_model(platform, power_cap_w)
    base = plan.stage_times(T)
    per_stage: List[List[Tuple[Optional[float], float]]] = []
    for i, (ct, _n) in enumerate(plan.pipeline.stages):
        freqs = platform.freq_levels(ct) or (None,)
        per_stage.append(
            [(f, base[i] * platform.freq_scale(ct, f)) for f in freqs]
        )
    taus = sorted({t for opts in per_stage for _f, t in opts})
    candidates: List[PowerAwarePlan] = [
        evaluate_frequencies(
            plan, T, platform, max_freqs(plan, platform),
            power_cap_w, objective, min_throughput,
            slo_p99_s, arrival_rate,
        )  # race-to-idle
    ]
    miss = object()  # distinct from None: a fixed-clock stage's OPP IS None
    for tau in taus:
        freqs: List[Optional[float]] = []
        for opts in per_stage:
            pick = next(  # ascending f <=> descending t: first hit = lowest f
                (f for f, t in opts if t <= tau * (1 + 1e-12)), miss
            )
            if pick is miss:  # tau faster than this stage's f_max
                break
            freqs.append(pick)
        if len(freqs) != plan.pipeline.p:
            continue
        candidates.append(
            evaluate_frequencies(
                plan, T, platform, tuple(freqs),
                power_cap_w, objective, min_throughput,
                slo_p99_s, arrival_rate,
            )
        )
    return max(
        candidates,
        key=lambda c: _power_rank_key(c, power_cap_w, min_throughput),
    )


def exhaustive_frequency_assignment(
    plan: PipelinePlan,
    T: TimeMatrix,
    platform: HeteroPlatform,
    power_cap_w: Optional[float] = None,
    objective: str = "throughput",
    min_throughput: Optional[float] = None,
    slo_p99_s: Optional[float] = None,
    arrival_rate: Optional[float] = None,
) -> PowerAwarePlan:
    """Oracle: every per-stage OPP combination (|OPP|^p — small instances
    only); tests bound :func:`assign_frequencies` against it."""
    per_stage = [
        platform.freq_levels(ct) or (None,) for ct, _ in plan.pipeline.stages
    ]
    best: Optional[PowerAwarePlan] = None
    for combo in itertools.product(*per_stage):
        cand = evaluate_frequencies(
            plan, T, platform, combo, power_cap_w, objective, min_throughput,
            slo_p99_s, arrival_rate,
        )
        if best is None or _power_rank_key(
            cand, power_cap_w, min_throughput
        ) > _power_rank_key(best, power_cap_w, min_throughput):
            best = cand
    assert best is not None
    return best


def _candidate_plans(
    n_layers: int, platform: HeteroPlatform, T: TimeMatrix, mode: str
) -> List[PipelinePlan]:
    """The plan candidates the selected DSE mode would consider, surfaced
    so the power-aware search can re-rank them under its own objective
    (the throughput-optimal pipeline is NOT always the capped or
    per-watt-optimal one — e.g. a cap may favour fewer, slower stages)."""
    if mode not in ("merge", "sweep", "best"):
        raise ValueError(f"unknown mode {mode!r}")
    plans: List[PipelinePlan] = []
    if mode in ("merge", "best"):
        plans.append(merge_stage(list(range(n_layers)), platform, T))
    if mode in ("sweep", "best"):
        plans.extend(_sweep_plans(n_layers, platform, T))
    seen = set()
    unique = []
    for pl in plans:
        key = (pl.pipeline.stages, pl.allocation)
        if key not in seen:
            seen.add(key)
            unique.append(pl)
    return unique


def power_aware_search(
    n_layers: int,
    platform: HeteroPlatform,
    T: TimeMatrix,
    mode: str = "best",
    power_cap_w: Optional[float] = None,
    objective: str = "throughput",
    min_throughput: Optional[float] = None,
    slo_p99_s: Optional[float] = None,
    arrival_rate: Optional[float] = None,
) -> PowerAwarePlan:
    """The DVFS-extended DSE entry point: (pipeline x allocation x per-stage
    OPP) ranked by ``objective`` under an average-power cap.

    ``T`` stays the 2-D f_max time matrix (the factored form of the
    (layer, config, freq) matrix — frequency enters via the platform's
    ``freq_scale``, exactly how the calibrated corrections compose).
    Returns the best feasible :class:`PowerAwarePlan`; if no candidate
    meets the cap even fully down-clocked, the least-power assignment is
    returned with ``feasible=False`` (best effort under overload) — the
    caller decides whether to shed load instead.
    """
    _require_power_model(platform, power_cap_w)
    best: Optional[PowerAwarePlan] = None
    for pl in _candidate_plans(n_layers, platform, T, mode):
        cand = assign_frequencies(
            pl, T, platform, power_cap_w, objective, min_throughput,
            slo_p99_s, arrival_rate,
        )
        if best is None or _power_rank_key(
            cand, power_cap_w, min_throughput
        ) > _power_rank_key(best, power_cap_w, min_throughput):
            best = cand
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# SLO-aware planning: rank by tail-latency feasibility before throughput
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SloPlan:
    """A plan ranked under an end-to-end p99 SLO at an offered rate.

    ``feasible`` means the queueing model predicts p99 within
    ``headroom * slo_p99_s`` — the margin absorbs model error (the M/D/1
    reduction over-/under-shoots the simulator by up to ~15% near high
    utilization; tests/test_queueing.py pins the band) so a plan the
    search calls feasible is not shown violating the SLO by the
    simulator.
    """

    plan: PipelinePlan
    prediction: LatencyPrediction
    throughput: float  # Eq. 12 saturation capacity (img/s)
    arrival_rate: float
    slo_p99_s: float
    headroom: float
    feasible: bool
    # The unified-evaluator record this shim was scored by (core.plan);
    # None only on hand-constructed instances.
    evaluation: Optional[Evaluation] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    def plan_ir(self) -> Plan:
        """This point of the design space as the unified IR."""
        return Plan.from_legacy(self)

    def notation(self) -> str:
        p99 = (
            "inf" if not self.prediction.stable
            else f"{self.prediction.p99_s * 1e3:.1f}ms"
        )
        verdict = "<=" if self.feasible else ">"
        return (
            f"{self.plan.notation()}  @ p99~{p99} "
            f"{verdict} {self.slo_p99_s * 1e3:.1f}ms SLO"
        )


def _slo_rank_key(s: SloPlan):
    """Feasibility floor first (the ``partition_search`` lexicographic
    idiom): among feasible plans, most throughput, then lowest p99; among
    stable-but-over-budget plans, closest to the budget; unstable plans
    last, least-overloaded first.

    Since the plan-IR migration this ordering lives in ``core.plan``
    (the ``"slo_throughput"`` objective + :class:`~.plan.TailSlo`
    constraint); this shim returns the stored
    :class:`~.plan.Evaluation` rank and only reconstructs the key for
    hand-built instances."""
    if s.evaluation is not None:
        return s.evaluation.rank
    if s.feasible:
        return (2, s.throughput, -s.prediction.p99_s)
    if s.prediction.stable:
        return (1, -s.prediction.p99_s, s.throughput)
    return (0, -s.prediction.utilization, s.throughput)


def latency_aware_search(
    n_layers: int,
    platform: HeteroPlatform,
    T: TimeMatrix,
    *,
    arrival_rate: float,
    slo_p99_s: float,
    mode: str = "best",
    headroom: float = 0.9,
    boundary_bytes: Optional[Sequence[int]] = None,
) -> SloPlan:
    """SLO-first DSE over the same candidate plans the throughput search
    considers, plus every single-stage vocabulary config (the low-latency
    end of the space a saturation search never visits).

    The throughput-optimal deep pipeline maximises Eq. 12 but pays its
    depth in base latency (every stage time + boundary hop is on the
    critical path of EVERY image); under an open-loop rate with a p99
    budget, a shallower plan with a little less capacity is often the
    only feasible choice.  Candidates are ranked feasibility-first (see
    :func:`_slo_rank_key`); if nothing fits the budget the best-effort
    plan is returned with ``feasible=False`` — the caller decides whether
    to shed load or relax the SLO.
    """
    if arrival_rate <= 0.0:
        raise ValueError(f"arrival_rate {arrival_rate} <= 0")
    if slo_p99_s <= 0.0:
        raise ValueError(f"slo_p99_s {slo_p99_s} <= 0")
    if not 0.0 < headroom <= 1.0:
        raise ValueError(f"headroom {headroom} outside (0, 1]")
    plans = _candidate_plans(n_layers, platform, T, mode)
    all_layers = tuple(range(n_layers))
    seen = {(pl.pipeline.stages, pl.allocation) for pl in plans}
    for stage in platform.stage_vocabulary():  # p = 1 candidates
        pl = _plan(Pipeline(stages=(stage,)), (all_layers,))
        if (pl.pipeline.stages, pl.allocation) not in seen:
            plans.append(pl)
    constraints = (TailSlo(slo_p99_s, headroom=headroom),)
    best: Optional[SloPlan] = None
    for pl in plans:
        ev = evaluate_plan(
            Plan.from_legacy(pl),
            T,
            platform,
            objective="slo_throughput",
            constraints=constraints,
            arrival_rate=arrival_rate,
            boundary_bytes=boundary_bytes,
        )
        cand = SloPlan(
            plan=pl,
            prediction=ev.metrics.prediction,
            throughput=ev.metrics.throughput,
            arrival_rate=arrival_rate,
            slo_p99_s=slo_p99_s,
            headroom=headroom,
            feasible=ev.feasible,
            evaluation=ev,
        )
        if best is None or _slo_rank_key(cand) > _slo_rank_key(best):
            best = cand
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# Exhaustive reference search (small instances only; used by tests/benches)
# ---------------------------------------------------------------------------

def exhaustive_two_way_split(
    layers: Sequence[int],
    T: TimeMatrix,
    stage_a: StageConfig,
    stage_b: StageConfig,
) -> Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], float]:
    """Brute-force optimal contiguous two-way split of ``layers``.

    Tries every prefix/suffix cut (the only splits Algorithm 1 can emit)
    and returns ``((left, right), bottleneck)`` minimising
    ``max(T_left^a, T_right^b)``.  O(n^2); reference oracle for the
    ``find_split`` property tests."""
    ordered = list(layers)
    best: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None
    best_t = float("inf")
    for k in range(len(ordered) + 1):
        left, right = tuple(ordered[:k]), tuple(ordered[k:])
        t = max(stage_time(T, left, stage_a), stage_time(T, right, stage_b))
        if t < best_t:
            best, best_t = (left, right), t
    assert best is not None
    return best, best_t

def _exhaustive_plan(
    n_layers: int, platform: HeteroPlatform, T: TimeMatrix
) -> PipelinePlan:
    """True optimum over EVERY executable plan on ``platform``: all
    partial-cluster pipelines (``enumerate_pipelines(allow_partial=True)``
    — the closure of what merge/sweep can emit after dropping empty
    stages) x every contiguous non-empty layer split, plus every
    single-stage vocabulary config.  Exponential; the inner oracle of
    :func:`exhaustive_partition` and of small-instance
    :func:`partition_search` shares."""
    best: Optional[PipelinePlan] = None
    best_tp = -1.0
    for stage in platform.stage_vocabulary():  # p = 1: any (ct, c) config
        plan = _plan(Pipeline(stages=(stage,)), (tuple(range(n_layers)),))
        tp = plan.throughput(T)
        if tp > best_tp:
            best, best_tp = plan, tp
    top = min(platform.total_cores(), n_layers)
    for p in range(2, top + 1):
        for pipeline in enumerate_pipelines(platform, p, allow_partial=True):
            for cuts in itertools.combinations(range(1, n_layers), p - 1):
                alloc = contiguous_allocation(cuts, n_layers, p)
                plan = _plan(pipeline, alloc)
                tp = plan.throughput(T)
                if tp > best_tp:
                    best, best_tp = plan, tp
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# Two-level partition DSE: clusters across models, layers within each share
# ---------------------------------------------------------------------------

# Share and SLO_PENALTY live in core.plan since the IR migration; both
# remain importable from here (re-exported above) for compatibility.


def _nonneg_compositions(total: int, parts: int) -> List[Tuple[int, ...]]:
    if parts == 1:
        return [(total,)]
    out = []
    for first in range(total + 1):
        for rest in _nonneg_compositions(total - first, parts - 1):
            out.append((first, *rest))
    return out


def enumerate_shares(platform: HeteroPlatform, n_models: int) -> List[Tuple[Share, ...]]:
    """All ways to partition the platform's clusters into ``n_models``
    disjoint core shares.

    Every core is assigned to some model (the paper never idles silicon
    at the cluster level; a model's *inner* DSE may still leave share
    cores unused) and every model receives at least one core.  Returns,
    per assignment, one ``((core_type, count), ...)`` share per model —
    hashable, zero-count entries elided."""
    if n_models < 1:
        raise ValueError("need >= 1 model")
    if n_models > platform.total_cores():
        raise ValueError(
            f"{n_models} models cannot each get a core on "
            f"{platform.total_cores()}-core {platform.name!r}"
        )
    per_ct = [
        _nonneg_compositions(ct.count, n_models) for ct in platform.core_types
    ]
    names = [ct.name for ct in platform.core_types]
    out: List[Tuple[Share, ...]] = []
    for combo in itertools.product(*per_ct):
        shares = []
        for mi in range(n_models):
            share = tuple(
                (names[ci], combo[ci][mi])
                for ci in range(len(names))
                if combo[ci][mi] > 0
            )
            shares.append(share)
        if all(shares):  # every model got >= 1 core
            out.append(tuple(shares))
    return out


def partition_objective(
    throughputs: Sequence[float],
    weights: Optional[Sequence[float]] = None,
    slo_rates: Optional[Sequence[float]] = None,
    fairness: str = "sum",
) -> float:
    """Aggregate co-serving score for one cluster-share assignment.

    fairness="sum"     — utilitarian: ``sum_m w_m * tp_m``.  Maximises
      machine-wide goodput; right when per-model demand is open-ended.
    fairness="max-min" — egalitarian: ``min_m w_m * tp_m``.  Maximises
      the worst model's (weighted) rate; right when every model must
      sustain comparable demand (set ``w_m = 1/demand_m`` to equalise
      heterogeneous demands).

    Either way, each relative SLO shortfall is charged
    :data:`SLO_PENALTY` in the returned scalar.  The *searches* rank
    assignments lexicographically via :func:`_objective_parts` —
    feasibility first, then least total shortfall, then score — so a
    feasible assignment beats every infeasible one even when throughputs
    are large enough to swamp the finite penalty; this scalar is the
    reported/compared form of that same ordering.

    Since the IR migration both pieces live in ``core.plan``
    (:func:`~.plan.partition_parts` with the :data:`~.plan.FAIRNESS`
    registry, scalarised by :func:`~.plan.partition_score`); this
    function is the compatibility name."""
    return partition_score(throughputs, weights, slo_rates, fairness)


def _objective_parts(
    throughputs: Sequence[float],
    weights: Optional[Sequence[float]],
    slo_rates: Optional[Sequence[float]],
    fairness: str,
) -> Tuple[float, float]:
    """(score, total relative SLO shortfall) — shim over core.plan."""
    return partition_parts(throughputs, weights, slo_rates, fairness)


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    """One model's slice of a partition: its core share and inner plan."""

    name: str
    share: HeteroPlatform
    plan: PipelinePlan
    throughput: float  # predicted Eq. 12 rate on this model's time matrix
    # DVFS assignment for this model's stages (power-aware partitions only)
    power: Optional[PowerAwarePlan] = None

    def notation(self) -> str:
        return f"{self.name}@{self.plan.notation()}"

    def plan_ir(self) -> Plan:
        """This model's slice as the unified IR (model + share + clocks)."""
        return Plan.from_legacy(self)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """A full co-serving assignment: disjoint shares + per-model plans."""

    assignments: Tuple[ModelPlan, ...]
    objective: float
    feasible: bool  # every model met its SLO throughput floor
    total_power_w: float = 0.0  # summed modeled avg power (power-aware only)

    @property
    def names(self) -> List[str]:
        return [a.name for a in self.assignments]

    def __getitem__(self, name: str) -> ModelPlan:
        for a in self.assignments:
            if a.name == name:
                return a
        raise KeyError(name)

    def throughputs(self) -> Dict[str, float]:
        return {a.name: a.throughput for a in self.assignments}

    def plans(self) -> Dict[str, PipelinePlan]:
        return {a.name: a.plan for a in self.assignments}

    def plan_irs(self) -> Tuple[Plan, ...]:
        """Every model's slice as the unified IR, in assignment order."""
        return tuple(a.plan_ir() for a in self.assignments)

    def notation(self) -> str:
        return " | ".join(a.notation() for a in self.assignments)


def _search_over_shares(
    names: Sequence[str],
    Ts: Sequence[TimeMatrix],
    platform: HeteroPlatform,
    weights: Sequence[float],
    slo_rates: Sequence[float],
    fairness: str,
    inner,
) -> PartitionPlan:
    """Rank every cluster-share assignment by the aggregate objective.

    ``inner(model_index, share) -> PipelinePlan | PowerAwarePlan`` supplies
    the per-share layer (and, power-aware, frequency) search; memoized per
    (model, share) because the same share recurs across many assignments."""
    cache: Dict[
        Tuple[int, Share],
        Tuple[HeteroPlatform, PipelinePlan, float, Optional[PowerAwarePlan]],
    ] = {}

    def solve(mi: int, share: Share):
        key = (mi, share)
        if key not in cache:
            sub = platform.subset(dict(share))
            result = inner(mi, sub)
            if isinstance(result, PowerAwarePlan):
                cache[key] = (sub, result.plan, result.throughput, result)
            else:
                cache[key] = (sub, result, result.throughput(Ts[mi]), None)
        return cache[key]

    best: Optional[PartitionPlan] = None
    best_key = None
    for assignment in enumerate_shares(platform, len(names)):
        solved = [solve(mi, share) for mi, share in enumerate(assignment)]
        tps = [tp for _, _, tp, _ in solved]
        score, shortfall = _objective_parts(tps, weights, slo_rates, fairness)
        # power-infeasible shares count like SLO misses: a feasible
        # assignment (cap met everywhere) beats any infeasible one
        power_ok = all(pp is None or pp.feasible for _, _, _, pp in solved)
        # lexicographic: feasibility beats any score, then least miss,
        # then score — immune to throughputs outscaling the penalty
        # (the shared core.plan idiom)
        key = partition_rank_key(score, shortfall, power_ok)
        if best_key is None or key > best_key:
            best_key = key
            best = PartitionPlan(
                assignments=tuple(
                    ModelPlan(
                        name=nm, share=sub, plan=plan, throughput=tp, power=pp
                    )
                    for nm, (sub, plan, tp, pp) in zip(names, solved)
                ),
                objective=score - SLO_PENALTY * shortfall,
                feasible=shortfall == 0.0 and power_ok,
                total_power_w=sum(
                    pp.avg_power_w for _, _, _, pp in solved if pp is not None
                ),
            )
    assert best is not None
    return best


def _normalize_instances(
    instances: Mapping[str, TimeMatrix],
    weights: Optional[Mapping[str, float]],
    slo_rates: Optional[Mapping[str, float]],
):
    names = list(instances)
    if not names:
        raise ValueError("need >= 1 model instance")
    # a typo'd model name must not silently drop a weight or SLO floor
    for label, mapping in (("weights", weights), ("slo_rates", slo_rates)):
        unknown = [k for k in (mapping or {}) if k not in instances]
        if unknown:
            raise ValueError(
                f"{label} name unknown models {unknown}; instances are {names}"
            )
    Ts = [instances[nm] for nm in names]
    w = [float((weights or {}).get(nm, 1.0)) for nm in names]
    slo = [float((slo_rates or {}).get(nm, 0.0)) for nm in names]
    return names, Ts, w, slo


def partition_search(
    instances: Mapping[str, TimeMatrix],
    platform: HeteroPlatform,
    *,
    weights: Optional[Mapping[str, float]] = None,
    slo_rates: Optional[Mapping[str, float]] = None,
    mode: str = "best",
    exact_threshold: int = 8,
    fairness: str = "sum",
    power_cap_w: Optional[float] = None,
    power_objective: str = "throughput",
) -> PartitionPlan:
    """Two-level DSE for multi-model co-serving.

    Level 1 enumerates cluster-share assignments (exact — the space is
    small, Eq. 1-style counting over models instead of stages); level 2
    reuses :func:`pipe_it_search` to balance each model's layers within
    its share.  Models whose layer count is <= ``exact_threshold`` also
    get the exhaustive inner search (cheap at that size), so on small
    instances the result provably matches :func:`exhaustive_partition`.

    ``instances`` maps model name -> that model's time matrix (order
    defines model order); ``weights``/``slo_rates``/``fairness`` feed
    :func:`partition_objective`.

    ``power_cap_w`` bounds the MACHINE's modeled average active power:
    each share receives a cap slice proportional to its all-max power
    envelope (shares are disjoint, so the slices sum to the cap), and the
    inner search gains the DVFS dimension (:func:`power_aware_search`)
    under that slice and ``power_objective``.  Per-model frequency
    assignments land on ``ModelPlan.power``; an assignment whose every
    share meets its slice outranks any that does not.
    """
    names, Ts, w, slo = _normalize_instances(instances, weights, slo_rates)
    _require_power_model(platform, power_cap_w)
    power_aware = power_cap_w is not None or power_objective != "throughput"
    machine_power = platform.max_power_w() if power_aware else 0.0

    def inner(mi: int, sub: HeteroPlatform):
        n = len(Ts[mi])
        if power_aware:
            cap = None
            if power_cap_w is not None and machine_power > 0.0:
                cap = power_cap_w * sub.max_power_w() / machine_power
            return power_aware_search(
                n, sub, Ts[mi], mode=mode,
                power_cap_w=cap, objective=power_objective,
            )
        plan = pipe_it_search(n, sub, Ts[mi], mode=mode)
        if n <= exact_threshold:
            exact = _exhaustive_plan(n, sub, Ts[mi])
            if exact.throughput(Ts[mi]) > plan.throughput(Ts[mi]):
                plan = exact
        return plan

    return _search_over_shares(names, Ts, platform, w, slo, fairness, inner)


def exhaustive_partition(
    instances: Mapping[str, TimeMatrix],
    platform: HeteroPlatform,
    *,
    weights: Optional[Mapping[str, float]] = None,
    slo_rates: Optional[Mapping[str, float]] = None,
    fairness: str = "sum",
) -> PartitionPlan:
    """Oracle for :func:`partition_search`: the same exact share
    enumeration, but with the exhaustive inner search everywhere.
    Exponential in layer count; small instances only (tests/benches)."""
    names, Ts, w, slo = _normalize_instances(instances, weights, slo_rates)

    def inner(mi: int, sub: HeteroPlatform) -> PipelinePlan:
        return _exhaustive_plan(len(Ts[mi]), sub, Ts[mi])

    return _search_over_shares(names, Ts, platform, w, slo, fairness, inner)


def exhaustive_search(
    n_layers: int,
    platform: HeteroPlatform,
    T: TimeMatrix,
    max_stages: Optional[int] = None,
) -> PipelinePlan:
    """Brute-force over every pipeline (Eq. 1) and every contiguous split
    (Eq. 2).  Exponential; only for validating the heuristic."""
    best: Optional[PipelinePlan] = None
    best_tp = -1.0
    h = platform.total_cores()
    top = min(max_stages or h, h, n_layers)
    for p in range(1, top + 1):
        if p == 1:
            # Degenerate single-stage "pipelines": best homogeneous cluster.
            for ct in platform.core_types:
                plan = _plan(
                    Pipeline(stages=((ct.name, ct.count),)),
                    (tuple(range(n_layers)),),
                )
                tp = plan.throughput(T)
                if tp > best_tp:
                    best, best_tp = plan, tp
            continue
        for pipeline in enumerate_pipelines(platform, p):
            for cuts in itertools.combinations(range(1, n_layers), p - 1):
                alloc = contiguous_allocation(cuts, n_layers, p)
                plan = _plan(pipeline, alloc)
                tp = plan.throughput(T)
                if tp > best_tp:
                    best, best_tp = plan, tp
    assert best is not None
    return best
