"""Fleet-level DSE: models -> boards -> cluster shares -> layer pipelines.

Pipe-it's pipeline (Eq. 12) maxes out ONE big.LITTLE board; serving
millions of users is a fleet property.  This module lifts the two-level
partition DSE (core/dse.py) one level up: a *fleet* is N heterogeneous
:class:`~.platform.HeteroPlatform` boards, each with its own power
envelope, and :func:`fleet_search` decides

1. **models -> boards** — which boards host a replica of which model
   (exact enumeration over per-model board subsets, like the share
   level's Eq. 1-style counting),
2. **boards -> cluster shares** — each board's hosted replica set is
   partitioned with :func:`~.dse.partition_search` (memoized per
   (board, hosted-set) because the same grouping recurs across many
   placements), which itself runs
3. **shares -> layer pipelines** — the paper's single-model DSE inside
   every share.

Placements are ranked with the same feasibility-first lexicographic key
single-board partitions use (:func:`~.plan.partition_rank_key`), where a
model's throughput is the SUM over its replicas (the router splits the
arrival stream), SLO floors apply to that aggregate, and power
feasibility means every board met its own envelope.  Every replica slice
of the winning placement is then re-scored through the unified plan IR
(:func:`~.plan.evaluate`) under the board's :class:`~.plan.Placement`
constraint — the same verify-through-the-IR idiom the degraded-mode
controller uses — so a fleet plan can never name a replica its board
cannot physically place.

Everything here is planning: boards are *simulated* (time matrices +
the §7 power model).  The live counterpart — router, replica lifecycle,
failure/rejoin — is serving/fleet.py.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .dse import (
    PartitionPlan,
    _normalize_instances,
    exhaustive_partition,
    partition_search,
)
from .pipeline import TimeMatrix
from .plan import (
    SLO_PENALTY,
    Evaluation,
    Placement,
    evaluate,
    partition_parts,
    partition_rank_key,
)
from .platform import HeteroPlatform


@dataclasses.dataclass(frozen=True)
class BoardSpec:
    """One board of the fleet: a platform plus its power envelope."""

    name: str
    platform: HeteroPlatform
    power_cap_w: Optional[float] = None  # None: uncapped


@dataclasses.dataclass(frozen=True)
class BoardPlan:
    """One board's slice of a fleet plan (``partition`` None = idle)."""

    board: str
    platform: HeteroPlatform
    partition: Optional[PartitionPlan]

    @property
    def models(self) -> Tuple[str, ...]:
        if self.partition is None:
            return ()
        return tuple(self.partition.names)

    def notation(self) -> str:
        inner = "idle" if self.partition is None else self.partition.notation()
        return f"{self.board}[{inner}]"


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """A full fleet assignment: per-board partitions + the aggregate verdict.

    ``objective``/``feasible`` follow the partition conventions
    (score minus :data:`~.plan.SLO_PENALTY` per unit of aggregate
    relative shortfall; feasible = every fleet-level SLO floor met by the
    summed replica rates AND every board under its power envelope)."""

    boards: Tuple[BoardPlan, ...]
    objective: float
    feasible: bool
    total_power_w: float = 0.0

    @property
    def names(self) -> List[str]:
        seen: List[str] = []
        for bp in self.boards:
            for nm in bp.models:
                if nm not in seen:
                    seen.append(nm)
        return seen

    def board(self, name: str) -> BoardPlan:
        for bp in self.boards:
            if bp.board == name:
                return bp
        raise KeyError(name)

    def replicas(self, model: str) -> List[str]:
        """Names of the boards hosting a replica of ``model``."""
        return [bp.board for bp in self.boards if model in bp.models]

    def replica_counts(self) -> Dict[str, int]:
        return {nm: len(self.replicas(nm)) for nm in self.names}

    def throughputs(self) -> Dict[str, float]:
        """Aggregate modeled img/s per model — summed over its replicas
        (the router splits each model's arrivals across them)."""
        agg: Dict[str, float] = {}
        for bp in self.boards:
            if bp.partition is None:
                continue
            for nm, tp in bp.partition.throughputs().items():
                agg[nm] = agg.get(nm, 0.0) + tp
        return agg

    def notation(self) -> str:
        return " || ".join(bp.notation() for bp in self.boards)


def _normalize_replicas(
    names: Sequence[str],
    n_boards: int,
    replicas: Optional[Mapping[str, int]],
) -> List[int]:
    unknown = [k for k in (replicas or {}) if k not in names]
    if unknown:
        raise ValueError(
            f"replicas name unknown models {unknown}; instances are {list(names)}"
        )
    out: List[int] = []
    for nm in names:
        r = int((replicas or {}).get(nm, 1))
        if not 1 <= r <= n_boards:
            raise ValueError(
                f"model {nm!r} wants {r} replicas on a {n_boards}-board fleet"
            )
        out.append(r)
    return out


def _enumerate_placements(
    n_models: int, n_boards: int, replica_counts: Sequence[int]
):
    """Every models->boards placement: per model, which boards host one of
    its replicas (a size-``replica_counts[m]`` subset)."""
    per_model = [
        list(itertools.combinations(range(n_boards), replica_counts[m]))
        for m in range(n_models)
    ]
    return itertools.product(*per_model)


def _search_over_placements(
    names: Sequence[str],
    instances: Mapping[str, TimeMatrix],
    boards: Sequence[BoardSpec],
    weights: Sequence[float],
    slo_rates: Sequence[float],
    fairness: str,
    replica_counts: Sequence[int],
    inner,
) -> FleetPlan:
    """Rank every placement by the aggregate objective.

    ``inner(board_index, hosted_names) -> PartitionPlan`` supplies the
    per-board share+pipeline search; memoized per (board, hosted set)
    because the same grouping recurs across many placements."""
    cache: Dict[Tuple[int, Tuple[str, ...]], Optional[PartitionPlan]] = {}

    def solve(b: int, hosted: Tuple[str, ...]) -> Optional[PartitionPlan]:
        key = (b, hosted)
        if key not in cache:
            cache[key] = inner(b, hosted) if hosted else None
        return cache[key]

    best: Optional[FleetPlan] = None
    best_key = None
    for placement in _enumerate_placements(
        len(names), len(boards), replica_counts
    ):
        hosted_by_board = tuple(
            tuple(nm for nm, bset in zip(names, placement) if b in bset)
            for b in range(len(boards))
        )
        # placements that overload a board (more models than cores) are
        # simply not in the space
        if any(
            len(h) > boards[b].platform.total_cores()
            for b, h in enumerate(hosted_by_board)
        ):
            continue
        parts = [solve(b, h) for b, h in enumerate(hosted_by_board)]
        agg: Dict[str, float] = {nm: 0.0 for nm in names}
        for part in parts:
            if part is None:
                continue
            for nm, tp in part.throughputs().items():
                agg[nm] += tp
        score, shortfall = partition_parts(
            [agg[nm] for nm in names], weights, slo_rates, fairness
        )
        # a board over its power envelope counts like an SLO miss: any
        # placement with every board inside its cap beats any without
        power_ok = all(part is None or part.feasible for part in parts)
        key = partition_rank_key(score, shortfall, power_ok)
        if best_key is None or key > best_key:
            best_key = key
            best = FleetPlan(
                boards=tuple(
                    BoardPlan(
                        board=boards[b].name,
                        platform=boards[b].platform,
                        partition=part,
                    )
                    for b, part in enumerate(parts)
                ),
                objective=score - SLO_PENALTY * shortfall,
                feasible=shortfall == 0.0 and power_ok,
                total_power_w=sum(
                    part.total_power_w for part in parts if part is not None
                ),
            )
    if best is None:
        raise ValueError(
            "no feasible placement: every models->boards assignment puts "
            "more models on some board than it has cores"
        )
    return best


def verify_placement(
    plan: FleetPlan, instances: Mapping[str, TimeMatrix]
) -> Dict[Tuple[str, str], Evaluation]:
    """Re-score every replica slice through the unified IR under its
    board's :class:`~.plan.Placement` constraint.

    Returns ``{(board, model): Evaluation}`` and raises ``ValueError`` if
    any replica cannot be placed on its board — the same
    verify-through-the-IR step the degraded-mode controller runs, so the
    DSE's arithmetic and the constraint system can never disagree about
    what a board can hold."""
    verdicts: Dict[Tuple[str, str], Evaluation] = {}
    for bp in plan.boards:
        if bp.partition is None:
            continue
        placement = Placement.for_board(bp.board, bp.platform)
        for mp in bp.partition.assignments:
            ev = evaluate(
                mp.plan_ir(),
                instances[mp.name],
                mp.share,
                constraints=(placement,),
            )
            if ev.binding == placement.name:
                raise ValueError(
                    f"replica {mp.name!r} does not fit board {bp.board!r}: "
                    f"{ev.plan.notation()}"
                )
            verdicts[(bp.board, mp.name)] = ev
    return verdicts


def fleet_search(
    instances: Mapping[str, TimeMatrix],
    boards: Sequence[BoardSpec],
    *,
    replicas: Optional[Mapping[str, int]] = None,
    weights: Optional[Mapping[str, float]] = None,
    slo_rates: Optional[Mapping[str, float]] = None,
    fairness: str = "sum",
    mode: str = "best",
    exact_threshold: int = 8,
) -> FleetPlan:
    """Three-level DSE for fleet co-serving (see module docstring).

    ``replicas`` maps model -> replica count (default 1); ``slo_rates``
    are FLEET-level floors on each model's aggregate (summed-replica)
    rate, so the per-board inner search runs floor-free and maximizes its
    weighted contribution, and feasibility is judged on the sums.  Boards
    with a ``power_cap_w`` run the power-aware inner search under their
    own envelope.  Model order in ``instances`` defines model order.
    """
    names = list(instances)
    if not names:
        raise ValueError("need >= 1 model instance")
    if not boards:
        raise ValueError("need >= 1 board")
    if len({b.name for b in boards}) != len(boards):
        raise ValueError("board names must be unique")
    _, _, w, slo = _normalize_instances(instances, weights, slo_rates)
    rc = _normalize_replicas(names, len(boards), replicas)

    def inner(b: int, hosted: Tuple[str, ...]) -> PartitionPlan:
        return partition_search(
            {nm: instances[nm] for nm in hosted},
            boards[b].platform,
            weights={nm: (weights or {}).get(nm, 1.0) for nm in hosted},
            mode=mode,
            exact_threshold=exact_threshold,
            fairness="sum",
            power_cap_w=boards[b].power_cap_w,
        )

    plan = _search_over_placements(
        names, instances, boards, w, slo, fairness, rc, inner
    )
    verify_placement(plan, instances)
    return plan


def exhaustive_fleet(
    instances: Mapping[str, TimeMatrix],
    boards: Sequence[BoardSpec],
    *,
    replicas: Optional[Mapping[str, int]] = None,
    weights: Optional[Mapping[str, float]] = None,
    slo_rates: Optional[Mapping[str, float]] = None,
    fairness: str = "sum",
) -> FleetPlan:
    """Oracle for :func:`fleet_search`: the same exact placement
    enumeration with the exhaustive partition oracle on every board.
    Exponential in layers x shares x placements; tiny instances only."""
    names = list(instances)
    if not names:
        raise ValueError("need >= 1 model instance")
    if not boards:
        raise ValueError("need >= 1 board")
    if len({b.name for b in boards}) != len(boards):
        raise ValueError("board names must be unique")
    _, _, w, slo = _normalize_instances(instances, weights, slo_rates)
    rc = _normalize_replicas(names, len(boards), replicas)

    def inner(b: int, hosted: Tuple[str, ...]) -> PartitionPlan:
        return exhaustive_partition(
            {nm: instances[nm] for nm in hosted},
            boards[b].platform,
            weights={nm: (weights or {}).get(nm, 1.0) for nm in hosted},
            fairness="sum",
        )

    plan = _search_over_placements(
        names, instances, boards, w, slo, fairness, rc, inner
    )
    verify_placement(plan, instances)
    return plan
