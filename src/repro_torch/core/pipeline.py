"""Pipeline configuration types, throughput (Eq. 12) and design-space size
(Eqs. 1-2).

A pipeline ``P = {P_1..P_p}`` is an ordered tuple of stage configurations
(homogeneous ``(core_type, count)`` tuples, fastest stages first — paper
§VI-B).  The layer allocation ``L = {L_1..L_p}`` partitions the ordered
layer list into contiguous (possibly empty) ranges.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .platform import HeteroPlatform, StageConfig

TimeMatrix = Sequence[Dict[StageConfig, float]]  # T[layer][stage_config]
Allocation = Tuple[Tuple[int, ...], ...]  # L: per stage, tuple of layer ids


def stage_time(T: TimeMatrix, layers: Sequence[int], stage: StageConfig) -> float:
    """Eq. 10: T_{L_i}^{P_i} = sum of layer times on that stage config."""
    return sum(T[l][stage] for l in layers)


@dataclasses.dataclass(frozen=True)
class Pipeline:
    stages: Tuple[StageConfig, ...]

    def __post_init__(self) -> None:
        if not self.stages:
            raise ValueError("pipeline needs >= 1 stage")

    @property
    def p(self) -> int:
        return len(self.stages)

    def validate_against(self, platform: HeteroPlatform) -> None:
        used: Dict[str, int] = {}
        for core_type, count in self.stages:
            if count < 1:
                raise ValueError(f"stage with {count} cores")
            used[core_type] = used.get(core_type, 0) + count
        avail = platform.counts()
        for ct, n in used.items():
            if n > avail.get(ct, 0):
                raise ValueError(f"pipeline uses {n} {ct!r} cores, only {avail.get(ct, 0)} exist")

    def notation(self) -> str:
        """Paper notation, e.g. 'B4-s2-s2'."""
        return "-".join(f"{t}{n}" for t, n in self.stages)


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """A pipeline plus its layer allocation."""

    pipeline: Pipeline
    allocation: Allocation  # same length as pipeline.stages

    def __post_init__(self) -> None:
        if len(self.allocation) != self.pipeline.p:
            raise ValueError("allocation length != number of stages")

    def stage_times(self, T: TimeMatrix) -> List[float]:
        return [
            stage_time(T, layers, stage)
            for layers, stage in zip(self.allocation, self.pipeline.stages)
        ]

    def bottleneck(self, T: TimeMatrix) -> float:
        return max(self.stage_times(T))

    def throughput(self, T: TimeMatrix) -> float:
        """Eq. 12: 1 / max_i T_{L_i}^{P_i}."""
        return 1.0 / max(self.bottleneck(T), 1e-12)

    def notation(self) -> str:
        ranges = []
        for layers in self.allocation:
            if layers:
                ranges.append(f"[{layers[0] + 1},{layers[-1] + 1}]")
            else:
                ranges.append("[]")
        return f"{self.pipeline.notation()}  {' - '.join(ranges)}"


def contiguous_allocation(split_points: Sequence[int], n_layers: int, p: int) -> Allocation:
    """Build L from ordered split points (len p-1, values in [0, n_layers])."""
    bounds = [0, *split_points, n_layers]
    return tuple(tuple(range(a, b)) for a, b in zip(bounds[:-1], bounds[1:]))


def num_pipelines(h_big: int, h_small: int, p: int) -> int:
    """Eq. 1: number of distinct p-stage pipelines on (H_B + H_s) cores."""
    total = 0
    for p_b in range(max(1, p - h_small), min(h_big, p - 1) + 1):
        p_s = p - p_b
        total += math.comb(h_big - 1, p_b - 1) * math.comb(h_small - 1, p_s - 1)
    return total


def design_space_size(w: int, h_big: int, h_small: int) -> int:
    """Eq. 2: total design points for a CNN with W major layers."""
    h = h_big + h_small
    return sum(
        math.comb(w - 1, p - 1) * num_pipelines(h_big, h_small, p)
        for p in range(2, h + 1)
    )


def _compositions(total: int, parts: int) -> List[Tuple[int, ...]]:
    if parts == 0:
        return [()] if total == 0 else []
    if parts == 1:
        return [(total,)] if total >= 1 else []
    res = []
    for first in range(1, total - parts + 2):
        for rest in _compositions(total - first, parts - 1):
            res.append((first, *rest))
    return res


def enumerate_pipelines(
    platform: HeteroPlatform, p: int, allow_partial: bool = False
) -> List[Pipeline]:
    """All pipelines with exactly p stages, faster cluster types first
    (paper §VI-B orders stages by decreasing compute capability,
    eliminating heterogeneous stages and Small-before-Big orders).

    Generalized to any number of cluster types (the TPU adaptation uses a
    single homogeneous chip type whose stage 'capability' is group size);
    not every cluster needs to contribute stages — unused clusters idle,
    except that every core of a cluster that IS used must be assigned
    (the paper never leaves partial clusters idle).

    ``allow_partial=True`` lifts that last rule: a used cluster's stages
    may sum to ANY total <= its count.  This is the closure of what the
    DSE heuristics can *emit* (merge/sweep drop stages that received no
    layers, stranding that stage's cores), which is the plan space the
    multi-model partition oracle must rank over (core/dse.py)."""
    cts = list(platform.core_types)
    out: List[Pipeline] = []

    def rec(i: int, remaining: int, acc: List[StageConfig]):
        if i == len(cts):
            if remaining == 0 and acc:
                out.append(Pipeline(stages=tuple(acc)))
            return
        ct = cts[i]
        # this cluster contributes k stages (0..min(count, remaining))
        for k in range(0, min(ct.count, remaining) + 1):
            if k == 0:
                rec(i + 1, remaining, acc)
                continue
            totals = range(k, ct.count + 1) if allow_partial else (ct.count,)
            for total in totals:
                for comp in _compositions(total, k):
                    rec(i + 1, remaining - k, acc + [(ct.name, n) for n in comp])

    rec(0, p, [])
    return [pl for pl in out if pl.p == p]
