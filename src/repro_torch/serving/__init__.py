"""Serving runtime for Pipe-it pipelines, on PyTorch and CUDA.

* :mod:`.engine`   — the stage functions (CUDA graphs on the card) and the
  one-shot engines: ``SingleStageEngine`` (kernel-level baseline) and
  ``PipelinedGraphEngine`` (per-image pipeline, Fig. 2).
* :mod:`.batching` — fixed-shape micro-batches with size-or-deadline flush.
* :mod:`.metrics`  — per-stage p50/p95/p99 service times, occupancy
  (Eq. 10/12 observed live), end-to-end latency.
* :mod:`.faults`   — seeded fault injection and the recovery policy.
* :mod:`.server`   — ``PipelineServer``: persistent stage workers, one
  CUDA stream each, bounded queues, backpressure.
* :mod:`.planner`  — ``AutoPlanner`` / ``serve()``: perf model → DSE →
  running server in one call (with an autotuner, from layer times
  measured on the card).
* :mod:`.persistence` — ``PlanStore``: the last-known-good plan, saved
  on startup and after every hot swap, for ``serve(resume_from=)``.

The rest of the control plane over servers (adaptive re-planning, the
DVFS governor, multi-model co-serving, fleets, load generation) is not
ported yet; see ROADMAP.md.
"""
from .batching import MicroBatch, gather, split_rows, stack_envs
from .engine import (
    PipelinedGraphEngine,
    SingleStageEngine,
    build_eager_stage_fns,
    build_stage_fns,
)
from .faults import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
    RecoveryPolicy,
    TransientStageError,
    WorkerCrash,
    fault_injecting_builder,
)
from .metrics import ServerMetrics, StageMetrics, percentile
from .persistence import PlanStore
from .planner import AutoPlanner, host_platform, serve
from .server import (
    Backpressure,
    PipelineServer,
    ServerClosed,
    ServingError,
    Ticket,
)

__all__ = [
    "AutoPlanner",
    "Backpressure",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "MicroBatch",
    "PipelineServer",
    "PipelinedGraphEngine",
    "PlanStore",
    "RecoveryPolicy",
    "ServerClosed",
    "ServerMetrics",
    "ServingError",
    "SingleStageEngine",
    "StageMetrics",
    "Ticket",
    "TransientStageError",
    "WorkerCrash",
    "build_eager_stage_fns",
    "build_stage_fns",
    "fault_injecting_builder",
    "gather",
    "host_platform",
    "percentile",
    "serve",
    "split_rows",
    "stack_envs",
]
