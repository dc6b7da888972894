"""Serving runtime for Pipe-it pipelines, on PyTorch and CUDA.

* :mod:`.engine`   — the stage functions (CUDA graphs on the card) and the
  one-shot engines: ``SingleStageEngine`` (kernel-level baseline),
  ``PipelinedGraphEngine`` (per-image pipeline, Fig. 2) and
  ``TimeSlicedEngine`` (several models time-sliced on one machine).
* :mod:`.batching` — fixed-shape micro-batches with size-or-deadline flush.
* :mod:`.metrics`  — per-stage p50/p95/p99 service times, occupancy
  (Eq. 10/12 observed live), end-to-end latency.
* :mod:`.faults`   — seeded fault injection and the recovery policy.
* :mod:`.server`   — ``PipelineServer``: persistent stage workers, one
  CUDA stream each, bounded queues, backpressure.
* :mod:`.planner`  — ``AutoPlanner`` / ``serve()``: perf model → DSE →
  running server in one call (with an autotuner, from layer times
  measured on the card); a dict of models gives a ``MultiModelServer``.
* :mod:`.registry` — ``ModelRegistry``: the co-resident models, their
  params, weights and SLO floors.
* :mod:`.multimodel` — ``MultiModelServer``: several CNNs on disjoint
  shares of the platform (the two-level partition DSE), one pipeline per
  model behind an admission-controlled router, ``swap_partition``, and
  the global re-partition loop (``PartitionController``).
* :mod:`.persistence` — ``PlanStore``: the last-known-good plan, saved
  on startup and after every hot swap, for ``serve(resume_from=)``.
* :mod:`.adaptive` — the closed loop: online calibrator → drift detector
  → re-plan → hot-swap (``serve(adaptive=True)``).
* :mod:`.governor` — frequency/power: ``DvfsGovernor`` applies the
  power-aware DSE's per-stage OPP assignment (the planning platform's
  modeled clocks, not the card's), normalizes observations back to
  f_max, and re-plans on throttle events (``serve(power_cap_w=...)``).
* :mod:`.loadgen`  — seeded open-loop arrival traces (Poisson, MMPP,
  diurnal) and ``run_open_loop``, which paces one into a live server.
* :mod:`.fleet`    — ``FleetRouter``: one ``MultiModelServer`` per board
  of a fleet plan (``core/fleet.py``) behind one ingress, with board
  loss, re-dispatch and rejoin; ``FleetAutoscaler`` re-plans the replica
  counts from the observed arrival rates.
"""
from .adaptive import (
    AdaptiveConfig,
    AdaptiveController,
    AdaptiveMonitor,
    DriftDetector,
    DriftingMatrix,
    OnlineCalibrator,
    OpenLoopServing,
    QueueController,
    QueuePolicy,
    ReplanEvent,
    ServerSampler,
    SimulatedServing,
    StageObservation,
    attach_adaptive,
    delayed_stage_fn_builder,
    run_adaptive_loop,
)
from .batching import MicroBatch, gather, split_rows, stack_envs
from .engine import (
    PipelinedGraphEngine,
    SingleStageEngine,
    TimeSlicedEngine,
    build_eager_stage_fns,
    build_stage_fns,
)
from .fleet import FleetAutoscaler, FleetRouter, NoReplica
from .governor import (
    DvfsGovernor,
    attach_governor,
    governed_stage_fn_builder,
    run_governed_loop,
    run_slo_governed_loop,
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
from .loadgen import (
    ArrivalTrace,
    OpenLoopReport,
    diurnal_trace,
    mmpp_trace,
    poisson_trace,
    run_open_loop,
)
from .metrics import RouterMetrics, ServerMetrics, StageMetrics, percentile
from .multimodel import (
    AdmissionError,
    MultiModelMonitor,
    MultiModelServer,
    PartitionController,
    PartitionEvent,
    attach_partition_adaptive,
)
from .persistence import PlanStore
from .planner import AutoPlanner, host_platform, serve
from .registry import ModelEntry, ModelRegistry
from .server import (
    Backpressure,
    PipelineServer,
    ServerClosed,
    ServingError,
    Ticket,
)

__all__ = [
    "AdaptiveConfig",
    "AdaptiveController",
    "AdaptiveMonitor",
    "AdmissionError",
    "ArrivalTrace",
    "AutoPlanner",
    "Backpressure",
    "DriftDetector",
    "DriftingMatrix",
    "DvfsGovernor",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "FleetAutoscaler",
    "FleetRouter",
    "MicroBatch",
    "ModelEntry",
    "ModelRegistry",
    "MultiModelMonitor",
    "MultiModelServer",
    "NoReplica",
    "OnlineCalibrator",
    "OpenLoopReport",
    "OpenLoopServing",
    "PartitionController",
    "PartitionEvent",
    "PipelineServer",
    "PipelinedGraphEngine",
    "PlanStore",
    "QueueController",
    "QueuePolicy",
    "RecoveryPolicy",
    "ReplanEvent",
    "RouterMetrics",
    "ServerClosed",
    "ServerMetrics",
    "ServerSampler",
    "ServingError",
    "SimulatedServing",
    "SingleStageEngine",
    "StageMetrics",
    "StageObservation",
    "Ticket",
    "TimeSlicedEngine",
    "TransientStageError",
    "WorkerCrash",
    "attach_adaptive",
    "attach_governor",
    "attach_partition_adaptive",
    "build_eager_stage_fns",
    "build_stage_fns",
    "delayed_stage_fn_builder",
    "diurnal_trace",
    "fault_injecting_builder",
    "gather",
    "governed_stage_fn_builder",
    "host_platform",
    "mmpp_trace",
    "percentile",
    "poisson_trace",
    "run_adaptive_loop",
    "run_governed_loop",
    "run_open_loop",
    "run_slo_governed_loop",
    "serve",
    "split_rows",
    "stack_envs",
]
