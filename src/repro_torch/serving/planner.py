"""AutoPlanner — model → time matrix → DSE → running server, in one call.

The paper's deployment story is a chain of artifacts: layer descriptors
(Eq. 3-4) feed the Eq. 5/8 performance model, which fills the time matrix
``T[layer][stage_config]`` (Eq. 10's inputs); Algorithms 1-3 search the
design space (size per Eq. 2) for the plan maximising Eq. 12 throughput;
the runtime then executes that plan.  This planner composes them so

    server = serve("vgg16", backend="cuda_fused")

is the whole pipeline: build graph → predict times → ``pipe_it_search``
→ :class:`~repro_torch.serving.server.PipelineServer`, warmed and started,
on the card.

Time sources
------------
``source="synthetic"``  — :func:`repro_torch.core.calibration.synthetic_model`:
    deterministic analytical timings; fast, reproducible, used in tests.
``source="calibrated"`` — :func:`repro_torch.core.calibration.calibrate`:
    fits Eq. 5/8 to GEMMs measured on the serving device (cached after
    the first run).
An explicit ``time_matrix`` overrides both.  With an autotuner
(``serve(autotune=True)`` or ``tuner=``) the layers' serving routes are
measured on the serving device (``kernels/backend.py::measure_graph_routes``)
and those times replace the regression for the layers they cover.

Not yet ported (each raises ``NotImplementedError`` naming its ROADMAP
item): the adaptive loop, the power-aware DSE and governor, and
multi-model co-serving.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

from ..cnn.graph import Graph
from ..cnn.models import MODELS
from ..core.calibration import calibrate, synthetic_model
from ..core.dse import pipe_it_search
from ..core.perfmodel import LayerTimePredictor
from ..core.pipeline import PipelinePlan, TimeMatrix
from ..core.platform import CoreType, HeteroPlatform, hikey970
from ..kernels.autotune import ConvAutotuner
from ..kernels.backend import measure_graph_routes, resolve_backend
from ..kernels.config import resolve_device
from .persistence import PlanStore
from .server import PipelineServer


def host_platform(n_groups: int = 2) -> HeteroPlatform:
    """One device seen as a pipeline platform.

    ``n_groups`` equal-speed single-"core" clusters whose concurrency the
    stages' overlapping streams provide (on the card) or host threads
    provide (on the CPU).  Planning against this platform with
    ``source="calibrated"`` balances the stages in device time.
    """
    if not 1 <= n_groups <= 8:
        raise ValueError("n_groups must be in [1, 8]")
    return HeteroPlatform(
        name=f"host{n_groups}",
        core_types=tuple(
            CoreType(chr(ord("L") + i), 1, 1.0) for i in range(n_groups)
        ),
    )


@dataclasses.dataclass
class AutoPlanner:
    """End-to-end plan construction for a CNN graph.

    mode : DSE mode — "merge" (the paper's Algorithm 3), "sweep"
        (work_flow over all pipelines) or "best" (both, keep the
        higher-throughput plan).
    source : where predicted layer times come from (see module docstring).
    backend : kernel execution backend spec for the stage functions
        ("torch" | "cuda" | "cuda_fused" | per-node mapping | resolved
        ``KernelBackend``).
    measured : {descriptor key: seconds} measured layer times
        (``measure_graph_routes``); they override the Eq. 5 regression in
        the predictor, so the time matrix reflects the kernels that serve.
    tuner : a ``repro_torch.kernels.autotune.ConvAutotuner``; the source
        of ``measured`` (all routes merged) when no mapping is given.
    device : the serving device; ``None`` means the card.
    """

    platform: HeteroPlatform = dataclasses.field(default_factory=hikey970)
    mode: str = "best"
    source: str = "synthetic"
    backend: object = None
    measured: object = None
    tuner: object = None
    device: object = None

    def predictor(self) -> LayerTimePredictor:
        if self.source == "synthetic":
            model = synthetic_model()
        elif self.source == "calibrated":
            model = calibrate(device=self.device)
        else:
            raise ValueError(f"unknown time source {self.source!r}")
        measured = self.measured
        if measured is None and self.tuner is not None:
            measured = self.tuner.route_seconds()
        return LayerTimePredictor(
            model=model, platform=self.platform, measured=measured
        )

    def time_matrix(self, graph: Graph) -> TimeMatrix:
        """Predicted T[layer][stage_config] for the graph's major layers."""
        return self.predictor().time_matrix(graph.descriptors())

    def search(self, n_layers: int, T: TimeMatrix) -> PipelinePlan:
        """Run the DSE on an existing time matrix (Algorithms 1-3)."""
        return pipe_it_search(n_layers, self.platform, T, mode=self.mode)

    def plan(self, graph: Graph, T: Optional[TimeMatrix] = None) -> PipelinePlan:
        T = self.time_matrix(graph) if T is None else T
        return self.search(len(graph.descriptors()), T)

    def build(
        self,
        graph: Graph,
        params=None,
        *,
        time_matrix: Optional[TimeMatrix] = None,
        batch_size: int = 4,
        flush_timeout_s: float = 0.01,
        queue_depth: int = 2,
        seed: int = 0,
        warmup: bool = True,
        stage_fn_builder=None,
        plan: Optional[PipelinePlan] = None,
        recovery=None,
    ) -> PipelineServer:
        """Plan the pipeline and construct a (warmed, started) server;
        ``stage_fn_builder`` goes to :class:`PipelineServer`.  ``plan``
        overrides the DSE (``serve(resume_from=)`` hands a persisted one
        in here)."""
        device = resolve_device(self.device)
        if params is None:
            params = graph.init(seed=seed, device=device)
        if plan is None:
            plan = self.plan(graph, time_matrix)
        server = PipelineServer(
            graph,
            params,
            plan,
            batch_size=batch_size,
            flush_timeout_s=flush_timeout_s,
            queue_depth=queue_depth,
            stage_fn_builder=stage_fn_builder,
            backend=self.backend,
            recovery=recovery,
            device=device,
        )
        if warmup:
            server.warmup()
        return server.start()


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"serve({option}) is not ported to repro_torch yet (ROADMAP.md, {item})"
    )


def serve(
    model: Union[str, Graph, Mapping],
    *,
    mode: str = "best",
    source: str = "synthetic",
    platform: Optional[HeteroPlatform] = None,
    time_matrix: Optional[TimeMatrix] = None,
    params=None,
    batch_size: int = 4,
    flush_timeout_s: float = 0.01,
    queue_depth: int = 2,
    seed: int = 0,
    warmup: bool = True,
    stage_fn_builder=None,
    backend=None,
    device=None,
    recovery=None,
    adaptive: bool = False,
    power_cap_w: Optional[float] = None,
    min_throughput: Optional[float] = None,
    autotune: bool = False,
    tuner=None,
    plan_store=None,
    resume_from=None,
) -> PipelineServer:
    """One call from model name (or Graph) to a running PipelineServer.

    ``device=None`` serves on the card and raises on a host without CUDA;
    pass ``device="cpu"`` for the plain PyTorch route.  ``backend``
    selects the kernel route for every stage ("torch" | "cuda" |
    "cuda_fused", or per node — see :mod:`repro_torch.kernels.backend`).
    ``params``
    (the port's tensors, e.g. from ``cnn.params.params_from_numpy``)
    default to ``Graph.init(seed)`` on the device.  ``recovery`` (a
    :class:`~repro_torch.serving.faults.RecoveryPolicy`) arms the
    server's fault-recovery layer.  ``stage_fn_builder`` replaces the
    stage functions (CUDA graphs on the card) for the first plan and every
    swap, as in :class:`PipelineServer`; for example
    ``lambda g, p: build_eager_stage_fns(g, p, backend="cuda_fused")``
    serves op by op.

    ``autotune=True`` attaches a
    :class:`~repro_torch.kernels.autotune.ConvAutotuner` on the serving
    device (or pass one as ``tuner``; ``backend`` then defaults to
    ``"torch"``): on the card it picks each fused conv's tile variant by
    time, and unless ``time_matrix`` is given it measures every layer's
    serving route once (JSON-cached per device), and the planner's time
    matrix is built from those measurements.  ``plan_store`` (a path or
    :class:`~repro_torch.serving.persistence.PlanStore`) persists the
    active plan as last-known-good JSON on startup and after every
    successful hot swap; ``resume_from`` (same types, usually the same
    path) serves a persisted plan and skips the route measurements, the
    time matrix and the DSE (the stage functions' convs are still tuned;
    an absent or unusable file means a normal cold start).

    >>> server = serve("vgg16", backend="cuda_fused", batch_size=4)
    >>> logits = server.submit(image).result()
    >>> server.stop()
    """
    if isinstance(model, Mapping):
        raise _not_ported("{model: ...}", "queue 1 item 8d, multi-model co-serving")
    if adaptive:
        raise _not_ported("adaptive=True", "queue 1 item 8b, adaptive re-planning")
    if power_cap_w is not None or min_throughput is not None:
        raise _not_ported(
            "power_cap_w/min_throughput", "queue 1 item 8c, governor and power-aware DSE"
        )
    dev = resolve_device(device)
    graph = MODELS[model]() if isinstance(model, str) else model
    if tuner is None and autotune:
        tuner = ConvAutotuner(device=dev, batch=batch_size)
    if tuner is not None and tuner.device.type != dev.type:
        raise ValueError(
            f"the tuner measures on {tuner.device}, the server runs on {dev}"
        )
    if backend is None and tuner is not None:
        backend = "torch"  # measurements must reflect the route that serves
    kb = resolve_backend(backend, tuner=tuner)
    # Warm start: a persisted last-known-good plan skips the measurements,
    # the time matrix and the DSE (best effort: an absent or unusable
    # store means a cold start).
    resume_plan = None
    if resume_from is not None:
        ir = PlanStore.coerce(resume_from).load_plan()
        if ir is not None:
            resume_plan = ir.as_pipeline_plan()
    measured = None
    if kb is not None and tuner is not None and time_matrix is None and resume_plan is None:
        # skipped when nothing plans from them: the measurements would be
        # dead startup latency
        measured = measure_graph_routes(graph, kb, tuner)
    planner = AutoPlanner(
        platform=platform if platform is not None else hikey970(),
        mode=mode,
        source=source,
        backend=kb,
        measured=measured,
        tuner=tuner,
        device=dev,
    )
    server = planner.build(
        graph,
        params,
        time_matrix=time_matrix,
        batch_size=batch_size,
        flush_timeout_s=flush_timeout_s,
        queue_depth=queue_depth,
        seed=seed,
        warmup=warmup,
        stage_fn_builder=stage_fn_builder,
        plan=resume_plan,
        recovery=recovery,
    )
    if plan_store is not None:
        # the startup plan is the first known-good one
        server.plan_store = PlanStore.coerce(plan_store)
        server._persist_plan()
    return server
