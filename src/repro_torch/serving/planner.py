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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

from ..cnn.graph import Graph
from ..cnn.models import MODELS
from ..core.calibration import calibrate, synthetic_model
from ..core.dse import (
    PartitionPlan,
    PowerAwarePlan,
    partition_search,
    pipe_it_search,
    power_aware_search,
)
from ..core.perfmodel import LayerTimePredictor
from ..core.pipeline import PipelinePlan, TimeMatrix
from ..core.platform import CoreType, HeteroPlatform, hikey970
from ..kernels.autotune import ConvAutotuner
from ..kernels.backend import measure_graph_routes, resolve_backend
from ..kernels.config import resolve_device
from .adaptive import AdaptiveConfig, attach_adaptive
from .governor import attach_governor
from .multimodel import MultiModelServer, attach_partition_adaptive
from .persistence import PlanStore
from .registry import ModelRegistry
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

    def power_plan(
        self,
        graph: Graph,
        T: Optional[TimeMatrix] = None,
        *,
        power_cap_w: Optional[float] = None,
        objective: str = "throughput",
        min_throughput: Optional[float] = None,
    ) -> PowerAwarePlan:
        """The DVFS-extended DSE: plan + per-stage OPP assignment under an
        average-power cap (:func:`repro_torch.core.dse.power_aware_search`)."""
        T = self.time_matrix(graph) if T is None else T
        return power_aware_search(
            len(graph.descriptors()), self.platform, T, mode=self.mode,
            power_cap_w=power_cap_w, objective=objective,
            min_throughput=min_throughput,
        )

    # ------------------------------------------------------- multi-model path
    def time_matrices(
        self, graphs: Mapping[str, Graph]
    ) -> Dict[str, TimeMatrix]:
        """Per-model predicted time matrices with one shared per-geometry
        memo (co-resident zoo CNNs share many conv shapes)."""
        return self.predictor().time_matrices(
            {name: g.descriptors() for name, g in graphs.items()}
        )

    def partition(
        self,
        graphs: Mapping[str, Graph],
        Ts: Optional[Mapping[str, TimeMatrix]] = None,
        *,
        weights: Optional[Mapping[str, float]] = None,
        slo_rates: Optional[Mapping[str, float]] = None,
        exact_threshold: int = 8,
        fairness: str = "sum",
        power_cap_w: Optional[float] = None,
        power_objective: str = "throughput",
    ) -> PartitionPlan:
        """Two-level DSE: clusters across models, layers within each share
        (:func:`repro_torch.core.dse.partition_search`)."""
        if Ts is None:
            Ts = self.time_matrices(graphs)
        return partition_search(
            {name: Ts[name] for name in graphs},  # graph order defines model order
            self.platform,
            weights=weights,
            slo_rates=slo_rates,
            mode=self.mode,
            exact_threshold=exact_threshold,
            fairness=fairness,
            power_cap_w=power_cap_w,
            power_objective=power_objective,
        )

    def build_multi(
        self,
        registry: ModelRegistry,
        *,
        time_matrices: Optional[Mapping[str, TimeMatrix]] = None,
        batch_size: int = 1,
        flush_timeout_s: float = 0.01,
        queue_depth: int = 2,
        max_inflight=None,
        warmup: bool = True,
        stage_fn_builders=None,
        fairness: str = "sum",
        power_cap_w: Optional[float] = None,
        power_objective: str = "throughput",
        partition: Optional[PartitionPlan] = None,
        recovery=None,
    ) -> MultiModelServer:
        """Partition the platform across the registry's models and
        construct a (warmed, started) :class:`MultiModelServer` on this
        planner's device.

        ``partition`` overrides the two-level DSE (the ``resume_from``
        warm-start path hands a persisted partition in here); ``recovery``
        arms every inner pipeline's fault-recovery layer
        (:class:`~repro_torch.serving.faults.RecoveryPolicy`)."""
        if partition is None:
            partition = self.partition(
                registry.graphs(),
                time_matrices,
                weights=registry.weights(),
                slo_rates=registry.slo_rates(),
                fairness=fairness,
                power_cap_w=power_cap_w,
                power_objective=power_objective,
            )
        mserver = MultiModelServer(
            registry,
            partition,
            batch_size=batch_size,
            flush_timeout_s=flush_timeout_s,
            queue_depth=queue_depth,
            max_inflight=max_inflight,
            stage_fn_builders=stage_fn_builders,
            backend=self.backend,
            tuner=self.tuner,
            fairness=fairness,
            recovery=recovery,
            device=self.device,
        )
        if warmup:
            mserver.warmup()
        return mserver.start()

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


def serve(
    model: Union[str, Graph, Mapping, ModelRegistry],
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
    adaptive_config: Optional[AdaptiveConfig] = None,
    power_cap_w: Optional[float] = None,
    power_objective: str = "throughput",
    min_throughput: Optional[float] = None,
    autotune: bool = False,
    tuner=None,
    max_inflight=None,
    fairness: Optional[str] = None,
    plan_store=None,
    resume_from=None,
) -> Union[PipelineServer, MultiModelServer]:
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
    path) serves a persisted plan and skips the DSE, and unless the
    adaptive loop or the power path needs the time matrix also the route
    measurements and the matrix (the stage functions' convs are still
    tuned; an absent or unusable file means a normal cold start).

    ``power_cap_w`` (watts of modeled average active power on the
    planning platform, e.g. ``hikey970()``'s OPP tables; nothing of the
    card's own power) and/or ``power_objective`` and ``min_throughput``
    switch the DSE to the DVFS-extended search
    (:func:`repro_torch.core.dse.power_aware_search`) and give the server
    a :class:`~repro_torch.serving.governor.DvfsGovernor` on
    ``server.governor`` (``server.governor.throttle(new_cap)`` re-plans
    under a new cap and hot-swaps); its clocks are bookkeeping over
    full-speed stage functions.  ``adaptive=True`` attaches the closed
    loop of :mod:`repro_torch.serving.adaptive` (``server.monitor``, a
    thread that calibrates the time matrix against the observed stage
    times and hot-swaps when the bottleneck drifts; ``adaptive_config``
    sets its knobs); ``server.stop()`` stops it first.

    **Multi-model co-serving**: pass a dict (or
    :class:`~repro_torch.serving.registry.ModelRegistry`) instead of one
    model and ``serve`` returns a
    :class:`~repro_torch.serving.multimodel.MultiModelServer` — the
    two-level partition DSE splits the platform's clusters across the
    models, one pipeline worker set per model runs on its share behind
    the admission-controlled router, every model's route measurements
    share ONE autotuner cache, and ``adaptive=True`` attaches the global
    re-partition loop.  Parameters a dict's entries lack are made from
    their seed (0) on ``device``.  ``max_inflight`` (an int or ``{model:
    bound}``) arms the router's per-model admission bound and
    ``fairness`` ("sum" | "max-min") selects the partition objective —
    both are multi-model-only and rejected for a single model.

    >>> server = serve("vgg16", backend="cuda_fused", batch_size=4)
    >>> logits = server.submit(image).result()
    >>> server.stop()

    >>> mm = serve({"vgg16": "vgg16", "mobilenet": "mobilenet"}, backend="cuda_fused")
    >>> logits = mm.submit("mobilenet", image).result()
    >>> mm.stop()
    """
    if isinstance(model, (Mapping, ModelRegistry)):
        if min_throughput is not None:
            raise ValueError(
                "min_throughput is a single-model option; multi-model "
                "throughput floors are per-model SLOs — set slo_rate on the "
                "registry entries instead"
            )
        return _serve_multi(
            model,
            mode=mode,
            source=source,
            platform=platform,
            time_matrix=time_matrix,
            batch_size=batch_size,
            flush_timeout_s=flush_timeout_s,
            queue_depth=queue_depth,
            warmup=warmup,
            adaptive=adaptive,
            adaptive_config=adaptive_config,
            stage_fn_builder=stage_fn_builder,
            backend=backend,
            device=device,
            autotune=autotune,
            tuner=tuner,
            max_inflight=max_inflight,
            fairness=fairness if fairness is not None else "sum",
            power_cap_w=power_cap_w,
            power_objective=power_objective,
            recovery=recovery,
            plan_store=plan_store,
            resume_from=resume_from,
        )
    if max_inflight is not None or fairness is not None:
        raise ValueError(
            "max_inflight/fairness are multi-model options; pass a dict of "
            "models (or a ModelRegistry) to serve()"
        )
    dev = resolve_device(device)
    graph = MODELS[model]() if isinstance(model, str) else model
    tuner, kb = _tuner_and_backend(dev, batch_size, autotune, tuner, backend)
    # Warm start: a persisted last-known-good plan skips the DSE (best
    # effort: an absent or unusable store means a cold start).
    resume_plan = None
    if resume_from is not None:
        ir = PlanStore.coerce(resume_from).load_plan()
        if ir is not None:
            resume_plan = ir.as_pipeline_plan()
    # min_throughput alone also arms the power path: the floor is enforced
    # as DVFS-feasibility, never silently dropped
    power_aware = (
        power_cap_w is not None
        or power_objective != "throughput"
        or min_throughput is not None
    )
    # The time matrix, and the route measurements it is made from, only
    # when something still needs it: the DSE (no resume), the power-aware
    # frequency search, or the adaptive loop's prior.  A resumed static
    # server at fixed clocks skips both.
    need_T = resume_plan is None or power_aware or adaptive
    measured = None
    if kb is not None and tuner is not None and time_matrix is None and need_T:
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
    T = time_matrix
    if T is None and need_T:
        T = planner.time_matrix(graph)
    pplan = None
    if power_aware:
        pplan = planner.power_plan(
            graph, T, power_cap_w=power_cap_w, objective=power_objective,
            min_throughput=min_throughput,
        )
    server = planner.build(
        graph,
        params,
        time_matrix=T,
        batch_size=batch_size,
        flush_timeout_s=flush_timeout_s,
        queue_depth=queue_depth,
        seed=seed,
        warmup=warmup,
        stage_fn_builder=stage_fn_builder,
        plan=pplan.plan if pplan is not None else resume_plan,
        recovery=recovery,
    )
    if power_aware:
        # the governor owns the clocks; its monitor thread only runs when
        # the caller asked for the adaptive loop (throttle() works either way)
        attach_governor(
            server,
            prior=T,
            platform=planner.platform,
            power_cap_w=power_cap_w,
            objective=power_objective,
            min_throughput=min_throughput,
            mode=mode,
            config=adaptive_config,
            start=adaptive,
        )
    elif adaptive:
        attach_adaptive(
            server,
            prior=T,
            platform=planner.platform,
            mode=mode,
            config=adaptive_config,
        )
    if plan_store is not None:
        # after the governor is attached, so the persisted plan carries
        # its clocks; the startup plan is the first known-good one
        server.plan_store = PlanStore.coerce(plan_store)
        server._persist_plan()
    return server


def _tuner_and_backend(dev, batch_size: int, autotune: bool, tuner, backend):
    """The autotuner (made on ``dev`` at ``batch_size`` when ``autotune``
    asks for one) and the resolved backend; with a tuner the backend
    defaults to ``"torch"``, so the measurements reflect the route that
    serves."""
    if tuner is None and autotune:
        tuner = ConvAutotuner(device=dev, batch=batch_size)
    if tuner is not None and tuner.device.type != dev.type:
        raise ValueError(
            f"the tuner measures on {tuner.device}, the server runs on {dev}"
        )
    if backend is None and tuner is not None:
        backend = "torch"
    return tuner, resolve_backend(backend, tuner=tuner)


def _serve_multi(
    model: Union[Mapping, ModelRegistry],
    *,
    mode: str,
    source: str,
    platform: Optional[HeteroPlatform],
    time_matrix,
    batch_size: int,
    flush_timeout_s: float,
    queue_depth: int,
    warmup: bool,
    adaptive: bool,
    adaptive_config: Optional[AdaptiveConfig],
    stage_fn_builder,
    backend,
    device,
    autotune: bool,
    tuner,
    max_inflight,
    fairness: str,
    power_cap_w: Optional[float] = None,
    power_objective: str = "throughput",
    recovery=None,
    plan_store=None,
    resume_from=None,
) -> MultiModelServer:
    """The multi-model arm of :func:`serve`.

    Mirrors the single-model chain per co-resident model — measure,
    predict, search, run — but with the two-level partition DSE in the
    middle and exactly ONE :class:`ConvAutotuner` shared by every model's
    route measurements: descriptor keys are geometry-keyed, so a conv
    shape two models share is measured once.  The time matrices are made
    from the routes that serve: the dicts ``measure_graph_routes``
    returns for each model under ``backend``, merged, never the tuner's
    fastest route per key (a tuner that also measured another route would
    plan on times that do not serve).
    """
    if len(model) == 0:
        raise ValueError("serve() got an empty model registry")
    dev = resolve_device(device)
    registry = ModelRegistry.coerce(model, device=dev)
    tuner, kb = _tuner_and_backend(dev, batch_size, autotune, tuner, backend)
    plat = platform if platform is not None else hikey970()
    # Warm start: a persisted last-known-good partition skips the
    # two-level DSE (best effort: an absent or unusable store, or one
    # saved for another set of models, means a cold start).
    resume_partition = None
    if resume_from is not None:
        resume_partition = PlanStore.coerce(resume_from).load_partition(plat)
        if resume_partition is not None and sorted(
            resume_partition.names
        ) != sorted(e.name for e in registry):
            resume_partition = None
    # The time matrices, and the route measurements they are made from,
    # only when something still needs them: the partition DSE (no resume)
    # or the adaptive loop's priors.
    need_T = resume_partition is None or adaptive
    measured = None
    if kb is not None and tuner is not None and time_matrix is None and need_T:
        measured = {}
        for entry in registry:  # one shared cache: common shapes time once
            measured.update(measure_graph_routes(entry.graph, kb, tuner))
    planner = AutoPlanner(
        platform=plat,
        mode=mode,
        source=source,
        backend=kb,
        measured=measured,
        tuner=tuner,
        device=dev,
    )
    Ts = None
    if time_matrix is None:
        if need_T:
            Ts = planner.time_matrices(registry.graphs())
    elif isinstance(time_matrix, Mapping):
        Ts = {e.name: time_matrix[e.name] for e in registry}
    else:
        raise ValueError(
            "multi-model serve() needs time_matrix as {model: TimeMatrix}"
        )
    builders = None
    if stage_fn_builder is not None:
        # a single builder callable applies to every model; per-model
        # overrides go through AutoPlanner.build_multi directly
        builders = {e.name: stage_fn_builder for e in registry}
    mserver = planner.build_multi(
        registry,
        time_matrices=Ts,
        batch_size=batch_size,
        flush_timeout_s=flush_timeout_s,
        queue_depth=queue_depth,
        warmup=warmup,
        stage_fn_builders=builders,
        max_inflight=max_inflight,
        fairness=fairness,
        power_cap_w=power_cap_w,
        power_objective=power_objective,
        partition=resume_partition,
        recovery=recovery,
    )
    if adaptive:
        attach_partition_adaptive(
            mserver,
            priors=Ts,
            platform=planner.platform,
            mode=mode,
            config=adaptive_config,
            power_cap_w=power_cap_w,
            power_objective=power_objective,
        )
    if plan_store is not None:
        mserver.plan_store = PlanStore.coerce(plan_store)
        mserver._persist_partition()
    return mserver
