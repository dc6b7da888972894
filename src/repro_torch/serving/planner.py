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
An explicit ``time_matrix`` overrides both.

Not yet ported (each raises ``NotImplementedError`` naming its ROADMAP
item): the adaptive loop, the power-aware DSE and governor, the
autotuner, plan persistence and multi-model co-serving.
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
from ..kernels.config import resolve_device
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
    measured : {descriptor key: seconds} measured layer times; they
        override the Eq. 5 regression in the predictor.
    device : the serving device; ``None`` means the card.
    """

    platform: HeteroPlatform = dataclasses.field(default_factory=hikey970)
    mode: str = "best"
    source: str = "synthetic"
    backend: object = None
    measured: object = None
    device: object = None

    def predictor(self) -> LayerTimePredictor:
        if self.source == "synthetic":
            model = synthetic_model()
        elif self.source == "calibrated":
            model = calibrate(device=self.device)
        else:
            raise ValueError(f"unknown time source {self.source!r}")
        return LayerTimePredictor(
            model=model, platform=self.platform, measured=self.measured
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
        recovery=None,
    ) -> PipelineServer:
        """Plan the pipeline and construct a (warmed, started) server;
        ``stage_fn_builder`` goes to :class:`PipelineServer`."""
        device = resolve_device(self.device)
        if params is None:
            params = graph.init(seed=seed, device=device)
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

    >>> server = serve("vgg16", backend="cuda_fused", batch_size=4)
    >>> logits = server.submit(image).result()
    >>> server.stop()
    """
    if isinstance(model, Mapping):
        raise _not_ported("{model: ...}", "queue 1 item 8, multi-model co-serving")
    if adaptive:
        raise _not_ported("adaptive=True", "queue 1 item 8, control plane")
    if power_cap_w is not None or min_throughput is not None:
        raise _not_ported(
            "power_cap_w/min_throughput", "queue 1 item 8, governor and power-aware DSE"
        )
    if autotune or tuner is not None:
        raise _not_ported("autotune/tuner", "queue 1 item 9, autotuner")
    if plan_store is not None or resume_from is not None:
        raise _not_ported("plan_store/resume_from", "queue 1 item 8, persistence")
    dev = resolve_device(device)
    graph = MODELS[model]() if isinstance(model, str) else model
    planner = AutoPlanner(
        platform=platform if platform is not None else hikey970(),
        mode=mode,
        source=source,
        backend=backend,
        device=dev,
    )
    return planner.build(
        graph,
        params,
        time_matrix=time_matrix,
        batch_size=batch_size,
        flush_timeout_s=flush_timeout_s,
        queue_depth=queue_depth,
        seed=seed,
        warmup=warmup,
        stage_fn_builder=stage_fn_builder,
        recovery=recovery,
    )
